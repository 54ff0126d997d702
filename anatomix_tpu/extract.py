"""Whole-volume feature extraction (the flagship inference workload).

Replaces the reference's `extract_features` (minmax-normalize + MONAI
sliding window, `/root/reference/anatomix/registration/convex_adam_utils.py:
134-221`) with a jit-compiled pipeline:

* eval-mode batch norm is folded into the preceding convs (a per-channel
  affine — free at inference, saves memory bandwidth),
* convs optionally run in bfloat16 with fp32 accumulation (`compute_dtype`),
* windows are batched and Gaussian-blend-stitched under one jit, optionally
  sharded across a device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.models.unet import LayerSpec, UnetPlan, unet_apply
from anatomix_tpu.ops.sliding_window import sliding_window_inference


def fold_batchnorm(plan: UnetPlan, params: dict[str, Any]):
    """Fold eval-mode batch norms into their preceding convs.

    Returns `(folded_plan, folded_params)` where norm layers become
    'identity' no-ops (indices — and therefore tap semantics — are
    preserved: the activation at the identity layer equals the old norm
    output).
    """
    if plan.config.norm != "batch":
        return plan, params
    new_layers = list(plan.layers)
    new_params = {k: dict(v) for k, v in params.items()}
    prev_conv = None
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            prev_conv = idx
        elif spec.kind == "norm":
            p = new_params.pop(str(idx))
            inv = np.asarray(p["scale"], np.float32) / np.sqrt(
                np.asarray(p["var"], np.float32) + plan.config.norm_eps
            )
            shift = np.asarray(p["bias"], np.float32) - np.asarray(
                p["mean"], np.float32
            ) * inv
            conv_p = new_params[str(prev_conv)]
            conv_p["w"] = np.asarray(conv_p["w"], np.float32) * inv
            conv_p["b"] = (
                np.asarray(conv_p.get("b", 0.0), np.float32) + shift
                if "b" in conv_p
                else shift
            )
            new_layers[idx] = LayerSpec("identity")
    folded_plan = dataclasses.replace(plan, layers=tuple(new_layers))
    return folded_plan, new_params


def _bind(impl, params):
    """`volume -> impl(volume, params)`: parameters travel as jit
    arguments, not as constants baked into the compiled program."""

    def fn(volume):
        return impl(volume, params)

    return fn


def minmax(arr: np.ndarray, minclip=None, maxclip=None) -> np.ndarray:
    """[0, 1] min-max normalization with optional clipping
    (`convex_adam_utils.py:134-156`)."""
    if not ((minclip is None) and (maxclip is None)):
        arr = np.clip(arr, minclip, maxclip)
    arr = arr.astype(np.float32)
    return (arr - arr.min()) / (arr.max() - arr.min())


def unit_normalize(feats: jax.Array, eps: float = 1e-8) -> jax.Array:
    """Voxelwise unit L2 norm across channels (required for the dev models
    per the reference README)."""
    norm = jnp.linalg.norm(feats.astype(jnp.float32), axis=-1, keepdims=True)
    return (feats / jnp.maximum(norm, eps)).astype(feats.dtype)


def zscore_normalize(feats: jax.Array, eps: float = 1e-6) -> jax.Array:
    """Voxelwise z-score across channels."""
    f32 = feats.astype(jnp.float32)
    mean = jnp.mean(f32, axis=-1, keepdims=True)
    std = jnp.std(f32, axis=-1, keepdims=True)
    return ((f32 - mean) / (std + eps)).astype(feats.dtype)


def make_feature_extractor(
    plan: UnetPlan,
    params: dict[str, Any],
    *,
    strategy: str = "sliding",
    roi_size=(128, 128, 128),
    sw_batch_size: int | None = None,  # auto: 2 (reference default)
    overlap: float = 0.8,
    mode: str = "gaussian",
    sigma_scale: float = 0.25,
    compute_dtype=None,
    fold_bn: bool = True,
    mesh=None,
):
    """Build a jitted `volume (1,D,H,W,C) -> features (1,D,H,W,out)` fn.

    Strategies:
      * 'sliding' — Gaussian-blended 128³ windows, the reference's exact
        semantics (`convex_adam_utils.py:202-219`).
      * 'full' — ONE whole-volume forward. For batch-norm models in eval
        mode the UNet is fully convolutional, so this computes the same
        feature map with a single consistent spatial context instead of 343
        overlapping window contexts — no tiling/blend artifacts, ~1/27th the
        FLOPs of overlap-0.8 tiling. Not bitwise-comparable to stitching
        (each stitched voxel mixes windows whose reflect-padding contexts
        differ); it is the artifact-free version of the same features.
        Spatial dims are padded to a multiple of 2^num_downs. NOT valid for
        instance-norm models (their normalization context is per-window).
      * 'full_tiled' — ONE whole-volume forward with instance-norm
        statistics computed per roi-sized subvolume tile
        (`ops/norms.tiled_instance_norm`): the documented fast variant for
        instance-norm models (`anatomix-dev`), whose normalization context
        is per-window under the reference semantics. Each voxel is
        normalized with the stats of its own ~roi³ tile — approximating
        the Gaussian blend of per-window stats at 1/27th the overlap-0.8
        FLOPs. Parity vs 'sliding' is quantified in
        tests/test_extract.py::test_full_tiled_vs_sliding.
      * 'auto' — 'full' for batch/none norms, 'sliding' otherwise.

    Fidelity guidance for instance-norm models at 94M/256³: reference-
    exact sliding at overlap 0.8 runs 343 windows; `overlap=0.5` runs 27
    at cosine ~0.87 to the reference features; `full_tiled` is one
    forward at cosine ~0.80. The default stays the reference-exact
    overlap-0.8 — pass `overlap=0.5` when throughput matters more than
    exact reference feature definitions (the cosine gap is instance-norm
    context, not kernel error).
    """
    # ViT backbone: fixed 128³ input -> sliding windows only
    # ("amenable to sliding window", reference README.md:47)
    from anatomix_tpu.models.vit3d import PrimusConfig, primus_apply

    if isinstance(plan, PrimusConfig):
        vit_cfg = plan
        params = jax.tree_util.tree_map(jnp.asarray, params)

        @jax.jit
        def extract_vit_impl(volume, p):
            def vit_window_fn(windows):
                return primus_apply(
                    vit_cfg, p, windows, compute_dtype=compute_dtype
                )

            return sliding_window_inference(
                volume,
                vit_window_fn,
                vit_cfg.num_classes,
                roi_size=vit_cfg.input_shape,
                sw_batch_size=sw_batch_size or 2,
                overlap=overlap,
                mode=mode,
                sigma_scale=sigma_scale,
                mesh=mesh,
            )

        return _bind(extract_vit_impl, params)

    if strategy == "auto":
        strategy = "full" if plan.config.norm in ("batch", "none") else "sliding"
    if fold_bn:
        plan, params = fold_batchnorm(plan, params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    out_channels = plan.config.output_nc

    if strategy == "full" and mesh is not None and "space" in getattr(
        mesh, "axis_names", ()
    ):
        # single giant volume sharded over the 'space' axis with per-conv
        # halo exchange between devices (parallel/spatial.py)
        from anatomix_tpu.parallel.spatial import spatial_sharded_unet

        return spatial_sharded_unet(
            plan, params, mesh, compute_dtype=compute_dtype
        )

    if strategy in ("full", "full_tiled"):
        stride = 2 ** plan.config.num_downs
        tiled = strategy == "full_tiled"

        @jax.jit
        def extract_impl(volume, p):
            spatial = volume.shape[1:4]
            pads = [(0, 0)]
            crops = []
            for s in spatial:
                pad = (-s) % stride
                pads.append((pad // 2, pad - pad // 2))
                crops.append((pad // 2, pad // 2 + s))
            pads.append((0, 0))
            x = jnp.pad(volume, pads) if any(
                q != (0, 0) for q in pads
            ) else volume
            tile_counts = None
            if tiled:
                # ~roi-sized normalization tiles (static: shapes are known
                # at trace time); a 256³ volume with roi 128 gets 2×2×2
                tile_counts = tuple(
                    max(1, round(s / r))
                    for s, r in zip(x.shape[1:4], roi_size)
                )
            y = unet_apply(
                plan, p, x, compute_dtype=compute_dtype,
                in_tile_counts=tile_counts,
            )
            (c0, c1), (c2, c3), (c4, c5) = crops
            return y[:, c0:c1, c2:c3, c4:c5, :]

        return _bind(extract_impl, params)

    if strategy != "sliding":
        raise ValueError(f"Unknown strategy: {strategy}")

    @jax.jit
    def extract_sliding_impl(volume, p):
        def sliding_apply(windows):
            return unet_apply(plan, p, windows, compute_dtype=compute_dtype)

        return sliding_window_inference(
            volume,
            sliding_apply,
            out_channels,
            roi_size=roi_size,
            sw_batch_size=sw_batch_size or 2,
            overlap=overlap,
            mode=mode,
            sigma_scale=sigma_scale,
            mesh=mesh,
        )

    return _bind(extract_sliding_impl, params)


def extract_features(
    img_fixed: np.ndarray,
    img_moving: np.ndarray,
    plan: UnetPlan,
    params: dict[str, Any],
    fixminclip=None,
    fixmaxclip=None,
    movminclip=None,
    movmaxclip=None,
    **extractor_kwargs,
):
    """Reference-compatible two-volume feature extraction
    (`convex_adam_utils.py:159-221`). Returns channel-last jax arrays."""
    extractor = make_feature_extractor(plan, params, **extractor_kwargs)
    fixed = jnp.asarray(
        minmax(img_fixed, fixminclip, fixmaxclip)[None, ..., None]
    )
    moving = jnp.asarray(
        minmax(img_moving, movminclip, movmaxclip)[None, ..., None]
    )
    return extractor(fixed), extractor(moving)
