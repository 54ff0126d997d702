"""jit-compiled sliding-window inference with Gaussian-blend stitching.

Replacement for MONAI's `sliding_window_inference` as used by the
reference for whole-volume feature extraction (128³ windows, overlap 0.8,
gaussian blending, sigma_scale 0.25, sw_batch 2 —
`/root/reference/anatomix/registration/convex_adam_utils.py:202-219`) and
segmentation validation (`train_segmentation.py:194-199`).

Design
------
* Window starts are computed from *static* shapes at trace time (MONAI's
  `dense_patch_slices` semantics), so the whole pipeline compiles once per
  volume shape with no retraces across window counts.
* The window loop is a `lax.scan` over fixed-size chunks: each step
  dynamic-slices a batch of windows from the (padded) volume, runs the model,
  multiplies by the precomputed Gaussian importance map, and scatter-adds
  into an accumulator. Nothing the size of `num_windows × roi³ × C` is ever
  materialized.
* The blend *weight* map is data-independent, so it is precomputed with
  numpy at trace time and baked in as a constant.
* Multi-chip: windows are embarrassingly parallel. With a `Mesh`, the window
  list is sharded over the mesh axis via `shard_map`; each device accumulates
  its windows locally and a single `psum` merges the accumulators.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def gaussian_importance_map(
    roi_size, sigma_scale: float = 0.25
) -> np.ndarray:
    """MONAI-style Gaussian importance map, normalized to max 1 and clamped.

    MONAI builds it by convolving a one-hot at the center voxel
    (`roi // 2` per axis) with an erf-discretized Gaussian of
    `sigma = sigma_scale * roi`, normalizing to max 1, then clamping to
    `max(min_nonzero, 1e-3)`. The map is separable: the outer product of
    per-axis windows, each normalized to max 1.
    """
    from scipy.special import erf

    axes = []
    for size in roi_size:
        sigma = sigma_scale * size
        center = size // 2
        i = np.arange(size, dtype=np.float64)
        denom = sigma * math.sqrt(2.0)
        w = 0.5 * (
            erf((i - center + 0.5) / denom) - erf((i - center - 0.5) / denom)
        )
        axes.append(w / w.max())
    m = (
        axes[0][:, None, None]
        * axes[1][None, :, None]
        * axes[2][None, None, :]
    )
    minv = max(float(m[m > 0].min()), 1e-3)
    return np.clip(m, minv, None).astype(np.float32)


def constant_importance_map(roi_size) -> np.ndarray:
    return np.ones(tuple(roi_size), dtype=np.float32)


def compute_window_starts(image_size, roi_size, overlap: float) -> np.ndarray:
    """Dense window start positions, MONAI `dense_patch_slices` semantics.

    Per axis: interval = int(roi * (1 - overlap)) (or roi if image == roi);
    number of windows = ceil((img - roi) / interval) + 1; start positions
    `i * interval` clamped to `img - roi` (so the last window is flush with
    the volume edge).
    """
    per_axis = []
    for img, roi in zip(image_size, roi_size):
        if img <= roi:
            per_axis.append(np.array([0]))
            continue
        interval = int(roi * (1.0 - overlap))
        if interval <= 0:
            interval = roi
        count = int(math.ceil((img - roi) / interval)) + 1
        starts = np.minimum(np.arange(count) * interval, img - roi)
        per_axis.append(np.unique(starts))
    grid = np.meshgrid(*per_axis, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1).astype(np.int32)


def blend_weight_map(image_size, starts: np.ndarray, imp: np.ndarray):
    """Sum of importance maps over all window placements (host-side)."""
    acc = np.zeros(tuple(image_size), dtype=np.float32)
    r = imp.shape
    for s in starts:
        acc[s[0]: s[0] + r[0], s[1]: s[1] + r[1], s[2]: s[2] + r[2]] += imp
    return acc


def _pad_to_roi(volume, roi_size):
    """Symmetric zero-pad spatial dims up to at least roi (MONAI `pad_nd`)."""
    spatial = volume.shape[1:4]
    pads = [(0, 0)]
    crops = []
    for img, roi in zip(spatial, roi_size):
        diff = max(roi - img, 0)
        half = diff // 2
        pads.append((half, diff - half))
        crops.append((half, half + img))
    pads.append((0, 0))
    if any(p != (0, 0) for p in pads):
        volume = jnp.pad(volume, pads)
    return volume, crops


def _scan_windows(
    volume3d: jax.Array,  # (D, H, W, C) padded
    starts: jax.Array,  # (M, 3) int32, chunk-padded
    mask: jax.Array,  # (M,) float32, 0 for padding windows
    apply_fn,
    imp: jax.Array,  # (r, r, r, 1)
    roi_size,
    out_channels: int,
    sw_batch_size: int,
    acc_dtype,
    vary_axis: str | None = None,
):
    D, H, W, C = volume3d.shape
    r0, r1, r2 = roi_size
    M = starts.shape[0]
    n_chunks = M // sw_batch_size

    # Folded accumulator: (W, C) is folded into rows of 128 values and
    # each window product is shifted into a fold-aligned canvas, so every
    # read-modify-write starts on a row boundary. Whether this beats a
    # plain (…, W, C) accumulator on the GPU is not measured yet.
    fold = 128 // out_channels if 128 % out_channels == 0 else 1
    fold = math.gcd(math.gcd(fold, W), r2)  # canvas/acc widths must fold
    Wf = (W + fold) // fold if fold > 1 else W
    lanes = out_channels * fold

    acc0 = jnp.zeros((D, H, Wf, lanes), acc_dtype)
    if vary_axis is not None:
        # Under shard_map the accumulator is device-varying (each shard sums
        # a different window subset); mark the carry accordingly.
        acc0 = jax.lax.pcast(acc0, (vary_axis,), to="varying")

    def slice_window(s):
        return jax.lax.dynamic_slice(
            volume3d, (s[0], s[1], s[2], 0), (r0, r1, r2, C)
        )

    def chunk_body(acc, chunk):
        chunk_starts, chunk_mask = chunk
        windows = jax.vmap(slice_window)(chunk_starts)
        out = apply_fn(windows)  # (B, r, r, r, out_channels)
        impf = imp.astype(acc_dtype)

        def scatter_one(a, s_o_m):
            s, o, m = s_o_m
            # blend multiply + f32 upcast inside the per-window step so it
            # fuses into the slice-add-update chain instead of
            # materializing a chunk-sized f32 tensor
            ow = o.astype(acc_dtype) * impf * m.astype(acc_dtype)
            if fold == 1:
                cur = jax.lax.dynamic_slice(
                    a, (s[0], s[1], s[2], 0), (r0, r1, r2, out_channels)
                )
                return (
                    jax.lax.dynamic_update_slice(
                        a, cur + ow, (s[0], s[1], s[2], 0)
                    ),
                    None,
                )
            r = s[2] % fold
            Lw = r2 + fold
            can = jax.lax.dynamic_slice(
                jnp.pad(ow, ((0, 0), (0, 0), (fold, fold), (0, 0))),
                (0, 0, fold - r, 0),
                (r0, r1, Lw, out_channels),
            ).reshape(r0, r1, Lw // fold, lanes)
            off = (s[2] - r) // fold
            cur = jax.lax.dynamic_slice(
                a, (s[0], s[1], off, 0), (r0, r1, Lw // fold, lanes)
            )
            return (
                jax.lax.dynamic_update_slice(
                    a, cur + can, (s[0], s[1], off, 0)
                ),
                None,
            )

        acc, _ = jax.lax.scan(
            scatter_one, acc, (chunk_starts, out, chunk_mask)
        )
        return acc, None

    acc, _ = jax.lax.scan(
        chunk_body,
        acc0,
        (
            starts.reshape(n_chunks, sw_batch_size, 3),
            mask.reshape(n_chunks, sw_batch_size),
        ),
    )
    if fold > 1:
        acc = acc.reshape(D, H, W + fold, out_channels)[:, :, :W]
    return acc


def sliding_window_inference(
    volume: jax.Array,
    apply_fn: Callable[[jax.Array], jax.Array],
    out_channels: int,
    *,
    roi_size=(128, 128, 128),
    sw_batch_size: int = 2,
    overlap: float = 0.8,
    mode: str = "gaussian",
    sigma_scale: float = 0.25,
    mesh: Mesh | None = None,
    mesh_axis: str = "data",
    acc_dtype=jnp.float32,
) -> jax.Array:
    """Whole-volume inference by Gaussian-blended sliding windows.

    `volume`: (1, D, H, W, C) channel-last. `apply_fn`: batched window model
    (B, r, r, r, C) -> (B, r, r, r, out_channels), same spatial size.
    Returns (1, D, H, W, out_channels).

    With `mesh`, windows are sharded over `mesh_axis` across devices and the
    partial accumulators merged with one `psum`.
    """
    if volume.ndim != 5 or volume.shape[0] != 1:
        raise ValueError("volume must be (1, D, H, W, C)")
    roi_size = tuple(roi_size)

    padded, crops = _pad_to_roi(volume, roi_size)
    spatial = padded.shape[1:4]

    starts_np = compute_window_starts(spatial, roi_size, overlap)
    if mode == "gaussian":
        imp_np = gaussian_importance_map(roi_size, sigma_scale)
    elif mode == "constant":
        imp_np = constant_importance_map(roi_size)
    else:
        raise ValueError(f"Unsupported blend mode: {mode}")

    weight_np = blend_weight_map(spatial, starts_np, imp_np)

    n_real = len(starts_np)
    if mesh is not None and mesh_axis not in mesh.shape:
        if len(mesh.axis_names) == 1:
            # shard over whatever single axis the caller's mesh has
            mesh_axis = mesh.axis_names[0]
        else:
            raise ValueError(
                f"mesh has no '{mesh_axis}' axis (axes: {mesh.axis_names}); "
                "pass mesh_axis= explicitly"
            )
    n_shards = mesh.shape[mesh_axis] if mesh is not None else 1
    group = sw_batch_size * n_shards
    n_padded = int(math.ceil(n_real / group)) * group
    starts_all = np.zeros((n_padded, 3), np.int32)
    starts_all[:n_real] = starts_np
    mask_all = np.zeros((n_padded,), np.float32)
    mask_all[:n_real] = 1.0

    imp = jnp.asarray(imp_np)[..., None]
    starts_dev = jnp.asarray(starts_all)
    mask_dev = jnp.asarray(mask_all)
    weight = jnp.asarray(weight_np)[None, ..., None]

    scan_fn = functools.partial(
        _scan_windows,
        apply_fn=apply_fn,
        roi_size=roi_size,
        out_channels=out_channels,
        sw_batch_size=sw_batch_size,
        acc_dtype=acc_dtype,
    )

    if mesh is None:
        acc = scan_fn(padded[0], starts_dev, mask_dev, imp=imp)
    else:
        from jax import shard_map

        def sharded(vol3d, starts, mask, imp_arr):
            local = scan_fn(
                vol3d, starts, mask, imp=imp_arr, vary_axis=mesh_axis
            )
            return jax.lax.psum(local, mesh_axis)

        acc = shard_map(
            sharded,
            mesh=mesh,
            in_specs=(P(), P(mesh_axis), P(mesh_axis), P()),
            out_specs=P(),
        )(padded[0], starts_dev, mask_dev, imp)

    out = acc[None] / weight.astype(acc.dtype)
    (c0, c1), (c2, c3), (c4, c5) = crops
    return out[:, c0:c1, c2:c3, c4:c5, :]
