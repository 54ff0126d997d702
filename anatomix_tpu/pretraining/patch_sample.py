"""Patch sampling + projector MLPs (the reference's `PatchSampleF`).

Reference: `/root/reference/pretraining/models/pretraining_networks.py:
280-519`. Key differences in this rebuild:

* MLP input widths are *static*, computed from the UNet plan's tap channels
  (`UnetPlan.tap_channels`), killing the reference's data-dependent lazy
  init (`pretraining_networks.py:409-410`) and its
  `data_dependent_initialize` dance (`supcl_model.py:539-600`).
* Coordinate sampling is Gumbel top-k — distribution-identical to the
  reference's `randperm` of (foreground) coords (uniform without
  replacement) but without materializing an n-element permutation —
  P_t = min(num_patches, voxels) per tap, shared across the two views.
* The per-tap MLP is Linear(no bias) → BatchNorm1d → ReLU (×1 or ×2) →
  Linear(no bias) → BatchNorm1d(affine=False), `n_mlps ∈ {2, 3}`; batch
  norm runs over the flattened (views · patches) axis in train mode.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def init_patch_mlps(
    key: jax.Array,
    tap_channels: Sequence[int],
    *,
    nc: int = 256,
    n_mlps: int = 3,
    init_type: str = "kaiming",
    init_gain: float = 0.02,
    dtype=jnp.float32,
) -> dict[str, Any]:
    """Per-tap projector parameters, keyed 'mlp_<i>'."""
    if n_mlps not in (2, 3):
        raise NotImplementedError("n_mlps must be 2 or 3")
    params: dict[str, Any] = {}
    for i, cin in enumerate(tap_channels):
        widths = [cin] + [nc] * n_mlps
        linears = []
        bns = []
        for j in range(n_mlps):
            key, sub = jax.random.split(key)
            fan_in = widths[j]
            if init_type == "kaiming":
                std = float(np.sqrt(2.0 / fan_in))
            elif init_type == "xavier":
                std = init_gain * float(
                    np.sqrt(2.0 / (fan_in + widths[j + 1]))
                )
            else:  # normal
                std = init_gain
            linears.append(
                jax.random.normal(sub, (widths[j], widths[j + 1]), dtype)
                * std
            )
            affine = j < n_mlps - 1  # final norm has affine=False
            bn = {
                "mean": jnp.zeros((widths[j + 1],), jnp.float32),
                "var": jnp.ones((widths[j + 1],), jnp.float32),
            }
            if affine:
                key, sub = jax.random.split(key)
                bn["scale"] = (
                    1.0
                    + jax.random.normal(sub, (widths[j + 1],), dtype)
                    * init_gain
                )
                bn["bias"] = jnp.zeros((widths[j + 1],), dtype)
            bns.append(bn)
        params[f"mlp_{i}"] = {
            "linears": linears,
            "bns": bns,
        }
    return params


def _bn1d(x, bn, *, train: bool, eps: float, momentum: float = 0.1):
    """BatchNorm1d over axis 0; returns (y, new_stats_or_None)."""
    x32 = x.astype(jnp.float32)
    if train:
        mean = jnp.mean(x32, axis=0)
        var = jnp.mean(jnp.square(x32 - mean), axis=0)
        n = x.shape[0]
        unbiased = var * (n / max(n - 1, 1))
        new = {
            "mean": (1 - momentum) * bn["mean"] + momentum * mean,
            "var": (1 - momentum) * bn["var"] + momentum * unbiased,
        }
    else:
        mean, var = bn["mean"], bn["var"]
        new = None
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    if "scale" in bn:
        y = y * bn["scale"].astype(jnp.float32) + bn["bias"].astype(
            jnp.float32
        )
    return y, new


def apply_patch_mlp(
    mlp_params: dict[str, Any],
    x: jax.Array,  # (N, C_in) flattened patch features
    *,
    train: bool = True,
    eps: float = 1e-5,
):
    """Project patch features; returns (y (N, nc), new_bn_stats list)."""
    new_stats = []
    n = len(mlp_params["linears"])
    for j, (w, bn) in enumerate(
        zip(mlp_params["linears"], mlp_params["bns"])
    ):
        x = x.astype(jnp.float32) @ w.astype(jnp.float32)
        x, upd = _bn1d(x, bn, train=train, eps=eps)
        if upd is not None:
            new_stats.append({**bn, **upd})
        else:
            new_stats.append(bn)
        if j < n - 1:
            x = jax.nn.relu(x)
    return x, new_stats


def sample_patch_coords(
    key: jax.Array,
    spatial: tuple[int, int, int],
    num_patches: int,
    mask: jax.Array | None = None,
) -> jax.Array:
    """Sample min(num_patches, voxels) distinct voxel coords, (P, 3) int32.

    Matches the reference's randperm-then-take (uniform, without
    replacement) over all voxels, or over foreground voxels when a mask is
    given (`pretraining_networks.py:436-460`). The masked path uses Gumbel
    top-k, which is a static-shape uniform sample without replacement over
    the mask support; unlike the reference (which returns fewer patches),
    when the foreground has fewer than `num_patches` voxels the remainder
    is filled with uniformly-sampled background voxels.
    """
    d, h, w = spatial
    n = d * h * w
    p = min(num_patches, n)
    if mask is None:
        # Gumbel top-k == uniform without replacement (equal scores), and
        # the by-score ordering of the selected set is itself a uniform
        # permutation — exactly `choice(replace=False)`'s distribution.
        # `choice` materializes a full n-element permutation (two sorts
        # over all 2M voxels at the 128-crop config); top_k of 512 is
        # cheaper.
        _, flat = jax.lax.top_k(jax.random.gumbel(key, (n,), jnp.float32), p)
    else:
        g = jax.random.gumbel(key, (n,), jnp.float32)
        # the penalty must be small enough that float32 keeps the Gumbel
        # noise on penalized entries (at -1e9 the spacing is 64 and every
        # background score collapses to exactly -1e9, making the "uniform"
        # background fill deterministically the lowest-index voxels); at
        # -1e4 the spacing is ~1e-3 and ordering noise survives while any
        # foreground score still dominates (gumbel range is ~[-3, 40])
        score = g + jnp.where(mask.reshape(-1) > 0, 0.0, -1e4)
        _, flat = jax.lax.top_k(score, p)
    cz = flat // (h * w)
    cy = (flat // w) % h
    cx = flat % w
    return jnp.stack([cz, cy, cx], axis=-1).astype(jnp.int32)


def nearest_downsample(
    vol: jax.Array, tap_spatial: tuple[int, int, int]
) -> jax.Array:
    """Nearest-downsample a (D, H, W) volume to a tap grid, matching torch
    `F.interpolate(mode='nearest')` (out[i] = in[floor(i*D/d)]) — used to
    bring a foreground mask to each tap's resolution
    (`pretraining_networks.py:398-402`)."""
    D, H, W = vol.shape
    d, h, w = tap_spatial
    if D % d == 0 and H % h == 0 and W % w == 0:
        return vol[:: D // d, :: H // h, :: W // w]
    iz = (jnp.arange(d, dtype=jnp.float32) * (D / d)).astype(jnp.int32)
    iy = (jnp.arange(h, dtype=jnp.float32) * (H / h)).astype(jnp.int32)
    ix = (jnp.arange(w, dtype=jnp.float32) * (W / w)).astype(jnp.int32)
    return vol[iz][:, iy][:, :, ix]


def gather_at_coords(feat: jax.Array, coords: jax.Array) -> jax.Array:
    """Gather (D, H, W, C) features at (P, 3) coords -> (P, C)."""
    D, H, W, C = feat.shape
    flat = (coords[:, 0] * H + coords[:, 1]) * W + coords[:, 2]
    return jnp.take(feat.reshape(-1, C), flat, axis=0)


def labels_at_coords(
    seg: jax.Array,  # (D, H, W) integer labels at full resolution
    coords: jax.Array,  # (P, 3) coords in the tap grid
    tap_spatial: tuple[int, int, int],
) -> jax.Array:
    """Labels of sampled tap-grid voxels via nearest-downsampling semantics.

    torch `F.interpolate(mode='nearest')` maps out[i] = in[floor(i·D/d)], so
    gathering the downsampled seg at `coords` equals gathering the full-res
    seg at scaled coords — no materialized downsampled volume needed
    (`supcl_model.py:106-113`).
    """
    D, H, W = seg.shape
    d, h, w = tap_spatial
    cz = (coords[:, 0] * (D // d)) if D % d == 0 else (
        (coords[:, 0].astype(jnp.float32) * (D / d)).astype(jnp.int32)
    )
    cy = (coords[:, 1] * (H // h)) if H % h == 0 else (
        (coords[:, 1].astype(jnp.float32) * (H / h)).astype(jnp.int32)
    )
    cx = (coords[:, 2] * (W // w)) if W % w == 0 else (
        (coords[:, 2].astype(jnp.float32) * (W / w)).astype(jnp.int32)
    )
    flat = (cz * H + cy) * W + cx
    return jnp.take(seg.reshape(-1), flat, axis=0)
