"""Differentiable 3D `grid_sample` with torch parity, channel-last.

torch convention being matched (`F.grid_sample` on 5-D input):
  * input (N, C, D, H, W)  -> here (N, D, H, W, C)
  * grid  (N, D, H, W, 3) with grid[..., 0]=x (W axis), 1=y (H), 2=z (D)
  * align_corners=False: pix = ((coord + 1) * size - 1) / 2
  * align_corners=True:  pix = (coord + 1) / 2 * (size - 1)
  * padding_mode='zeros': out-of-bounds corner taps contribute zero.

Used in four reference call sites: inverse consistency
(`convex_adam_utils.py:592-601`), Adam instance optimization
(`instance_optimization.py:360-371`), final image/label warping
(`run_convex_adam_with_network_feats.py:248-266`), and mask infill.

Implemented as 8 masked corner gathers over a flattened volume —
XLA lowers these to plain gathers, and the expression is
differentiable in both the volume and the grid (grad w.r.t. the grid flows
through the trilinear weights, which instance optimization requires).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _unnormalize(coord, size, align_corners):
    size = jnp.float32(size)
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1.0)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _gather_volume(vol_flat, z, y, x, D, H, W):
    """Gather vol_flat (N, D*H*W, C) at integer (z, y, x) of shape (N, P)."""
    idx = (z * H + y) * W + x
    return jnp.take_along_axis(vol_flat, idx[..., None], axis=1)


def grid_sample(
    vol: jax.Array,
    grid: jax.Array,
    *,
    mode: str = "bilinear",
    align_corners: bool = False,
) -> jax.Array:
    """Sample `vol` (N, D, H, W, C) at normalized `grid` (N, d, h, w, 3).

    Returns (N, d, h, w, C). padding_mode='zeros' only (the only mode the
    reference uses).
    """
    N, D, H, W, C = vol.shape
    out_spatial = grid.shape[1:4]
    g = grid.reshape(N, -1, 3).astype(jnp.float32)

    x = _unnormalize(g[..., 0], W, align_corners)
    y = _unnormalize(g[..., 1], H, align_corners)
    z = _unnormalize(g[..., 2], D, align_corners)

    vol_flat = vol.reshape(N, D * H * W, C)

    if mode == "nearest":
        # torch rounds half away from... uses round-half-to-even? It uses
        # `std::nearbyint` (round half to even). jnp.rint matches.
        xi = jnp.rint(x).astype(jnp.int32)
        yi = jnp.rint(y).astype(jnp.int32)
        zi = jnp.rint(z).astype(jnp.int32)
        valid = (
            (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H) & (zi >= 0) & (zi < D)
        )
        xi = jnp.clip(xi, 0, W - 1)
        yi = jnp.clip(yi, 0, H - 1)
        zi = jnp.clip(zi, 0, D - 1)
        out = _gather_volume(vol_flat, zi, yi, xi, D, H, W)
        out = out * valid[..., None].astype(out.dtype)
        return out.reshape(N, *out_spatial, C)

    if mode != "bilinear":
        raise ValueError(f"Unsupported grid_sample mode: {mode}")

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    z0 = jnp.floor(z)
    fx = x - x0
    fy = y - y0
    fz = z - z0

    out = None
    for dz in (0, 1):
        wz = (1.0 - fz) if dz == 0 else fz
        zc = z0 + dz
        for dy in (0, 1):
            wy = (1.0 - fy) if dy == 0 else fy
            yc = y0 + dy
            for dx in (0, 1):
                wx = (1.0 - fx) if dx == 0 else fx
                xc = x0 + dx
                valid = (
                    (xc >= 0)
                    & (xc < W)
                    & (yc >= 0)
                    & (yc < H)
                    & (zc >= 0)
                    & (zc < D)
                )
                weight = wz * wy * wx * valid.astype(jnp.float32)
                xi = jnp.clip(xc.astype(jnp.int32), 0, W - 1)
                yi = jnp.clip(yc.astype(jnp.int32), 0, H - 1)
                zi = jnp.clip(zc.astype(jnp.int32), 0, D - 1)
                tap = _gather_volume(vol_flat, zi, yi, xi, D, H, W)
                contrib = tap.astype(jnp.float32) * weight[..., None]
                out = contrib if out is None else out + contrib

    return out.astype(vol.dtype).reshape(N, *out_spatial, C)


def make_packed_sampler(vol: jax.Array, *, align_corners: bool = False):
    """Build a fast repeated-warp sampler for one volume.

    Packs the 2×2×2 neighborhood into channels once (one zero-padded
    shifted concat), so each subsequent `sample(grid)` does ONE row-gather
    of (N, 8·C) instead of 8 and combines corners with elementwise weights
    — identical results to `grid_sample(vol, grid)` (bilinear, zeros
    padding). The layout was chosen for a device whose gathers cost per
    row; whether it pays on the GPU is not measured yet. Use when the same
    volume is sampled many times (the Adam instance-optimization loop: 80
    warps of the same features, `instance_optimization.py:329-384`).
    """
    N_, D, H, W, C = vol.shape
    if N_ != 1:
        raise ValueError("packed sampler supports batch 1")
    volp = jnp.pad(
        vol[0], ((1, 1), (1, 1), (1, 1), (0, 0))
    )  # zero border serves out-of-range corner taps
    nb = jnp.concatenate(
        [
            jax.lax.slice(
                volp, (dz, dy, dx, 0),
                (dz + D + 1, dy + H + 1, dx + W + 1, C),
            )
            for dz in (0, 1)
            for dy in (0, 1)
            for dx in (0, 1)
        ],
        axis=-1,
    )  # (D+1, H+1, W+1, 8C); row at (z0+1, y0+1, x0+1) holds all corners
    nb_flat = nb.reshape(-1, 8 * C)
    Hp, Wp = H + 1, W + 1

    def sample(grid: jax.Array) -> jax.Array:
        out_spatial = grid.shape[1:4]
        g = grid.reshape(-1, 3).astype(jnp.float32)
        x = _unnormalize(g[:, 0], W, align_corners)
        y = _unnormalize(g[:, 1], H, align_corners)
        z = _unnormalize(g[:, 2], D, align_corners)
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        z0 = jnp.floor(z)
        fx = x - x0
        fy = y - y0
        fz = z - z0
        # base corners in [-1, D-1] read true values / the zero border;
        # anything further out is masked to zero (grid_sample zeros pad)
        valid = (
            (x0 >= -1) & (x0 <= W - 1)
            & (y0 >= -1) & (y0 <= H - 1)
            & (z0 >= -1) & (z0 <= D - 1)
        )
        xi = jnp.clip(x0, -1, W - 1).astype(jnp.int32) + 1
        yi = jnp.clip(y0, -1, H - 1).astype(jnp.int32) + 1
        zi = jnp.clip(z0, -1, D - 1).astype(jnp.int32) + 1
        rows = jnp.take(
            nb_flat, (zi * Hp + yi) * Wp + xi, axis=0
        )  # (N, 8C)
        taps = rows.reshape(-1, 8, C).astype(jnp.float32)
        wz = jnp.stack([1.0 - fz, fz], -1)  # (N, 2)
        wy = jnp.stack([1.0 - fy, fy], -1)
        wx = jnp.stack([1.0 - fx, fx], -1)
        w8 = (
            wz[:, :, None, None] * wy[:, None, :, None]
            * wx[:, None, None, :]
        ).reshape(-1, 8)
        out = jnp.einsum("nk,nkc->nc", w8, taps)
        out = out * valid[:, None].astype(jnp.float32)
        return out.reshape(1, *out_spatial, C).astype(vol.dtype)

    return sample


def identity_grid(
    spatial: tuple[int, int, int], *, align_corners: bool = False
) -> jax.Array:
    """Normalized identity grid (1, D, H, W, 3), matching
    `F.affine_grid(eye(3,4), (1, 1, D, H, W), align_corners=...)`.

    grid[..., 0] = x over W, 1 = y over H, 2 = z over D. For
    align_corners=False torch evaluates at ((2i + 1)/size - 1) * (size-1)/size
    ... equivalently linspace scaled by (size-1)/size; we reproduce exactly:
    coords are `(-1 + 1/size) .. (1 - 1/size)` evenly spaced.
    """
    D, H, W = spatial

    def axis_coords(size):
        if align_corners:
            return jnp.linspace(-1.0, 1.0, size, dtype=jnp.float32)
        step = 2.0 / size
        return (jnp.arange(size, dtype=jnp.float32) + 0.5) * step - 1.0

    zs = axis_coords(D)
    ys = axis_coords(H)
    xs = axis_coords(W)
    zz, yy, xx = jnp.meshgrid(zs, ys, xs, indexing="ij")
    return jnp.stack([xx, yy, zz], axis=-1)[None]
