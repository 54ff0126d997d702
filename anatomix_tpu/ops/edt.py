"""Exact Euclidean distance/feature transform, jittable on the device.

On-device replacement for the scipy `distance_transform_edt(...,
return_indices=True)` host call the reference uses for masked feature-merge
infill (`/root/reference/anatomix/registration/instance_optimization.py:67-96`).
Running it on device avoids shipping whole volumes host->device->host through
the (slow) interconnect purely for a preprocessing step.

Method: the squared EDT is separable, so it factors into three 1-D min-plus
("distance") passes:

    pass over axis a:   out[i] = min_j ( (i - j)^2 + cost[j] )

Each pass is computed exactly by brute-force min over j, vectorized across
all other voxels and chunked over the output index i (O(n) work per voxel
per axis — at the reference's ::2-subsampled 128^3 this is ~0.8 G adds+mins). Nearest-voxel indices are carried through the passes:
pass a yields the argmin j along axis a, and the indices found by earlier
passes are gathered at that j.

Ties are broken toward the smallest index along the pass axis (jnp.argmin
semantics); scipy may pick a different equidistant voxel, so infilled
*values* can differ at exact-tie sites while distances agree exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Large-but-safe "infinity" for int32 min-plus: three passes each add at most
# (n-1)^2 <= 2^22 for n <= 2049, so 2^30 + 3*2^22 < 2^31 never overflows.
_INF = jnp.int32(1 << 30)


def _chunk(n: int, target: int = 16) -> int:
    """Largest divisor of n that is <= target (chunked i-loop step)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def _minplus_pass(cost: jax.Array, axis: int) -> tuple[jax.Array, jax.Array]:
    """One exact 1-D squared-distance pass along `axis`.

    cost: int32 running squared cost. Returns (new_cost, argmin_j) where
    new_cost[..., i, ...] = min_j ((i-j)^2 + cost[..., j, ...]) and argmin_j
    is the minimizing source index along `axis` (first minimum on ties).
    """
    c = jnp.moveaxis(cost, axis, 0)  # (n, rest...)
    n = c.shape[0]
    j = jnp.arange(n, dtype=jnp.int32)
    ci = _chunk(n)
    i_chunks = jnp.arange(n, dtype=jnp.int32).reshape(n // ci, ci)

    rest_nd = c.ndim - 1

    def one_chunk(i_vec):  # (ci,) output positions
        # (ci, n) squared offsets, broadcast against (n, rest...)
        d2 = (i_vec[:, None] - j[None, :]) ** 2
        d2 = d2.reshape((ci, n) + (1,) * rest_nd)
        tot = d2 + c[None]  # (ci, n, rest...)
        return jnp.min(tot, axis=1), jnp.argmin(tot, axis=1).astype(jnp.int32)

    best, arg = jax.lax.map(one_chunk, i_chunks)  # (n//ci, ci, rest...)
    best = best.reshape(c.shape)
    arg = arg.reshape(c.shape)
    return jnp.moveaxis(best, 0, axis), jnp.moveaxis(arg, 0, axis)


def edt_feature_transform(mask: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Nearest-foreground-voxel transform of a 3-D mask (jittable, exact).

    mask: (X, Y, Z), nonzero = foreground/feature voxels.
    Returns (idx, dist2): idx is (3, X, Y, Z) int32 coordinates of the
    nearest foreground voxel for every voxel (matching the roles of scipy's
    `distance_transform_edt(mask == 0, return_indices=True)` indices), and
    dist2 the exact int32 squared Euclidean distance. If the mask is empty
    all distances are >= _INF and indices are meaningless.
    """
    m = mask != 0
    X, Y, Z = m.shape
    cost = jnp.where(m, jnp.int32(0), _INF)

    cost, fx = _minplus_pass(cost, 0)  # fx: nearest x' within each x-line
    cost, fy = _minplus_pass(cost, 1)
    # nearest point after the y pass is (fx[x, y', z], y', z) with y' = fy
    fx = jnp.take_along_axis(fx, fy, axis=1)
    cost, fz = _minplus_pass(cost, 2)
    fx = jnp.take_along_axis(fx, fz, axis=2)
    fy = jnp.take_along_axis(fy, fz, axis=2)

    idx = jnp.stack([fx, fy, fz])
    return idx, cost


def edt_infill(img: jax.Array, mask: jax.Array) -> jax.Array:
    """Replace out-of-mask voxels with their nearest in-mask intensity.

    img, mask: (X, Y, Z). In-mask voxels keep their original value.
    """
    idx, _ = edt_feature_transform(mask)
    filled = img[idx[0], idx[1], idx[2]]
    return jnp.where(mask != 0, img, filled)
