"""MIND-SSC self-similarity descriptor (12 channels), on device.

Semantics match the reference `MINDSSC` (`/root/reference/anatomix/
registration/convex_adam_utils.py:311-406`), itself after Heinrich et al.
MICCAI 2013. The reference realizes the 12 neighbour-pair shifts as one-hot
3³ conv kernels; since a one-hot kernel is just a shift, here the shifted
volumes are produced by slicing a replicate-padded volume directly — no
conv, no kernel materialization, fuses into the elementwise pipeline.

Layout: volumes are channel-last (1, H, W, D, C); the descriptor keeps the
reference's channel permutation (matching the original C++ ordering).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.ops.pool import avg_pool3d

# The fixed 6-neighbourhood and the 12 (shift1, shift2) pairs, precomputed
# exactly as the reference does (pdist² == 2 and upper-triangle mask).
_SIX = np.array(
    [[0, 1, 1], [1, 1, 0], [1, 0, 1], [1, 1, 2], [2, 1, 1], [1, 2, 1]],
    dtype=np.int64,
)


def _shift_pairs():
    diff = _SIX[:, None, :] - _SIX[None, :, :]
    dist = (diff ** 2).sum(-1)
    x, y = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    mask = (x > y) & (dist == 2)
    idx1 = np.repeat(_SIX[:, None, :], 6, axis=1).reshape(-1, 3)[
        mask.reshape(-1)
    ]
    idx2 = np.repeat(_SIX[None, :, :], 6, axis=0).reshape(-1, 3)[
        mask.reshape(-1)
    ]
    return idx1, idx2


_IDX1, _IDX2 = _shift_pairs()
# channel permutation matching the original C++ ordering
# (convex_adam_utils.py:398-404)
_PERM = np.array([6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3])


def _shifted(img_pad: jax.Array, offset, dilation: int, spatial):
    """Slice a (1, H+2d, W+2d, D+2d, 1) replicate-padded volume at a 3³-grid
    offset scaled by `dilation` -> (1, H, W, D, 1)."""
    H, W, D = spatial
    oz, oy, ox = (int(o) * dilation for o in offset)
    return jax.lax.slice(
        img_pad,
        (0, oz, oy, ox, 0),
        (1, oz + H, oy + W, ox + D, 1),
    )


import functools


@functools.partial(jax.jit, static_argnums=(1, 2))
def mindssc(
    img: jax.Array, radius: int = 2, dilation: int = 2
) -> jax.Array:
    """12-channel MIND-SSC of a (1, H, W, D, 1) volume -> (1, H, W, D, 12).

    The anatomix pipeline always calls it with (radius=1, dilation=2)
    (`instance_optimization.py:99-113`).
    """
    if img.ndim != 5 or img.shape[-1] != 1:
        raise ValueError("img must be (1, H, W, D, 1)")
    spatial = img.shape[1:4]
    kernel_size = radius * 2 + 1

    d = dilation
    img_pad = jnp.pad(
        img.astype(jnp.float32),
        ((0, 0), (d, d), (d, d), (d, d), (0, 0)),
        mode="edge",  # torch ReplicationPad3d
    )

    diffs = []
    for i1, i2 in zip(_IDX1, _IDX2):
        a = _shifted(img_pad, i1, d, spatial)
        b = _shifted(img_pad, i2, d, spatial)
        diffs.append(a - b)
    diff2 = jnp.concatenate(diffs, axis=-1) ** 2  # (1, H, W, D, 12)

    # patch-SSD: replicate-pad by radius then plain box mean
    diff2_pad = jnp.pad(
        diff2,
        ((0, 0), (radius,) * 2, (radius,) * 2, (radius,) * 2, (0, 0)),
        mode="edge",
    )
    ssd = avg_pool3d(diff2_pad, kernel_size, stride=1, padding=0)

    mind = ssd - jnp.min(ssd, axis=-1, keepdims=True)
    mind_var = jnp.mean(mind, axis=-1, keepdims=True)
    scalar_mean = jnp.mean(mind_var)
    mind_var = jnp.clip(
        mind_var, scalar_mean * 0.001, scalar_mean * 1000.0
    )
    mind = jnp.exp(-mind / mind_var)

    return mind[..., jnp.asarray(_PERM)]


def pdist_squared(x: np.ndarray) -> np.ndarray:
    """Pairwise squared distances between column points (3, N) — numpy util
    mirroring `pdist_squared` (`convex_adam_utils.py:285-304`)."""
    xx = (x ** 2).sum(0)
    dist = xx[:, None] + xx[None, :] - 2.0 * (x.T @ x)
    dist = np.nan_to_num(dist, nan=0.0)
    return np.clip(dist, 0.0, None)
