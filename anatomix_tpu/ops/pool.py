"""Pooling ops (NDHWC) matching torch semantics.

* `max_pool` / `avg_pool`: the UNet's `Pool(2)` downsampling
  (`/root/reference/anatomix/model/network.py:297,368`).
* `avg_pool3d`: the registration stack's general
  `F.avg_pool3d(kernel, padding, stride)` with torch's default
  `count_include_pad=True` (zeros contribute to the average) — used as a box
  filter everywhere in ConvexAdam (`/root/reference/anatomix/registration/
  convex_adam_utils.py:105-131,380-384,520-527`).
* `box_filter`: repeated stride-1 box smoothing (`apply_avg_pool3d`,
  `convex_adam_utils.py:105-131`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _as3(v):
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _reduce_max(x, w, s):
    return jax.lax.reduce_window(
        x,
        -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating) else jnp.iinfo(
            x.dtype
        ).min,
        jax.lax.max,
        window_dimensions=(1, *w, 1),
        window_strides=(1, *s, 1),
        padding="VALID",
    )


@jax.custom_vjp
def _max_pool2x(x):
    """2x2x2 stride-2 MaxPool with an argmax-routed backward.

    Not on the default path: `max_pool` uses XLA's reduce_window and its
    select-and-scatter backward. Kept as the tie-routing reference its
    test pins."""
    return _reduce_max(x, (2, 2, 2), (2, 2, 2))


def _mp2x_fwd(x):
    return _max_pool2x(x), x


def _mp2x_bwd(x, dy):
    B, D, H, W, C = x.shape
    v = x.reshape(B, D // 2, 2, H // 2, 2, W // 2, 2, C)
    v = jnp.transpose(v, (0, 1, 3, 5, 2, 4, 6, 7)).reshape(
        B, D // 2, H // 2, W // 2, 8, C
    )
    # slot order (ad, ah, aw) == torch's (kd, kh, kw) window flatten, and
    # jnp.argmax picks the first max — matching torch's and XLA's
    # select-and-scatter tie routing
    idx = jnp.argmax(v, axis=4)
    oh = jax.nn.one_hot(idx, 8, axis=4, dtype=dy.dtype)
    g = oh * dy[:, :, :, :, None, :]
    g = g.reshape(B, D // 2, H // 2, W // 2, 2, 2, 2, C)
    g = jnp.transpose(g, (0, 1, 4, 2, 5, 3, 6, 7)).reshape(B, D, H, W, C)
    return (g,)


_max_pool2x.defvjp(_mp2x_fwd, _mp2x_bwd)


def max_pool(x: jax.Array, window: int = 2, stride: int | None = None):
    """MaxPool over spatial dims of NDHWC (torch ceil_mode=False).

    Backward is XLA's select-and-scatter (first-max tie routing, matching
    torch)."""
    w = _as3(window)
    s = _as3(stride if stride is not None else window)
    return _reduce_max(x, w, s)


def avg_pool(x: jax.Array, window: int = 2, stride: int | None = None):
    """AvgPool over spatial dims of NDHWC, no padding."""
    w = _as3(window)
    s = _as3(stride if stride is not None else window)
    summed = jax.lax.reduce_window(
        x.astype(jnp.float32),
        0.0,
        jax.lax.add,
        window_dimensions=(1, *w, 1),
        window_strides=(1, *s, 1),
        padding="VALID",
    )
    return (summed / (w[0] * w[1] * w[2])).astype(x.dtype)


def avg_pool3d(
    x: jax.Array,
    kernel_size,
    *,
    stride=1,
    padding=0,
) -> jax.Array:
    """torch `F.avg_pool3d(count_include_pad=True)` on NDHWC input.

    Zero-pads by `padding` on each side, then computes windowed means
    dividing by the full kernel volume (padded zeros included), exactly like
    torch's default.
    """
    k = _as3(kernel_size)
    s = _as3(stride)
    p = _as3(padding)
    pads = ((0, 0), (p[0], p[0]), (p[1], p[1]), (p[2], p[2]), (0, 0))
    summed = jax.lax.reduce_window(
        x.astype(jnp.float32),
        0.0,
        jax.lax.add,
        window_dimensions=(1, *k, 1),
        window_strides=(1, *s, 1),
        padding=pads,
    )
    return (summed / (k[0] * k[1] * k[2])).astype(x.dtype)


def box_filter(x: jax.Array, kernel_size: int, num_repeats: int) -> jax.Array:
    """Repeated stride-1 zero-padded box smoothing (`apply_avg_pool3d`,
    `/root/reference/anatomix/registration/convex_adam_utils.py:105-131`)."""
    pad = kernel_size // 2
    for _ in range(num_repeats):
        x = avg_pool3d(x, kernel_size, stride=1, padding=pad)
    return x
