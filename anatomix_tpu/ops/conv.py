"""3D convolution with torch-compatible 'same' padding semantics, NDHWC.

Design notes
------------
* Data layout is channel-last (NDHWC) and kernels are DHWIO; on the GPU
  XLA hands these convolutions to cuDNN.
* Reflect/replicate padding is applied explicitly with `jnp.pad` followed by
  a VALID convolution; zero padding uses the convolution's own `SAME` padding
  so XLA can fuse it.
* Convolutions optionally run in bfloat16 (`compute_dtype`) with results cast
  back; accumulation stays fp32 via `preferred_element_type`.

Reference semantics being matched: `nn.Conv3d(..., padding='same',
padding_mode=pad_type)` as used by the reference UNet
(`/root/reference/anatomix/model/network.py:309-465`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# torch padding_mode -> jnp.pad mode
_PAD_MODES = {
    "reflect": "reflect",      # mirror, edge not repeated (torch 'reflect')
    "replicate": "edge",       # torch 'replicate'
    "zeros": "constant",
    "circular": "wrap",
}


def pad_same(x: jax.Array, kernel_size, pad_type: str = "zeros") -> jax.Array:
    """Pad spatial dims of an NDHWC array for a stride-1 'same' conv.

    Matches torch's `padding='same'` for odd kernels: `k // 2` on both sides.
    """
    if isinstance(kernel_size, int):
        kernel_size = (kernel_size,) * 3
    mode = _PAD_MODES[pad_type]
    pads = [(0, 0)] + [(k // 2, (k - 1) // 2) for k in kernel_size] + [(0, 0)]
    if all(p == (0, 0) for p in pads):
        return x
    return jnp.pad(x, pads, mode=mode)


_DIMNUMS = ("NDHWC", "DHWIO", "NDHWC")


def conv3d(
    x: jax.Array,
    w: jax.Array,
    b: jax.Array | None = None,
    *,
    stride=1,
    padding="VALID",
    pad_type: str = "zeros",
    dilation=1,
    compute_dtype=None,
    precision=None,
) -> jax.Array:
    """3D convolution on NDHWC input with DHWIO kernel.

    `padding` may be 'SAME' (torch padding='same' semantics for stride 1),
    'VALID', or explicit [(lo, hi)] * 3. Non-zero `pad_type` forces explicit
    padding + VALID conv.

    `precision`: fp32 inputs default to Precision.HIGHEST so the GPU does
    true fp32 convs (a TF32 conv breaks the ≤1e-3 parity target); pass
    `compute_dtype=jnp.bfloat16` for the fast path instead.
    """
    if isinstance(stride, int):
        stride = (stride,) * 3
    if isinstance(dilation, int):
        dilation = (dilation,) * 3

    if padding == "SAME" and pad_type != "zeros":
        # Explicit reflect/replicate padding, then VALID conv.
        ks = tuple(
            (kd - 1) * d + 1
            for kd, d in zip(w.shape[:3], dilation)
        )
        x = pad_same(x, ks, pad_type)
        padding = "VALID"

    out_dtype = x.dtype
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)

    if precision is None and x.dtype == jnp.float32:
        precision = jax.lax.Precision.HIGHEST

    # f32 accumulation is requested only for f32 inputs: with bf16 inputs a
    # f32 preferred_element_type breaks the conv transpose rule (the f32
    # cotangent mismatches the bf16 operand under jax.grad); cuDNN still
    # accumulates bf16 convs in f32 internally before the output rounding.
    y = jax.lax.conv_general_dilated(
        x,
        w,
        window_strides=stride,
        padding=padding,
        rhs_dilation=dilation,
        dimension_numbers=_DIMNUMS,
        precision=precision,
        preferred_element_type=(
            jnp.float32 if x.dtype == jnp.float32 else None
        ),
    )
    y = y.astype(out_dtype)
    if b is not None:
        y = y + b.astype(y.dtype)
    return y


def torch_conv_weight_to_jax(w: np.ndarray) -> np.ndarray:
    """torch ConvNd weight (O, I, k...) -> degenerate-3D DHWIO.

    1D/2D kernels embed as 3D with leading singleton kernel axes:
    Conv1d (O, I, k) -> (1, 1, k, I, O); Conv2d (O, I, kh, kw) ->
    (1, kh, kw, I, O) — the layout under which 1D/2D models run through
    the same NDHWC conv path (`models/unet.py`)."""
    ndims = w.ndim - 2
    assert 1 <= ndims <= 3, f"conv weight rank {w.ndim} unsupported"
    axes = tuple(range(2, 2 + ndims)) + (1, 0)
    wj = np.ascontiguousarray(np.transpose(w, axes))
    return wj.reshape((1,) * (3 - ndims) + wj.shape)


def jax_conv_weight_to_torch(w: np.ndarray, dimension: int = 3) -> np.ndarray:
    """Degenerate-3D DHWIO (kD, kH, kW, I, O) -> torch ConvNd weight
    (O, I, k...), dropping the leading singleton kernel axes for
    `dimension` < 3."""
    t = np.ascontiguousarray(np.transpose(w, (4, 3, 0, 1, 2)))
    for _ in range(3 - dimension):
        assert t.shape[2] == 1, (
            f"kernel axis not singleton for dimension={dimension}: {t.shape}"
        )
        t = t[:, :, 0]
    return np.ascontiguousarray(t)
