"""`ops/conv.py` against a numpy direct-sum 3D convolution."""

import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.ops.conv import _PAD_MODES, conv3d, pad_same


def _direct_conv(x, w, b, stride, pad_type):
    """NDHWC x DHWIO, torch 'same' padding by k//2 with `pad_type`, then a
    VALID strided direct sum in float64."""
    k = w.shape[0]
    p = k // 2
    xp = np.pad(x.astype(np.float64), ((0, 0), (p, p), (p, p), (p, p),
                                       (0, 0)), mode=_PAD_MODES[pad_type])
    n = [(s - k) // stride + 1 for s in xp.shape[1:4]]
    out = np.zeros((x.shape[0], *n, w.shape[-1]))
    for a in range(k):
        for bb in range(k):
            for c in range(k):
                patch = xp[:, a:a + stride * n[0]:stride,
                           bb:bb + stride * n[1]:stride,
                           c:c + stride * n[2]:stride, :]
                out += np.einsum("bdhwi,io->bdhwo", patch, w[a, bb, c])
    return out + b


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cin", [1, 3, 16])
@pytest.mark.parametrize("pad_type", ["zeros", "reflect", "replicate"])
def test_conv3d_matches_direct_sum(pad_type, cin, stride):
    rng = np.random.default_rng(cin * 10 + stride)
    x = rng.standard_normal((2, 9, 8, 10, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, 5)) * 0.2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = _direct_conv(x, w, b, stride, pad_type)
    if stride == 1:
        got = conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     padding="SAME", pad_type=pad_type)
    else:
        xp = pad_same(jnp.asarray(x), 3, pad_type)
        got = conv3d(xp, jnp.asarray(w), jnp.asarray(b), stride=2,
                     padding="VALID")
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)
