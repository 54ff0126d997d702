"""Sliding-window inference tests: window layout, stitching correctness,
single-window identity, and multi-device sharding equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.ops.sliding_window import (
    blend_weight_map,
    compute_window_starts,
    gaussian_importance_map,
    sliding_window_inference,
)


def test_window_starts_monai_semantics():
    # 256 image, 128 roi, overlap 0.8 -> interval 25, 7 positions per axis
    starts = compute_window_starts((256, 256, 256), (128, 128, 128), 0.8)
    per_axis = np.unique(starts[:, 0])
    assert per_axis[0] == 0 and per_axis[-1] == 128
    assert len(per_axis) == 7
    assert len(starts) == 7 ** 3
    # image == roi -> one window
    starts = compute_window_starts((128, 128, 128), (128, 128, 128), 0.8)
    assert len(starts) == 1 and (starts == 0).all()


def test_gaussian_importance_properties():
    imp = gaussian_importance_map((128, 128, 128), 0.25)
    assert imp.shape == (128, 128, 128)
    assert imp.max() == pytest.approx(1.0)
    assert imp[64, 64, 64] == pytest.approx(1.0)
    assert imp.min() >= 1e-3  # clamped
    # symmetry around the center voxel
    np.testing.assert_allclose(imp[63, 64, 64], imp[65, 64, 64], rtol=1e-6)


def _naive_stitch(vol, apply_fn, out_ch, roi, overlap, imp):
    """Straightforward numpy loop oracle over the same window layout."""
    D, H, W, C = vol.shape[1:]
    starts = compute_window_starts((D, H, W), roi, overlap)
    acc = np.zeros((D, H, W, out_ch), np.float64)
    wgt = blend_weight_map((D, H, W), starts, imp).astype(np.float64)
    for s in starts:
        win = vol[:, s[0]:s[0]+roi[0], s[1]:s[1]+roi[1], s[2]:s[2]+roi[2], :]
        out = np.asarray(apply_fn(jnp.asarray(win)))[0]
        acc[s[0]:s[0]+roi[0], s[1]:s[1]+roi[1], s[2]:s[2]+roi[2]] += (
            out * imp[..., None]
        )
    return (acc / wgt[..., None])[None]


def _toy_model(x):
    """Cheap stand-in for the UNet: channel mix + nonlinearity."""
    w = jnp.asarray(
        np.linspace(-1, 1, x.shape[-1] * 3, dtype=np.float32).reshape(
            x.shape[-1], 3
        )
    )
    return jnp.tanh(x @ w)


def _toy_model4(x):
    """4-channel variant: 128 % 4 == 0, so the folded-canvas stitch
    (fold > 1 with unaligned shifts) is exercised exactly."""
    w = jnp.asarray(
        np.linspace(-1, 1, x.shape[-1] * 4, dtype=np.float32).reshape(
            x.shape[-1], 4
        )
    )
    return jnp.tanh(x @ w)


def test_stitching_matches_naive_oracle_folded(rng):
    """out_channels=4 -> fold = gcd(32, W, roi) > 1: the shifted-canvas
    aligned RMW path must match the naive oracle at unaligned starts."""
    vol = rng.standard_normal((1, 40, 36, 32, 2), dtype=np.float32)
    roi = (16, 16, 16)
    imp = gaussian_importance_map(roi, 0.25)
    ref = _naive_stitch(vol, _toy_model4, 4, roi, 0.5, imp)
    got = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol), _toy_model4, 4, roi_size=roi,
            sw_batch_size=3, overlap=0.5, mode="gaussian",
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_stitching_matches_naive_oracle(rng):
    vol = rng.standard_normal((1, 40, 36, 33, 2), dtype=np.float32)
    roi = (16, 16, 16)
    imp = gaussian_importance_map(roi, 0.25)
    ref = _naive_stitch(vol, _toy_model, 3, roi, 0.5, imp)
    got = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol),
            _toy_model,
            3,
            roi_size=roi,
            sw_batch_size=3,
            overlap=0.5,
            mode="gaussian",
        )
    )
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_single_window_is_identity():
    """volume == roi: stitched result equals a direct model call (the
    CPU-runnable ≤1e-3 parity configuration)."""
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((1, 16, 16, 16, 2), dtype=np.float32)
    direct = np.asarray(_toy_model(jnp.asarray(vol)))
    got = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol), _toy_model, 3, roi_size=(16, 16, 16),
            sw_batch_size=2,
        )
    )
    np.testing.assert_allclose(got, direct, atol=1e-6)


def test_small_volume_padded_and_cropped():
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((1, 10, 16, 12, 2), dtype=np.float32)
    got = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol), _toy_model, 3, roi_size=(16, 16, 16),
        )
    )
    assert got.shape == (1, 10, 16, 12, 3)


def test_jit_and_shape_stability():
    fn = jax.jit(
        lambda v: sliding_window_inference(
            v, _toy_model, 3, roi_size=(16, 16, 16), overlap=0.25,
            sw_batch_size=4,
        )
    )
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((1, 32, 32, 32, 2), dtype=np.float32)
    out1 = fn(jnp.asarray(vol))
    out2 = fn(jnp.asarray(vol * 2))
    assert out1.shape == out2.shape == (1, 32, 32, 32, 3)


def test_multidevice_sharded_matches_single():
    from jax.sharding import Mesh

    devices = np.array(jax.devices()[:8])
    assert len(devices) == 8, "conftest should provide 8 virtual cpu devices"
    mesh = Mesh(devices, ("data",))

    rng = np.random.default_rng(4)
    vol = rng.standard_normal((1, 32, 32, 32, 2), dtype=np.float32)
    single = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol), _toy_model, 3, roi_size=(16, 16, 16),
            overlap=0.5, sw_batch_size=2,
        )
    )
    sharded = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol), _toy_model, 3, roi_size=(16, 16, 16),
            overlap=0.5, sw_batch_size=2, mesh=mesh,
        )
    )
    np.testing.assert_allclose(sharded, single, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(32, 32, 32), (40, 28, 35)])
@pytest.mark.parametrize("mode", ["gaussian", "constant"])
@pytest.mark.parametrize("overlap", [0.25, 0.5, 0.8])
def test_stitching_oracle_grid(overlap, mode, shape):
    """The XLA scan stitch == the naive numpy loop over overlaps, blend
    modes and cubic / non-cubic volumes (3 output channels: unfolded
    canvas; 4: folded canvas, alternating with the shape)."""
    from anatomix_tpu.ops.sliding_window import constant_importance_map

    rng = np.random.default_rng(7)
    vol = rng.standard_normal((1,) + shape + (2,), dtype=np.float32)
    roi = (16, 16, 16)
    model, out_ch = (
        (_toy_model, 3) if shape[2] % 2 else (_toy_model4, 4)
    )
    imp = (
        gaussian_importance_map(roi, 0.25) if mode == "gaussian"
        else constant_importance_map(roi)
    )
    ref = _naive_stitch(vol, model, out_ch, roi, overlap, imp)
    got = np.asarray(
        sliding_window_inference(
            jnp.asarray(vol), model, out_ch, roi_size=roi,
            sw_batch_size=2, overlap=overlap, mode=mode,
        )
    )
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
