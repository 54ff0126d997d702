"""Op-level parity tests vs torch oracles (the 'unforgiving ≤1e-3' ladder).

Each op the reference relies on — same-pad reflect conv, instance/batch
norm, pooling, nearest/trilinear upsampling, avg_pool3d box filters,
grid_sample — is checked against torch on small random volumes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import requires_torch

TOL = 1e-5


def to_t(x):
    """NDHWC numpy -> torch NCDHW tensor."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def from_t(t):
    """torch NCDHW -> NDHWC numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


@requires_torch
@pytest.mark.parametrize("pad_type", ["zeros", "reflect", "replicate"])
def test_conv3d_same(rng, pad_type):
    import torch

    from anatomix_tpu.ops.conv import conv3d, torch_conv_weight_to_jax

    x = rng.standard_normal((2, 8, 9, 10, 3), dtype=np.float32)
    conv = torch.nn.Conv3d(
        3, 5, 3, padding="same",
        padding_mode=pad_type if pad_type != "zeros" else "zeros",
    )
    with torch.no_grad():
        ref = from_t(conv(to_t(x)))
    w = torch_conv_weight_to_jax(conv.weight.detach().numpy())
    b = conv.bias.detach().numpy()
    got = np.asarray(
        conv3d(x, w, b, padding="SAME", pad_type=pad_type)
    )
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
def test_instance_norm(rng):
    import torch

    from anatomix_tpu.ops.norms import instance_norm

    x = rng.standard_normal((2, 6, 7, 8, 4), dtype=np.float32)
    norm = torch.nn.InstanceNorm3d(4, eps=1e-2, track_running_stats=False)
    ref = from_t(norm(to_t(x)))
    got = np.asarray(instance_norm(x, eps=1e-2))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
def test_batch_norm_eval(rng):
    import torch

    from anatomix_tpu.ops.norms import batch_norm_inference

    x = rng.standard_normal((2, 6, 7, 8, 4), dtype=np.float32)
    norm = torch.nn.BatchNorm3d(4, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(
            rng.standard_normal(4, dtype=np.float32)))
        norm.bias.copy_(torch.from_numpy(
            rng.standard_normal(4, dtype=np.float32)))
        norm.running_mean.copy_(torch.from_numpy(
            rng.standard_normal(4, dtype=np.float32)))
        norm.running_var.copy_(torch.from_numpy(
            rng.random(4, dtype=np.float32) + 0.5))
    norm.eval()
    with torch.no_grad():
        ref = from_t(norm(to_t(x)))
    got = np.asarray(
        batch_norm_inference(
            x,
            norm.running_mean.numpy(),
            norm.running_var.numpy(),
            norm.weight.detach().numpy(),
            norm.bias.detach().numpy(),
            eps=1e-5,
        )
    )
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
def test_batch_norm_train_stats(rng):
    import torch

    from anatomix_tpu.ops.norms import batch_norm_train

    x = rng.standard_normal((2, 4, 5, 6, 3), dtype=np.float32)
    norm = torch.nn.BatchNorm3d(3, eps=1e-5, momentum=0.1)
    norm.train()
    ref = from_t(norm(to_t(x)))
    got, new_mean, new_var = batch_norm_train(
        x,
        np.zeros(3, np.float32),
        np.ones(3, np.float32),
        norm.weight.detach().numpy(),
        norm.bias.detach().numpy(),
        eps=1e-5,
    )
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(new_mean), norm.running_mean.numpy(), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(new_var), norm.running_var.numpy(), atol=1e-4, rtol=1e-4
    )


@requires_torch
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2(rng, kind):
    import torch.nn.functional as F

    from anatomix_tpu.ops.pool import avg_pool, max_pool

    x = rng.standard_normal((2, 8, 10, 12, 3), dtype=np.float32)
    if kind == "max":
        ref = from_t(F.max_pool3d(to_t(x), 2))
        got = np.asarray(max_pool(x, 2))
    else:
        ref = from_t(F.avg_pool3d(to_t(x), 2))
        got = np.asarray(avg_pool(x, 2))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
def test_max_pool2x_grad_matches_torch_with_ties(rng):
    """max_pool's backward (XLA select-and-scatter) and the argmax VJP
    `_max_pool2x` must use torch's tie rule (gradient
    to the FIRST max in (kd, kh, kw) window order). ReLU'd inputs make
    exact-zero ties common, so this pins the routing bit-exactly, not
    just on distinct values."""
    import jax
    import torch
    import torch.nn.functional as F

    from anatomix_tpu.ops.pool import max_pool

    x = np.maximum(
        rng.standard_normal((2, 8, 8, 8, 4)), 0
    ).astype(np.float32)
    dy = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)

    gx = np.asarray(
        jax.grad(
            lambda v: jnp.sum(max_pool(v) * jnp.asarray(dy))
        )(jnp.asarray(x))
    )
    xt = torch.tensor(np.transpose(x, (0, 4, 1, 2, 3)), requires_grad=True)
    F.max_pool3d(xt, 2).backward(
        torch.tensor(np.transpose(dy, (0, 4, 1, 2, 3)))
    )
    gt = np.transpose(xt.grad.numpy(), (0, 2, 3, 4, 1))
    assert np.abs(gx - gt).max() == 0.0

    # the retired argmax VJP stays torch-pinned too: the HW tier compares
    # select-and-scatter against it to transfer tie parity to hardware
    from anatomix_tpu.ops.pool import _max_pool2x

    gc = np.asarray(
        jax.grad(
            lambda v: jnp.sum(_max_pool2x(v) * jnp.asarray(dy))
        )(jnp.asarray(x))
    )
    assert np.abs(gc - gt).max() == 0.0


def test_batch_norm_train_bf16_apply_matches_f32(rng):
    """Sub-f32 batch_norm_train folds (mean, invstd, scale, bias) into one
    per-channel affine applied in the input dtype; the result must stay
    within bf16 rounding of the f32 apply and the running stats must be
    dtype-independent (always f32)."""
    from anatomix_tpu.ops.norms import batch_norm_train

    x = jnp.asarray(rng.standard_normal((2, 8, 8, 8, 6), dtype=np.float32))
    sc = jnp.asarray(rng.standard_normal(6).astype(np.float32))
    bi = jnp.asarray(rng.standard_normal(6).astype(np.float32))
    rm, rv = jnp.zeros(6), jnp.ones(6)
    y32, m32, v32 = batch_norm_train(x, rm, rv, sc, bi, eps=1e-5)
    y16, m16, v16 = batch_norm_train(
        x.astype(jnp.bfloat16), rm, rv, sc, bi, eps=1e-5
    )
    rel = float(
        jnp.max(jnp.abs(y16.astype(jnp.float32) - y32))
        / jnp.max(jnp.abs(y32))
    )
    assert rel < 0.03
    np.testing.assert_allclose(np.asarray(m16), np.asarray(m32), atol=1e-2)
    np.testing.assert_allclose(
        np.asarray(v16), np.asarray(v32), atol=1e-2, rtol=1e-2
    )


def test_batch_norm_train_bf16_large_dc_offset(rng):
    """Large per-channel DC offsets (|mean| >> std — e.g. post-ReLU
    activations) are where a naive folded x*a + b bf16 apply loses
    |mean*a|*2^-8 to cancellation (ADVICE r3). The subtract-first form
    must keep the error at deviation scale: within a few bf16 ulps of
    the f32 apply on N(50, 1) inputs."""
    from anatomix_tpu.ops.norms import batch_norm_train

    x = jnp.asarray(
        50.0 + rng.standard_normal((2, 8, 8, 8, 6)).astype(np.float32)
    )
    sc = jnp.asarray(1.0 + 0.1 * rng.standard_normal(6).astype(np.float32))
    bi = jnp.asarray(rng.standard_normal(6).astype(np.float32))
    rm, rv = jnp.zeros(6), jnp.ones(6)
    xb = x.astype(jnp.bfloat16)
    # floor: the f32 apply on the bf16-quantized input — the error the
    # input dtype alone imposes (~|x|*2^-9 deviations ≈ 0.17 here)
    y_floor, _, _ = batch_norm_train(
        xb.astype(jnp.float32), rm, rv, sc, bi, eps=1e-5
    )
    y16, _, _ = batch_norm_train(xb, rm, rv, sc, bi, eps=1e-5)
    apply_err = float(
        jnp.max(jnp.abs(y16.astype(jnp.float32) - y_floor))
    )
    # the bf16 apply itself must only add deviation-scale rounding (a few
    # bf16 ulps of the ~unit output), NOT the |mean*a|*2^-8 ≈ 0.2
    # DC-cancellation term of the naive x*a + b form
    assert apply_err < 0.05, apply_err


def test_channel_layer_norm_bf16_large_dc_offset(rng):
    """Same regime for the ViT ChannelLayerNorm bf16 apply: the
    per-voxel mean's bf16 quantization is corrected in f32, so a big DC
    offset must not leave a systematic shift."""
    from anatomix_tpu.ops.norms import channel_layer_norm

    x = jnp.asarray(
        50.0 + rng.standard_normal((2, 4, 4, 4, 32)).astype(np.float32)
    )
    xb = x.astype(jnp.bfloat16)
    y_floor = channel_layer_norm(xb.astype(jnp.float32))
    y16 = channel_layer_norm(xb)
    apply_err = float(
        jnp.max(jnp.abs(y16.astype(jnp.float32) - y_floor))
    )
    assert apply_err < 0.05, apply_err


@requires_torch
@pytest.mark.parametrize("k,pad,stride", [(3, 1, 1), (5, 2, 1), (2, 0, 2)])
def test_avg_pool3d_padded(rng, k, pad, stride):
    import torch.nn.functional as F

    from anatomix_tpu.ops.pool import avg_pool3d

    x = rng.standard_normal((1, 7, 8, 9, 3), dtype=np.float32)
    ref = from_t(F.avg_pool3d(to_t(x), k, padding=pad, stride=stride))
    got = np.asarray(avg_pool3d(x, k, padding=pad, stride=stride))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
@pytest.mark.parametrize("mode", ["nearest", "trilinear"])
def test_upsample2x(rng, mode):
    import torch.nn.functional as F

    from anatomix_tpu.ops.resize import upsample2x

    x = rng.standard_normal((1, 5, 6, 7, 3), dtype=np.float32)
    ref = from_t(F.interpolate(to_t(x), scale_factor=2, mode=mode))
    got = np.asarray(upsample2x(x, mode))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize3d_arbitrary(rng, align_corners):
    import torch.nn.functional as F

    from anatomix_tpu.ops.resize import resize3d

    x = rng.standard_normal((1, 5, 6, 7, 2), dtype=np.float32)
    ref = from_t(
        F.interpolate(
            to_t(x), size=(9, 4, 11), mode="trilinear",
            align_corners=align_corners,
        )
    )
    got = np.asarray(
        resize3d(x, (9, 4, 11), mode="trilinear",
                 align_corners=align_corners)
    )
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=1e-4)


@requires_torch
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(rng, align_corners, mode):
    import torch.nn.functional as F

    from anatomix_tpu.ops.grid_sample import grid_sample

    x = rng.standard_normal((2, 6, 7, 8, 3), dtype=np.float32)
    # include out-of-bounds coordinates to exercise zeros padding
    grid = (rng.random((2, 4, 5, 6, 3), dtype=np.float32) * 2.6) - 1.3
    import torch

    ref = from_t(
        F.grid_sample(
            to_t(x),
            torch.from_numpy(grid),
            mode=mode,
            align_corners=align_corners,
        )
    )
    got = np.asarray(
        grid_sample(x, grid, mode=mode, align_corners=align_corners)
    )
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-3)


@requires_torch
@pytest.mark.parametrize("align_corners", [False, True])
def test_identity_grid(align_corners):
    import torch
    import torch.nn.functional as F

    from anatomix_tpu.ops.grid_sample import identity_grid

    ref = F.affine_grid(
        torch.eye(3, 4).unsqueeze(0), (1, 1, 5, 6, 7),
        align_corners=align_corners,
    ).numpy()
    got = np.asarray(identity_grid((5, 6, 7), align_corners=align_corners))
    np.testing.assert_allclose(got, ref, atol=1e-6)


@requires_torch
def test_packed_sampler_matches_grid_sample(rng):
    from anatomix_tpu.ops.grid_sample import grid_sample, make_packed_sampler

    vol = rng.standard_normal((1, 6, 7, 8, 5)).astype(np.float32)
    grid = (rng.random((1, 4, 5, 6, 3), dtype=np.float32) * 2.6) - 1.3
    ref = np.asarray(grid_sample(vol, grid, mode="bilinear"))
    got = np.asarray(make_packed_sampler(vol)(grid))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)


def test_even_chunk_sizes_block_invariant():
    """e(2s, n) == 2*e(s, n) whenever s >= n — the contract that keeps
    full-resolution and block-space (halved-dims) tiled-instance-norm
    boundaries identical at every depth; undersized splits raise."""
    import pytest

    from anatomix_tpu.ops.norms import _even_chunk_sizes as e

    for n in (1, 2, 3, 4):
        for s in range(n, 200):
            full = e(2 * s, n)
            assert full == [2 * c for c in e(s, n)], (s, n)
            assert sum(full) == 2 * s and all(c > 0 for c in full)
    with pytest.raises(ValueError):
        e(3, 4)


def test_batch_norm_train_custom_vjp_matches_autodiff():
    """The hand analytic BN adjoint (_bn_train_norm) == XLA autodiff of
    the same forward, including cotangents on the returned batch mean and
    variance (f32; the train path uses this VJP)."""
    from anatomix_tpu.ops.norms import _bn_train_impl, _bn_train_norm

    rng = np.random.default_rng(0)
    C = 6
    x = jnp.asarray(rng.standard_normal((2, 5, 4, 3, C)).astype(np.float32))
    scale = jnp.asarray(rng.standard_normal(C).astype(np.float32))
    bias = jnp.asarray(rng.standard_normal(C).astype(np.float32))
    cots = (
        jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)),
        jnp.asarray(rng.standard_normal(C).astype(np.float32)),
        jnp.asarray(rng.standard_normal(C).astype(np.float32)),
    )

    def run(norm):
        out, vjp = jax.vjp(norm, x, scale, bias)
        return out, vjp(cots)

    out_ref, grads_ref = jax.jit(lambda: run(
        lambda x, s, b: _bn_train_impl(x, s, b, 1e-5, None)[:3]))()
    out_got, grads_got = jax.jit(lambda: run(
        lambda x, s, b: _bn_train_norm(x, s, b, 1e-5, None)))()

    for a, b in zip(out_got, out_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)
    for name, a, b in zip("x scale bias".split(), grads_got, grads_ref):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(b).max()),
            err_msg=f"d{name}",
        )


def test_batch_norm_train_custom_vjp_bf16_close_to_f32():
    """bf16 inputs: the custom adjoint's dx tracks the f32 analytic
    gradient (the autodiff of the bf16 folded apply only adds rounding
    noise on top — see the subtract-first fold notes)."""
    from anatomix_tpu.ops.norms import batch_norm_train

    rng = np.random.default_rng(1)
    C = 8
    x32 = jnp.asarray(
        rng.standard_normal((2, 8, 8, 8, C)).astype(np.float32)
    )
    t = jnp.asarray(rng.standard_normal((2, 8, 8, 8, C)).astype(np.float32))
    rm, rv = jnp.zeros((C,)), jnp.ones((C,))
    scale = jnp.asarray(rng.standard_normal(C).astype(np.float32))
    bias = jnp.asarray(rng.standard_normal(C).astype(np.float32))

    def loss(x):
        y, _, _ = batch_norm_train(x, rm, rv, scale, bias)
        return jnp.sum((y.astype(jnp.float32) - t) ** 2)

    g32 = np.asarray(jax.jit(jax.grad(loss))(x32))
    gbf = np.asarray(
        jax.jit(jax.grad(loss))(x32.astype(jnp.bfloat16)), np.float32
    )
    denom = np.abs(g32).max() + 1e-8
    assert np.abs(gbf - g32).max() / denom < 5e-2
