"""Primus 3D ViT tests: shapes, interface modes, parameter scale, RoPE."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.models.vit3d import (
    PRIMUS_CONFIGS,
    PrimusConfig,
    init_primus_params,
    primus_apply,
    primus_param_count,
)

TINY = PrimusConfig(
    input_channels=1, num_classes=4, embed_dim=48, eva_depth=2,
    eva_numheads=4, patch_embed_size=(8, 8, 8), input_shape=(16, 16, 16),
    num_register_tokens=2, init_values=0.1, scale_attn_inner=True,
    qk_norm=True, out_norm="demean", out_norm_eps=1e-2,
    register_init_std=0.02, in_eps=1e-2,
)


@pytest.fixture(scope="module")
def tiny():
    params = init_primus_params(TINY, jax.random.PRNGKey(0))
    return TINY, params


def test_forward_shape_and_norm(tiny):
    cfg, params = tiny
    x = jnp.asarray(
        np.random.default_rng(0)
        .standard_normal((2, 16, 16, 16, 1))
        .astype(np.float32)
    )
    out = primus_apply(cfg, params, x)
    assert out.shape == (2, 16, 16, 16, 4)
    # demean out-norm: per-channel spatial mean ~ 0
    means = np.asarray(jnp.mean(out, axis=(1, 2, 3)))
    np.testing.assert_allclose(means, 0.0, atol=1e-5)


def test_pretraining_interface_modes(tiny):
    cfg, params = tiny
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    out, feats = primus_apply(cfg, params, x, layers=[-1])
    assert len(feats) == 1
    np.testing.assert_array_equal(np.asarray(out), np.asarray(feats[0]))
    feats_only = primus_apply(cfg, params, x, layers=[-1], encode_only=True)
    assert len(feats_only) == 1


def test_input_shape_enforced(tiny):
    cfg, params = tiny
    with pytest.raises(ValueError, match="bound to input_shape"):
        primus_apply(cfg, params, jnp.zeros((1, 8, 8, 8, 1)))


def test_param_count_anatomix_dev_vit_scale():
    """The registry S-config (12×396×6h) should land near the published 26M."""
    from anatomix_tpu.models.registry import ANATOMIX_VARIANTS

    kw = ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"]
    cfg = PrimusConfig(
        input_channels=kw["input_channels"], num_classes=kw["num_classes"],
        embed_dim=kw["embed_dim"], eva_depth=kw["eva_depth"],
        eva_numheads=kw["eva_numheads"],
        patch_embed_size=tuple(kw["patch_embed_size"]),
        input_shape=tuple(kw["input_shape"]),
        num_register_tokens=kw["num_register_tokens"],
        qk_norm=kw["qk_norm"], scale_attn_inner=kw["scale_attn_inner"],
        out_norm=kw["out_norm"], version="v2",
    )
    params = init_primus_params(cfg, jax.random.PRNGKey(0))
    count = primus_param_count(params)
    assert 20e6 < count < 33e6, count
    assert PRIMUS_CONFIGS["S"]["embed_dim"] == 396


def test_rope_changes_with_position(tiny):
    """Permuting spatial content must not be equivalent to permuting the
    output (position information is injected)."""
    cfg, params = tiny
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((1, 16, 16, 16, 1), ).astype(
        np.float32))
    out1 = np.asarray(primus_apply(cfg, params, x))
    out2 = np.asarray(primus_apply(cfg, params, jnp.flip(x, axis=1)))
    assert not np.allclose(out1, np.flip(out2, axis=1), atol=1e-3)


def test_gradients_flow(tiny):
    cfg, params = tiny
    x = jnp.ones((1, 16, 16, 16, 1), jnp.float32)

    def loss(p):
        return jnp.mean(primus_apply(cfg, p, x) ** 2)

    grads = jax.grad(loss)(params)
    gnorm = np.sqrt(
        sum(float(jnp.sum(g ** 2)) for g in jax.tree_util.tree_leaves(grads))
    )
    assert np.isfinite(gnorm) and gnorm > 0


def _synthetic_upstream_state_dict(cfg, rng):
    """Fabricate a state dict in the documented upstream layout: timm-EVA
    attribute names under `eva.`, wrapper additions (q/k_norm per
    `architectures.py:108-115`), nnUNet-style numeric module indices inside
    down_projection/up_projection."""
    import torch

    sd = {}
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)
    )
    d = cfg.embed_dim
    hd = cfg.head_dim
    hidden = cfg.mlp_hidden
    sd["eva.pos_embed"] = t(1, cfg.num_tokens, d)
    sd["register_tokens"] = t(1, cfg.num_register_tokens, d)
    for i in range(cfg.eva_depth):
        b = f"eva.blocks.{i}"
        sd[f"{b}.norm1.weight"] = t(d)
        sd[f"{b}.norm1.bias"] = t(d)
        sd[f"{b}.attn.q_proj.weight"] = t(d, d)
        sd[f"{b}.attn.q_bias"] = t(d)
        sd[f"{b}.attn.k_proj.weight"] = t(d, d)
        sd[f"{b}.attn.v_proj.weight"] = t(d, d)
        sd[f"{b}.attn.v_bias"] = t(d)
        sd[f"{b}.attn.proj.weight"] = t(d, d)
        sd[f"{b}.attn.proj.bias"] = t(d)
        sd[f"{b}.attn.q_norm.weight"] = t(hd)
        sd[f"{b}.attn.q_norm.bias"] = t(hd)
        sd[f"{b}.attn.k_norm.weight"] = t(hd)
        sd[f"{b}.attn.k_norm.bias"] = t(hd)
        sd[f"{b}.attn.norm.weight"] = t(d)
        sd[f"{b}.attn.norm.bias"] = t(d)
        sd[f"{b}.gamma_1"] = t(d)
        sd[f"{b}.gamma_2"] = t(d)
        sd[f"{b}.norm2.weight"] = t(d)
        sd[f"{b}.norm2.bias"] = t(d)
        sd[f"{b}.mlp.w1.weight"] = t(hidden, d)
        sd[f"{b}.mlp.w1.bias"] = t(hidden)
        sd[f"{b}.mlp.w2.weight"] = t(hidden, d)
        sd[f"{b}.mlp.w2.bias"] = t(hidden)
        sd[f"{b}.mlp.w3.weight"] = t(d, hidden)
        sd[f"{b}.mlp.w3.bias"] = t(d)
    sd["eva.norm.weight"] = t(d)
    sd["eva.norm.bias"] = t(d)

    # tokenizer convs, torch Conv3d layout (O, I, kD, kH, kW)
    base = cfg.tokenizer_base_features
    sd["down_projection.encoder.0.weight"] = t(base, cfg.input_channels,
                                               3, 3, 3)
    sd["down_projection.encoder.0.bias"] = t(base)
    ch = base
    mod = 1
    for level, depth in enumerate(cfg.tokenizer_depth_per_level):
        out_ch = min(ch * 2, cfg.embed_dim)
        sd[f"down_projection.encoder.{mod}.weight"] = t(out_ch, ch, 3, 3, 3)
        sd[f"down_projection.encoder.{mod}.bias"] = t(out_ch)
        mod += 1
        for _ in range(depth):
            for _c in range(2):
                sd[f"down_projection.encoder.{mod}.weight"] = t(
                    out_ch, out_ch, 3, 3, 3
                )
                sd[f"down_projection.encoder.{mod}.bias"] = t(out_ch)
                mod += 1
        ch = out_ch
    sd[f"down_projection.encoder.{mod}.weight"] = t(cfg.embed_dim, ch,
                                                    1, 1, 1)
    sd[f"down_projection.encoder.{mod}.bias"] = t(cfg.embed_dim)

    # decoder, torch ConvTranspose3d layout (I, O, kD, kH, kW)
    import math

    n_up = int(round(math.log2(cfg.patch_embed_size[0])))
    ch = cfg.embed_dim
    for i in range(n_up):
        out_ch = cfg.num_classes if i == n_up - 1 else max(ch // 2, 32)
        sd[f"up_projection.decode.{i}.weight"] = t(ch, out_ch, 2, 2, 2)
        sd[f"up_projection.decode.{i}.bias"] = t(out_ch)
        ch = out_ch
    return sd


def test_convert_primus_state_dict_full_coverage(tiny):
    """A synthetic upstream-layout state dict converts with zero unmapped
    source keys and zero unfilled targets, producing the exact runtime
    param-tree structure (VERDICT r1 item 4a)."""
    from anatomix_tpu.models.vit3d.convert import convert_primus_state_dict

    cfg, ref_params = tiny
    rng = np.random.default_rng(7)
    sd = _synthetic_upstream_state_dict(cfg, rng)
    params, unmapped, unfilled = convert_primus_state_dict(cfg, sd)
    assert unmapped == [], unmapped
    assert unfilled == [], unfilled

    # identical tree structure + leaf shapes as a fresh init
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    got = dict(
        (jax.tree_util.keystr(p), np.asarray(v).shape)
        for p, v in jax.tree_util.tree_leaves_with_path(params)
    )
    for path, leaf in ref_leaves:
        ks = jax.tree_util.keystr(path)
        assert ks in got, f"missing converted leaf {ks}"
        assert got[ks] == leaf.shape, (ks, got[ks], leaf.shape)
    assert len(got) == len(ref_leaves)

    # spot-check the layout transforms
    np.testing.assert_allclose(
        np.asarray(params["blocks"][0]["q_proj"]["w"]),
        sd["eva.blocks.0.attn.q_proj.weight"].numpy().T,
    )
    np.testing.assert_allclose(
        np.asarray(params["tokenizer"]["stem"]["w"]),
        sd["down_projection.encoder.0.weight"].numpy().transpose(
            2, 3, 4, 1, 0
        ),
    )

    # converted params run end-to-end
    x = jnp.asarray(
        rng.standard_normal((1,) + tuple(cfg.input_shape) + (1,)).astype(
            np.float32
        )
    )
    out = primus_apply(cfg, jax.tree_util.tree_map(jnp.asarray, params), x)
    assert out.shape == (1, 16, 16, 16, cfg.num_classes)
    assert np.isfinite(np.asarray(out)).all()


def test_decoder_matches_torch_convtranspose():
    """The converter's ConvTranspose3d mapping reproduces torch numerics
    through the REAL runtime decoder (`primus._decoder`, GEMM +
    depth-to-space) — not through `lax.conv_transpose`, which the runtime
    does not call (that path needs a spatially flipped kernel; the
    scatter layout does not)."""
    import torch

    from anatomix_tpu.models.vit3d.convert import _deconv_t
    from anatomix_tpu.models.vit3d.primus import _decoder

    torch.manual_seed(0)
    tc = torch.nn.ConvTranspose3d(6, 5, 2, stride=2)
    x = torch.randn(2, 6, 4, 4, 4)
    ref = tc(x).detach().numpy()
    dec = [{
        "w": jnp.asarray(_deconv_t(tc.weight.detach().numpy())),
        "b": jnp.asarray(tc.bias.detach().numpy()),
    }]
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 4, 1))
    y = _decoder(dec, xj, compute_dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(y).transpose(0, 4, 1, 2, 3), ref, atol=1e-5
    )


def test_rope_half_matches_interleaved():
    """rotate-half RoPE on permuted channels == interleaved RoPE then the
    same permutation (the exact-math identity behind the q/k projection
    weight permutation in _attention)."""
    import numpy as np

    from anatomix_tpu.models.vit3d.primus import (
        _apply_rope,
        _apply_rope_half,
        _rope_half_perm,
    )

    rng = np.random.default_rng(0)
    B, H, N, hd = 2, 3, 5, 12
    x = jnp.asarray(rng.standard_normal((B, H, N, hd)).astype(np.float32))
    cos = jnp.asarray(rng.standard_normal((N, hd // 2)).astype(np.float32))
    sin = jnp.asarray(rng.standard_normal((N, hd // 2)).astype(np.float32))
    perm = _rope_half_perm(hd)
    old = np.asarray(_apply_rope(x, cos, sin))[..., perm]
    new = np.asarray(_apply_rope_half(x[..., perm], cos, sin))
    np.testing.assert_allclose(new, old, atol=1e-6)
