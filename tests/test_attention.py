"""ViT attention: the padded `jax.nn.dot_product_attention` wrapper against
the plain f32 einsum reference, forward and gradient."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.models.vit3d import PrimusConfig, init_primus_params
from anatomix_tpu.models.vit3d.primus import (
    _attention,
    _rope_tables,
    dot_product_attention,
)


def _qkv(n, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((2, n, 3, hd)), jnp.float32)
            for _ in range(3)]


@pytest.mark.parametrize("n", [5, 37])
@pytest.mark.parametrize("hd", [66, 8, 13])
def test_padded_attention_forward(hd, n):
    q, k, v = _qkv(n, hd)
    scale = 1.0 / math.sqrt(hd)
    with jax.default_matmul_precision("highest"):
        got = dot_product_attention(q, k, v, scale=scale,
                                    implementation="xla")
        ref = dot_product_attention(q, k, v, scale=scale,
                                    implementation="einsum")
    assert got.shape == (2, n, 3, hd)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [5, 37])
@pytest.mark.parametrize("hd", [66, 8, 13])
def test_padded_attention_gradient(hd, n):
    q, k, v = _qkv(n, hd, seed=1)
    t = _qkv(n, hd, seed=2)[0]
    scale = 1.0 / math.sqrt(hd)

    def loss(q, k, v, impl):
        out = dot_product_attention(q, k, v, scale=scale,
                                    implementation=impl)
        return jnp.sum(out * t)

    with jax.default_matmul_precision("highest"):
        got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v, "xla")
        ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v, "einsum")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_prefix", [0, 2, 8])
def test_block_attention_register_prefix(n_prefix):
    """A whole attention block (projections, QK norm, RoPE on the tokens
    after the register prefix) gives the same output through the padded
    wrapper as through the einsum reference."""
    cfg = PrimusConfig(
        input_channels=1, num_classes=4, embed_dim=66, eva_depth=1,
        eva_numheads=1, input_shape=(16, 16, 16),
        num_register_tokens=n_prefix, qk_norm=True, scale_attn_inner=True,
    )
    block = init_primus_params(cfg, jax.random.PRNGKey(0))["blocks"][0]
    n = cfg.num_tokens + n_prefix
    x = jax.random.normal(jax.random.PRNGKey(1), (1, n, cfg.embed_dim))
    rope = _rope_tables(cfg)
    with jax.default_matmul_precision("highest"):
        got = _attention(cfg, block, x, rope, n_prefix, attn_impl="xla")
        ref = _attention(cfg, block, x, rope, n_prefix, attn_impl="einsum")
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
