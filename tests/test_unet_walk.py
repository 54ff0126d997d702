"""The UNet XLA walk: bf16 against f32 at `highest` precision over the
model topologies, and train-mode gradients against finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from anatomix_tpu.models.unet import (
    UnetConfig,
    build_plan,
    init_params,
    unet_apply,
)

TOPOLOGIES = {
    # the 6M anatomix layer mix
    "batch_max_nearest": dict(norm="batch"),
    # the 94M anatomix-dev layer mix
    "instance_avg_trilinear": dict(norm="instance", pooling="Avg",
                                   interp="trilinear", norm_eps=1e-2),
    "residual_lrelu": dict(norm="batch", residual_connection=True,
                           activation="lrelu"),
    "affine_prelu_zeros": dict(norm="instance_affine", activation="prelu",
                               pad_type="zeros"),
}


def _model(name, seed=0):
    cfg = UnetConfig(dimension=3, input_nc=1, output_nc=4, num_downs=2,
                     ngf=8, **TOPOLOGIES[name])
    plan = build_plan(cfg)
    return plan, init_params(plan, jax.random.PRNGKey(seed))


def _cos_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = np.sum(a * b, -1) / (
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    return cos.mean(), np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_bf16_walk_tracks_f32_highest(name):
    plan, params = _model(name)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 16, 16, 16, 1))
    y16 = jax.jit(lambda v: unet_apply(
        plan, params, v, compute_dtype=jnp.bfloat16))(x)
    with jax.default_matmul_precision("highest"):
        y32 = jax.jit(lambda v: unet_apply(plan, params, v))(x)
    assert y16.dtype == jnp.float32 and y16.shape == y32.shape
    cos, rel = _cos_rel(y16, y32)
    assert cos >= 0.999, cos
    assert rel <= 3e-2, rel


SMOOTH = {
    # tanh / Avg pool keep the loss smooth, so a central difference is
    # accurate; the norms (and the custom batch-norm adjoint) are the
    # walk's own
    "batch_tanh": dict(norm="batch", activation="tanh", pooling="Avg"),
    "instance_tanh_trilinear": dict(norm="instance", activation="tanh",
                                    pooling="Avg", interp="trilinear"),
    "residual_tanh": dict(norm="batch", activation="tanh", pooling="Avg",
                         residual_connection=True, final_act="tanh"),
}


@pytest.mark.parametrize("name", sorted(SMOOTH))
def test_train_walk_gradient_matches_finite_differences(name):
    """Directional derivative of a train-mode loss (batch statistics, the
    custom BN adjoint) against a central difference."""
    cfg = UnetConfig(dimension=3, input_nc=1, output_nc=4, num_downs=2,
                     ngf=8, **SMOOTH[name])
    plan = build_plan(cfg)
    params = init_params(plan, jax.random.PRNGKey(2))
    x = jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 8, 1))
    t = jax.random.normal(jax.random.PRNGKey(4), (2, 8, 8, 8, 4))

    def loss(p):
        out = unet_apply(plan, p, x, train=True)
        y = out[0] if isinstance(out, tuple) else out
        return jnp.mean((y - t) ** 2)

    # a random unit direction over all parameters
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    dirs = [jax.random.normal(k, leaf.shape, leaf.dtype)
            for k, leaf in zip(keys, leaves)]
    norm = float(jnp.sqrt(sum(jnp.sum(d * d) for d in dirs)))
    direction = jax.tree_util.tree_unflatten(treedef,
                                             [d / norm for d in dirs])
    with jax.default_matmul_precision("highest"):
        g = jax.jit(jax.grad(loss))(params)
        analytic = sum(
            float(jnp.vdot(a, b)) for a, b in zip(
                jax.tree_util.tree_leaves(g),
                jax.tree_util.tree_leaves(direction))
        )
        eps = 1e-2
        shift = lambda s: jax.tree_util.tree_map(  # noqa: E731
            lambda p, d: p + s * d, params, direction)
        f = jax.jit(loss)
        numeric = (float(f(shift(eps))) - float(f(shift(-eps)))) / (2 * eps)
    assert abs(analytic - numeric) <= 1e-2 * abs(numeric) + 1e-5, (
        analytic, numeric)
