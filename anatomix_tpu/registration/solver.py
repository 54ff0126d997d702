"""ConvexAdam two-stage solver: stage-1 coupled convex + stage-2 Adam
instance optimization.

Semantics match `run_stage1_registration` / `run_instance_opt`
(`/root/reference/anatomix/registration/instance_optimization.py:122-399`).
Design: the 80-iteration Adam loop is a `lax.scan` over a pure step
(optax Adam ≡ torch Adam bias-corrected update), compiled once; gradients
flow through the box-filter smoothing and the trilinear grid_sample exactly
as the reference's autograd does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax

from anatomix_tpu.ops.grid_sample import (
    grid_sample,
    identity_grid,
    make_packed_sampler,
)
from anatomix_tpu.ops.pool import avg_pool, box_filter
from anatomix_tpu.ops.resize import resize3d
from anatomix_tpu.registration.correlate import (
    correlate,
    coupled_convex,
    displacement_mesh,
)
from anatomix_tpu.registration.warp import (
    diffusion_regularizer,
    inverse_consistency,
    smooth_disp,
)


def run_stage1_registration(
    features_fix_smooth: jax.Array,  # (1, H', W', D', C)
    features_mov_smooth: jax.Array,
    disp_hw: int,
    grid_sp: int,
    sizes: tuple[int, int, int],
    ic: bool = True,
) -> jax.Array:
    """Correlation + coupled convex (+ optional inverse consistency +
    upsample). Returns (1, H, W, D, 3) displacement in voxel units (dH, dW,
    dD) at full resolution when `ic`, else the grid-spaced field
    (`instance_optimization.py:122-222`)."""
    H, W, D = sizes
    mesh = jnp.asarray(displacement_mesh(disp_hw))

    ssd, ssd_argmin = correlate(
        features_fix_smooth, features_mov_smooth, disp_hw
    )
    disp_soft = coupled_convex(ssd, ssd_argmin, mesh)

    if not ic:
        return disp_soft

    scale = jnp.asarray(
        [H // grid_sp - 1, W // grid_sp - 1, D // grid_sp - 1],
        jnp.float32,
    ) / 2.0

    ssd_b, argmin_b = correlate(
        features_mov_smooth, features_fix_smooth, disp_hw
    )
    disp_soft_b = coupled_convex(ssd_b, argmin_b, mesh)

    # normalize + (dH,dW,dD)->(x,y,z) flip, run IC, flip back
    d1 = (disp_soft / scale)[..., ::-1]
    d2 = (disp_soft_b / scale)[..., ::-1]
    disp_ice, _ = inverse_consistency(d1, d2, iterations=15)

    disp_vox = disp_ice[..., ::-1] * scale * grid_sp
    return resize3d(
        disp_vox, (H, W, D), mode="trilinear", align_corners=False
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "grid_sp_adam", "lambda_weight", "selected_niter", "selected_smooth",
        "lr",
    ),
)
def run_instance_opt(
    disp_hr: jax.Array,  # (1, H, W, D, 3) voxel units
    features_fix: jax.Array,  # (1, H, W, D, C) full-res merged features
    features_mov: jax.Array,
    grid_sp_adam: int = 2,
    lambda_weight: float = 0.75,
    selected_niter: int = 80,
    selected_smooth: int = 0,
    lr: float = 1.0,
) -> jax.Array:
    """Adam instance optimization (`instance_optimization.py:269-399`).

    The optimizable variable is the grid-spaced displacement (the reference
    parameterizes it as a Conv3d weight, which is just a tensor); each step
    box-smooths it (3×, k=3), measures the diffusion regularizer + the
    feature-matching cost at grid_sample'd positions, and Adam(lr=1) steps.
    Like the reference, the returned field comes from the *pre-update*
    weights of the final iteration.
    """
    H, W, D = features_fix.shape[1:4]
    g = grid_sp_adam
    Hg, Wg, Dg = H // g, W // g, D // g

    patch_fix = avg_pool(features_fix.astype(jnp.float32), g)
    patch_mov = avg_pool(features_mov.astype(jnp.float32), g)

    disp_lr = resize3d(
        disp_hr.astype(jnp.float32), (Hg, Wg, Dg), mode="trilinear",
        align_corners=False,
    )
    weights0 = disp_lr / g  # (1, Hg, Wg, Dg, 3)

    scale = jnp.asarray(
        [(Hg - 1) / 2.0, (Wg - 1) / 2.0, (Dg - 1) / 2.0], jnp.float32
    )
    grid0 = identity_grid((Hg, Wg, Dg), align_corners=False)

    tx = optax.adam(lr)
    # one-time corner packing: each Adam step then needs a single row-gather
    # instead of 8 (see make_packed_sampler)
    sample_mov = make_packed_sampler(patch_mov, align_corners=False)

    def loss_fn(w):
        disp_sample = box_filter(w, kernel_size=3, num_repeats=3)
        reg_loss = diffusion_regularizer(disp_sample, lambda_weight)
        grid = grid0 + (disp_sample / scale)[..., ::-1]
        sampled = sample_mov(grid)
        cost = jnp.mean((sampled - patch_fix) ** 2, axis=-1) * 12.0
        return jnp.mean(cost) + reg_loss, disp_sample

    def step(carry, _):
        w, opt_state, _ = carry
        (_, disp_sample), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(w)
        updates, opt_state = tx.update(grads, opt_state, w)
        w = optax.apply_updates(w, updates)
        # carry the pre-update field so the final iteration's is returned
        return (w, opt_state, disp_sample), None

    (_, _, fitted), _ = jax.lax.scan(
        step,
        (weights0, tx.init(weights0), weights0),
        None,
        length=selected_niter,
    )

    disp_out = resize3d(
        fitted * g, (H, W, D), mode="trilinear", align_corners=False
    )
    if selected_smooth in (3, 5):
        disp_out = smooth_disp(disp_out, selected_smooth, num_repeats=3)
    return disp_out
