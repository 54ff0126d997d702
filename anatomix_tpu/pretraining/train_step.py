"""The pretraining train step: pure, jitted, data-parallel over a mesh.

Replaces the reference's `SupCLModel.optimize_parameters`
(`/root/reference/pretraining/models/supcl_model.py:603-661`) +
`calculate_NCE_loss` (`supcl_model.py:801-843`): forward the two views
through the UNet collecting tap activations, sample per-sample patch
coordinates shared across views, project with the per-tap MLPs, sum the
per-tap SupPatchNCE losses (weights default to 1/num_taps, `supcl_model.py:
388-399`), and take one AdamW step on both networks (`supcl_model.py:
508-517,583-591`).

Differences: bf16 compute with fp32 norms replaces AMP+GradScaler (bf16
keeps fp32's exponent range, so no loss scaling), batch-norm running stats
are threaded functionally, and data parallelism is expressed with
`NamedSharding` on the batch — XLA inserts the grad all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import optax

from anatomix_tpu.models.unet import UnetPlan, init_params, unet_apply


def _backbone_forward(plan, params_g, x, tap_layers, train, compute_dtype,
                      bn_axis_name, eval_norm_layers=()):
    """Dispatch UNet vs Primus backbones.

    Primus forces a single tap on the final feature map (logged as layer -1,
    `supcl_model.py:404-410`)."""
    if isinstance(plan, UnetPlan):
        if train:
            _, taps, new_stats = unet_apply(
                plan, params_g, x, layers=tap_layers, train=True,
                compute_dtype=compute_dtype, bn_axis_name=bn_axis_name,
                eval_norm_layers=eval_norm_layers,
            )
            return taps, new_stats
        _, taps = unet_apply(
            plan, params_g, x, layers=tap_layers,
            compute_dtype=compute_dtype,
        )
        return taps, {}
    # PrimusConfig: single-scale NCE on the decoded volume
    from anatomix_tpu.models.vit3d import primus_apply

    _, taps = primus_apply(
        plan, params_g, x, layers=[-1], compute_dtype=compute_dtype,
    )
    return taps, {}


def backbone_tap_channels(plan, tap_layers):
    if isinstance(plan, UnetPlan):
        return plan.tap_channels(tuple(tap_layers))
    return (plan.num_classes,)
from anatomix_tpu.pretraining.losses import sup_patch_nce_loss
from anatomix_tpu.pretraining.patch_sample import (
    apply_patch_mlp,
    gather_at_coords,
    init_patch_mlps,
    labels_at_coords,
    nearest_downsample,
    sample_patch_coords,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array
    params_g: Any
    params_f: Any
    opt_state_g: Any
    opt_state_f: Any
    # host-driven LR multiplier on top of the compiled schedule; the
    # `lr_policy=plateau` hook (reference ReduceLROnPlateau stepped on val
    # loss, `pretraining_networks.py:583-590` + `trainers/train.py:379-380`)
    # updates it from the train loop without retracing the step.
    lr_scale: jax.Array

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def _trainable_mask(params, frozen_layers=()):
    """False for batch-norm running stats (they are not optimizer targets;
    AdamW weight decay must not touch them) and for frozen layer indices
    (the reference's `unfreeze_layers` mechanism, `supcl_model.py:
    421-427,880-896`)."""
    frozen = {str(i) for i in frozen_layers}

    def mask_leaf(path, leaf):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        if any(k in ("mean", "var") for k in keys):
            return False
        if frozen and keys and str(keys[0]) in frozen:
            return False
        return True

    return jax.tree_util.tree_map_with_path(mask_leaf, params)


def frozen_layer_ids(plan, unfreeze_layers, tap_layers):
    """Layer ids frozen when `unfreeze_layers` is set: every parameterized
    layer up to the last tap except those listed."""
    if not unfreeze_layers:
        return ()
    keep = {int(i) for i in unfreeze_layers}
    last = max(tap_layers)
    return tuple(
        i
        for i, s in enumerate(plan.layers)
        if s.kind in ("conv", "norm") and i <= last and i not in keep
    )


def make_optimizer(
    lr: float = 2e-4,
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-5,
    grad_clip: float | None = None,
    schedule=None,
    mask=None,
    grad_accum: int = 1,
):
    """AdamW matching the reference's optimizer_G/optimizer_F settings
    (`supcl_model.py:508-517,583-591`), with optional global-norm clipping
    and gradient accumulation (`supcl_model.py:618-657`).

    The learning rate is always wrapped as a schedule callable so the
    optimizer-state tree structure is identical with and without a schedule
    (the train step swaps in a host-scaled schedule for `lr_policy=plateau`
    without changing the state layout)."""
    sched = schedule if schedule is not None else (lambda count: lr)
    tx = optax.adamw(
        sched,
        b1=beta1,
        b2=beta2,
        weight_decay=weight_decay,
    )
    if grad_clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    if mask is not None:
        # NOTE: optax.masked passes masked-OUT leaves' gradients through as
        # raw updates; frozen/stat leaves must be hard-zeroed instead.
        labels = jax.tree_util.tree_map(
            lambda m: "train" if m else "freeze", mask
        )
        tx = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()}, labels
        )
    if grad_accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=grad_accum)
    return tx


def init_train_state(
    plan: UnetPlan,
    key: jax.Array,
    *,
    tap_layers: Sequence[int],
    num_patches: int = 512,
    netf_nc: int = 256,
    n_mlps: int = 3,
    lr: float = 2e-4,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-5,
    grad_clip: float | None = None,
    grad_clip_f: float | None = None,
    grad_accum: int = 1,
    init_type: str = "kaiming",
    init_gain: float = 0.02,
    schedule=None,
    params_g: Any = None,
    frozen_layers: Sequence[int] = (),
) -> TrainState:
    kg, kf = jax.random.split(key)
    if params_g is None:
        if isinstance(plan, UnetPlan):
            params_g = init_params(
                plan, kg, init_type=init_type, init_gain=init_gain
            )
        else:
            from anatomix_tpu.models.vit3d import init_primus_params

            params_g = init_primus_params(plan, kg)
    params_f = init_patch_mlps(
        kf,
        backbone_tap_channels(plan, tap_layers),
        nc=netf_nc,
        n_mlps=n_mlps,
        init_type=init_type,
        init_gain=init_gain,
    )
    common = dict(
        beta1=beta1, beta2=beta2, weight_decay=weight_decay,
        schedule=schedule, grad_accum=grad_accum,
    )
    tx_g = make_optimizer(
        lr, grad_clip=grad_clip,
        mask=_trainable_mask(params_g, frozen_layers), **common,
    )
    tx_f = make_optimizer(
        lr, grad_clip=grad_clip_f if grad_clip_f is not None else grad_clip,
        mask=_trainable_mask(params_f), **common
    )
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params_g=params_g,
        params_f=params_f,
        opt_state_g=tx_g.init(params_g),
        opt_state_f=tx_f.init(params_f),
        lr_scale=jnp.ones((), jnp.float32),
    )


@dataclasses.dataclass(frozen=True)
class NCEOptions:
    temperature: float = 0.33
    lambda_nce: float = 1.0
    weigh_rarity: bool = False
    balance_denominator: bool = False
    weighting_mode: str = "raw"


def nce_forward(
    plan: UnetPlan,
    params_g,
    params_f,
    views: jax.Array,  # (B, 2, D, H, W, C)
    segs: jax.Array,  # (B, D, H, W, 1) integer labels
    rng: jax.Array,
    *,
    tap_layers: Sequence[int],
    num_patches: int,
    nce: NCEOptions,
    nce_weights: Sequence[float] | None = None,
    train: bool = True,
    compute_dtype=None,
    bn_axis_name: str | None = None,
    eval_norm_layers: Sequence[int] = (),
    fg_masks: jax.Array | None = None,  # (B, D, H, W) >0 = foreground
):
    """Compute the multi-tap SupPatchNCE loss.

    With `fg_masks`, patch coordinates are sampled from foreground voxels
    only (the reference's PatchSampleF mask path,
    `pretraining_networks.py:436-460`; the mask is nearest-interpolated to
    each tap's grid).

    Returns (loss, aux) with aux = dict(new_g_stats, new_f_stats,
    per_layer_losses).
    """
    tap_layers = tuple(tap_layers)
    B = views.shape[0]
    x = jnp.concatenate([views[:, 0], views[:, 1]], axis=0)  # (2B, ...)

    taps, new_g_stats = _backbone_forward(
        plan, params_g, x, tap_layers, train, compute_dtype, bn_axis_name,
        eval_norm_layers=eval_norm_layers,
    )

    if nce_weights is None:
        nce_weights = [1.0 / len(tap_layers)] * len(tap_layers)

    total = 0.0
    per_layer = {}
    new_f_stats = {}
    seg3d = segs[..., 0]
    for t, (layer_id, feat, w_t) in enumerate(
        zip(tap_layers, taps, nce_weights)
    ):
        tap_spatial = feat.shape[1:4]
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, B)
        if fg_masks is not None:
            tap_masks = jax.vmap(
                lambda m: nearest_downsample(m, tap_spatial)
            )(fg_masks)
            coords = jax.vmap(
                lambda k, m: sample_patch_coords(
                    k, tap_spatial, num_patches, mask=m
                )
            )(keys, tap_masks)  # (B, P, 3)
        else:
            coords = jax.vmap(
                lambda k: sample_patch_coords(k, tap_spatial, num_patches)
            )(keys)  # (B, P, 3)

        g1 = jax.vmap(gather_at_coords)(feat[:B], coords)  # (B, P, ch)
        g2 = jax.vmap(gather_at_coords)(feat[B:], coords)
        stacked = jnp.stack([g1, g2], axis=1)  # (B, 2, P, ch)
        Bp = stacked.shape[2]
        flat = stacked.reshape(B * 2 * Bp, stacked.shape[-1])
        proj, f_stats = apply_patch_mlp(
            params_f[f"mlp_{t}"], flat, train=train
        )
        new_f_stats[f"mlp_{t}"] = {
            "linears": params_f[f"mlp_{t}"]["linears"],
            "bns": f_stats,
        }
        proj = proj.reshape(B, 2, Bp, -1)

        labels = jax.vmap(
            lambda s, c: labels_at_coords(s, c, tap_spatial)
        )(seg3d, coords)  # (B, P)

        loss_t = jnp.mean(
            jax.vmap(
                lambda f, l: sup_patch_nce_loss(
                    f,
                    l,
                    temperature=nce.temperature,
                    weigh_rarity=nce.weigh_rarity,
                    balance_denominator=nce.balance_denominator,
                    weighting_mode=nce.weighting_mode,
                )
            )(proj, labels)
        )
        total = total + loss_t * w_t * nce.lambda_nce
        per_layer[str(layer_id)] = loss_t

    aux = {
        "new_g_stats": new_g_stats,
        "new_f_stats": new_f_stats,
        "per_layer": per_layer,
    }
    return total, aux


def _merge_bn_stats(params_g, new_g_stats):
    merged = dict(params_g)
    for idx, (mean, var) in new_g_stats.items():
        merged[idx] = {**params_g[idx], "mean": mean, "var": var}
    return merged


def build_train_step(
    plan: UnetPlan,
    *,
    tap_layers: Sequence[int],
    num_patches: int = 512,
    nce_temperature: float = 0.33,
    lambda_nce: float = 1.0,
    weigh_rarity: bool = False,
    balance_denominator: bool = False,
    weighting_mode: str = "raw",
    nce_weights: Sequence[float] | None = None,
    lr: float = 2e-4,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-5,
    grad_clip: float | None = None,
    grad_clip_f: float | None = None,
    grad_accum: int = 1,
    schedule=None,
    compute_dtype=None,
    mesh=None,
    donate: bool = True,
    frozen_layers: Sequence[int] = (),
    use_fg_mask: bool = False,
):
    """Build the jitted train step `(state, views, segs, rng) -> (state,
    metrics)`.

    With `mesh`, inputs are expected sharded over the 'data' axis and params
    replicated; XLA inserts the grad all-reduce across the mesh.
    """
    nce = NCEOptions(
        temperature=nce_temperature,
        lambda_nce=lambda_nce,
        weigh_rarity=weigh_rarity,
        balance_denominator=balance_denominator,
        weighting_mode=weighting_mode,
    )
    opt_common = dict(
        beta1=beta1, beta2=beta2, weight_decay=weight_decay,
        grad_accum=grad_accum,
    )

    def step_fn(state: TrainState, views, segs, rng):
        # schedule × host-driven scale (traced: lr_scale is a state leaf)
        def scaled_schedule(count):
            base = schedule(count) if schedule is not None else lr
            return base * state.lr_scale

        def loss_fn(params_g, params_f):
            eval_norms = tuple(
                i for i in frozen_layers
                if isinstance(plan, UnetPlan)
                and plan.layers[i].kind == "norm"
            )
            return nce_forward(
                plan, params_g, params_f, views, segs, rng,
                tap_layers=tap_layers, num_patches=num_patches, nce=nce,
                nce_weights=nce_weights, train=True,
                compute_dtype=compute_dtype,
                eval_norm_layers=eval_norms,
                # label > 0 is the foreground mask (the reference's dataset
                # ships a dedicated `mask` key, `h5supcl_dataset.py:339-343`;
                # seg>0 is its value for the synthetic training data)
                fg_masks=(segs[..., 0] > 0) if use_fg_mask else None,
            )

        (loss, aux), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(state.params_g, state.params_f)
        grads_g, grads_f = grads

        tx_g = make_optimizer(
            lr, grad_clip=grad_clip, schedule=scaled_schedule,
            mask=_trainable_mask(state.params_g, frozen_layers),
            **opt_common,
        )
        tx_f = make_optimizer(
            lr,
            grad_clip=grad_clip_f if grad_clip_f is not None else grad_clip,
            schedule=scaled_schedule,
            mask=_trainable_mask(state.params_f), **opt_common,
        )
        updates_g, opt_state_g = tx_g.update(
            grads_g, state.opt_state_g, state.params_g
        )
        updates_f, opt_state_f = tx_f.update(
            grads_f, state.opt_state_f, state.params_f
        )
        params_g = optax.apply_updates(state.params_g, updates_g)
        params_f = optax.apply_updates(state.params_f, updates_f)

        params_g = _merge_bn_stats(params_g, aux["new_g_stats"])
        # merge projector BN stats (keep updated linears from the optimizer)
        for name, sub in aux["new_f_stats"].items():
            params_f[name] = {
                "linears": params_f[name]["linears"],
                "bns": [
                    {
                        **new_bn,
                        **{
                            k: v
                            for k, v in opt_bn.items()
                            if k in ("scale", "bias")
                        },
                    }
                    for new_bn, opt_bn in zip(
                        sub["bns"], params_f[name]["bns"]
                    )
                ],
            }

        grad_norm_g = optax.global_norm(grads_g)
        grad_norm_f = optax.global_norm(grads_f)
        metrics = {
            "loss": loss,
            "grad_norm_G": grad_norm_g,
            "grad_norm_F": grad_norm_f,
            "lr": scaled_schedule(state.step),
            **{f"nce_{k}": v for k, v in aux["per_layer"].items()},
        }
        new_state = TrainState(
            step=state.step + 1,
            params_g=params_g,
            params_f=params_f,
            opt_state_g=opt_state_g,
            opt_state_f=opt_state_f,
            lr_scale=state.lr_scale,
        )
        return new_state, metrics

    donate_argnums = (0,) if donate else ()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        repl = NamedSharding(mesh, P())
        data = NamedSharding(mesh, P("data"))
        return jax.jit(
            step_fn,
            in_shardings=(repl, data, data, repl),
            out_shardings=(repl, repl),
            donate_argnums=donate_argnums,
        )
    return jax.jit(step_fn, donate_argnums=donate_argnums)
