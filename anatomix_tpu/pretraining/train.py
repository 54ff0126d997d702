"""Pretraining trainer loop + launcher CLI.

Replaces `pretraining/trainers/train.py` + `scripts/pretrain_anatomix.py`
(the reference shells out to a subprocess; here the launcher IS the
trainer): two-view H5 dataset with on-device paired augmentation, pure
jitted AdamW train step (data-parallel over a mesh), const_linear schedule,
print/display/save cadences, eval cadence with best-val tracking, resumable
checkpoints (weights + full optimizer state + step), provenance dump.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from anatomix_tpu.models.unet import UnetConfig, build_plan
from anatomix_tpu.pretraining.config import PretrainConfig
from anatomix_tpu.pretraining.dataset import H5TwoViewDataset, make_pair_augment
from anatomix_tpu.pretraining.schedulers import make_schedule
from anatomix_tpu.pretraining.train_step import (
    build_train_step,
    init_train_state,
    nce_forward,
    NCEOptions,
)
from anatomix_tpu.utils.checkpoint import (
    load_state_leaves,
    save_pytree,
    save_state_leaves,
)
from anatomix_tpu.utils.logging import ScalarLogger
from anatomix_tpu.utils.visualization import log_panels, save_tensor


def build_all(cfg: PretrainConfig, steps_per_epoch: int, mesh=None):
    if cfg.netG == "unet":
        plan = build_plan(
            UnetConfig(
                dimension=cfg.ndims,
                input_nc=cfg.input_nc,
                output_nc=cfg.output_nc,
                num_downs=cfg.num_downs,
                ngf=cfg.ngf,
                norm=cfg.normG,
                activation=cfg.actG,
                pooling=cfg.pool_type,
                interp=cfg.interp_type,
                norm_eps=cfg.norm_eps_G,
            )
        )
        taps = cfg.tap_layers()
    elif cfg.netG == "primus":
        from anatomix_tpu.models.vit3d import PrimusConfig

        plan = PrimusConfig(
            input_channels=cfg.input_nc,
            num_classes=cfg.output_nc,
            input_shape=(cfg.crop_size,) * 3,
            out_norm="demean",
            qk_norm=True,
            scale_attn_inner=True,
            init_values=0.1,
            in_eps=cfg.norm_eps_G,
        )
        taps = (-1,)  # ViT exposes a single feature scale
    else:
        raise NotImplementedError(f"netG {cfg.netG!r}")

    if cfg.lr_policy == "plateau":
        # loss-driven: constant compiled schedule, host-side PlateauState
        # scales `state.lr_scale` at the eval cadence (reference
        # ReduceLROnPlateau, `pretraining_networks.py:583-590`)
        schedule = None
    else:
        schedule = make_schedule(
            cfg.lr, cfg.lr_policy,
            n_epochs=cfg.n_epochs, n_epochs_decay=cfg.n_epochs_decay,
            steps_per_epoch=steps_per_epoch,
        )
    frozen = ()
    if cfg.unfreeze_layers and cfg.netG == "unet":
        from anatomix_tpu.pretraining.train_step import frozen_layer_ids

        frozen = frozen_layer_ids(
            plan,
            [int(i) for i in cfg.unfreeze_layers.split(",")],
            taps,
        )
        print(f"Freezing {len(frozen)} layers (unfreeze="
              f"{cfg.unfreeze_layers})")
    common = dict(
        tap_layers=taps,
        num_patches=cfg.num_patches,
        lr=cfg.lr,
        beta1=cfg.beta1,
        beta2=cfg.beta2,
        weight_decay=cfg.weight_decay,
        grad_clip=cfg.max_norm_G if cfg.clip_grad else None,
        grad_clip_f=cfg.max_norm_F if cfg.clip_grad else None,
        grad_accum=cfg.grad_accum_iters,
        schedule=schedule,
        frozen_layers=frozen,
    )
    state = init_train_state(
        plan,
        jax.random.PRNGKey(cfg.seed),
        netf_nc=cfg.netF_nc,
        n_mlps=cfg.n_mlps,
        init_type=cfg.init_type,
        init_gain=cfg.init_gain,
        **common,
    )
    step = build_train_step(
        plan,
        nce_temperature=cfg.nce_T,
        lambda_nce=cfg.lambda_NCE,
        weigh_rarity=cfg.weigh_rarity,
        balance_denominator=cfg.balance_denominator,
        weighting_mode=cfg.weighting_mode,
        nce_weights=cfg.nce_weights,
        mesh=mesh,
        donate=False,
        use_fg_mask=cfg.load_mask,
        **common,
    )
    return plan, taps, state, step


def compute_val_loss(plan, cfg, taps, state, val_ds, rng_np, n_batches,
                     repl_sharding=None):
    """Validation loss on full volumes (no aug), `train.py:317-376`.

    `repl_sharding` (multihost): the train state lives on the GLOBAL
    replicated mesh; mixing process-local host arrays with global-mesh
    arrays in one jit raises (incompatible device sets), so the val
    inputs — identical on every process, lockstep SPMD — are replicated
    onto the same sharding first."""
    nce = NCEOptions(
        temperature=cfg.nce_T, lambda_nce=cfg.lambda_NCE,
        weigh_rarity=cfg.weigh_rarity,
        balance_denominator=cfg.balance_denominator,
        weighting_mode=cfg.weighting_mode,
    )
    losses = []
    n = min(n_batches, len(val_ds.subjects))
    for i in range(n):
        img_a, img_b, seg = val_ds.get(i, rng_np)
        views = jnp.stack([
            jnp.asarray(img_a)[..., None], jnp.asarray(img_b)[..., None]
        ])[None]
        segs = jnp.asarray(seg, jnp.int32)[None, ..., None]
        if repl_sharding is not None:
            views = jax.device_put(views, repl_sharding)
            segs = jax.device_put(segs, repl_sharding)
        loss, _ = nce_forward(
            plan, state.params_g, state.params_f, views, segs,
            jax.random.PRNGKey(i), tap_layers=taps,
            num_patches=cfg.num_patches, nce=nce,
            nce_weights=cfg.nce_weights, train=False,
        )
        losses.append(float(loss))
    return float(np.mean(losses)) if losses else float("nan")


def train(cfg: PretrainConfig, train_h5: str | None = None,
          val_h5: str | None = None):
    # multi-host: initialize jax.distributed BEFORE any other backend use
    # (one trainer process per host; SURVEY §2.6/§5.8 design obligation)
    pid, nproc = 0, 1
    if cfg.multihost:
        from anatomix_tpu.parallel import multihost as mh

        mh.initialize_distributed()
        pid, nproc = jax.process_index(), jax.process_count()

    run_dir = os.path.join(cfg.ckpt_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    if pid == 0:
        cfg.save(os.path.join(run_dir, "train_opt.json"))

    train_h5 = train_h5 or os.path.join(cfg.dataroot, "train_data.hdf5")
    val_h5 = val_h5 or os.path.join(cfg.dataroot, "val_data.hdf5")
    train_ds = H5TwoViewDataset(train_h5, cfg, train=True)
    val_ds = (
        H5TwoViewDataset(val_h5, cfg, train=False)
        if os.path.exists(val_h5)
        else None
    )
    if cfg.lr_policy == "plateau" and val_ds is None:
        raise ValueError(
            "lr_policy='plateau' steps on the validation loss "
            f"(reference pretraining_networks.py:591-607) but no val "
            f"dataset exists at {val_h5}; provide val_data.hdf5 or pick "
            "another lr_policy"
        )

    mesh = None
    repl_sharding = None
    if cfg.multihost:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = mh.global_data_mesh()
        if cfg.batch_size % mesh.size:
            raise ValueError(
                f"multihost: global batch_size {cfg.batch_size} must divide "
                f"evenly over {mesh.size} global devices"
            )
        repl_sharding = NamedSharding(mesh, P())
        if pid == 0:
            print(
                f"Multi-host data-parallel: {nproc} processes, "
                f"{mesh.size} devices, global batch {cfg.batch_size}"
            )
    else:
        n_dev = cfg.data_parallel_devices or len(jax.devices())
        if n_dev > 1 and cfg.batch_size % n_dev == 0:
            from jax.sharding import Mesh

            mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
            print(f"Data-parallel over {n_dev} devices")

    steps_per_epoch = max(len(train_ds) // cfg.batch_size, 1)
    plan, taps, state, step = build_all(cfg, steps_per_epoch, mesh)
    augment = make_pair_augment(cfg)

    # resume / warm start (precedence: continue_train > pretrained_name >
    # pretrained_G_only_ckpt; `base_model.py:119-143`)
    from anatomix_tpu.pretraining.warmstart import (
        load_partial,
        resolve_warm_start,
    )
    from anatomix_tpu.utils.checkpoint import load_pytree

    state_path = os.path.join(run_dir, "latest_train_state.npz")
    total_iters = 0
    best_val = float("inf")
    g_ckpt, f_ckpt, resume_path = resolve_warm_start(
        run_dir,
        continue_train=cfg.continue_train,
        pretrained_name=cfg.pretrained_name,
        pretrained_g_only_ckpt=cfg.pretrained_G_only_ckpt,
        ckpt_root=cfg.ckpt_dir,
    )
    if resume_path:
        try:
            state = load_state_leaves(resume_path, state)
        except ValueError:
            # pre-lr_scale checkpoint (the scalar leaf landed with the
            # plateau policy): re-insert the template's lr_scale at its
            # leaf position and retry, so older runs keep resuming
            import numpy as _np

            paths_leaves, treedef = jax.tree_util.tree_flatten_with_path(
                state
            )
            z = _np.load(resume_path, allow_pickle=False)
            old = [z[f"leaf_{i}"] for i in range(len(z.files))]
            if len(old) != len(paths_leaves) - 1:
                raise
            merged, it = [], iter(old)
            for path, leaf in paths_leaves:
                if any(
                    getattr(p, "name", None) == "lr_scale" for p in path
                ):
                    merged.append(leaf)
                else:
                    nxt = next(it)
                    if _np.shape(nxt) != _np.shape(leaf):
                        # not a pre-lr_scale checkpoint after all — a real
                        # structural mismatch; surface the original error
                        raise
                    merged.append(nxt)
            state = jax.tree_util.tree_unflatten(treedef, merged)
            print("Migrated pre-lr_scale train state")
        total_iters = int(state.step)
        bv_path = os.path.join(run_dir, "best_val_loss.txt")
        if os.path.exists(bv_path):
            best_val = float(open(bv_path).read().strip())
        print(f"Resumed at iter {total_iters} (best val {best_val})")
    else:
        if g_ckpt and os.path.exists(g_ckpt):
            print(f"Warm-starting G from {g_ckpt}")
            from anatomix_tpu.models.unet import UnetPlan

            loaded_g = load_pytree(g_ckpt)
            state = state.replace(
                params_g=load_partial(plan, state.params_g, loaded_g)
                if isinstance(plan, UnetPlan)
                else loaded_g
            )
        if f_ckpt and os.path.exists(f_ckpt):
            print(f"Warm-starting F from {f_ckpt}")
            state = state.replace(params_f=load_pytree(f_ckpt))

    # plateau LR policy: host-side ReduceLROnPlateau state scaling the
    # compiled constant schedule via `state.lr_scale`
    # (`pretraining_networks.py:583-590`, stepped on val loss as in
    # `trainers/train.py:379-380`)
    plateau = None
    plateau_path = os.path.join(run_dir, "plateau_state.json")
    if cfg.lr_policy == "plateau":
        from anatomix_tpu.pretraining.schedulers import PlateauState

        plateau = PlateauState(lr=cfg.lr)
        if resume_path and os.path.exists(plateau_path):
            import json

            with open(plateau_path) as f:
                plateau = PlateauState(**json.load(f))
            state = state.replace(
                lr_scale=jnp.asarray(plateau.lr / cfg.lr, jnp.float32)
            )

    if cfg.multihost:
        # replicate the train state over the global mesh (identical local
        # copies on every process -> a fully-replicated global array)
        state = jax.device_put(state, repl_sharding)

    if pid == 0:
        logger = ScalarLogger(run_dir, purge_step=total_iters or None)
    else:  # non-zero ranks never write artifacts
        class _NullLogger:
            def log(self, *a, **k):
                pass

            def log_text(self, *a, **k):
                pass

            def close(self):
                pass

        logger = _NullLogger()
    rng_np = np.random.default_rng(cfg.seed + total_iters)
    # the prefetch worker thread draws from its own child generator: numpy
    # Generators are not thread-safe and prepare_batch overlaps the main
    # thread's validation draws
    rng_data = rng_np.spawn(1)[0]
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), total_iters)

    n_epochs_total = cfg.n_epochs + cfg.n_epochs_decay
    t_data, t_step = 0.0, 0.0
    stop = False

    def prepare_batch(idxs, keys, rngs):
        """Host H5 read + H2D transfer + on-device paired augmentation.

        Runs on a worker thread so the host->device copies and HDF5 reads
        overlap the previous train step — the functional
        replacement for the reference's DataLoader workers
        (`pretraining/data/__init__.py:89-97`)."""
        views_list, segs_list = [], []
        for i, sub, item_rng in zip(idxs, keys, rngs):
            img_a, img_b, seg = train_ds.get(int(i), item_rng)
            # ship compactly (half the host->device bytes of f32):
            # [0,1]-normalized images as f16 (quantization intentional — inputs are
            # percentile-normalized to [0,1]), integer labels as i16
            assert seg.max() < np.iinfo(np.int16).max, (
                f"label ids up to {seg.max()} overflow the int16 transfer"
            )
            a = jnp.asarray(img_a.astype(np.float16)).astype(jnp.float32)
            b = jnp.asarray(img_b.astype(np.float16)).astype(jnp.float32)
            sg = jnp.asarray(seg.astype(np.int16)).astype(jnp.float32)
            v, s = augment(sub, a, b, sg)
            views_list.append(v)
            segs_list.append(s)
        return (
            jnp.stack(views_list),
            jnp.stack(segs_list).astype(jnp.int32),
        )

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)

    local_bs = cfg.batch_size // nproc

    def batch_futures():
        nonlocal key
        for epoch in range(n_epochs_total):
            if cfg.multihost:
                # epoch-seeded shared permutation: every process sees the
                # same global batch composition and reads only its
                # contiguous shard; per-item RNG is derived from
                # (seed, global step, batch position), so the pipeline is
                # process-count-invariant (same global batch -> same loss)
                order = np.random.default_rng(
                    [cfg.seed, 7919 + epoch]
                ).permutation(len(train_ds))
            else:
                order = rng_np.permutation(len(train_ds))
            for step_i, start in enumerate(
                range(0, steps_per_epoch * cfg.batch_size, cfg.batch_size)
            ):
                idxs = order[start: start + cfg.batch_size]
                if cfg.multihost:
                    gstep = epoch * steps_per_epoch + step_i
                    base = jax.random.fold_in(
                        jax.random.PRNGKey(cfg.seed + 1), gstep
                    )
                    lo = pid * local_bs
                    idxs = idxs[lo: lo + local_bs]
                    keys = [
                        jax.random.fold_in(base, lo + j)
                        for j in range(local_bs)
                    ]
                    rngs = [
                        np.random.default_rng(
                            [cfg.seed, 104729 + gstep, lo + j]
                        )
                        for j in range(local_bs)
                    ]
                else:
                    keys = []
                    for _ in idxs:
                        key, sub = jax.random.split(key)
                        keys.append(sub)
                    rngs = [rng_data] * len(idxs)
                yield epoch, pool.submit(prepare_batch, idxs, keys, rngs)

    it = batch_futures()
    pending = next(it, None)
    while pending is not None:
        epoch, fut = pending
        t0 = time.time()
        views, segs = fut.result()
        pending = next(it, None)  # queue the next batch immediately
        views_local, segs_local = views, segs  # this process's shard
        if cfg.multihost:
            # assemble global batch-sharded arrays from per-process shards
            views, segs = mh.global_batch_from_local(mesh, (views, segs))
        t_data = 0.9 * t_data + 0.1 * (time.time() - t0)

        t0 = time.time()
        key, sub = jax.random.split(key)
        if cfg.multihost:
            sub = jax.device_put(sub, repl_sharding)
        state, metrics = step(state, views, segs, sub)
        total_iters += 1
        t_step = 0.9 * t_step + 0.1 * (time.time() - t0)

        if total_iters % cfg.print_freq == 0:
            scalars = {f"loss/{k}": float(v) for k, v in metrics.items()
                       if k.startswith("nce_") or k == "loss"}
            scalars["metrics/grad_norm_G"] = float(
                metrics["grad_norm_G"])
            scalars["metrics/grad_norm_F"] = float(
                metrics["grad_norm_F"])
            logger.log(total_iters, scalars)
            logger.log_text(
                f"(epoch: {epoch}, iters: {total_iters}, "
                f"data: {t_data:.3f}s, step: {t_step:.3f}s) "
                f"loss: {float(metrics['loss']):.4f}"
            )

        if (
            pid == 0
            and cfg.display_freq
            and total_iters % cfg.display_freq == 0
        ):
            # mid-slice panels of the current batch (reference
            # `trainers/train.py:256-258` display cadence); fetch only the
            # mid slices, not whole volumes.
            # Uses the process-LOCAL shard (global batch slices are not
            # addressable cross-process).
            def _mid(v):
                return np.asarray(v[v.shape[0] // 2])[None]

            log_panels(
                logger,
                "train/visuals",
                {
                    "view1": _mid(views_local[0, 0]),
                    "view2": _mid(views_local[0, 1]),
                    "seg": _mid(segs_local[0].astype(jnp.float32)),
                },
                total_iters,
            )

        if pid == 0 and total_iters % cfg.save_latest_freq == 0:
            # periodic volume dumps of the live training tensors
            # (`trainers/train.py:302-309` + `util/util.py:39-75`)
            vis_dir = os.path.join(run_dir, "visuals")
            save_tensor(
                np.asarray(views_local[0, 0].astype(jnp.float16)),
                os.path.join(vis_dir, "latest_view1.nii.gz"),
            )
            save_tensor(
                np.asarray(views_local[0, 1].astype(jnp.float16)),
                os.path.join(vis_dir, "latest_view2.nii.gz"),
            )
            save_tensor(
                np.asarray(segs_local[0]),
                os.path.join(vis_dir, "latest_seg.nii.gz"),
            )
            save_state_leaves(state_path, state)
            save_pytree(
                os.path.join(run_dir, "latest_net_G.npz"),
                state.params_g,
            )
            save_pytree(
                os.path.join(run_dir, "latest_net_F.npz"),
                state.params_f,
            )

        if total_iters % cfg.evaluation_freq == 0:
            if pid == 0:
                save_pytree(
                    os.path.join(run_dir, f"{total_iters}_net_G.npz"),
                    state.params_g,
                )
                save_state_leaves(state_path, state)
            # val (and the plateau lr_scale it drives) runs on EVERY
            # process — identical inputs, lockstep SPMD — so the
            # replicated train state stays consistent across hosts
            if val_ds is not None:
                val_loss = compute_val_loss(
                    plan, cfg, taps, state, val_ds, rng_np,
                    cfg.n_val_during_train, repl_sharding=repl_sharding,
                )
                logger.log(total_iters, {"loss/val": val_loss})
                if plateau is not None:
                    new_lr = plateau.step(val_loss)
                    state = state.replace(
                        lr_scale=jnp.asarray(
                            new_lr / cfg.lr, jnp.float32
                        )
                    )
                    if cfg.multihost:
                        # the fresh lr_scale leaf is process-local;
                        # re-replicate so the next step sees one global
                        # state again
                        state = jax.device_put(state, repl_sharding)
                    if pid == 0:
                        import json

                        with open(plateau_path, "w") as f:
                            json.dump(dataclasses.asdict(plateau), f)
                    logger.log(total_iters, {"lr": new_lr})
                if val_loss < best_val:
                    best_val = val_loss
                    if pid == 0:
                        save_pytree(
                            os.path.join(run_dir, "best_val_net_G.npz"),
                            state.params_g,
                        )
                        with open(
                            os.path.join(run_dir, "best_val_loss.txt"), "w"
                        ) as f:
                            f.write(str(best_val))

        if cfg.max_iters and total_iters >= cfg.max_iters:
            stop = True
            break

    if pid == 0:
        save_state_leaves(state_path, state)
        save_pytree(
            os.path.join(run_dir, "latest_net_G.npz"), state.params_g
        )
        save_pytree(
            os.path.join(run_dir, "latest_net_F.npz"), state.params_f
        )
    logger.close()
    train_ds.close()
    if val_ds is not None:
        val_ds.close()
    return state


def build_parser():
    p = argparse.ArgumentParser(description="anatomix contrastive pretraining")
    defaults = PretrainConfig()
    for field in dataclasses.fields(PretrainConfig):
        name = f"--{field.name}"
        default = getattr(defaults, field.name)
        if isinstance(default, bool):
            p.add_argument(name, type=lambda s: s.lower() in
                           ("1", "true", "yes"), default=default)
        elif field.name == "nce_layers":
            p.add_argument(name, type=str, default="27,31,38,45,52,65")
        elif field.name == "nce_weights":
            p.add_argument(name, type=str, default="1")
        else:
            p.add_argument(name, type=type(default) if default is not None
                           else str, default=default)
    return p


def config_from_args(args) -> PretrainConfig:
    kw = vars(args).copy()
    kw["nce_layers"] = tuple(
        int(i) for i in str(kw["nce_layers"]).split(",")
    )
    if str(kw["nce_weights"]) == "1":
        kw["nce_weights"] = None
    else:
        w = [float(i) for i in str(kw["nce_weights"]).split(",")]
        total = sum(w)
        kw["nce_weights"] = tuple(i / total for i in w)
    return PretrainConfig(**kw)


if __name__ == "__main__":
    train(config_from_args(build_parser().parse_args()))
