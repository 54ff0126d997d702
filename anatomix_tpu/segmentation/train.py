"""Few-shot segmentation finetuning loop + CLI.

Replaces `train_segmentation.py` (`/root/reference/anatomix/segmentation/
train_segmentation.py:28-357`): DiceCE train loss, Dice validation via
sliding-window inference (crop³ windows, overlap 0.7, sw_batch 4),
Adam(lr, wd=0) + cosine annealing stepped per epoch, best-val + periodic
full-state checkpoints, TensorBoard/JSONL scalars.

Design: the whole train step (forward with train-mode batch norm,
DiceCE, grads, Adam update, BN stat merge) is one jitted program; data
parallelism over a mesh arrives by sharding the batch.
"""

from __future__ import annotations

import argparse
import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from anatomix_tpu.ops.sliding_window import sliding_window_inference
from anatomix_tpu.segmentation.data import VolumeCache, data_handler
from anatomix_tpu.segmentation.losses import dice_ce_loss, dice_loss
from anatomix_tpu.segmentation.model import load_seg_model, seg_forward
from anatomix_tpu.segmentation.transforms import train_transform, val_transform
from anatomix_tpu.utils.checkpoint import save_pytree
from anatomix_tpu.utils.logging import ScalarLogger


def cosine_annealing(lr0: float, n_epochs: int, steps_per_epoch: int):
    """torch CosineAnnealingLR(T_max=n_epochs) stepped per epoch."""

    def schedule(step):
        epoch = step // steps_per_epoch
        return lr0 * (1 + jnp.cos(jnp.pi * epoch / n_epochs)) / 2.0

    return schedule


def build_seg_train_step(plan, tx, *, compute_dtype=None):
    @jax.jit
    def step(params, opt_state, images, labels):
        def loss_fn(p):
            logits, new_stats = seg_forward(
                plan, p, images, train=True, compute_dtype=compute_dtype
            )
            return dice_ce_loss(logits, labels), new_stats

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        backbone = dict(params["backbone"])
        for idx, (mean, var) in new_stats.items():
            backbone[idx] = {**backbone[idx], "mean": mean, "var": var}
        return {**params, "backbone": backbone}, opt_state, loss

    return step


def validate(plan, params, val_images, val_labels, cache, crop_size,
             n_classes, compute_dtype=None):
    """Sliding-window Dice validation (`train_segmentation.py:183-224`)."""

    def window_fn(w):
        return seg_forward(plan, params, w, compute_dtype=compute_dtype)

    losses = []
    for img_path, seg_path in zip(val_images, val_labels):
        img = val_transform(jnp.asarray(cache.get(img_path)))
        lab = jnp.asarray(cache.get(seg_path))
        logits = sliding_window_inference(
            img[None, ..., None],
            window_fn,
            n_classes + 1,
            roi_size=(crop_size,) * 3,
            sw_batch_size=4,
            overlap=0.7,
            mode="constant",
        )
        losses.append(float(dice_loss(logits, lab[None])))
    return float(np.mean(losses)) if losses else float("nan")


def main(opt):
    ckpt_dir = os.path.join(
        "finetuning_runs", "checkpoints", opt.exp_name
    )
    run_dir = os.path.join("finetuning_runs", "runs", opt.exp_name)
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = ScalarLogger(run_dir)

    trimages, trsegs, vaimages, vasegs = data_handler(
        opt.dataset, opt.train_amount, opt.n_iters_per_epoch,
        opt.batch_size,
    )
    print(f"Training cache: {len(trimages)} images {len(trsegs)} segs")
    print(f"Validation set: {len(vaimages)} images {len(vasegs)} segs")

    plan, params = load_seg_model(
        opt.n_classes,
        ckpt_path=opt.pretrained_ckpt,
        hf_variant=opt.hf_variant,
        num_downs=opt.num_downs, ngf=opt.ngf, output_nc=opt.output_nc,
        norm=opt.norm, interp=opt.interp, pooling=opt.pooling,
    )
    params = jax.tree_util.tree_map(jnp.asarray, params)

    steps_per_epoch = max(len(trimages) // opt.batch_size, 1)
    schedule = cosine_annealing(opt.lr, opt.n_epochs, steps_per_epoch)
    tx = optax.adam(schedule)
    opt_state = tx.init(params)
    train_step = build_seg_train_step(plan, tx)

    cache = VolumeCache()
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    best_val_loss = float("inf")
    best_loss_epoch = -1
    global_step = 0

    for epoch in range(opt.n_epochs):
        print("-" * 10)
        print(f"epoch {epoch + 1:04d}/{opt.n_epochs:04d}")
        order = rng.permutation(len(trimages))
        epoch_loss, steps = 0.0, 0
        for start in range(0, steps_per_epoch * opt.batch_size,
                           opt.batch_size):
            idxs = order[start: start + opt.batch_size]
            if len(idxs) < opt.batch_size:
                break
            imgs, labs = [], []
            for i in idxs:
                key, sub = jax.random.split(key)
                img = jnp.asarray(cache.get(trimages[i]))
                lab = jnp.asarray(cache.get(trsegs[i]))
                im, lb = train_transform(sub, img, lab, opt.crop_size)
                imgs.append(im)
                labs.append(lb)
            batch_img = jnp.stack(imgs)[..., None]
            batch_lab = jnp.stack(labs).astype(jnp.int32)
            params, opt_state, loss = train_step(
                params, opt_state, batch_img, batch_lab
            )
            loss = float(loss)
            epoch_loss += loss
            steps += 1
            global_step += 1
            logger.log(global_step, {"train_loss": loss})
        epoch_loss /= max(steps, 1)
        print(f"epoch {epoch + 1} average loss: {epoch_loss:.4f}")

        if (epoch + 1) % opt.val_interval == 0:
            # mid-slice panels (the reference's plot_2d_or_3d_image role)
            from anatomix_tpu.utils.visualization import log_panels

            preds = jnp.argmax(
                seg_forward(plan, params, batch_img), axis=-1
            ).astype(jnp.float32)
            log_panels(
                logger, "train/panels",
                {
                    "image": np.asarray(batch_img[0, ..., 0]),
                    "label": np.asarray(batch_lab[0])
                    / (opt.n_classes + 1.0),
                    "output": np.asarray(preds[0]) / (opt.n_classes + 1.0),
                },
                epoch + 1,
            )
            val_loss = validate(
                plan, params, vaimages, vasegs, cache, opt.crop_size,
                opt.n_classes,
            )
            logger.log(epoch + 1, {"val_loss_mean_dice": val_loss})
            if val_loss < best_val_loss:
                best_val_loss = val_loss
                best_loss_epoch = epoch + 1
                save_pytree(
                    os.path.join(
                        ckpt_dir, f"best_dict_epoch{epoch + 1:04d}.npz"
                    ),
                    params,
                )
                print("saved new best loss model")
            print(
                f"current epoch: {epoch + 1} current mean dice: "
                f"{val_loss:.4f} best mean dice: {best_val_loss:.4f} "
                f"at epoch {best_loss_epoch}"
            )
            save_pytree(
                os.path.join(ckpt_dir, f"epoch{epoch + 1:04d}.npz"),
                {"params": params, "opt_state": opt_state,
                 "epoch": np.asarray(epoch + 1)},
            )
    logger.close()
    return params


def build_parser():
    p = argparse.ArgumentParser(description="Few-shot segmentation finetune")
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("--dataset", type=str, required=True,
                   help="dir with imagesTr/labelsTr/imagesVal/labelsVal")
    p.add_argument("--n_classes", type=int, required=True,
                   help="number of foreground classes")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--pretrained_ckpt", type=str, default=None,
                     help=".pth/.npz checkpoint or 'scratch'")
    src.add_argument("--hf_variant", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--n_epochs", type=int, default=500)
    p.add_argument("--val_interval", type=int, default=10)
    p.add_argument("--train_amount", type=int, default=3)
    p.add_argument("--n_iters_per_epoch", type=int, default=75)
    p.add_argument("--num_downs", type=int, default=4)
    p.add_argument("--ngf", type=int, default=16)
    p.add_argument("--output_nc", type=int, default=16)
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--interp", type=str, default="nearest")
    p.add_argument("--pooling", type=str, default="Max")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
