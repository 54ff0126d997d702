"""Tutorial 1 — 3D feature extraction & training-free multimodal
registration (mirrors the reference Colab tutorial linked from
`/root/reference/README.md:10`).

Builds a synthetic "multimodal" pair the same way the anatomix
pretraining data is made — one shared anatomy (labelmap), two different
GMM appearance draws — deforms one of them with a known smooth warp,
then registers them with anatomix features + MIND through the
ConvexAdam-style solver and reports label Dice before/after.

Runs on CPU in ~2 minutes with the default tiny random-init backbone:

    python examples/feature_extraction_and_registration.py

Use real pretrained weights (converted once with
`python -m anatomix_tpu.models.convert_cli anatomix.pth anatomix.npz`):

    python examples/feature_extraction_and_registration.py \
        --ckpt anatomix.npz --size 128
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp


def build_pair(size: int, seed: int = 0):
    """Shared anatomy, two GMM appearances, one known smooth deformation."""
    from anatomix_tpu.synthgen.core import (
        draw_perlin_deformation,
        generate_voxel_sphere,
        sample_gmm,
    )

    rng = np.random.default_rng(seed)
    labels = np.zeros((size,) * 3, np.uint8)
    n_blobs = 6
    for k in range(1, n_blobs + 1):
        radius = int(size * rng.uniform(0.08, 0.18))
        center = rng.integers(radius + 2, size - radius - 2, 3)
        sphere = generate_voxel_sphere(
            radius, (size,) * 3,
            center_shift=center - size // 2,
        )
        labels[sphere > 0] = k

    # two appearances of the same anatomy = a synthetic multimodal pair
    n_lab = len(np.unique(labels))
    view1 = sample_gmm(rng.uniform(25, 255, n_lab), rng.uniform(5, 20, n_lab),
                       labels, zero_bckgnd=0.0, rng=rng)
    view2 = sample_gmm(rng.uniform(25, 255, n_lab), rng.uniform(5, 20, n_lab),
                       labels, zero_bckgnd=0.0, rng=rng)

    # known smooth deformation of view2 + its labels = the "moving" image
    field = draw_perlin_deformation(
        (3, size, size, size), scales=[size // 8, size // 4],
        max_std=2.5, rng=rng,
    )  # (3, D, H, W) iid components, voxel units
    disp = np.moveaxis(field, 0, -1)  # (D, H, W, 3) -> (dH, dW, dD)
    from anatomix_tpu.registration.warp import warp_volume

    disp_j = jnp.asarray(disp, jnp.float32)[None]
    moving = np.asarray(
        warp_volume(
            jnp.asarray(view2, jnp.float32)[None, ..., None], disp_j
        )[0, ..., 0]
    )
    moving_seg = np.asarray(
        warp_volume(
            jnp.asarray(labels, jnp.float32)[None, ..., None], disp_j,
            mode="nearest",
        )[0, ..., 0]
    ).astype(np.uint8)
    return view1.astype(np.float32), labels, moving, moving_seg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default=None,
                    help=".npz checkpoint from convert_cli")
    ap.add_argument("--hf-variant", type=str, default=None)
    ap.add_argument("--ngf", type=int, default=4,
                    help="width of the random-init demo backbone")
    ap.add_argument("--num-downs", type=int, default=2)
    ap.add_argument("--niter", type=int, default=30,
                    help="Adam instance-opt iterations (reference: 80)")
    args = ap.parse_args()

    print(f"backend: {jax.default_backend()}")
    fixed, fixed_seg, moving, moving_seg = build_pair(args.size)
    print(f"synthetic pair built: {fixed.shape}, "
          f"{int(fixed_seg.max())} labels")

    # ---- model ----------------------------------------------------------
    if args.ckpt or args.hf_variant:
        from anatomix_tpu.models.load import load_model

        plan, params = load_model(
            ckpt_path=args.ckpt, hf_variant=args.hf_variant
        )
    else:
        from anatomix_tpu.models.unet import (
            UnetConfig, build_plan, init_params,
        )

        plan = build_plan(UnetConfig(
            dimension=3, input_nc=1, output_nc=args.ngf,
            num_downs=args.num_downs, ngf=args.ngf,
        ))
        params = init_params(plan, jax.random.PRNGKey(0))
        print("using a RANDOM-INIT demo backbone — pass --ckpt for real "
              "anatomix features")

    # ---- feature extraction (standalone, tutorial part 1) ---------------
    from anatomix_tpu.extract import extract_features

    roi = min(args.size, 128)
    feats_fixed, feats_moving = extract_features(
        fixed, moving, plan, params,
        strategy="auto", roi_size=(roi,) * 3,
        compute_dtype=jnp.float32,
    )
    print(f"features: {feats_fixed.shape} "
          f"(voxel-wise {feats_fixed.shape[-1]}-d descriptors)")

    # ---- registration (tutorial part 2) ----------------------------------
    from anatomix_tpu.registration.pipeline import macro_dice, register_pair
    from anatomix_tpu.registration.warp import warp_volume

    t0 = time.time()
    disp, solver_s = register_pair(
        fixed, moving, plan, params,
        grid_sp=2, disp_hw=1, selected_niter=args.niter,
        grid_sp_adam=2, ic=True, extract_strategy="auto",
        compute_dtype=jnp.float32,
    )
    print(f"registration done in {time.time() - t0:.1f}s wall "
          f"(solver {solver_s:.2f}s)")

    moved_seg = np.asarray(
        warp_volume(
            jnp.asarray(moving_seg, jnp.float32)[None, ..., None],
            disp, mode="nearest",
        )[0, ..., 0]
    ).astype(np.uint8)

    d_before = macro_dice(fixed_seg, moving_seg)
    d_after = macro_dice(fixed_seg, moved_seg)
    print(f"label Dice before: {d_before:.3f}  after: {d_after:.3f}")
    assert d_after > d_before, "registration should improve alignment"
    print("OK")


if __name__ == "__main__":
    main()
