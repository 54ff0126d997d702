"""Tutorial 3 — synthesize training data and pretrain anatomix
(the reference's `generate_training_data.sh` + `scripts/pretrain_anatomix.py`
recipe, end to end at toy scale).

1. Makes a handful of organ "templates" (random blobs as NIfTIs — in the
   real recipe these are TotalSegmentator labelmaps after step0).
2. Runs the synthesis pipeline: label ensembles -> paired GMM+corruption
   views -> HDF5 (anatomix_tpu.synthgen.pipeline, steps 1-3).
3. Runs a short supervised-PatchNCE pretraining smoke
   (`--max_iters`, exactly the reference's smoke-test knob) and resumes
   it once to demonstrate exact-iteration checkpoint resume.

Runs on CPU in ~4 minutes:

    python examples/synthgen_and_pretraining.py
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np


def make_templates(template_dir: str, n: int, size: int, seed: int = 0):
    from anatomix_tpu.synthgen.core import generate_voxel_sphere
    from anatomix_tpu.utils.nifti import save_volume

    rng = np.random.default_rng(seed)
    os.makedirs(template_dir, exist_ok=True)
    for i in range(n):
        radius = int(size * rng.uniform(0.15, 0.3))
        center = rng.integers(radius + 1, size - radius - 1, 3)
        vol = generate_voxel_sphere(
            radius, (size,) * 3, center_shift=center - size // 2
        )
        save_volume(
            os.path.join(template_dir, f"organ{i:02d}.nii.gz"),
            vol.astype(np.float32),
        )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=32,
                    help="synthesized volume sidelength (reference: 128)")
    ap.add_argument("--n-vols", type=int, default=6)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--workdir", type=str, default=None)
    args = ap.parse_args()

    import jax

    print(f"backend: {jax.default_backend()}")
    root = args.workdir or tempfile.mkdtemp(prefix="anatomix_pretrain_")

    # ---- 1+2: synthesize paired training data -> HDF5 -------------------
    from anatomix_tpu.synthgen.pipeline import generate_training_data

    template_dir = os.path.join(root, "templates")
    make_templates(template_dir, n=5, size=args.size)
    train_h5 = generate_training_data(
        template_dir, os.path.join(root, "synth"), args.n_vols,
        val_count=2, sidelen=args.size, seed=0,
    )
    print(f"training data: {train_h5}")

    # ---- 3: pretraining smoke + exact-iteration resume -------------------
    from anatomix_tpu.pretraining.config import PretrainConfig
    from anatomix_tpu.pretraining.train import train

    cfg = PretrainConfig(
        name="pretrain_demo",
        dataroot=os.path.dirname(train_h5),
        ckpt_dir=os.path.join(root, "checkpoints"),
        crop_size=args.size,
        batch_size=1,
        ngf=4,
        num_downs=2,
        netF_nc=16,
        num_patches=32,
        nce_layers=(5, 8),       # taps valid for the 2-down toy net
        max_iters=args.iters,
        print_freq=2,
        save_latest_freq=4,
        evaluation_freq=4,
        n_val_during_train=1,
    )
    state = train(cfg)
    print(f"smoke training done (max_iters={cfg.max_iters})")

    cfg_resume = dataclasses.replace(
        cfg, continue_train=True, max_iters=args.iters * 2
    )
    train(cfg_resume)
    print("resume from latest checkpoint OK")
    print("run dir:", os.path.join(cfg.ckpt_dir, cfg.name))
    print("OK")


if __name__ == "__main__":
    main()
