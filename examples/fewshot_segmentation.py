"""Tutorial 2 — finetune anatomix for 3D few-shot semantic segmentation
(mirrors the reference Colab tutorial linked from
`/root/reference/README.md:11`).

Generates a tiny synthetic labelled dataset (GMM appearances over
sphere-blob anatomies, the same recipe as the pretraining data), lays it
out as `imagesTr/labelsTr/imagesVal/labelsVal` NIfTIs, then runs the
few-shot finetuning loop (`anatomix_tpu.segmentation.train`) with a fresh
1x1x1 output head and sliding-window Dice validation.

Runs on CPU in ~3 minutes with a tiny scratch backbone:

    python examples/fewshot_segmentation.py

With real pretrained weights:

    python examples/fewshot_segmentation.py --ckpt anatomix.npz \
        --ngf 16 --num-downs 4 --crop 96
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def make_dataset(root: str, n_train: int, n_val: int, size: int,
                 n_classes: int, seed: int = 0):
    from anatomix_tpu.synthgen.core import generate_voxel_sphere, sample_gmm
    from anatomix_tpu.utils.nifti import save_volume

    rng = np.random.default_rng(seed)
    for split, n in (("Tr", n_train), ("Val", n_val)):
        os.makedirs(os.path.join(root, f"images{split}"), exist_ok=True)
        os.makedirs(os.path.join(root, f"labels{split}"), exist_ok=True)
        for i in range(n):
            labels = np.zeros((size,) * 3, np.uint8)
            for k in range(1, n_classes + 1):
                radius = int(size * rng.uniform(0.10, 0.20))
                center = rng.integers(radius + 2, size - radius - 2, 3)
                sphere = generate_voxel_sphere(
                    radius, (size,) * 3, center_shift=center - size // 2
                )
                labels[sphere > 0] = k
            n_lab = len(np.unique(labels))
            img = sample_gmm(
                rng.uniform(25, 255, n_lab), rng.uniform(5, 20, n_lab),
                labels, zero_bckgnd=0.0, rng=rng,
            )
            save_volume(
                os.path.join(root, f"images{split}", f"case{i:03d}.nii.gz"),
                img.astype(np.float32),
            )
            save_volume(
                os.path.join(root, f"labels{split}", f"case{i:03d}.nii.gz"),
                labels.astype(np.float32),
            )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--crop", type=int, default=32)
    ap.add_argument("--n-classes", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--ckpt", type=str, default="scratch",
                    help=".npz/.pth checkpoint, or 'scratch'")
    ap.add_argument("--ngf", type=int, default=4)
    ap.add_argument("--num-downs", type=int, default=2)
    ap.add_argument("--workdir", type=str, default=None)
    args = ap.parse_args()

    import jax

    print(f"backend: {jax.default_backend()}")

    root = args.workdir or tempfile.mkdtemp(prefix="anatomix_fewshot_")
    data_dir = os.path.join(root, "dataset")
    make_dataset(data_dir, n_train=4, n_val=2, size=args.size,
                 n_classes=args.n_classes)
    print(f"synthetic few-shot dataset at {data_dir}")

    from anatomix_tpu.segmentation.train import build_parser, main as seg_main

    os.chdir(root)  # run dirs (finetuning_runs/...) land in the workdir
    opt = build_parser().parse_args([
        "--exp_name", "fewshot_demo",
        "--dataset", data_dir,
        "--n_classes", str(args.n_classes),
        "--pretrained_ckpt", args.ckpt,
        "--crop_size", str(args.crop),
        "--batch_size", "2",
        "--n_epochs", str(args.epochs),
        "--val_interval", "1",
        "--train_amount", "3",
        "--n_iters_per_epoch", "8",
        "--num_downs", str(args.num_downs),
        "--ngf", str(args.ngf),
        "--output_nc", str(args.ngf),
    ])
    seg_main(opt)
    print("checkpoints in", os.path.join(root, "finetuning_runs"))
    print("OK")


if __name__ == "__main__":
    main()
