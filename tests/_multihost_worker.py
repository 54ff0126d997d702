"""Subprocess worker for the multi-host trainer test.

Launched once per simulated host with JAX_COORDINATOR_ADDRESS /
JAX_NUM_PROCESSES / JAX_PROCESS_ID set; forces a virtual-CPU platform with
4/nproc local devices so the GLOBAL device count is 4 regardless of the
process count (same global mesh, same global batch -> the loss must match
across process counts).
"""

import os
import sys


def main():
    nproc = int(os.environ["JAX_NUM_PROCESSES"])
    dataroot, ckpt_dir, name = sys.argv[1:4]
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={4 // nproc}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from anatomix_tpu.pretraining.config import PretrainConfig
    from anatomix_tpu.pretraining.train import train

    cfg = PretrainConfig(
        name=name, ckpt_dir=ckpt_dir, dataroot=dataroot,
        ndims=3, input_nc=1, output_nc=4, ngf=4, num_downs=2,
        nce_layers=(11, 33), netF_nc=16, n_mlps=2, num_patches=16,
        crop_size=16, batch_size=4, n_epochs=2, n_epochs_decay=0,
        print_freq=1, save_latest_freq=100,
        # evaluation_freq=2 with max_iters=2: the val + plateau
        # re-replication path runs exactly once (ADVICE r3: it was never
        # exercised — global-mesh state × host-local val inputs in one
        # jit raises in real multi-controller runs)
        evaluation_freq=2, lr_policy="plateau", n_val_during_train=2,
        max_iters=2, multihost=True,
    )
    train(cfg)
    print(f"WORKER_DONE pid={jax.process_index()}/{jax.process_count()}",
          flush=True)


if __name__ == "__main__":
    main()
