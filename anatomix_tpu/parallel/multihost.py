"""Multi-host (multi-slice) scale-out utilities.

The reference is strictly single-process / single-GPU: its DataParallel
path is vestigial and never active (reference
`pretraining/models/pretraining_networks.py:752-760`,
`pretraining/models/base_model.py:146-157`; SURVEY §2.6), and there is no
torch.distributed / NCCL / MPI anywhere. Multi-host data parallelism is
therefore new design surface (SURVEY §5.8): each host feeds the shard of
the global batch that lives on its local devices, and XLA all-reduces the
gradients over every device (NCCL on GPUs).

Usage (one process per host, each told the coordinator's address, the
process count and its own index):

    from anatomix_tpu.parallel import multihost
    multihost.initialize_distributed()          # no-op when single-process
    mesh = multihost.global_data_mesh()         # 1-D 'data' over ALL devices
    batch = multihost.global_batch_from_local(mesh, local_batch_tree)

The resulting `jax.Array`s are valid inputs to the mesh-sharded train step
(`pretraining/train_step.py` with `in_shardings=P('data')`).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize `jax.distributed` for a multi-host run.

    Arguments fall back to the standard env vars
    (`JAX_COORDINATOR_ADDRESS`, `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`).
    Returns True if a multi-process runtime was initialized, False for the
    single-process no-op (so callers can gate without try/except).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None
    )
    env_pid = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(env_pid) if env_pid else None
    )
    if coordinator_address is None and num_processes is None:
        return False  # single process: nothing to join
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def global_data_mesh(devices=None) -> Mesh:
    """1-D 'data' mesh over all global devices, slice-contiguous.

    `jax.devices()` orders devices by process, so within-slice neighbors
    stay adjacent on the mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), ("data",))


def global_batch_from_local(mesh: Mesh, local_tree, spec: P = P("data")):
    """Assemble global batch-sharded `jax.Array`s from per-process data.

    `local_tree` holds each process's contiguous slice of the global batch
    (host numpy or device arrays); the global batch dimension is
    `process_count * local_batch`. Single-process this degrades to a plain
    sharded `device_put`, so the same code path runs everywhere.
    """
    sharding = NamedSharding(mesh, spec)

    def one(x):
        x = np.asarray(x)
        return jax.make_array_from_process_local_data(sharding, x)

    return jax.tree.map(one, local_tree)


def fold_in_process(key: jax.Array) -> jax.Array:
    """Give each host an independent PRNG stream (augmentations must differ
    across the hosts' batch shards)."""
    return jax.random.fold_in(key, jax.process_index())
