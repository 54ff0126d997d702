"""Parallelism: device meshes, data parallelism, spatial (halo) sharding.

The reference has no distributed code (SURVEY.md §2.6); this module adds
`NamedSharding` data parallelism for training
and window-sharded inference (see `ops/sliding_window.py` /
`pretraining/train_step.py`), plus true spatial sharding of a single giant
volume via `shard_map` + `ppermute` halo exchange — the volumetric analog of
context/sequence parallelism.
"""

from anatomix_tpu.parallel.mesh import (
    data_mesh,
    data_sharding,
    replicate,
    space_mesh,
)
from anatomix_tpu.parallel.multihost import (
    global_batch_from_local,
    global_data_mesh,
    initialize_distributed,
)
from anatomix_tpu.parallel.spatial import (
    halo_pad_d,
    spatial_sharded_unet,
)

__all__ = [
    "data_mesh",
    "data_sharding",
    "global_batch_from_local",
    "global_data_mesh",
    "halo_pad_d",
    "initialize_distributed",
    "replicate",
    "space_mesh",
    "spatial_sharded_unet",
]
