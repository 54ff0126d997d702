"""Supervised PatchNCE contrastive pretraining.

Rebuilds the reference's `pretraining/` stack (CUT-lineage SupCLModel,
`/root/reference/pretraining/models/supcl_model.py`) as functional JAX:
static-width projector MLPs (no data-dependent init dance), a pure jitted
train step, data-parallel batches over a device mesh, Orbax checkpointing.
"""

from anatomix_tpu.pretraining.losses import sup_patch_nce_loss
from anatomix_tpu.pretraining.patch_sample import (
    apply_patch_mlp,
    init_patch_mlps,
    sample_patch_coords,
)
from anatomix_tpu.pretraining.train_step import (
    TrainState,
    build_train_step,
    init_train_state,
)

__all__ = [
    "TrainState",
    "apply_patch_mlp",
    "build_train_step",
    "init_patch_mlps",
    "init_train_state",
    "sample_patch_coords",
    "sup_patch_nce_loss",
]
