"""Op library (channel-last / NDHWC throughout)."""

from anatomix_tpu.ops.activations import get_activation
from anatomix_tpu.ops.conv import conv3d, pad_same
from anatomix_tpu.ops.grid_sample import grid_sample, identity_grid
from anatomix_tpu.ops.norms import (
    batch_norm_inference,
    batch_norm_train,
    channel_demean,
    channel_layer_norm,
    instance_norm,
)
from anatomix_tpu.ops.pool import avg_pool, avg_pool3d, box_filter, max_pool
from anatomix_tpu.ops.resize import resize3d, upsample2x

__all__ = [
    "avg_pool",
    "avg_pool3d",
    "batch_norm_inference",
    "batch_norm_train",
    "box_filter",
    "channel_demean",
    "channel_layer_norm",
    "conv3d",
    "get_activation",
    "grid_sample",
    "identity_grid",
    "instance_norm",
    "max_pool",
    "pad_same",
    "resize3d",
    "upsample2x",
]
