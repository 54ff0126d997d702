"""Spatial sharding of a single volume with halo exchange between devices.

The volumetric analog of context parallelism (SURVEY.md §5.7): the volume's
leading spatial axis is sharded across the 'space' mesh axis, every conv
exchanges a 1-voxel halo with its mesh neighbours via `ppermute` (reflect /
replicate / zero semantics preserved at the global edges), pools and
upsamples stay shard-local, and skip concats align by construction. The
result is the unsharded network, at 1/n memory per device — how a volume
too large for one card's memory is processed without tiling artifacts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from anatomix_tpu.models.unet import UnetPlan, unet_apply


def halo_pad_d(
    x: jax.Array,  # (B, Dl, H, W, C) local shard
    axis_name: str,
    pad_type: str = "reflect",
) -> jax.Array:
    """Pad the sharded D axis by 1 with neighbor halos (global edges follow
    `pad_type`)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    if n == 1:
        mode = {"reflect": "reflect", "replicate": "edge",
                "zeros": "constant"}[pad_type]
        return jnp.pad(x, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)),
                       mode=mode)

    from_left = jax.lax.ppermute(
        x[:, -1:], axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    from_right = jax.lax.ppermute(
        x[:, :1], axis_name, [(i, i - 1) for i in range(1, n)]
    )
    if pad_type == "reflect":
        edge_left = x[:, 1:2]
        edge_right = x[:, -2:-1]
    elif pad_type == "replicate":
        edge_left = x[:, :1]
        edge_right = x[:, -1:]
    else:  # zeros
        edge_left = jnp.zeros_like(x[:, :1])
        edge_right = jnp.zeros_like(x[:, -1:])

    left = jnp.where(idx == 0, edge_left, from_left)
    right = jnp.where(idx == n - 1, edge_right, from_right)
    return jnp.concatenate([left, x, right], axis=1)


def spatial_sharded_unet(
    plan: UnetPlan,
    params,
    mesh: Mesh,
    *,
    axis: str = "space",
    compute_dtype=None,
):
    """Build a jitted `volume (1, D, H, W, C) -> features` with the D axis
    sharded over `axis`. Requires D divisible by (mesh[axis] · 2^num_downs)
    so pools stay shard-local."""
    n = mesh.shape[axis]
    stride = 2 ** plan.config.num_downs

    def sharded(vol, p):
        return unet_apply(
            plan, p, vol,
            compute_dtype=compute_dtype,
            spatial_axis_name=axis,
        )

    mapped = jax.shard_map(
        sharded,
        mesh=mesh,
        in_specs=(P(None, axis), P()),
        out_specs=P(None, axis),
        check_vma=False,
    )

    @jax.jit
    def run(volume):
        D = volume.shape[1]
        if D % (n * stride):
            raise ValueError(
                f"D={D} must be divisible by space axis ({n}) × "
                f"2^num_downs ({stride})"
            )
        return mapped(volume, params)

    return run


def receptive_field(plan: UnetPlan) -> int:
    """Full-resolution receptive field of the UNet (for slab-halo sizing)."""
    rf = 1
    stride = 1
    for spec in plan.layers:
        if spec.kind == "conv":
            rf += 2 * stride
        elif spec.kind == "pool":
            rf += stride  # window 2
            stride *= 2
        elif spec.kind == "upsample":
            stride = max(stride // 2, 1)
    return rf
