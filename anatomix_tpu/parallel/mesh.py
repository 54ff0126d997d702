"""Mesh construction helpers.

The cards of one host are joined all to all (NVLink), so a mesh follows
the algorithm alone: 'data' for batch or window parallelism, 'space' for a
volume sharded along its leading axis.
"""

from __future__ import annotations

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(devices=None, n: int | None = None) -> Mesh:
    """1-D 'data' mesh over (a prefix of) the local devices."""
    import jax

    devices = list(devices if devices is not None else jax.devices())
    if n:
        devices = devices[:n]
    return Mesh(np.array(devices), ("data",))


def space_mesh(devices=None, data: int = 1, space: int | None = None) -> Mesh:
    """2-D ('data', 'space') mesh: batch DP × spatial sharding."""
    import jax

    devices = list(devices if devices is not None else jax.devices())
    if space is None:
        space = len(devices) // data
    devices = devices[: data * space]
    return Mesh(
        np.array(devices).reshape(data, space), ("data", "space")
    )


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
