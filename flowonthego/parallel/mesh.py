"""Device-mesh helpers for frame-batch ('data') x spatial-tile ('space')
parallelism.

The reference is single-GPU (SURVEY.md §2.4: no distributed component);
this axis layout splits the embarrassingly parallel frame axis
(no communication) from the halo-coupled spatial axis (row strips
exchanging boundary rows).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SPACE_AXIS = "space"


def make_mesh(n_data: int | None = None, n_space: int = 1,
              devices=None) -> Mesh:
    """Create a [data, space] mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data * n_space != len(devices):
        raise ValueError(f"{n_data}x{n_space} mesh != {len(devices)} devices")
    arr = np.asarray(devices).reshape(n_data, n_space)
    return Mesh(arr, (DATA_AXIS, SPACE_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading frame-batch axis over 'data'."""
    return NamedSharding(mesh, P(DATA_AXIS))


def batch_space_sharding(mesh: Mesh) -> NamedSharding:
    """Shard [batch, H, ...] over ('data', 'space')."""
    return NamedSharding(mesh, P(DATA_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
