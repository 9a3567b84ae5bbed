"""Device-mesh construction for particle-sharded runs.

The reference's distributed axis is MPI data decomposition over particles
(ver5_all/GSimulation.cpp:93-115).  The equivalent here is a 1-D
``jax.sharding.Mesh`` over the particle axis.  The mesh follows the
algorithm: the cards of a GPU host are joined all to all, so no device
order is preferred."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

AXIS = "shard"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))
