"""Device-mesh helpers (L6).

The reference's 'distributed backend' is a single-host ROS topic bus
(SURVEY.md section 5.8); here the transport is the device interconnect:
a 1-D ``jax.sharding.Mesh`` over the GPUs, XLA collectives (NCCL over
NVLink) via ``shard_map``. Multi-host initialization goes through
``jax.distributed.initialize`` (no-op on a single process).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D mesh over the first n devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def initialize_multihost(**kwargs) -> None:
    """Multi-host bring-up; safe no-op when unconfigured (single process)."""
    import os

    if "JAX_COORDINATOR_ADDRESS" in os.environ or kwargs:
        jax.distributed.initialize(**kwargs)
