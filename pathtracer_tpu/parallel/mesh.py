"""Device mesh construction and sharding specs.

The reference has no distributed tier (single WebGPU device, SURVEY.md §2.4).
This module supplies the scaling story: a 1-D ``rays`` mesh axis over all
devices. Rays (pixels x samples) shard across it; the scene/BVH
replicates; images and scene-parameter gradients reduce with ``psum``.
The axis follows the algorithm alone: every card of a host reaches every
other at the same rate, so no shape is taken from the interconnect.
Multi-host extends the same mesh via ``jax.distributed``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    """1-D mesh over all (or given) devices; rays shard along it."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a leading ray/pixel axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding for replicated state (scene, BVH, materials)."""
    return NamedSharding(mesh, P())
