"""Scene state across the two packages.

This system has no weights: what crosses between the JAX reference and
the port is the scene, an occupancy grid with its world placement. These
helpers move it through numpy, which both packages read.
"""

from __future__ import annotations

import numpy as np

from ray_tracing_octrees_tpu_torch._device import DeviceLike
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid


def grid_from_numpy(occ, origin, voxel_size,
                    device: DeviceLike = None) -> VoxelGrid:
    """VoxelGrid on ``device`` from numpy ``occ`` (uint8[Z, Y, X]),
    ``origin`` (3 floats) and ``voxel_size``."""
    return VoxelGrid.create(np.asarray(occ, np.uint8), origin=origin,
                            voxel_size=voxel_size, device=device)


def grid_to_numpy(grid: VoxelGrid):
    """(occ uint8[Z, Y, X], origin f32[3], voxel_size f32) as numpy."""
    return (grid.occ.cpu().numpy().astype(np.uint8),
            grid.origin.cpu().numpy().astype(np.float32),
            np.float32(grid.voxel_size.cpu()))
