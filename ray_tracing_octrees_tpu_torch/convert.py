"""Scene state across the two packages.

This system has no weights: what crosses between the JAX reference and
the port is the scene, an occupancy grid with its world placement, and
the structures built from it, such as the occupancy pyramid. These
helpers move them through numpy, which both packages read.
"""

from __future__ import annotations

import numpy as np

import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import OccupancyPyramid


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


def pyramid_from_numpy(code_levels,
                       device: DeviceLike = None) -> OccupancyPyramid:
    """OccupancyPyramid on ``device`` from the per-level uint8 code arrays
    (finest first), e.g. the JAX ``OccupancyPyramid.code_levels``."""
    dev = resolve_device(device)
    return OccupancyPyramid([
        torch.as_tensor(np.array(c, np.uint8), device=dev)
        for c in code_levels])


def pyramid_to_numpy(pyramid: OccupancyPyramid):
    """The per-level uint8 code arrays (finest first) as numpy."""
    return [c.cpu().numpy().astype(np.uint8) for c in pyramid.code_levels]
