"""Mesh-extraction pipelines: Marching Cubes and Voxel Blocks.

Counterpart of ``ray_tracing_octrees_tpu/models/extraction.py``: the
model-level equivalents of ``MarchingCubesRenderer`` (Renderer.cpp:14-36)
and ``VoxelCubeRenderer`` (Renderer.cpp:40-168) driven by
``renderOctree`` (main.cpp:95-208): extraction with optional frustum
culling, returning a bounded triangle soup (verts, normals, count) on the
renderer's device (CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import LinearOctree
from ray_tracing_octrees_tpu_torch.ops.blocks import (
    count_block_triangles, extract_block_faces,
)
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
    count_mc_triangles, marching_cubes_grid,
)
from ray_tracing_octrees_tpu_torch.render.frustum import (
    visible_cell_mask, visible_node_mask,
)


@dataclasses.dataclass
class MarchingCubesRenderer:
    """Dense table-driven MC with cell-level frustum culling.

    The reference culls octree subtrees at margin 50, then runs localMC
    per leaf (main.cpp:154-189); culling cells is the array equivalent
    and conservative (a superset of the surviving cells never drops
    visible geometry).
    """

    config: EngineConfig = DEFAULT_CONFIG
    device: DeviceLike = None

    def render(self, grid: VoxelGrid, view_proj=None):
        dev = resolve_device(self.device)
        grid = grid.to(dev)
        mask = None
        if view_proj is not None:
            mask = visible_cell_mask(
                grid.occ.shape, grid.origin, grid.voxel_size, view_proj,
                self.config.extraction_frustum_margin, device=dev)
        return marching_cubes_grid(grid, self.config.max_triangles,
                                   cell_mask=mask, device=dev)

    def count(self, grid: VoxelGrid):
        return count_mc_triangles(grid.to(resolve_device(self.device)))


@dataclasses.dataclass
class VoxelBlockRenderer:
    """Exposed-face extraction over solid octree leaves with node
    culling."""

    config: EngineConfig = DEFAULT_CONFIG
    device: DeviceLike = None

    def render(self, grid: VoxelGrid, tree: LinearOctree, view_proj=None):
        dev = resolve_device(self.device)
        grid, tree = grid.to(dev), tree.to(dev)
        mask = None
        if view_proj is not None:
            mask = visible_node_mask(tree, grid.origin, grid.voxel_size,
                                     view_proj,
                                     self.config.extraction_frustum_margin)
        return extract_block_faces(grid, tree, self.config.max_triangles,
                                   node_mask=mask, device=dev)

    def count(self, grid: VoxelGrid, tree: LinearOctree):
        dev = resolve_device(self.device)
        return count_block_triangles(grid.to(dev), tree.to(dev))
