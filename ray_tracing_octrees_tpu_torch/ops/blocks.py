"""Voxel block ("minecraft-style") exposed-face extraction.

Counterpart of ``ray_tracing_octrees_tpu/ops/blocks.py``, the replacement
for ``VoxelCubeRenderer`` (Renderer.cpp:40-168): every solid leaf of the
octree emits the two triangles of each cube face whose face-centre
neighbour voxel is EMPTY or out of bounds (``addBlockFaces``,
Renderer.cpp:64-99). Vectorized over the linear octree's node arrays;
output rows find their face by a binary search of the inclusive cumsum
of the per-face counts (as ``ops/marching_cubes.py``), so they come out
in the reference package's order with no host sync. An optional
per-node mask folds in frustum culling (renderOctree's margin-50 test,
main.cpp:154-189).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import LinearOctree
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma

# Face order +X, -X, +Y, -Y, +Z, -Z as in addBlockFaces (Renderer.cpp:84-99)
_FACE_NORMALS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32)

# Quad corner selectors (sx, sy, sz): 0 -> minCorner component, 1 -> max.
# Each face lists (v0, v1, v2, v3) as addFace{Pos,Neg}{X,Y,Z}
# (Renderer.cpp:101-156); addQuad(v0, v1, v3, v2) emits the triangles
# (v0, v1, v3) and (v3, v1, v2) (Renderer.cpp:158-168).
_FACE_QUADS = np.array(
    [
        [[1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]],  # +X
        [[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]],  # -X
        [[0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]],  # +Y
        [[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]],  # -Y
        [[0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1]],  # +Z
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],  # -Z
    ],
    np.int32)
# triangles as quad-corner indices: (v0, v1, v3) and (v3, v1, v2)
_TRI_CORNERS = np.array([[0, 1, 3], [3, 1, 2]], np.int32)
# [6, 2, 3, 3] corner selectors per face / triangle / vertex
_FACE_TRIS = _FACE_QUADS[:, _TRI_CORNERS]


@functools.lru_cache(maxsize=None)
def _face_tables(dev: torch.device):
    """(_FACE_TRIS, _FACE_NORMALS) on ``dev``, uploaded once a device."""
    return upload(_FACE_TRIS, dev), upload(_FACE_NORMALS, dev)


def _probe_coords(x0, y0, z0, size):
    """Face-centre neighbour voxel per face ([N] ints -> three [N, 6])."""
    half = size // 2
    px = torch.stack([x0 + size, x0 - 1, x0 + half, x0 + half, x0 + half,
                      x0 + half], -1)
    py = torch.stack([y0 + half, y0 + half, y0 + size, y0 - 1, y0 + half,
                      y0 + half], -1)
    pz = torch.stack([z0 + half, z0 + half, z0 + half, z0 + half, z0 + size,
                      z0 - 1], -1)
    return px, py, pz


def _exposed(grid: VoxelGrid, tree: LinearOctree, node_mask=None):
    """bool[N, 6]: the faces of active solid leaves whose probe voxel is
    EMPTY or out of bounds (checkFace, Renderer.cpp:76-82)."""
    active = tree.is_leaf & tree.is_solid
    if node_mask is not None:
        active = active & torch.as_tensor(node_mask, device=tree.device)
    px, py, pz = _probe_coords(tree.x, tree.y, tree.z, tree.size)
    return (grid.sample_safe(px, py, pz) == 0) & active[:, None]


def extract_block_faces(grid: VoxelGrid, tree: LinearOctree,
                        max_triangles: int,
                        node_mask: Optional[torch.Tensor] = None,
                        device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exposed faces of all solid leaves, on ``device`` (CUDA unless
    ``device="cpu"``; grid and tree are moved there).

    Returns (verts f32[max_triangles, 3, 3], normals f32[max_triangles,
    3], count int32 0-d); rows past count are zero. ``node_mask``
    (bool[N]) restricts emission (frustum culling).
    """
    dev = resolve_device(device)
    grid, tree = grid.to(dev), tree.to(dev)
    exposed = _exposed(grid, tree, node_mask).reshape(-1)     # [N * 6]
    face_counts = exposed.to(torch.int32) * 2
    cap = int(max_triangles)
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    ends = torch.cumsum(face_counts, 0, dtype=torch.int32)     # inclusive
    count = torch.clamp(ends[-1], max=cap)
    valid = j < count
    tri_face = torch.searchsorted(ends, j, right=True).clamp(
        max=face_counts.numel() - 1)
    tri_t = j - (ends[tri_face] - face_counts[tri_face])
    tri_face = torch.where(valid, tri_face, 0)
    tri_t = torch.where(valid, tri_t, 0).long()
    node = tri_face // 6
    face = tri_face - node * 6

    # corners: minCorner = origin + (x0, y0, z0) * vs; ext = size * vs
    f32 = torch.float32
    xyz0 = torch.stack([tree.x[node], tree.y[node], tree.z[node]], -1).to(f32)
    min_c = _fma(xyz0, grid.voxel_size, grid.origin[None, :])        # [T, 3]
    ext = tree.size[node].to(f32)[:, None] * grid.voxel_size
    face_tris, face_normals = _face_tables(dev)
    sel = face_tris[face, tri_t]                                 # [T, 3, 3]
    verts = _fma(sel.to(f32), ext[:, None, :], min_c[:, None, :])
    normals = face_normals[face]
    verts = torch.where(valid[:, None, None], verts, 0.0)
    normals = torch.where(valid[:, None], normals, 0.0)
    return verts, normals, count


def count_block_triangles(grid: VoxelGrid, tree: LinearOctree) -> torch.Tensor:
    """Triangle count for capacity sizing, 2 per exposed face (int64 0-d
    tensor on the tree's device)."""
    return 2 * _exposed(grid.to(tree.device), tree).sum()
