"""Occupancy pyramid over the voxel grid: the exact tracer's hierarchy.

Counterpart of the pyramid half of ``ray_tracing_octrees_tpu/core/
octree.py`` (``padded_cube_size``, ``OccupancyPyramid``, ``_reduce_level``,
``build_pyramid``). For every level k the pyramid stores, per 2^k-sized
cell, a 2-bit code: 0 all empty, 1 mixed, 2 all solid. With space outside
the grid read as empty (``getVoxelSafe``, OctreeVoxel.cpp:694-702) this
encodes the reference octree losslessly: a node is a leaf iff its cell is
uniform or has size 1 (the ``allSame`` rule of buildOctreeRec,
OctreeVoxel.cpp:724-745).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def padded_cube_size(dim_x: int, dim_y: int, dim_z: int) -> int:
    """Next power of two >= max dim (OctreeVoxel.cpp:768-770)."""
    s = 1
    while s < max(dim_x, dim_y, dim_z):
        s <<= 1
    return s


class OccupancyPyramid:
    """Per-level cell codes, finest (k = 0, the occupancy itself) first.

    ``code_levels[k]`` is uint8 of shape ``ceil(dims / 2^k)`` in (Z, Y, X)
    order, for k = 0 .. L where 2^L is the root size.
    """

    def __init__(self, code_levels: List[torch.Tensor]):
        self.code_levels = list(code_levels)

    @property
    def num_levels(self) -> int:
        return len(self.code_levels)

    @property
    def root_size(self) -> int:
        return 1 << (self.num_levels - 1)

    def level_dims_zyx(self, k: int) -> Tuple[int, int, int]:
        return tuple(self.code_levels[k].shape)

    def cell_code(self, k: int, cx, cy, cz) -> torch.Tensor:
        """2-bit code of level-k cells (int tensors of cell coordinates);
        cells outside the array are uniform-empty (0)."""
        arr = self.code_levels[k]
        dz, dy, dx = arr.shape
        inb = ((cx >= 0) & (cy >= 0) & (cz >= 0)
               & (cx < dx) & (cy < dy) & (cz < dz))
        xc = cx.clamp(0, dx - 1).long()
        yc = cy.clamp(0, dy - 1).long()
        zc = cz.clamp(0, dz - 1).long()
        return torch.where(inb, arr[zc, yc, xc], 0).to(torch.uint8)


def _reduce_level(prev_any: torch.Tensor, prev_all: torch.Tensor):
    """One 2x reduction step with virtual EMPTY padding to even dims."""
    dz, dy, dx = prev_any.shape
    pz, py, px = dz % 2, dy % 2, dx % 2
    if pz or py or px:
        pad = (0, px, 0, py, 0, pz)
        prev_any = F.pad(prev_any, pad, value=False)
        prev_all = F.pad(prev_all, pad, value=False)
    nz, ny, nx = (s // 2 for s in prev_any.shape)
    r_any = prev_any.reshape(nz, 2, ny, 2, nx, 2).any(5).any(3).any(1)
    r_all = prev_all.reshape(nz, 2, ny, 2, nx, 2).all(5).all(3).all(1)
    return r_any, r_all


def build_pyramid(occ: torch.Tensor) -> OccupancyPyramid:
    """The code pyramid of occupancy ``occ`` ([Z, Y, X], nonzero = solid),
    on ``occ``'s device."""
    occ_b = torch.as_tensor(occ) > 0
    dz, dy, dx = occ_b.shape
    num_levels = padded_cube_size(dx, dy, dz).bit_length()
    any_levels, all_levels = [occ_b], [occ_b]
    for _ in range(num_levels - 1):
        a, b = _reduce_level(any_levels[-1], all_levels[-1])
        any_levels.append(a)
        all_levels.append(b)
    return OccupancyPyramid([a.to(torch.uint8) + b.to(torch.uint8)
                             for a, b in zip(any_levels, all_levels)])
