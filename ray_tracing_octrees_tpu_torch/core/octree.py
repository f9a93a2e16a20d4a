"""Occupancy pyramid over the voxel grid: the exact tracer's hierarchy.

Counterpart of the pyramid half of ``ray_tracing_octrees_tpu/core/
octree.py`` (``padded_cube_size``, ``OccupancyPyramid``, ``_reduce_level``,
``build_pyramid``, ``build_leaf_volume``, ``decode_skip_radius``). The
linear (BFS node array) octree is not ported yet. For every level k the
pyramid stores, per 2^k-sized
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


def _upsample(a: torch.Tensor, f: int) -> torch.Tensor:
    """Nearest upsample by ``f`` along all three axes."""
    for ax in range(3):
        a = a.repeat_interleave(f, dim=ax)
    return a


def _dilate3(a: torch.Tensor) -> torch.Tensor:
    """3x3x3 OR-dilation of a bool volume (cells past the edges read
    False)."""
    return F.max_pool3d(a.to(torch.float32)[None, None], 3, stride=1,
                        padding=1)[0, 0] > 0


def _cube(code: torch.Tensor, sk: int) -> torch.Tensor:
    """A level's codes zero-padded (uniform-empty) to the (sk)^3 cube."""
    out = torch.zeros((sk, sk, sk), dtype=code.dtype, device=code.device)
    dz, dy, dx = code.shape
    out[:dz, :dy, :dx] = code
    return out


def build_leaf_volume(pyramid: OccupancyPyramid,
                      skip_radius_cap: int = 7) -> torch.Tensor:
    """Per-voxel packed leaf descriptor over the full 2^L root cube, on the
    pyramid's device.

    u8[S, S, S] with, for the voxel v:

      bit  0    : solid (occupancy),
      bits 1..4 : leaf level, the largest pyramid level whose cell holding
                  v is uniform (cells outside the grid read uniform-empty):
                  the level ``trace_octree``'s root-to-voxel descent finds,
      bits 5..7 : empty-skip radius code c, decoded r = c for c <= 3
                  (exact Chebyshev distances) and r = 2^(c-1) for c in
                  4..7 (8/16/32/64, from coarse pyramid neighbourhoods):
                  the box [v - r, v + r + 1) holds no solid voxel; 0 for
                  solid voxels (:func:`decode_skip_radius`).

    One lookup of this volume replaces the per-level descent in
    ``trace/octree_trace.py::trace_octree_fast``.
    """
    top = pyramid.num_levels - 1
    S = pyramid.root_size
    u8 = torch.uint8

    # topmost uniform level per voxel, coarse to fine, each level's state
    # upsampled by 2 before the next
    code_c = _cube(pyramid.code_levels[top], S >> top)
    uni = code_c != 1
    level = torch.where(uni, top, 0).to(u8)
    solid = uni & (code_c == 2)
    found = uni
    for k in range(top - 1, -1, -1):
        level, solid, found = (_upsample(x, 2) for x in (level, solid, found))
        code_c = _cube(pyramid.code_levels[k], S >> k)
        uni = code_c != 1
        take = uni & ~found
        level = torch.where(take, k, level.to(torch.int32)).to(u8)
        solid = torch.where(take, code_c == 2, solid)
        found = found | uni

    # codes 1..3 (exact): after i 3^3 dilations of the solid mask, dil is
    # "some solid voxel within Chebyshev distance i"
    dil = solid
    radius = torch.zeros(solid.shape, dtype=u8, device=solid.device)
    for _ in range(min(int(skip_radius_cap), 3)):
        dil = _dilate3(dil)
        radius = radius + (~dil).to(u8)
    # codes 4..7 (r = 2^(c-1)): no solid in the 3^3 block of level-k cells
    # (k = c - 1) around v's cell makes r = 2^k safe for every v in the
    # centre cell; monotone in c, so the largest qualified code wins
    if int(skip_radius_cap) > 3:
        for c in range(4, min(int(skip_radius_cap), 7) + 1):
            k = c - 1
            if k > top:
                break
            q = ~_dilate3(_cube(pyramid.code_levels[k], S >> k) != 0)
            radius = torch.where(_upsample(q, 1 << k), c,
                                 radius.to(torch.int32)).to(u8)
    radius = torch.where(solid, 0, radius.to(torch.int32)).to(u8)
    return solid.to(u8) | (level << 1) | (radius << 5)


def decode_skip_radius(code: torch.Tensor) -> torch.Tensor:
    """Decoded Chebyshev skip radius (int32) of a leaf-volume radius code:
    r = c for c <= 3, else 2^(c-1)."""
    c = code.to(torch.int32)
    return torch.where(c <= 3, c, torch.bitwise_left_shift(
        torch.ones_like(c), c - 1))
