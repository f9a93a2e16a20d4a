"""Table-driven Marching Cubes over a dense lattice.

Counterpart of ``ray_tracing_octrees_tpu/ops/marching_cubes.py``: the
replacement for the reference's per-leaf recursive extraction
(``localMC`` / ``marchingCubesCell``, OctreeVoxel.cpp:633-879, driven by
``MarchingCubesRenderer::render``, Renderer.cpp:14-36) and the
scalar-field entry (``marchingCubesVolume``, MarchingCubes.cpp:622-689).

``std::vector::push_back`` becomes a prefix sum: every cell gets its
8-bit case and triangle count, the inclusive cumsum of the counts gives
each cell's output rows, and each output row finds its cell by a binary
search of the cumsum (row j belongs to the first cell whose cumsum
exceeds j), then gathers its vertices from the case tables. The rows
come out in the reference package's order (cell-major, then triangle),
with no scatter and no host sync. The octree plays no role: cells inside
uniform leaves classify to case 0 or 255. Frustum culling is a cell mask
(``cell_mask``), the reference's margin-50 AABB test (main.cpp:154-189)
at cell granularity.

The reference package splits this into three compiled programs because
XLA's fused gathers were slow; the port runs it as one function.

Floats: with the binary field (+-1, iso 0) every edge vertex is the exact
midpoint p1 + 0.5 * (p2 - p1) and the normal is normalize(cross(e1, e2)),
as localMC; the general path keeps vertexInterp's epsilon branches
(OctreeVoxel.cpp:633-640). Products that the reference's compiled form
fuses into multiply-adds are fused here too (``_fma``), so general fields
round as the reference does.
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
from ray_tracing_octrees_tpu_torch.ops import mc_tables as t
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _sqrt

f32 = torch.float32


@functools.lru_cache(maxsize=None)
def _tables(dev: torch.device):
    """(TRI_COUNTS, TRI_EDGES, EDGE_CORNERS, CORNER_OFFSETS) as int32 on
    ``dev``, uploaded once a device."""
    return tuple(upload(np.asarray(a, np.int32), dev) for a in (
        t.TRI_COUNTS, t.TRI_EDGES, t.EDGE_CORNERS, t.CORNER_OFFSETS))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cross(a, b) over the last dim as the reference's compiled form
    rounds it: each component one multiply-add, a1 * b2 - (a2 * b1)
    fused (``_fma``, the same bits on every device)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
                        _fma(a0, b1, -(a1 * b0))], dim=-1)


def norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean length over the last dim of size 3 as the reference's
    compiled reduction rounds it (x0^2, then two multiply-adds), rooted
    with the correctly rounded ``_sqrt``."""
    x0, x1, x2 = v.unbind(-1)
    n = _sqrt(_fma(x2, x2, _fma(x1, x1, x0 * x0)))
    return n[..., None] if keepdim else n


def unit_normals(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """normalize(cross(e1, e2)), a zero cross product left zero."""
    n = cross3(e1, e2)
    return n / torch.clamp(norm3(n, keepdim=True), min=1e-30)


def _cell_cases(inside: torch.Tensor) -> torch.Tensor:
    """8-bit MC case per cell (int32[Z-1, Y-1, X-1]) of a bool[Z, Y, X]
    'inside' mask over lattice points: bit i set iff corner i is inside
    (value < iso), marchingCubesCell's rule (OctreeVoxel.cpp:648-651)."""
    nz, ny, nx = (s - 1 for s in inside.shape)
    case = torch.zeros((nz, ny, nx), dtype=torch.int32, device=inside.device)
    for i in range(8):
        dx, dy, dz = (int(v) for v in t.CORNER_OFFSETS[i])
        bit = inside[dz:dz + nz, dy:dy + ny, dx:dx + nx]
        case |= bit.to(torch.int32) << i
    return case


def count_mc_triangles(grid: VoxelGrid) -> torch.Tensor:
    """Total triangle count (int64 0-d tensor on the grid's device),
    without emitting geometry (capacity sizing)."""
    case = _cell_cases(grid.occ > 0)
    return _tables(grid.device)[0][case.long()].sum()


def _interp_vertex(iso, p1, p2, v1, v2):
    """vertexInterp (OctreeVoxel.cpp:633-640) with its epsilon early-outs."""
    eps = 1e-5
    mu = (iso - v1) / (v2 - v1)
    p = _fma(mu[..., None], p2 - p1, p1)
    p = torch.where(((v1 - v2).abs() < eps)[..., None], p1, p)
    p = torch.where(((iso - v2).abs() < eps)[..., None], p2, p)
    p = torch.where(((iso - v1).abs() < eps)[..., None], p1, p)
    return p


def _mc_impl(field: torch.Tensor, origin: torch.Tensor,
             spacing: torch.Tensor, iso: torch.Tensor,
             cell_mask: Optional[torch.Tensor], max_triangles: int):
    """MC over lattice values ``field`` f32[Z, Y, X] at origin + (x, y,
    z) * spacing. Returns (verts f32[max_triangles, 3, 3], normals
    f32[max_triangles, 3], count int32 0-d); rows past count are zero."""
    dev = field.device
    dz, dy, dx = field.shape
    nzc, nyc, nxc = dz - 1, dy - 1, dx - 1
    tri_counts, tri_edges, edge_corners, corner_offsets = _tables(dev)
    case = _cell_cases(field < iso).reshape(-1)
    counts = tri_counts[case.long()]
    if cell_mask is not None:
        counts = torch.where(cell_mask.reshape(-1).to(dev), counts, 0)
    cap = int(max_triangles)
    j = torch.arange(cap, dtype=torch.int32, device=dev)
    if counts.numel() == 0:
        total = torch.zeros((), dtype=torch.int32, device=dev)
        cell = torch.zeros_like(j)
        tri_t = torch.zeros_like(j)
    else:
        ends = torch.cumsum(counts, 0, dtype=torch.int32)   # inclusive
        total = ends[-1]
        cell = torch.searchsorted(ends, j, right=True).clamp(
            max=counts.numel() - 1)
        tri_t = j - (ends[cell] - counts[cell])
        cell = cell.to(torch.int32)
    count = torch.clamp(total, max=cap)
    valid = j < count
    cell = torch.where(valid, cell, 0)
    tri_t = torch.where(valid, tri_t, 0)

    cz = cell // (nyc * nxc)
    rem = cell - cz * (nyc * nxc)
    cy = rem // nxc
    cx = rem - cy * nxc
    case_f = case[cell.long()].long()
    edges3 = tri_edges[case_f, tri_t.long()].long()           # [T, 3]
    corners = edge_corners[edges3].long()                     # [T, 3, 2]
    offs = corner_offsets[corners]                            # [T, 3, 2, 3]
    px = cx[:, None, None] + offs[..., 0]
    py = cy[:, None, None] + offs[..., 1]
    pz = cz[:, None, None] + offs[..., 2]
    vals = field.reshape(-1)[((pz * dy + py) * dx + px).long()]     # [T, 3, 2]

    pos = _fma(torch.stack([px, py, pz], dim=-1).to(f32), spacing, origin)
    verts = _interp_vertex(iso, pos[:, :, 0, :], pos[:, :, 1, :],
                           vals[:, :, 0], vals[:, :, 1])
    n = unit_normals(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    verts = torch.where(valid[:, None, None], verts, 0.0)
    n = torch.where(valid[:, None], n, 0.0)
    return verts, n, count


def marching_cubes_grid(grid: VoxelGrid, max_triangles: int,
                        cell_mask: Optional[torch.Tensor] = None,
                        device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MC over the binary grid with localMC's conventions, on ``device``
    (CUDA unless ``device="cpu"``; the grid is moved there).

    FILLED -> -1, EMPTY -> +1, iso 0 (OctreeVoxel.cpp:787-792); lattice
    point (x, y, z) sits at origin + (x, y, z) * voxelSize, the voxel's
    min corner, as localMC's corners.

    Returns (verts f32[max_triangles, 3, 3], normals f32[max_triangles,
    3], count int32 0-d). Rows past count are zero; with more than
    ``max_triangles`` triangles the output is truncated (count ==
    max_triangles). ``cell_mask`` bool[Z-1, Y-1, X-1] keeps cells.
    """
    grid = grid.to(resolve_device(device))
    field = torch.where(grid.occ > 0, -1.0, 1.0).to(f32)
    return _mc_impl(field, grid.origin, grid.voxel_size,
                    torch.zeros((), dtype=f32, device=grid.device),
                    cell_mask, max_triangles)


def marching_cubes_volume(field_zyx, origin, spacing, iso: float,
                          max_triangles: int, device: DeviceLike = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-volume MC over a scalar field with true interpolation
    (``marchingCubesVolume``, MarchingCubes.h:19-23, MarchingCubes.cpp:
    622-689), on ``device``: lattice values field[z, y, x] at origin +
    (x, y, z) * spacing, corners inside where value < iso, edge vertices
    interpolated to the iso level."""
    dev = resolve_device(device)
    as32 = lambda a: torch.as_tensor(np.asarray(
        a.cpu() if torch.is_tensor(a) else a, np.float32), device=dev)
    return _mc_impl(as32(field_zyx), as32(origin), as32(spacing),
                    as32(iso), None, max_triangles)
