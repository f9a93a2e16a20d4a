"""Dual contouring: hermite data, per-cell dual vertices, triangle topology.

Counterpart of ``ray_tracing_octrees_tpu/ops/dual_contouring.py``, the
rebuild of ``AdaptiveDualContouringRenderer`` with two paths:

1. ``dual_contour_uniform``: the single-pass per-voxel design the
   reference intended on the GPU (executeComputeShaderSinglePass +
   buildTrianglesCPU, AdaptiveDualContouringRenderer.cpp:281-525), with
   its broken shader fixed: one dual vertex per voxel cell, then two
   triangles per sign-change face from the four cell vertices around it
   (buildTrianglesCPU's +X / +Y / +Z quad rule, :436-487).
2. ``adaptive_dual_contouring``: the octree-leaf path (createTriangles,
   :528-803): per surface-leaf dual vertices, min-corner-edge quads over
   up to four edge-adjacent leaves with the <= 2x size-ratio rule,
   inside / outside normal flips and the 1e-6 degenerate-area filter,
   plus the boundary face-fan fallback (createFaceTriangles, :805-1088).
   As in the reference package, every leaf's vertex comes from its own
   extent (the reference computes a neighbour's vertex with the querying
   cell's size, so its result depends on traversal order, :699-723).

Hermite intersections follow ``calculateIntersection`` (:1236-1357):
edge midpoints (t = 0.5 for the +-1 field), central-difference normals
perpendicular to the edge axis, oriented filled -> empty.

The adaptive path is paced by the host, level by level, with the
reference package's syncs and no more: the per-level leaf ids come from
host copies of ``is_leaf`` / ``level`` (``tree_meta``) and go to the
device in one copy from pinned memory, which does not wait; the host then
waits three times, for the need-vertex mask, the fan candidates' count
and the kept triangles' count (and twice more, for the copies to the
host, unless ``device_out``). Left out, as
they exist only for XLA: ``_pad_pow2``'s power-of-two id buckets and the
64k / 8k output buckets (they bound recompiles; every batch here has its
exact size, and padded rows never emitted, so the kept order is the
same), the "one program over all levels" fusions and ``host_fetch``'s
aligned repack (they work round a remote runtime's dispatch floor).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.config import DCConfig, QEFConfig
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import (
    LinearOctree, find_node_vol,
)
from ray_tracing_octrees_tpu_torch.ops.compaction import (
    compact_indices, mark_true,
)
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
    cross3, norm3,
)
from ray_tracing_octrees_tpu_torch.ops.qef import _c, generate_dual_vertex
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _sqrt

_DC = DCConfig()
f32 = torch.float32

_AXES = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.int32)
_PERP = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # dir -> perpendicular axes
_FACE_DIRS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                       [0, 0, 1], [0, 0, -1]], np.int32)
_TABLES = dict(
    axes=_AXES.astype(np.float32),
    # corner i takes the max end on axis a iff bit a of i
    corners=np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1]
                      for i in range(8)], bool),
    # dual_contour_uniform's quad corner steps per face direction
    d01=np.array([[0, 1, 0], [1, 0, 0], [0, 1, 0]], np.int32),
    d10=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.int32),
    face_normals=_FACE_DIRS.astype(np.float32),
    # per face axis, the two tangents of the boundary fans' grid
    tangents=np.array([[[0, 1, 0], [0, 0, 1]], [[1, 0, 0], [0, 0, 1]],
                       [[1, 0, 0], [0, 1, 0]]], np.float32),
)


# The tables go to a device once (and once a cell size): a copy from host
# memory made per call would wait for the queued work.

@functools.lru_cache(maxsize=None)
def _tables(dev: torch.device) -> dict:
    return {k: upload(a, dev) for k, a in _TABLES.items()}


@functools.lru_cache(maxsize=None)
def _shell_offsets(size: int, stride: int, dev: torch.device):
    """gather_cell_hermite's scanned lattice offsets, per edge axis: a
    tuple of 3 (ox, oy, oz) int32 tensors on ``dev``."""
    offs = np.arange(0, size + 1, stride, dtype=np.int32)
    ozg, oyg, oxg = np.meshgrid(offs, offs, offs, indexing="ij")
    oall = (oxg.reshape(-1), oyg.reshape(-1), ozg.reshape(-1))
    out = []
    for axis in range(3):
        keep = oall[axis] >= size - 1
        for b in range(3):
            if b != axis:
                keep = keep | (oall[b] == size)
        out.append(tuple(upload(o[keep], dev) for o in oall))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _interior_offsets(size: int, dev: torch.device):
    """(ox, oy, oz) int32[size^3] on ``dev``: every voxel of a cell."""
    o = np.arange(size, dtype=np.int32)
    ozg, oyg, oxg = np.meshgrid(o, o, o, indexing="ij")
    return tuple(upload(g.reshape(-1), dev) for g in (oxg, oyg, ozg))

def _in_dims(dims, *xyz):
    """All of the (x, y, z) triples inside [0, dims)."""
    ok = None
    for x, y, z in zip(*[iter(xyz)] * 3):
        b = ((x >= 0) & (y >= 0) & (z >= 0) & (x < dims[0]) & (y < dims[1])
             & (z < dims[2]))
        ok = b if ok is None else ok & b
    return ok


def edge_hermite(grid: VoxelGrid, x, y, z, axis: int):
    """Hermite point of the lattice edge (x, y, z) -> +axis, vectorized
    over index tensors: (crossing bool, pos f32[..., 3], normal f32[...,
    3]); ``crossing`` is False when an endpoint is out of bounds
    (gatherHermiteData skips those)."""
    ax = _AXES[axis]
    x2, y2, z2 = x + int(ax[0]), y + int(ax[1]), z + int(ax[2])
    dims = grid.dims_xyz
    inb2 = (x2 < dims[0]) & (y2 < dims[1]) & (z2 < dims[2])
    f1 = grid.sample_safe(x, y, z) > 0
    f2 = grid.sample_safe(x2, y2, z2) > 0
    crossing = _in_dims(dims, x, y, z) & inb2 & (f1 != f2)

    # midpoint (t = v1 / (v1 - v2) = 0.5 exactly for the +-1 field)
    p1 = grid.grid_to_world(x, y, z)
    p2 = grid.grid_to_world(x2, y2, z2)
    pos = p1 + 0.5 * (p2 - p1)

    # central-difference normal perpendicular to the edge at point 1
    s = grid.scalar_field_safe
    if axis == 0:
        g1 = s(x, y + 1, z) - s(x, y - 1, z)
        g2 = s(x, y, z + 1) - s(x, y, z - 1)
        n = torch.stack([torch.zeros_like(g1), g1, g2], -1)
    elif axis == 1:
        g1 = s(x + 1, y, z) - s(x - 1, y, z)
        g2 = s(x, y, z + 1) - s(x, y, z - 1)
        n = torch.stack([g1, torch.zeros_like(g1), g2], -1)
    else:
        g1 = s(x + 1, y, z) - s(x - 1, y, z)
        g2 = s(x, y + 1, z) - s(x, y - 1, z)
        n = torch.stack([g1, g2, torch.zeros_like(g1)], -1)

    len2 = (n * n).sum(-1)          # small integers: exact in any order
    edge_dir = _tables(n.device)["axes"][axis]
    n_unit = n / torch.clamp(_sqrt(len2)[..., None], min=1e-30)
    n = torch.where((len2 < 1e-10)[..., None], edge_dir, n_unit)

    # orientation: flip when (n . edge > 0) == isFilled2
    # (AdaptiveDualContouringRenderer.cpp:1338-1346)
    flip = (n[..., axis] > 0) == f2
    return crossing, pos, torch.where(flip[..., None], -n, n)


def gather_cell_hermite(grid: VoxelGrid, cx, cy, cz, size: int, stride: int):
    """gatherHermiteData for cells of one size and stride.

    cx / cy / cz: int[C] cell corners. Scans lattice offsets 0, stride,
    ... <= size on each axis (points past dim-1 are masked: the reference
    clamps maxX to dim-1) and the 3 forward edges of each point
    (AdaptiveDualContouringRenderer.cpp:1090-1144). Returns (points
    f32[C, K, 3], normals f32[C, K, 3], mask bool[C, K]).

    Leaves are uniform, so an edge with both voxels inside the cell
    ([c, c + size)) never crosses: a crossing needs the far voxel to leave
    the cell along the edge axis (offset >= size - 1) or the point to sit
    on a far face (an offset == size on another axis). Only that shell is
    scanned, which equals the full cube scan on uniform cells.
    """
    dims = grid.dims_xyz
    cx, cy, cz = (c.to(torch.int32) for c in (cx, cy, cz))
    pts, nrms, msks = [], [], []
    for axis, (sx, sy, sz) in enumerate(
            _shell_offsets(size, stride, grid.device)):
        px = cx[:, None] + sx[None, :]
        py = cy[:, None] + sy[None, :]
        pz = cz[:, None] + sz[None, :]
        in_scan = ((px <= dims[0] - 1) & (py <= dims[1] - 1)
                   & (pz <= dims[2] - 1))
        crossing, pos, n = edge_hermite(grid, px, py, pz, axis)
        msks.append(crossing & in_scan)
        pts.append(pos)
        nrms.append(n)
    return torch.cat(pts, 1), torch.cat(nrms, 1), torch.cat(msks, 1)


def _tri(a, b, c, invert, keep, eps: float):
    """One flat-shaded triangle (a, b, c): its rows f32[..., 3, 3], its
    unit normal (negated where ``invert``) and ``keep`` & area > eps."""
    cr = cross3(b - a, c - a)
    length = norm3(cr, keepdim=True)
    area = 0.5 * length[..., 0]
    n = cr / torch.clamp(length, min=1e-30)
    n = torch.where(invert[..., None], -n, n)
    return torch.stack([a, b, c], dim=-2), n, keep & (area > eps)


def _quad_triangles(v00, v01, v11, v10, invert, eps: float):
    """addQuad (AdaptiveDualContouringRenderer.cpp:393-433): triangles
    (v00, v01, v11) and (v00, v11, v10) with the area > eps filter and
    flat normals flipped by ``invert``. Returns (verts[..., 2, 3, 3],
    normals[..., 2, 3], keep[..., 2])."""
    yes = torch.ones_like(invert)
    va, na, ka = _tri(v00, v01, v11, invert, yes, eps)
    vb, nb, kb = _tri(v00, v11, v10, invert, yes, eps)
    return (torch.stack([va, vb], -3), torch.stack([na, nb], -2),
            torch.stack([ka, kb], -1))


def _decode3(lin, ny: int, nx: int):
    """(x, y, z) of a flat [Z, Y, X] index."""
    z = lin // (ny * nx)
    rem = lin - z * (ny * nx)
    y = rem // nx
    return rem - y * nx, y, z


def dual_contour_uniform(grid: VoxelGrid, max_cells: int, max_triangles: int,
                         qef_cfg: QEFConfig = QEFConfig(),
                         device: DeviceLike = None):
    """Single-pass per-voxel DC (the fixed GPU design), on ``device``
    (CUDA unless ``device="cpu"``), its dual vertices solved with
    ``qef_cfg``. Returns (verts f32[max_triangles, 3, 3], normals
    f32[max_triangles, 3], count int32 0-d); rows past count are zero.
    The degenerate-triangle area is ``DCConfig()``'s, as the reference
    package's."""
    dev = resolve_device(device)
    grid = grid.to(dev)
    dx, dy, dz = grid.dims_xyz
    occ = grid.occ > 0

    # --- per-voxel dual vertices ------------------------------------------
    # a cell needs a computed vertex iff its size-1 hermite scan (its 8
    # corners' forward edges) holds a crossing; the rest keep their centre
    def cell_any(edge_mask):
        m = torch.zeros((dz + 1, dy + 1, dx + 1), dtype=torch.bool,
                        device=dev)
        m[:edge_mask.shape[0], :edge_mask.shape[1],
          :edge_mask.shape[2]] = edge_mask
        acc = torch.zeros((dz, dy, dx), dtype=torch.bool, device=dev)
        for a in (0, 1):
            for b in (0, 1):
                for c in (0, 1):
                    acc |= m[a:a + dz, b:b + dy, c:c + dx]
        return acc

    active = (cell_any(occ[:, :, :-1] != occ[:, :, 1:])
              | cell_any(occ[:, :-1, :] != occ[:, 1:, :])
              | cell_any(occ[:-1, :, :] != occ[1:, :, :]))
    cell_idx, n_active = compact_indices(active, max_cells)
    acx, acy, acz = _decode3(cell_idx, dy, dx)
    pts, nrms, msk = gather_cell_hermite(grid, acx, acy, acz, 1, 1)
    valid_cell = torch.arange(max_cells, device=dev) < n_active
    msk = msk & valid_cell[:, None]
    centers = grid.voxel_center(acx, acy, acz)
    cell_size = grid.voxel_size.expand(centers.shape[:1])
    dual = generate_dual_vertex(pts, nrms, msk, centers, cell_size, qef_cfg)

    # dense vertex field, default the voxel centre
    zz, yy, xx = torch.meshgrid(*(torch.arange(n, dtype=torch.int32,
                                               device=dev)
                                  for n in (dz, dy, dx)), indexing="ij")
    flat = grid.voxel_center(xx, yy, zz).reshape(-1, 3)
    slots = torch.where(valid_cell, cell_idx, flat.shape[0]).long()
    flat = torch.cat([flat, flat[:1]])
    flat[slots] = dual
    vert_field = flat[:-1].reshape(dz, dy, dx, 3)

    # --- face quads (buildTrianglesCPU over cells in [0, dim-1)^3) ---------
    fz, fy, fx = dz - 1, dy - 1, dx - 1
    c_fill = occ[:fz, :fy, :fx]
    faces = torch.stack([
        (c_fill != occ[:fz, :fy, 1:fx + 1]).reshape(-1),
        (c_fill != occ[:fz, 1:fy + 1, :fx]).reshape(-1),
        (occ[1:fz + 1, :fy, :fx] != c_fill).reshape(-1)], 1).reshape(-1)
    invert_all = c_fill.reshape(-1).repeat_interleave(3)

    max_faces = max_triangles      # each face emits <= 2 tris
    fidx, n_faces = compact_indices(faces, max_faces)
    f_cell = fidx // 3
    f_dir = (fidx - f_cell * 3).long()
    cx_, cy_, cz_ = _decode3(f_cell, fy, fx)
    f_valid = torch.arange(max_faces, device=dev) < n_faces

    # quad corners per direction (buildTrianglesCPU:441-482):
    #  +X: V00=(x,y,z) V01=(x,y+1,z) V10=(x+1,y,z) V11=(x+1,y+1,z)
    #  +Y: V00=(x,y,z) V01=(x+1,y,z) V10=(x,y+1,z) V11=(x+1,y+1,z)
    #  +Z: V00=(x,y,z) V01=(x,y+1,z) V10=(x,y,z+1) V11=(x,y+1,z+1)
    d01, d10 = (_tables(dev)[k][f_dir] for k in ("d01", "d10"))
    at = lambda ox, oy, oz: vert_field[(cz_ + oz).long(), (cy_ + oy).long(),
                                       (cx_ + ox).long()]
    v00 = at(0, 0, 0)
    v01 = at(d01[:, 0], d01[:, 1], d01[:, 2])
    v10 = at(d10[:, 0], d10[:, 1], d10[:, 2])
    v11 = at(d01[:, 0] + d10[:, 0], d01[:, 1] + d10[:, 1],
             d01[:, 2] + d10[:, 2])
    invert = invert_all[fidx.long()] & f_valid
    verts2, normals2, keep2 = _quad_triangles(
        v00, v01, v11, v10, invert, _DC.degenerate_area_eps)
    keep2 = keep2 & f_valid[:, None]

    tri_idx, n_tris = compact_indices(keep2.reshape(-1), max_triangles)
    t_valid = torch.arange(max_triangles, device=dev) < n_tris
    verts = verts2.reshape(-1, 3, 3)[tri_idx.long()]
    normals = normals2.reshape(-1, 3)[tri_idx.long()]
    verts = torch.where(t_valid[:, None, None], verts, 0.0)
    normals = torch.where(t_valid[:, None], normals, 0.0)
    return verts, normals, n_tris


# ---------------------------------------------------------------------------
# adaptive (octree-leaf) dual contouring
# ---------------------------------------------------------------------------

def cell_contains_surface(grid: VoxelGrid, cx, cy, cz, size: int):
    """cellContainsSurface (AdaptiveDualContouringRenderer.cpp:1367-1530)
    for leaf corners of one ``size``: the corner disagreement test, the
    strided face probes on all six faces, and the exhaustive interior scan
    for size <= 4. bool[C]."""
    dev = grid.device
    dx, dy, dz = grid.dims_xyz
    min_x, min_y, min_z = (c.clamp(min=0) for c in (cx, cy, cz))
    max_x = torch.clamp(cx + size, max=dx)
    max_y = torch.clamp(cy + size, max=dy)
    max_z = torch.clamp(cz + size, max=dz)
    nonempty = (min_x < max_x) & (min_y < max_y) & (min_z < max_z)

    def occ_at(x, y, z):
        return _in_dims((dx, dy, dz), x, y, z), grid.sample_safe(x, y, z) > 0

    # corners, [C, 8]
    sel = _tables(dev)["corners"]
    qx = torch.where(sel[None, :, 0], (max_x - 1)[:, None], min_x[:, None])
    qy = torch.where(sel[None, :, 1], (max_y - 1)[:, None], min_y[:, None])
    qz = torch.where(sel[None, :, 2], (max_z - 1)[:, None], min_z[:, None])
    inb, f = occ_at(qx, qy, qz)
    result = (inb & f).any(-1) & (inb & ~f).any(-1)

    # strided diagonal face probes, [C, n_off] per direction and end
    offs = torch.arange(0, size, max(1, size // 4), dtype=torch.int32,
                        device=dev)[None, :]

    def probes(at, p1, p2, ok, lo_end, hi_end, dcap):
        r = torch.zeros_like(result)
        for ea, eb in ((lo_end - 1, lo_end), (hi_end - 1, hi_end)):
            inb_ = (ea[:, None] >= 0) & (eb[:, None] < dcap) & ok
            _, f1 = at(ea.clamp(0, dcap - 1)[:, None], p1, p2)
            _, f2 = at(eb.clamp(0, dcap - 1)[:, None], p1, p2)
            r = r | (inb_ & (f1 != f2)).any(-1)
        return r

    x1 = min_x[:, None] + offs
    y1 = min_y[:, None] + offs
    z1 = min_z[:, None] + offs
    result = result | probes(
        lambda a, b, c: occ_at(a, b, c), y1, z1,
        (y1 < max_y[:, None]) & (z1 < max_z[:, None]), min_x, max_x, dx)
    result = result | probes(
        lambda a, b, c: occ_at(b, a, c), x1, z1,
        (x1 < max_x[:, None]) & (z1 < max_z[:, None]), min_y, max_y, dy)
    result = result | probes(
        lambda a, b, c: occ_at(b, c, a), x1, y1,
        (x1 < max_x[:, None]) & (y1 < max_y[:, None]), min_z, max_z, dz)

    # exhaustive interior scan for small cells, [C, size^3]
    if size <= 4:
        oxg, oyg, ozg = _interior_offsets(size, dev)
        x = min_x[:, None] + oxg[None, :]
        y = min_y[:, None] + oyg[None, :]
        z = min_z[:, None] + ozg[None, :]
        inb_ = ((x < max_x[:, None] - 1) & (y < max_y[:, None] - 1)
                & (z < max_z[:, None] - 1))
        _, f = occ_at(x, y, z)
        _, fx = occ_at(x + 1, y, z)
        _, fy = occ_at(x, y + 1, z)
        _, fz = occ_at(x, y, z + 1)
        result = result | (inb_ & ((f != fx) | (f != fy) | (f != fz))).any(-1)
    return result & nonempty


def _node_centers(tree: LinearOctree, grid: VoxelGrid) -> torch.Tensor:
    """Per-node cell centre with each node's own size, f32[N, 3]."""
    corner = grid.grid_to_world(tree.x, tree.y, tree.z)
    return _fma(0.5 * tree.size[:, None].to(f32), grid.voxel_size, corner)


def _pass0_level(grid, tree, id_vol, ids, node_mask, need_vertex, s: int,
                 max_ratio: float):
    """One level of pass 0: surface classification, the min-corner
    crossing edges per direction, the size-ratio-gated edge-adjacent leaf
    lookups (createTriangles' neighbour gather,
    AdaptiveDualContouringRenderer.cpp:683-685), and the need-vertex
    marks (surface leaves, valid adjacent leaves, and the face neighbours
    of boundary surface leaves, which the fans may need).

    Returns (surf bool[P], [(crossing, [(nid, ok) x 3]) x 3]); marks
    ``need_vertex`` (bool[N + 1]) in place."""
    def locate(qx, qy, qz):
        if id_vol is not None:
            return find_node_vol(tree, id_vol, qx, qy, qz)
        return tree.find_node(qx, qy, qz)

    n_nodes = tree.num_nodes
    ids_l = ids.long()
    cx, cy, cz = tree.x[ids_l], tree.y[ids_l], tree.z[ids_l]
    surf = cell_contains_surface(grid, cx, cy, cz, s)
    if node_mask is not None:
        surf = surf & node_mask[ids_l]
    dims = grid.dims_xyz
    f1 = grid.sample_safe(cx, cy, cz) > 0
    adj_per_dir = []
    for d in range(3):
        ax = _AXES[d]
        ex2, ey2, ez2 = cx + s * int(ax[0]), cy + s * int(ax[1]), \
            cz + s * int(ax[2])
        f2 = grid.sample_safe(ex2, ey2, ez2) > 0
        crossing = surf & _in_dims(dims, cx, cy, cz, ex2, ey2, ez2) \
            & (f1 != f2)
        a1, a2 = _PERP[d]
        adj_info = []
        for da1, da2 in ((1, 0), (0, 1), (1, 1)):
            off = [0, 0, 0]
            off[a1] = da1 * s
            off[a2] = da2 * s
            qx, qy, qz = cx - off[0], cy - off[1], cz - off[2]
            nid = locate(qx, qy, qz)
            nid_c = nid.clamp(0, n_nodes - 1).long()
            size_n = tree.size[nid_c]
            ok = (_in_dims(dims, qx, qy, qz) & (nid >= 0)
                  & tree.is_leaf[nid_c]
                  & (torch.clamp(size_n, min=s)
                     <= torch.clamp(size_n, max=s) * float(max_ratio))
                  & crossing)
            adj_info.append((torch.where(ok, nid, -1), ok))
        adj_per_dir.append((crossing, adj_info))

    mark_true(need_vertex, ids, surf)
    for _, adj_info in adj_per_dir:
        for nid, ok in adj_info:
            mark_true(need_vertex, nid.clamp(0, n_nodes - 1), ok)

    # boundary-fan participants: face neighbours of boundary surface
    # leaves need their own-size dual vertex too
    at_boundary = ((cx == 0) | (cy == 0) | (cz == 0) | (cx + s >= dims[0])
                   | (cy + s >= dims[1]) | (cz + s >= dims[2]))
    fan_possible = surf & at_boundary
    for fd in _FACE_DIRS:
        nx_, ny_, nz_ = (c + int(o) * s for c, o in zip((cx, cy, cz), fd))
        nid = locate(nx_, ny_, nz_)
        nid_c = nid.clamp(0, n_nodes - 1)
        ok = (fan_possible & _in_dims(dims, nx_, ny_, nz_) & (nid >= 0)
              & tree.is_leaf[nid_c.long()])
        mark_true(need_vertex, nid_c, ok)
    return surf, adj_per_dir


def _pass1_level(grid, tree, vertex, ids, s: int, stride: int,
                 qef_cfg: QEFConfig):
    """One level of pass 1: the hermite shell scan and the QEF dual
    vertex (``qef_cfg``) of every needed leaf of size ``s``, written into
    ``vertex``."""
    ids_l = ids.long()
    pts, nrms, msk = gather_cell_hermite(
        grid, tree.x[ids_l], tree.y[ids_l], tree.z[ids_l], s, stride)
    cell_size = torch.full((ids.shape[0],), float(s), dtype=f32,
                           device=vertex.device) * grid.voxel_size
    vertex[ids_l] = generate_dual_vertex(pts, nrms, msk, vertex[ids_l],
                                         cell_size, qef_cfg)


def _pass2(tree, vertex, ids, adj_per_dir, emitted_any, area_eps: float):
    """Pass 2, createTriangles' emission over the 3 edge directions, for
    the rows of every level at once (the math never reads the level).

    Returns (verts [6P, 3, 3], normals [6P, 3], keep [6P]), rows in the
    reference package's order (per direction: the first triangles of all
    rows, then the second ones); marks ``emitted_any`` (bool[N + 1])."""
    n_nodes = tree.num_nodes
    ids_l = ids.long()
    solid_self = tree.is_solid[ids_l]
    v_self = vertex[ids_l]
    leaf_emitted = torch.zeros(ids.shape, dtype=torch.bool,
                               device=ids.device)
    vs, ns, ks = [], [], []
    for crossing, adj_info in adj_per_dir:
        (nid1, ok1), (nid2, ok2), (nid3, ok3) = adj_info
        v1, v2, v3 = (vertex[nid.clamp(0, n_nodes - 1).long()]
                      for nid in (nid1, nid2, nid3))
        cnt = 1 + ok1.to(torch.int32) + ok2.to(torch.int32) \
            + ok3.to(torch.int32)
        # ordered compaction of [self, v1, v2, v3]
        second = torch.where(ok1[:, None], v1, v2)
        third = torch.where(ok1[:, None], torch.where(ok2[:, None], v2, v3),
                            v3)
        t1v, t1n, t1k = _tri(v_self, second, third, solid_self,
                             crossing & (cnt >= 3), area_eps)
        t2v, t2n, t2k = _tri(v_self, third, v3, solid_self,
                             crossing & (cnt == 4), area_eps)
        vs += [t1v, t2v]
        ns += [t1n, t2n]
        ks += [t1k, t2k]
        leaf_emitted = leaf_emitted | t1k | t2k
    mark_true(emitted_any, ids, leaf_emitted)
    return torch.cat(vs), torch.cat(ns), torch.cat(ks)


def tree_host_meta(tree: LinearOctree):
    """Host copies (numpy) of (is_leaf, level) for
    :func:`adaptive_dual_contouring`: per-tree constants, computed once a
    scene and passed as ``tree_meta`` so repeated extractions skip the two
    device-to-host pulls."""
    return tree.is_leaf.cpu().numpy().astype(bool), tree.level.cpu().numpy()


def _level_batches(ids_by_level, dev):
    """{level: int32 ids on ``dev``} from host id arrays, in one upload."""
    if not ids_by_level:
        return {}
    flat = upload(np.concatenate(list(ids_by_level.values())), dev)
    ends = np.cumsum([len(v) for v in ids_by_level.values()])
    return {k: flat[e - len(v):e]
            for (k, v), e in zip(ids_by_level.items(), ends)}


def adaptive_dual_contouring(grid: VoxelGrid, tree: LinearOctree,
                             node_mask=None,
                             qef_cfg: QEFConfig = QEFConfig(),
                             dc_cfg: DCConfig = DCConfig(),
                             with_boundary_fans: bool = True,
                             node_id_vol=None, tree_meta=None,
                             device_out: bool = False,
                             device: DeviceLike = None):
    """Adaptive octree-leaf DC (createTriangles semantics, order-free),
    on ``device`` (CUDA unless ``device="cpu"``; grid, tree and the
    optional tensors are moved there).

    node_mask: optional bool[N] visibility (frustum culling at margin 50,
    as renderOctree applies before render(), main.cpp:154-189).
    qef_cfg: pass 1's dual-vertex solve. dc_cfg: ``max_size_ratio`` (the
    neighbour-leaf LOD limit of pass 0 and the fans), the hermite scan's
    ``stride_large_cell`` above ``stride_switch_size``,
    ``degenerate_area_eps`` and ``face_fan_divisions``; its ``qef`` and
    ``always_fine_size`` are not read, as in the reference package.
    node_id_vol: optional i32[S, S, S] from
    ``core.octree.build_node_id_volume``: every neighbour lookup becomes
    one volume lookup (same results). tree_meta: optional host (is_leaf,
    level) from :func:`tree_host_meta`.

    Returns (verts f32[count, 3, 3], normals f32[count, 3], count int):
    on the host, or with ``device_out`` on the device.
    """
    dev = resolve_device(device)
    grid, tree = grid.to(dev), tree.to(dev)
    if node_mask is not None:
        node_mask = torch.as_tensor(node_mask, device=dev)
    if node_id_vol is not None:
        node_id_vol = node_id_vol.to(dev)
    leaf, level = tree_meta if tree_meta is not None else tree_host_meta(tree)
    n_nodes = tree.num_nodes

    # ---- pass 0: surface leaves and crossing edges, level by level -------
    levels = sorted(set(level[leaf].tolist()))
    level_ids = _level_batches(
        {k: np.nonzero(leaf & (level == k))[0].astype(np.int32)
         for k in levels}, dev)
    need_vertex = torch.zeros(n_nodes + 1, dtype=torch.bool, device=dev)
    seg = {}      # level -> (ids, surf, adjacency)
    for k in levels:
        ids = level_ids[k]
        surf, adj = _pass0_level(grid, tree, node_id_vol, ids, node_mask,
                                 need_vertex, 1 << k,
                                 float(dc_cfg.max_size_ratio))
        seg[k] = (ids, surf, adj)

    # ---- pass 1: dual vertices of every needed leaf ------------------------
    vertex = _node_centers(tree, grid)      # default: own-size cell centre
    need_np = need_vertex[:n_nodes].cpu().numpy()
    needed = {}
    for k in levels:
        ids = np.nonzero(leaf & (level == k) & need_np)[0].astype(np.int32)
        if len(ids):
            needed[k] = ids
    for k, ids in _level_batches(needed, dev).items():
        s = 1 << k
        stride = (dc_cfg.stride_large_cell if s > dc_cfg.stride_switch_size
                  else 1)
        _pass1_level(grid, tree, vertex, ids, s, stride, qef_cfg)

    # ---- pass 2: triangle emission, every level's rows at once -------------
    emitted_any = torch.zeros(n_nodes + 1, dtype=torch.bool, device=dev)
    parts = []
    if levels:
        ids_cat = torch.cat([seg[k][0] for k in levels])
        adj_cat = [(torch.cat([seg[k][2][d][0] for k in levels]),
                    [tuple(torch.cat([seg[k][2][d][1][j][i] for k in levels])
                           for i in range(2)) for j in range(3)])
                   for d in range(3)]
        parts.append(_pass2(tree, vertex, ids_cat, adj_cat, emitted_any,
                            float(dc_cfg.degenerate_area_eps)))

    # ---- pass 3: boundary face fans (createFaceTriangles fallback) ---------
    if with_boundary_fans and levels:
        fans = _boundary_face_fans(grid, tree, vertex, seg, levels,
                                   emitted_any[:n_nodes], dc_cfg, node_id_vol)
        if fans is not None:
            parts.append(fans)

    if not parts:
        z = torch.zeros((0, 3, 3), dtype=f32, device=dev)
        out = (z, z[:, :, 0], 0)
        return out if device_out else (out[0].cpu(), out[1].cpu(), 0)
    keep = torch.cat([k for _, _, k in parts])
    rows = torch.nonzero(keep).squeeze(1)     # the kept rows, in order
    verts = torch.cat([v for v, _, _ in parts])[rows]
    normals = torch.cat([n for _, n, _ in parts])[rows]
    total = int(rows.shape[0])
    if device_out:
        return verts, normals, total
    return verts.cpu(), normals.cpu(), total


def _boundary_face_fans(grid, tree, vertex, seg, levels, emitted_any,
                        dc_cfg: DCConfig, id_vol=None):
    """createFaceTriangles (AdaptiveDualContouringRenderer.cpp:805-1088)
    for surface leaves that emitted nothing and touch the grid boundary.

    Candidates are compacted (one wait for their count) before the
    192-triangles-a-cell expansion; every level's candidates then run in
    one batch (the size is a per-row tensor). Returns (verts, normals,
    keep) or None."""
    dev = grid.device
    ids_cat = torch.cat([seg[k][0] for k in levels])
    surf = torch.cat([seg[k][1] for k in levels])
    s_cat = torch.cat([torch.full(seg[k][0].shape, 1 << k, dtype=torch.int32,
                                  device=dev) for k in levels])
    dx, dy, dz = grid.dims_xyz
    ids_l = ids_cat.long()
    cx, cy, cz = tree.x[ids_l], tree.y[ids_l], tree.z[ids_l]
    at_boundary = ((cx == 0) | (cy == 0) | (cz == 0) | (cx + s_cat >= dx)
                   | (cy + s_cat >= dy) | (cz + s_cat >= dz))
    eligible = surf & ~emitted_any[ids_l] & at_boundary
    sel = torch.nonzero(eligible).squeeze(1)
    if sel.numel() == 0:
        return None
    return _fan_level(grid, tree, vertex, id_vol, ids_cat[sel], s_cat[sel],
                      int(dc_cfg.face_fan_divisions),
                      float(dc_cfg.max_size_ratio))


def _fan_level(grid, tree, vertex, id_vol, ids, s, divisions: int,
               max_ratio: float):
    """Boundary-fan emission for the candidate rows ``ids`` (sizes ``s``,
    a per-row tensor). Returns (verts [E, 3, 3], normals [E, 3], keep
    [E]) with E = P * 6 faces * divisions^2 * 8 triangles, emit-major."""
    dx, dy, dz = grid.dims_xyz
    n_nodes = tree.num_nodes
    ids_l = ids.long()
    cx, cy, cz = tree.x[ids_l], tree.y[ids_l], tree.z[ids_l]
    v_self = vertex[ids_l]
    solid_self = tree.is_solid[ids_l]
    half = (0.5 * s.to(f32) * grid.voxel_size)[:, None]       # [P, 1]
    face_normals = _tables(grid.device)["face_normals"]
    tangents = _tables(grid.device)["tangents"]
    fan_v, fan_n, fan_k = [], [], []
    for f, fd in enumerate(_FACE_DIRS):
        nx, ny, nz = (c + int(o) * s for c, o in zip((cx, cy, cz), fd))
        if id_vol is not None:
            nid = find_node_vol(tree, id_vol, nx, ny, nz)
        else:
            nid = tree.find_node(nx, ny, nz)
        nid_c = nid.clamp(0, n_nodes - 1).long()
        found_leaf = (nid >= 0) & tree.is_leaf[nid_c]
        size_n = tree.size[nid_c]
        ratio_bad = found_leaf & (torch.maximum(s, size_n)
                                  > torch.minimum(s, size_n) * max_ratio)
        # grid-sample fallback at the neighbour's centre (clamped)
        half_s = s // 2
        sample_solid = grid.sample_safe((nx + half_s).clamp(0, dx - 1),
                                        (ny + half_s).clamp(0, dy - 1),
                                        (nz + half_s).clamp(0, dz - 1)) > 0
        neighbor_solid = torch.where(found_leaf, tree.is_solid[nid_c],
                                     sample_solid)
        active = (_in_dims((dx, dy, dz), nx, ny, nz) & ~ratio_bad
                  & (neighbor_solid != solid_self))
        # the neighbour's vertex: its leaf's own, else its centre at self
        # size
        nb_center = grid.grid_to_world(nx, ny, nz) + half
        v_nb = torch.where(found_leaf[:, None], vertex[nid_c], nb_center)
        t1v, t2v = tangents[f // 2]
        f_normal = face_normals[f]
        out_normal = torch.where(solid_self[:, None], f_normal[None, :],
                                 -f_normal[None, :])
        face_center = 0.5 * (v_self + v_nb)

        # (divisions + 1)^2 bulged grid points
        pts = {}
        for i in range(divisions + 1):
            for j in range(divisions + 1):
                u = 2.0 * (i / divisions) - 1.0
                v = 2.0 * (j / divisions) - 1.0
                bulge = half * _c(0.05) * _c(1.0 - (u * u + v * v))
                pts[(i, j)] = (face_center + t1v[None, :] * (half * _c(u))
                               + t2v[None, :] * (half * _c(v))
                               + f_normal[None, :] * bulge)

        def emit(a, b, c, nrm):
            fan_v.append(torch.stack([a, b, c], dim=1))
            fan_n.append(nrm)
            fan_k.append(active)

        for i in range(divisions):
            for j in range(divisions):
                p00, p10 = pts[(i, j)], pts[(i + 1, j)]
                p01, p11 = pts[(i, j + 1)], pts[(i + 1, j + 1)]
                # cell-vertex fan (tri1..tri4, :992-1032)
                emit(v_self, p00, p10, out_normal)
                emit(v_self, p10, p11, out_normal)
                emit(v_self, p11, p01, out_normal)
                emit(v_self, p01, p00, out_normal)
                # neighbour fan, reversed winding, negated normal
                # (:1036-1083)
                emit(v_nb, p10, p00, -out_normal)
                emit(v_nb, p11, p10, -out_normal)
                emit(v_nb, p01, p11, -out_normal)
                emit(v_nb, p00, p01, -out_normal)
    return torch.cat(fan_v), torch.cat(fan_n), torch.cat(fan_k)
