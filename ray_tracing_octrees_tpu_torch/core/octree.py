"""Occupancy pyramid over the voxel grid: the exact tracer's hierarchy.

Counterpart of the pyramid half of ``ray_tracing_octrees_tpu/core/
octree.py``, both halves:

1. The occupancy pyramid (``padded_cube_size``, ``OccupancyPyramid``,
   ``_reduce_level``, ``build_pyramid``, ``build_leaf_volume``,
   ``decode_skip_radius``). For every level k it stores, per 2^k-sized
   cell, a 2-bit code: 0 all empty, 1 mixed, 2 all solid. With space
   outside the grid read as empty (``getVoxelSafe``, OctreeVoxel.cpp:
   694-702) this encodes the reference octree losslessly: a node is a
   leaf iff its cell is uniform or has size 1 (the ``allSame`` rule of
   buildOctreeRec, OctreeVoxel.cpp:724-745).
2. The linear octree (``pack_key``, ``LinearOctree``,
   ``build_linear_octree``, ``build_node_id_volume``, ``find_node_vol``,
   ``leaf_grid_arrays``, ``get_neighbors``): BFS-flattened node arrays,
   the GPU layout ``RayTracerBVH::setOctree`` uploads (RayTracerBVH.cpp:
   430-505; ``GPUNodes``, RayTracerBVH.h:21-26), with ``g_octreeMap``
   (Renderer.cpp:11) as a binary search over sorted corner keys.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device


def padded_cube_size(dim_x: int, dim_y: int, dim_z: int) -> int:
    """Next power of two >= max dim (OctreeVoxel.cpp:768-770)."""
    s = 1
    while s < max(dim_x, dim_y, dim_z):
        s <<= 1
    return s


class OccupancyPyramid:
    """Per-level cell codes, finest (k = 0, the occupancy itself) first.

    ``code_levels[k]`` is uint8 of shape ``ceil(dims / 2^k)`` in (Z, Y, X)
    order, for k = 0 .. L where 2^L is the root size: 0 uniform-empty, 1
    mixed, 2 uniform-solid. ``any_levels[k]`` / ``all_levels[k]`` are the
    per-level any / all occupancy reductions it encodes.
    """

    def __init__(self, code_levels: List[torch.Tensor]):
        self.code_levels = list(code_levels)

    @property
    def any_levels(self) -> List[torch.Tensor]:
        return [c > 0 for c in self.code_levels]

    @property
    def all_levels(self) -> List[torch.Tensor]:
        return [c == 2 for c in self.code_levels]

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

    def cell_state(self, k: int, cx, cy, cz):
        """(any, all) of level-k cells; outside the array (False, False)."""
        code = self.cell_code(k, cx, cy, cz)
        return code > 0, code == 2


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


# --------------------------------------------------------------------------
# the linear octree
# --------------------------------------------------------------------------

def pack_key(x, y, z) -> torch.Tensor:
    """The reference node-map key (OctreeVoxel.cpp:552-554),
    (x << 20) | (y << 10) | z, as int32: grids stay <= 1000 a side
    (BuildingLoader.cpp:200-209), so padded coords <= 1024 fit."""
    i32 = lambda c: torch.as_tensor(c).to(torch.int32)
    return (i32(x) << 20) | (i32(y) << 10) | i32(z)


@dataclasses.dataclass(frozen=True)
class LinearOctree:
    """BFS-flattened octree node arrays (root at index 0), on one device.

    The reference's GPU node buffer (RayTracerBVH.h:21-26): integer corner
    coords in voxel units of the padded 2^L cube, power-of-two size,
    leaf / solid / uniform flags and eight child indices (-1 = none,
    bit0 = x, bit1 = y, bit2 = z). Every leaf is uniform (buildOctreeRec
    stops only at uniform regions or size 1).

    ``sorted_keys`` / ``sorted_node_idx`` stand for ``g_octreeMap``: the
    keys are ``pack_key(x, y, z)``, ascending, with the deepest (smallest)
    node at each shared corner.
    """

    x: torch.Tensor           # int32[N]
    y: torch.Tensor           # int32[N]
    z: torch.Tensor           # int32[N]
    size: torch.Tensor        # int32[N]
    is_leaf: torch.Tensor     # bool[N]
    is_solid: torch.Tensor    # bool[N]
    is_uniform: torch.Tensor  # bool[N]
    children: torch.Tensor    # int32[N, 8]
    level: torch.Tensor       # int32[N]; 0 = finest (size 1)
    sorted_keys: torch.Tensor      # int32[M] unique corner keys, ascending
    sorted_node_idx: torch.Tensor  # int32[M] deepest node at that corner

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "LinearOctree":
        return LinearOctree(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})

    def world_bounds(self, grid_origin, voxel_size):
        """Per-node world AABB (lo, hi), f32[N, 3] each (nodeMin / nodeMax,
        RayTracerBVH.cpp:262-264)."""
        f32 = torch.float32
        origin = torch.as_tensor(grid_origin, device=self.device).to(f32)
        vs = torch.as_tensor(voxel_size, device=self.device).to(f32)
        lo = origin[None, :] + torch.stack(
            [self.x, self.y, self.z], dim=-1).to(f32) * vs
        hi = lo + self.size[:, None].to(f32) * vs
        return lo, hi

    def find_node(self, x, y, z) -> torch.Tensor:
        """Deepest node anchored at corner (x, y, z), or -1 (int32):
        ``g_octreeMap.find(buildKey(x, y, z))``
        (AdaptiveDualContouringRenderer.cpp:671-677), vectorized."""
        key = pack_key(x, y, z).to(self.device)
        pos = torch.searchsorted(self.sorted_keys, key)
        pos_c = pos.clamp(0, self.sorted_keys.shape[0] - 1)
        hit = self.sorted_keys[pos_c] == key
        return torch.where(hit, self.sorted_node_idx[pos_c], -1)


def _build_linear_arrays(occ_np: np.ndarray) -> dict:
    """The BFS node arrays of a bool[Z, Y, X] occupancy, as numpy (the
    reference's CPU build + flatten)."""
    dz, dy, dx = occ_np.shape
    num_levels = padded_cube_size(dx, dy, dz).bit_length()

    # host mip stack, finest first, with virtual EMPTY padding
    any_l, all_l = [occ_np], [occ_np]
    for _ in range(num_levels - 1):
        prev_any, prev_all = any_l[-1], all_l[-1]
        pad = tuple((0, (-n) % 2) for n in prev_any.shape)
        if any(p for _, p in pad):
            prev_any = np.pad(prev_any, pad, constant_values=False)
            prev_all = np.pad(prev_all, pad, constant_values=False)
        nz, ny, nx = (n // 2 for n in prev_any.shape)
        any_l.append(prev_any.reshape(nz, 2, ny, 2, nx, 2).any(axis=(1, 3, 5)))
        all_l.append(prev_all.reshape(nz, 2, ny, 2, nx, 2).all(axis=(1, 3, 5)))

    def cell_any_all(k, cx, cy, cz):
        """(any, all) at level k, out-of-array cells (False, False)."""
        a, b = any_l[k], all_l[k]
        inb = ((cx >= 0) & (cy >= 0) & (cz >= 0) & (cx < a.shape[2])
               & (cy < a.shape[1]) & (cz < a.shape[0]))
        xc = np.clip(cx, 0, a.shape[2] - 1)
        yc = np.clip(cy, 0, a.shape[1] - 1)
        zc = np.clip(cz, 0, a.shape[0] - 1)
        return (np.where(inb, a[zc, yc, xc], False),
                np.where(inb, b[zc, yc, xc], False))

    # BFS level by level; cells (cx, cy, cz) at their own level's scale
    offs = np.array([[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1]
                     for i in range(8)], np.int64)
    cells = np.zeros((1, 3), np.int64)
    per_level, offsets, total = [], [], 0
    k = num_levels - 1
    while True:
        c_any, c_all = cell_any_all(k, cells[:, 0], cells[:, 1], cells[:, 2])
        uniform = c_all | ~c_any
        if k == 0:
            uniform = np.ones_like(uniform)
        per_level.append((k, cells, uniform, np.where(uniform, c_all, False)))
        offsets.append(total)
        total += cells.shape[0]
        if k == 0 or not (~uniform).any():
            break
        parents = cells[~uniform]          # in visit order
        cells = (parents[:, None, :] * 2 + offs[None, :, :]).reshape(-1, 3)
        k -= 1

    n = total
    out = dict(x=np.zeros(n, np.int32), y=np.zeros(n, np.int32),
               z=np.zeros(n, np.int32), size=np.zeros(n, np.int32),
               is_leaf=np.zeros(n, bool), is_solid=np.zeros(n, bool),
               is_uniform=np.zeros(n, bool), level=np.zeros(n, np.int32),
               children=np.full((n, 8), -1, np.int32))
    for li, (kk, cells_k, uniform, solid) in enumerate(per_level):
        sl = slice(offsets[li], offsets[li] + cells_k.shape[0])
        for a, name in enumerate("xyz"):
            out[name][sl] = cells_k[:, a] * (1 << kk)
        out["size"][sl] = 1 << kk
        out["is_leaf"][sl] = uniform
        out["is_solid"][sl] = solid
        out["is_uniform"][sl] = uniform
        out["level"][sl] = kk
        if li + 1 < len(per_level):
            nonuni = ~uniform
            ranks = np.cumsum(nonuni) - 1   # rank among non-uniform parents
            base = offsets[li + 1] + 8 * ranks
            idx = np.nonzero(nonuni)[0]
            out["children"][offsets[li] + idx] = (base[idx, None]
                                                  + np.arange(8)[None, :])

    # g_octreeMap parity: the deepest node wins at shared corners (numpy's
    # stable lexsort, as the reference package sorts)
    keys = (out["x"] << 20) | (out["y"] << 10) | out["z"]
    order = np.lexsort((out["size"], keys))   # by key, then size ascending
    sorted_all = keys[order]
    first = np.ones(n, bool)
    first[1:] = sorted_all[1:] != sorted_all[:-1]
    out["sorted_keys"] = sorted_all[first].astype(np.int32)
    out["sorted_node_idx"] = order[first].astype(np.int32)
    return out


def build_linear_octree(occ, device: DeviceLike = None) -> LinearOctree:
    """The BFS node arrays of occupancy ``occ`` ([Z, Y, X], nonzero =
    solid), built with numpy on the host (once per scene, as the
    reference's CPU build + flatten) and moved to ``device`` (CUDA unless
    ``device="cpu"``).

    The node set and flags are buildOctreeRec's: from the 2^L root,
    every non-uniform cell splits into 8 children (bit0 = x, bit1 = y,
    bit2 = z); leaves are uniform cells and size-1 cells. BFS order is
    RayTracerBVH::setOctree's queue: level by level, children in parent
    visit order, then child index order.
    """
    dev = resolve_device(device)
    occ_np = (occ.cpu().numpy() if torch.is_tensor(occ)
              else np.asarray(occ)) > 0
    arrays = _build_linear_arrays(occ_np)
    return LinearOctree(**{k: torch.from_numpy(v).to(dev)
                           for k, v in arrays.items()})


def build_node_id_volume(tree: LinearOctree,
                         root_size: int = 0) -> torch.Tensor:
    """i32[S, S, S]: the id of the leaf holding each voxel of the root
    cube, on the tree's device. S is ``root_size``, or with 0 the root
    node's size (one read from the device).

    The constant-time half of ``g_octreeMap``: the deepest node anchored
    at a corner c is always a leaf (internal nodes carry all 8 children),
    and it exists iff the leaf holding c has its min corner at c. So
    ``find_node`` becomes one volume lookup and an anchored check
    (:func:`find_node_vol`). Built top-down from the child arrays in
    floor(log2(S)) doubling steps.
    """
    dev = tree.device
    if not root_size:
        root_size = int(tree.size[0])
    children = tree.children.long()
    ids = torch.zeros((1, 1, 1), dtype=torch.int64, device=dev)
    for _ in range(int(root_size).bit_length() - 1):
        ids = _upsample(ids, 2)
        h = torch.arange(ids.shape[0], device=dev) & 1
        octant = (h[None, None, :]          # x -> bit 0 (OctreeVoxel.cpp:751-755)
                  + 2 * h[None, :, None]    # y -> bit 1
                  + 4 * h[:, None, None])   # z -> bit 2
        child = children[ids, octant.expand(ids.shape)]
        ids = torch.where(child >= 0, child, ids)
    return ids.to(torch.int32)


def find_node_vol(tree: LinearOctree, id_vol: torch.Tensor, x, y,
                  z) -> torch.Tensor:
    """``find_node`` through the node-id volume: one lookup and an
    anchored check. Equal to ``LinearOctree.find_node`` on in-cube
    coordinates; out-of-cube queries give -1."""
    S = id_vol.shape[0]
    dev = id_vol.device
    x, y, z = (torch.as_tensor(c, device=dev).to(torch.int32)
               for c in (x, y, z))
    inb = (x >= 0) & (y >= 0) & (z >= 0) & (x < S) & (y < S) & (z < S)
    cl = lambda c: c.clamp(0, S - 1).long()
    nid = id_vol[cl(z), cl(y), cl(x)]
    # anchored <=> the corner is aligned to the holding leaf's size: the
    # low `level` bits of every coordinate are zero
    lvl = tree.level[nid.long()]
    low = (torch.ones_like(lvl) << lvl) - 1
    anchored = ((x | y | z) & low) == 0
    return torch.where(inb & anchored, nid, -1)


def leaf_grid_arrays(tree: LinearOctree, dims_xyz: Tuple[int, int, int]):
    """Dense per-voxel leaf data, numpy on the host: (leaf_size[z, y, x]
    int32, leaf_solid[z, y, x] bool, leaf_corner_id[z, y, x] int32, the
    leaf whose corner voxel it is, else -1). A helper for small scenes
    and debugging."""
    dx, dy, dz = dims_xyz
    xs, ys, zs, sizes = (t.cpu().numpy() for t in (tree.x, tree.y, tree.z,
                                                   tree.size))
    solid = tree.is_solid.cpu().numpy()
    leaf_size = np.zeros((dz, dy, dx), np.int32)
    leaf_solid = np.zeros((dz, dy, dx), bool)
    corner_id = np.full((dz, dy, dx), -1, np.int32)
    for i in np.nonzero(tree.is_leaf.cpu().numpy())[0]:
        x0, y0, z0, s = xs[i], ys[i], zs[i], sizes[i]
        if x0 >= dx or y0 >= dy or z0 >= dz:
            continue
        box = (slice(z0, min(z0 + s, dz)), slice(y0, min(y0 + s, dy)),
               slice(x0, min(x0 + s, dx)))
        leaf_size[box] = s
        leaf_solid[box] = solid[i]
        corner_id[z0, y0, x0] = i
    return leaf_size, leaf_solid, corner_id


def get_neighbors(tree: LinearOctree, node_idx) -> torch.Tensor:
    """Six face-neighbour node indices (or -1) per node, int32[..., 6]:
    ``getNeighbors`` (OctreeVoxel.cpp:559-630), the corner offset by
    +-size along each axis, resolved through the corner-key map."""
    idx = torch.as_tensor(node_idx, device=tree.device).long()
    x, y, z, s = tree.x[idx], tree.y[idx], tree.z[idx], tree.size[idx]
    return torch.stack([
        tree.find_node(x + dx * s, y + dy * s, z + dz * s)
        for dx, dy, dz in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                           (0, 0, 1), (0, 0, -1))], dim=-1)
