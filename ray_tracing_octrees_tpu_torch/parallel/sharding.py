"""Multi-device sharded tracing, frames and extraction on torch.distributed.

Counterpart of ``ray_tracing_octrees_tpu/parallel/sharding.py``. Every
function is SPMD: each rank of the mesh calls it with the same full
inputs, keeps only its shard (its ``dp`` slice of the rays, its ``tp`` /
``sp`` rows of the grid or of the sweep layout) and returns the global
result on every rank, all-gathered as JAX's global arrays are. The mesh
(:mod:`~ray_tracing_octrees_tpu_torch.parallel.mesh`) names the device:
CUDA, or the CPU where the caller built a CPU mesh. On a rank outside the
mesh (``make_mesh`` over fewer ranks than the group) every function
returns None and joins no collective.

The reference's two idioms, both producing the single-device result:

1. GSPMD, here DTensor: :func:`trace_sharded` and
   :func:`render_image_sharded` place the grid Z-sharded over ``tp`` and
   the rays over ``dp`` with ``distribute_tensor`` (each rank cuts its
   shard from its own full inputs: ``src_data_rank=None``, no scatter),
   and all-gather the grid's local shards over ``tp``: the all-gather
   XLA inserts. (``full_tensor()`` would gather through the functional
   collectives, whose wait segfaults with gloo on CUDA tensors, the
   layout of several ranks on one card.)
2. Explicit collectives, as ``shard_map``: :func:`trace_shardmap`
   all-gathers the Z-slabs; :func:`trace_segmented`, the slab-segmented
   fast and volume frames and :func:`marching_cubes_halo` never gather the
   grid: a min-combine of first hits, a pick-and-sum of what the winner
   holds, and a one-layer halo.

The Z-slab decomposition mirrors the reference's partial Z-slab cache
loads (CacheUtils.cpp:60-111). Collectives run on the process group's
own backend: NCCL on device tensors between cards, gloo on host tensors
on the CPU; gloo with CUDA tensors (several ranks on one card) takes them
for all-reduce and all-gather, and :func:`_p2p_buffer` copies the halo
exchange's tensors to the host.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from ray_tracing_octrees_tpu_torch._device import resolve_device
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
    lambert_shade,
)
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
    marching_cubes_grid,
)
from ray_tracing_octrees_tpu_torch.parallel.mesh import (
    grid_z_sharding, ray_sharding,
)
from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ss
from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree

f32 = torch.float32
_BIG = 3e38   # the miss sentinel of trace_segmented's min-combine


# --------------------------------------------------------------------------
# mesh axes and collectives
# --------------------------------------------------------------------------

def _on_mesh_ranks(fn):
    """``fn(mesh, ...)`` on the ranks ``mesh`` holds; None on any other
    rank of the group, which then joins none of ``fn``'s collectives (the
    ranks of a mesh smaller than the group take them alone)."""
    @functools.wraps(fn)
    def on_ranks(mesh: DeviceMesh, *args, **kwargs):
        if mesh.get_coordinate() is None:
            return None
        return fn(mesh, *args, **kwargs)
    return on_ranks


def _axis(mesh: DeviceMesh, name: str):
    """(process group, this rank's index, size) of mesh axis ``name``."""
    size = mesh.shape[mesh.mesh_dim_names.index(name)]
    return mesh.get_group(name), mesh.get_local_rank(name), size


def _distribute(t: torch.Tensor, mesh: DeviceMesh, placements):
    """``t`` as a DTensor with ``placements``, each rank's shard cut from
    its own copy of the full ``t`` (every rank passes the same inputs),
    so placing it sends nothing."""
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _whole_pyramid(occ: torch.Tensor, mesh: DeviceMesh):
    """The pyramid of the whole grid: ``occ`` placed Z-sharded over tp,
    its shards all-gathered in rank order."""
    tp_g, _, tp = _axis(mesh, "tp")
    local = _distribute(occ, mesh, grid_z_sharding(mesh)).to_local()
    return build_pyramid(_all_gather(local, tp_g, tp))


def _device(mesh: DeviceMesh) -> torch.device:
    return resolve_device(mesh.device_type)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The axis' ``t`` concatenated along dim 0, in rank order."""
    t = t.contiguous()
    out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _gather_dict(res: dict, group, size: int) -> dict:
    """Each leaf of ``res`` gathered over the axis."""
    return {k: _all_gather(v, group, size) for k, v in res.items()}


def _p2p_buffer(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` in the memory the group's send / recv reads: a host copy of
    a CUDA tensor when the backend is gloo, whose send and recv hand
    device pointers to its TCP transport (the process aborts on
    "writev ... Bad address"); ``t`` itself otherwise."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _ring_from_next(t: torch.Tensor, group, rank: int, size: int):
    """JAX's ``ppermute`` ring ``i -> i - 1``: send ``t`` to the previous
    rank of the axis; return what the next one sent."""
    send = _p2p_buffer(t.contiguous(), group)
    recv = torch.empty_like(send)
    peer = lambda r: dist.get_global_rank(group, r % size)
    ops = [dist.P2POp(dist.isend, send, peer(rank - 1), group),
           dist.P2POp(dist.irecv, recv, peer(rank + 1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


def _pad_to_multiple(a: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    pad = (-a.shape[axis]) % m
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], axis)


def _inputs(mesh, occ, origins, directions, grid_origin, voxel_size):
    """(occ padded to tp slabs, rays padded to dp slices, grid origin
    f32[3] and voxel size f32), on the mesh's device."""
    dev = _device(mesh)
    tp = _axis(mesh, "tp")[2]
    dp = _axis(mesh, "dp")[2]
    occ = _pad_to_multiple(torch.as_tensor(occ, device=dev), 0, tp)
    o = _pad_to_multiple(torch.as_tensor(origins, dtype=f32, device=dev),
                         0, dp)
    d = _pad_to_multiple(torch.as_tensor(directions, dtype=f32, device=dev),
                         0, dp)
    g0 = torch.as_tensor(np.asarray(ss._host(grid_origin), np.float32),
                         device=dev)
    vs = torch.as_tensor(np.float32(ss._host(voxel_size)), device=dev)
    return occ, o, d, g0, vs


def _rows_of(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows [i * len / n, (i + 1) * len / n) of ``x``."""
    per = x.shape[0] // n
    return x[i * per:(i + 1) * per]


def _slab_origin(g0, vs, zi: int, slab_z: int):
    """The Z-slab's grid origin: ``g0 + [0, 0, 1] * (zi * slab_z * vs)``,
    rounded as the reference's f32 ops."""
    step = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=g0.device)
    return g0 + step * (float(zi * slab_z) * vs)


# --------------------------------------------------------------------------
# the octree tracer, sharded
# --------------------------------------------------------------------------

@_on_mesh_ranks
def trace_sharded(mesh: DeviceMesh, occ, origins, directions, grid_origin,
                  voxel_size, max_steps: int = 512) -> dict:
    """GSPMD-style sharded trace: rays over dp, occupancy Z-slabs over tp.

    The grid is placed Z-sharded (``distribute_tensor``) and its shards
    all-gathered over tp, the all-gather XLA inserts; each rank traces its
    dp slice of the rays. Returns the trace dict over the rays padded to
    a multiple of dp, on every rank.
    """
    occ, o, d, g0, vs = _inputs(mesh, occ, origins, directions,
                                grid_origin, voxel_size)
    o_s = _distribute(o, mesh, ray_sharding(mesh))
    d_s = _distribute(d, mesh, ray_sharding(mesh))
    res = trace_octree(_whole_pyramid(occ, mesh), o_s.to_local(),
                       d_s.to_local(), g0, vs, max_steps=max_steps)
    dp_g, _, dp = _axis(mesh, "dp")
    return _gather_dict(res, dp_g, dp)


@_on_mesh_ranks
def trace_shardmap(mesh: DeviceMesh, occ, origins, directions, grid_origin,
                   voxel_size, max_steps: int = 512) -> dict:
    """Explicit-collective trace: all-gather the grid's Z-slabs over tp,
    private rays on dp. Returns what :func:`trace_sharded` returns."""
    occ, o, d, g0, vs = _inputs(mesh, occ, origins, directions,
                                grid_origin, voxel_size)
    tp_g, zi, tp = _axis(mesh, "tp")
    dp_g, ri, dp = _axis(mesh, "dp")
    occ_full = _all_gather(_rows_of(occ, zi, tp), tp_g, tp)
    res = trace_octree(build_pyramid(occ_full), _rows_of(o, ri, dp),
                       _rows_of(d, ri, dp), g0, vs, max_steps=max_steps)
    return _gather_dict(res, dp_g, dp)


@_on_mesh_ranks
def render_image_sharded(
    mesh: DeviceMesh,
    occ,
    origins,
    directions,
    grid_origin,
    voxel_size,
    light_dir=(-1.0, -1.0, -1.0),
    base_color=(1.0, 0.8, 0.6),
    ambient=(0.1, 0.1, 0.1),
    max_steps: int = 512,
    shadows: bool = True,
) -> torch.Tensor:
    """Full sharded render step (trace + shadow + shade), GSPMD style:
    grid Z-sharded over tp, rays and pixels over dp. Returns f32[N, 4]
    rgba on every rank."""
    n_rays = int(origins.shape[0])
    occ, o, d, g0, vs = _inputs(mesh, occ, origins, directions,
                                grid_origin, voxel_size)
    o_l = _distribute(o, mesh, ray_sharding(mesh)).to_local()
    d_l = _distribute(d, mesh, ray_sharding(mesh)).to_local()
    pyr = _whole_pyramid(occ, mesh)
    res = trace_octree(pyr, o_l, d_l, g0, vs, max_steps=max_steps)
    color = lambert_shade(res["normal"], res["hit"], light_dir, base_color,
                          ambient)
    if shadows:
        l = ss._unit(torch.as_tensor(light_dir, dtype=f32, device=o.device))
        so = res["point"] + res["normal"] * (vs * 2.0)
        sd = (-l)[None, :].expand(so.shape)
        sres = trace_octree(pyr, so, sd, g0, vs, max_steps=max_steps)
        occl = sres["hit"] & res["hit"]
        amb = torch.as_tensor(ambient, dtype=f32, device=o.device)
        color = torch.where(occl[:, None], amb.expand(color.shape), color)
    img = torch.cat([color, torch.ones_like(color[:, :1])], dim=-1)
    dp_g, _, dp = _axis(mesh, "dp")
    return _all_gather(img, dp_g, dp)[:n_rays]


@_on_mesh_ranks
def trace_segmented(mesh: DeviceMesh, occ, origins, directions, grid_origin,
                    voxel_size, max_steps: int = 512) -> dict:
    """Sequence-parallel tracing: rays split into per-rank Z-SEGMENTS.

    Each rank holds only its Z-slab of the grid (its pyramid built from
    the slab, its origin shifted by the slab's Z offset) and traces its
    dp slice of the rays through its own segment; the nearest hit wins
    by an all-reduce MIN of t over tp, point and normal follow by
    pick-and-SUM, steps are summed. Returns the trace dict, all-gathered
    over dp, on every rank.
    """
    occ, o, d, g0, vs = _inputs(mesh, occ, origins, directions,
                                grid_origin, voxel_size)
    tp_g, zi, tp = _axis(mesh, "tp")
    dp_g, ri, dp = _axis(mesh, "dp")
    slab_z = occ.shape[0] // tp
    res = trace_octree(build_pyramid(_rows_of(occ, zi, tp)),
                       _rows_of(o, ri, dp), _rows_of(d, ri, dp),
                       _slab_origin(g0, vs, zi, slab_z), vs,
                       max_steps=max_steps)
    t = torch.where(res["hit"], res["t"], _BIG)
    t_min = _all_reduce(t, dist.ReduceOp.MIN, tp_g)
    won = res["hit"] & (t == t_min)
    hit_any = t_min < _BIG

    def pick(x):
        x = torch.where(won.reshape((-1,) + (1,) * (x.ndim - 1)), x, 0.0)
        return _all_reduce(x, dist.ReduceOp.SUM, tp_g)

    return _gather_dict(dict(
        hit=hit_any,
        t=torch.where(hit_any, t_min, 0.0),
        point=pick(res["point"]),
        normal=pick(res["normal"]),
        steps=_all_reduce(res["steps"], dist.ReduceOp.SUM, tp_g),
    ), dp_g, dp)


# --------------------------------------------------------------------------
# the slab-segmented frames
# --------------------------------------------------------------------------

def _segment(S: int, n: int, r: int) -> Tuple[int, int]:
    """(first row, rows) of rank ``r``'s segment: the sweep layout's S
    slabs padded to a whole number of 32-slab chunks on each of n ranks."""
    sp = S + (-S) % ss.CH
    sp_l = (sp + (-sp) % (ss.CH * n)) // n
    return r * sp_l, sp_l


@_on_mesh_ranks
def sweep_packed_segmented(
    mesh: DeviceMesh,
    volume,             # f32[Z, Y, X]
    shadow_vol,         # f32[Z, Y, X] from slab_sweep.shadow_volume, or None
    grid_origin,
    voxel_size,
    camera_pos,
    view,
    fov_deg: float,
    aspect: float,
    inter_h: Optional[int] = None,
    inter_w: Optional[int] = None,
    axis: str = "sp",
    light_dir=(-1.0, -1.0, -1.0),
    base_color=(1.0, 0.8, 0.6),
    ambient=(0.1, 0.1, 0.1),
    layouts: Optional[ss.SweepLayouts] = None,
):
    """The production slab-sweep first hit, slab-segmented across ranks.

    The sweep layout's rows, padded to ``32 * n``, split evenly over the
    n ranks of mesh axis ``axis``: rank r sweeps only rows [r * sp_l,
    (r + 1) * sp_l) with ``_sweep_core(..., o_base=r * sp_l)``. The global
    first hit per texel is an all-reduce MIN of first_o (ray order is
    layout row order; the miss sentinel S + 1 loses every min); the
    winner's shadow sample follows by pick-and-SUM (rows are globally
    unique, so exactly one rank wins and the sum is exact). A rank keeps
    only its rows on its device, copied from the volume's (the whole
    layout is never built), in ``layouts`` when given (one per scene, as
    for ``render_fast_frame``) or anew. Returns (packed f32[IH, IW] as
    ``_sweep_all``'s, the scalars on the device, the geometry statics).
    """
    dev = _device(mesh)
    grp, r, n = _axis(mesh, axis)
    layouts = ss._scene_layouts(volume, shadow_vol, layouts, dev)
    origin = np.asarray(ss._host(grid_origin), np.float32)
    vox = float(ss._host(voxel_size))
    axis_world, flip, (S, A, B), window, scal_np, crop_lo = \
        ss._frame_geometry(layouts.volume.shape, origin, vox, camera_pos,
                           view, fov_deg, aspect, light_dir, base_color,
                           ambient)
    auto_h, auto_w = ss._auto_inter(window)
    inter_h = auto_h if inter_h is None else inter_h
    inter_w = auto_w if inter_w is None else inter_w
    lo, sp_l = _segment(S, n, r)

    def rows(which):
        src = layouts.volume if which == "volume" else layouts.shadow
        return layouts.derived(
            ("rows", which, axis_world, flip, S, crop_lo, lo, sp_l),
            lambda: ss._layout_rows(src, axis_world, flip, S, crop_lo, lo,
                                 sp_l))

    has_shadow = layouts.shadow is not None
    scal = torch.as_tensor(scal_np, device=dev)
    first_o, sh_first = ss._sweep_core(
        rows("volume"), scal, S, A, B, inter_h, inter_w, flip,
        shadow_sw=rows("shadow") if has_shadow else None, o_base=lo)
    fo = _all_reduce(first_o, dist.ReduceOp.MIN, grp)
    if has_shadow:
        won = (first_o == fo) & (fo < float(S))
        shw = _all_reduce(torch.where(won, sh_first, 0.0),
                          dist.ReduceOp.SUM, grp)
    else:
        shw = torch.zeros_like(fo)
    packed = ss._pack_first_o(fo, shw, S, flip, has_shadow)
    return packed, scal, dict(
        axis_world=axis_world, flip=flip, S=S, A=A, B=B, inter_h=inter_h,
        inter_w=inter_w, has_shadow=has_shadow, scal_np=scal_np)


@_on_mesh_ranks
def sweep_frame_segmented(
    mesh: DeviceMesh,
    volume,
    shadow_vol,
    grid_origin,
    voxel_size,
    camera_pos,
    view,
    fov_deg: float,
    aspect: float,
    width: int,
    height: int,
    light_dir=(-1.0, -1.0, -1.0),
    base_color=(1.0, 0.8, 0.6),
    ambient=(0.1, 0.1, 0.1),
    inter_h: Optional[int] = None,
    inter_w: Optional[int] = None,
    axis: str = "sp",
    layouts: Optional[ss.SweepLayouts] = None,
) -> torch.Tensor:
    """The fast frame (sweep + lookup + Lambert / shadow shade) with the
    sweep slab-segmented across the mesh: the multi-device variant of
    ``slab_sweep.render_fast_frame(..., fused=False)``, equal to it bit
    for bit. The packed table comes back whole on every rank from the
    combine, and each rank runs the per-pixel finish (ray set-up,
    ``warp_lookup``, shading). Returns f32[H, W, 4] rgba."""
    packed, scal, meta = sweep_packed_segmented(
        mesh, volume, shadow_vol, grid_origin, voxel_size, camera_pos,
        view, fov_deg, aspect, inter_h=inter_h, inter_w=inter_w, axis=axis,
        light_dir=light_dir, base_color=base_color, ambient=ambient,
        layouts=layouts)
    ih, iw = meta["inter_h"], meta["inter_w"]
    lin, behind, dirs, d_s_n = ss._warp_setup(
        scal, meta["axis_world"], ih, iw, width, height,
        torch.as_tensor(ss._view_consts(meta["scal_np"]), device=scal.device))
    w_val = ss._warp_values(packed, lin, ih, iw, width, height)
    return ss._finish_shade(w_val, behind, dirs, d_s_n, scal, width, height,
                            meta["has_shadow"])


@_on_mesh_ranks
def volume_frame_segmented(
    mesh: DeviceMesh,
    scene: rs.VolumeSweepScene,
    grid_origin,
    camera_pos,
    view,
    fov_deg: float,
    aspect: float,
    width: int,
    height: int,
    time_value: float = 0.0,
    axis: str = "sp",
) -> dict:
    """The VOLUME_RAYCAST fast frame, slab-segmented across ranks.

    Each rank holds only its rows of the detection and packed field
    layouts (copied from the scene's volumes and kept in
    ``scene.layouts``; the whole layouts are never built), sweeps them
    with ``_volume_sweep_core(..., o_base=...)``, the global first hit is
    an all-reduce MIN, and the winner's field values (24-bit integers in
    f32, so the sum is exact) follow by pick-and-SUM. The per-pixel half
    runs on every rank: ``_gather_table`` (``warp_lookup_multi``) and
    ``_shade_pixels``. Equal to ``render_volume_frame`` bit for bit;
    returns its dict.
    """
    dev = _device(mesh)
    if scene.device != dev:
        raise ValueError(f"the scene is on {scene.device}, not {dev}")
    grp, r, n = _axis(mesh, axis)

    def rows_bundle(scene, axis_world, flip, S, crop_lo):
        lo, sp_l = _segment(S, n, r)
        key = ("rows", axis_world, flip, S, crop_lo, lo, sp_l)
        ent = scene.layouts.get(key)
        if ent is None:
            rows = lambda v: ss._layout_rows(v, axis_world, flip, S, crop_lo,
                                          lo, sp_l)
            ent = (rows(scene.det),
                   [torch.cat([rows(fv) for fv in ch], dim=2)
                    for ch in scene.bundles])
            scene.layouts.clear()
            scene.layouts[key] = ent
        return ent

    det_l, cats_l, scal_np, m = rs._volume_frame_inputs(
        scene, grid_origin, camera_pos, view, fov_deg, aspect,
        layout=rows_bundle)
    S, ih, iw = m["S"], m["inter_h"], m["inter_w"]
    scal = torch.as_tensor(scal_np, device=dev)
    fo, vals = rs._volume_sweep_core(
        det_l, cats_l, scal, S, m["A"], m["B"], ih, iw, m["flip"], m["nf"],
        o_base=_segment(S, n, r)[0])
    fo_g = _all_reduce(fo, dist.ReduceOp.MIN, grp)
    won = (fo == fo_g) & (fo_g < float(S))
    vals_g = tuple(_all_reduce(torch.where(won, v, 0.0), dist.ReduceOp.SUM,
                               grp) for v in vals)
    packed, flat_vals = rs._pack_volume_first_o(fo_g, vals_g, S, m["flip"])
    lin, behind, dirs, d_s_n = ss._warp_setup(
        scal, m["axis_world"], ih, iw, width, height,
        torch.as_tensor(ss._view_consts(scal_np), device=dev))
    w_depth, w_vals = rs._gather_table(packed, flat_vals, lin, ih, iw, width,
                                       height)
    return rs._shade_pixels(w_depth, w_vals, behind, dirs, d_s_n, scal,
                            time_value, width, height)


# --------------------------------------------------------------------------
# Marching Cubes on Z-slab shards
# --------------------------------------------------------------------------

@_on_mesh_ranks
def marching_cubes_halo(mesh: DeviceMesh, occ, grid_origin, voxel_size,
                        max_triangles_per_shard: int):
    """Tensor-parallel Marching Cubes on Z-slab-resident grids.

    The grid lives in Z-slabs over ``tp`` (each rank keeps its slab) and
    never all-gathers. Each MC cell reads a +1 lattice halo in Z, so every
    rank sends its FIRST occupancy layer to its -Z neighbour once per
    extraction (JAX's ``ppermute`` ring; with one shard there is no
    neighbour): the only exchange. The last shard's halo is empty, and
    cells at global z >= Z - 1 are masked, so the output equals dense MC.

    Returns (verts f32[tp * cap, 3, 3], normals f32[tp * cap, 3], counts
    i32[tp]), all-gathered over tp on every rank: shard s's triangles
    occupy verts[s * cap : s * cap + counts[s]].
    """
    dev = _device(mesh)
    grp, zi, tp = _axis(mesh, "tp")
    occ = torch.as_tensor(occ, device=dev)
    Z = occ.shape[0]
    occ = _pad_to_multiple(occ, 0, tp)
    zl = occ.shape[0] // tp
    g0 = torch.as_tensor(np.asarray(ss._host(grid_origin), np.float32),
                         device=dev)
    vs = torch.as_tensor(np.float32(ss._host(voxel_size)), device=dev)
    slab = _rows_of(occ, zi, tp)
    halo = _ring_from_next(slab[:1], grp, zi, tp) if tp > 1 else None
    if zi == tp - 1:
        halo = torch.zeros_like(slab[:1])
    occ_ext = torch.cat([slab, halo], dim=0)              # [zl + 1, Y, X]
    lgrid = VoxelGrid(occ=occ_ext, origin=_slab_origin(g0, vs, zi, zl),
                      voxel_size=vs)
    # mask cells whose GLOBAL z has no dense-MC counterpart
    cz = torch.arange(zl, device=dev)[:, None, None] + zi * zl
    cell_mask = (cz < Z - 1).expand(zl, occ_ext.shape[1] - 1,
                                    occ_ext.shape[2] - 1)
    verts, normals, count = marching_cubes_grid(
        lgrid, max_triangles=max_triangles_per_shard, cell_mask=cell_mask,
        device=dev)
    return (_all_gather(verts, grp, tp), _all_gather(normals, grp, tp),
            _all_gather(count.reshape(1).to(torch.int32), grp, tp))
