"""Sweep-exact octree tracer: the exact tracer's first hit through the sweep.

Counterpart of ``ray_tracing_octrees_tpu/trace/sweep_exact.py``. The
DDA tracer (:mod:`.octree_trace`) walks every ray; this module reaches
the same first hits, the reference's intersectOctreeIterative semantics
(RayTracerBVH.cpp:239-327), through the slab-sweep machinery:

1. DETECTION hats whose per-slab footprint is WIDENED by the texel
   half-cell, so a texel's candidate bits (``mesh_grid._sweep_candidates``)
   are a proven superset of the solid crossings of every pixel ray
   through its lattice cell (bit o = "some cell the ray crosses in slab o
   is solid").
2. CONSUME rounds on the actual pixel rays: each round takes one
   candidate slab per unresolved ray, fetches the packed ta x tb
   neighbourhood occupancy of its footprint (one lookup) and runs exact
   ray/AABB tests on those cells. Cells of slab o span s in [k, k + 1],
   so slab order is t order: the first slab with a valid solid crossing
   holds the nearest hit, t = max(entry, 0) — the reference's
   tNear-of-solid-leaf semantics (RayTracerBVH.cpp:283-287).
3. The leaf node of the hit (for the normalize(p - nodeCenter) normal)
   from one lookup of the leaf volume (``core/octree.build_leaf_volume``).

Shadow rays share one direction, so their detection field is an
orthographic light-space sweep built once per scene and light
(:func:`build_shadow_field`); only the consume rounds run per frame.
The per-pixel dead test (a texel with no candidate at all) runs through
:func:`warp_kernel.warp_lookup` on the texel any-flag table.

Exactness envelope (host gate, :func:`sweep_exact_setup`): the eye
outside the volume along the sweep axis, and footprints within a 3-tap
window per axis, or 5 taps on one axis. Where the reference runs its
rounds on fixed-width ladders and counts the rows past a stage as
overflow, the port compacts to the unresolved rows every round, so
overflow is 0 by construction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import dataclasses
from typing import Optional

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.trace import mesh_grid
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
    _AXIS_SELECTORS, _SAB_IDX, _auto_inter, _fdiv, _frame_scalars_np, _host,
    _scene_layouts, _sqrt, _sweep_geometry, _unit, _view_consts,
    first_set_from,
)
from ray_tracing_octrees_tpu_torch.trace.warp_kernel import warp_lookup

_BIG = 3.0e38
_DEG = 1e-12


# --------------------------------------------------------------------------
# packed neighbourhood occupancy (the consume rounds' one lookup)
# --------------------------------------------------------------------------

def _shift_axis(cs, off: int, axis: int):
    """Zero-padded shift: result[..., i, ...] = cs[..., i + off, ...]."""
    if off == 0:
        return cs
    shape = list(cs.shape)
    shape[axis] = abs(off)
    zeros = torch.zeros(shape, dtype=cs.dtype, device=cs.device)
    n = cs.shape[axis]
    if off > 0:
        return torch.cat([cs.narrow(axis, off, n - off), zeros], dim=axis)
    return torch.cat([zeros, cs.narrow(axis, 0, n + off)], dim=axis)


def _pack_neighborhood(occ_sw, ta: int = 3, tb: int = 3):
    """f32[sp*A*B]: bit tb*(da+ra) + (db+rb) set iff cell (o, a+da, b+db)
    is solid (ra = (ta-1)//2, rb = (tb-1)//2; zeros past the lateral
    edges) — the bit scheme of the detection taps, so one lookup answers
    a round's whole ta x tb footprint. ta*tb <= 15 keeps it f32-exact."""
    if ta * tb > 15:
        raise ValueError(f"tap window {ta}x{tb} exceeds 15 bits")
    ra, rb = (ta - 1) // 2, (tb - 1) // 2
    cs = (occ_sw > 0).to(torch.float32)
    out = torch.zeros_like(cs)
    for da in range(-ra, ra + 1):
        sa_ = _shift_axis(cs, da, 1)
        for db in range(-rb, rb + 1):
            # neighbour value at (a+da, b+db) lands at (a, b)
            out = out + _shift_axis(sa_, db, 2) * float(
                2 ** (tb * (da + ra) + (db + rb)))
    return out.reshape(-1)


def _nb9_for(layouts, axis_world: int, flip: bool, S: int, ta: int = 3,
             tb: int = 3):
    """The packed neighbourhood of the scene's sweep layout, kept in the
    caller's per-scene ``layouts`` (the reference's id-keyed cache)."""
    key = ("nb9", axis_world, bool(flip), S, ta, tb)
    return layouts.derived(key, lambda: _pack_neighborhood(
        layouts.get("volume", axis_world, flip, S, 0), ta, tb))


# --------------------------------------------------------------------------
# widened detection hats
# --------------------------------------------------------------------------

def _tap_weights(ta: int, tb: int):
    """Per-axis integer weights whose products enumerate distinct bits:
    a-tap da -> 2^(tb*(da+ra)), b-tap db -> 2^(db+rb)."""
    ra, rb = (ta - 1) // 2, (tb - 1) // 2
    wa = [float(2 ** (tb * i)) for i in range(ta)]
    wb = [float(2 ** i) for i in range(tb)]
    return ra, rb, wa, wb


def _widened_perspective_hats(scal, sp: int, s_valid: int, a_size: int,
                              b_size: int, inter_h: int, inter_w: int,
                              flip: bool, ta: int = 3, tb: int = 3):
    """Per-frame detection hats with footprint masks widened so each
    texel's bits cover EVERY ray through its lattice cell.

    For a ray through window coordinate ua, the slab-centre position is
    pa(ua, o) = eye_a + (ua - eye_a) * inv_s(o) and its in-slab footprint
    half-width is 0.5 |ua - eye_a| / |z0 - eye_s|. Over the texel cell
    |ua - ua0| <= ha the footprints lie within pa0 +- (half0 + wa(o)),
    wa(o) = ha * (|inv_s(o)| + 0.5 / |z0 - eye_s|).

    ``scal`` is the f32 frame-scalar tensor on the device. Returns
    (ma_w bf16[sp, IH, A], mb_w bf16[sp, IW, B], am f32[sp, IH],
    bm f32[sp, IW]).
    """
    f32 = torch.float32
    dev = scal.device
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]

    ua = a_min + _fdiv((a_max - a_min) * (
        torch.arange(inter_h, dtype=f32, device=dev) + 0.5), inter_h)
    ub = b_min + _fdiv((b_max - b_min) * (
        torch.arange(inter_w, dtype=f32, device=dev) + 0.5), inter_w)
    ha = _fdiv(0.5 * (a_max - a_min), inter_h)
    hb = _fdiv(0.5 * (b_max - b_min), inter_w)
    o_all = torch.arange(sp, dtype=f32, device=dev)
    k_all = (float(s_valid) - 1.0 - o_all) if flip else o_all
    inv_s = (k_all + 0.5 - eye_s) / (z0 - eye_s)             # 1/s_scale
    pa_all = eye_a + (ua[None, :] - eye_a) * inv_s[:, None]  # [sp, IH]
    pb_all = eye_b + (ub[None, :] - eye_b) * inv_s[:, None]  # [sp, IW]
    inv_z = 0.5 / (z0 - eye_s).abs()
    wa = ha * (inv_s.abs() + inv_z)                          # [sp]
    wb = hb * (inv_s.abs() + inv_z)
    half_a = 0.5 * ((ua - eye_a) / (z0 - eye_s)).abs()       # [IH]
    half_b = 0.5 * ((ub - eye_b) / (z0 - eye_s)).abs()       # [IW]

    ra, rb, wa_l, wb_l = _tap_weights(ta, tb)
    ma_w = _taps(pa_all, a_size, ra, wa_l)
    mb_w = _taps(pb_all, b_size, rb, wb_l)
    am = _fmask(pa_all, half_a[None, :] + wa[:, None], ra, wa_l)
    bm = _fmask(pb_all, half_b[None, :] + wb[:, None], rb, wb_l)
    return ma_w, mb_w, am, bm


def _taps(p_all, size: int, r: int, weights):
    """Occupancy taps: weight w_i on the cell floor(p) + (i - r), i.e. the
    power of two 2^(stride * i) at tap index i = a - floor(p) + r, zero
    outside [0, len(weights)). Built by integer shifts, exact in bf16."""
    nw = len(weights)
    stride = 0 if nw < 2 else int(round(math.log2(weights[1])))
    d2 = (torch.arange(size, dtype=torch.float32, device=p_all.device)
          - torch.floor(p_all)[..., None] + float(r))  # tap index per cell
    inside = (d2 >= 0) & (d2 < nw)
    e = (d2.clamp(0, nw - 1).to(torch.int32) * stride)
    m = torch.where(inside, torch.bitwise_left_shift(torch.ones_like(e), e)
                    .to(torch.float32), 0.0)
    return m.to(torch.bfloat16)


def _fmask(p_all, ext, r: int, weights):
    """Footprint-interval mask: sum of w_i over cell offsets (i - r) inside
    [floor(p - ext), floor(p + ext)] - floor(p). Exact while ext <= r (the
    support gate)."""
    lo = torch.floor(p_all - ext) - torch.floor(p_all)
    hi = torch.floor(p_all + ext) - torch.floor(p_all)
    m = torch.zeros(p_all.shape, dtype=torch.float32, device=p_all.device)
    for i, w in enumerate(weights):
        da = float(i - r)
        m = m + w * ((lo <= da) & (da <= hi)).to(torch.float32)
    return m


def _ortho_hats(sa: float, sb: float, aa_min: float, aa_span: float,
                ab_min: float, ab_span: float, sp: int, s_valid: int,
                a_size: int, b_size: int, inter_h: int, inter_w: int,
                flip: bool, ta: int = 3, tb: int = 3, device=None):
    """Detection hats of the orthographic light-space sweep.

    Shadow rays share one direction, so a ray is named by its intercept
    (alpha_a, alpha_b): its lateral position at slab k is alpha + slope *
    (k + 0.5) with the shared slope (sa, sb). The footprint half-width is
    the constant |slope| / 2 and the texel-cell widening exactly the half
    lattice spacing. Returns (ma_w, mb_w, am, bm) as
    :func:`_widened_perspective_hats`.
    """
    f32 = torch.float32
    aa = aa_min + _fdiv(aa_span * (torch.arange(
        inter_h, dtype=f32, device=device) + 0.5), inter_h)
    ab = ab_min + _fdiv(ab_span * (torch.arange(
        inter_w, dtype=f32, device=device) + 0.5), inter_w)
    ha = 0.5 * aa_span / inter_h
    hb = 0.5 * ab_span / inter_w
    o_all = torch.arange(sp, dtype=f32, device=device)
    k_all = (float(s_valid) - 1.0 - o_all) if flip else o_all
    pa_all = aa[None, :] + sa * (k_all[:, None] + 0.5)       # [sp, IH]
    pb_all = ab[None, :] + sb * (k_all[:, None] + 0.5)       # [sp, IW]
    ra, rb, wa_l, wb_l = _tap_weights(ta, tb)
    ma_w = _taps(pa_all, a_size, ra, wa_l)
    mb_w = _taps(pb_all, b_size, rb, wb_l)
    am = _fmask(pa_all, float(np.float32(abs(sa) * 0.5 + ha)), ra, wa_l)
    bm = _fmask(pb_all, float(np.float32(abs(sb) * 0.5 + hb)), rb, wb_l)
    return ma_w, mb_w, am, bm


# --------------------------------------------------------------------------
# exact consume: rounds of (first-set-bit slab -> ta x tb cell AABB tests)
# --------------------------------------------------------------------------

def _axis_interval(ro, rd, lo, hi):
    """Exact slab interval (tin, tout) of ray coordinate ro + t*rd within
    [lo, hi); degenerate axes (|rd| ~ 0) resolve by position."""
    deg = rd.abs() < _DEG
    inv = 1.0 / torch.where(deg, 1.0, rd)
    t0 = (lo - ro) * inv
    t1 = (hi - ro) * inv
    tin = torch.minimum(t0, t1)
    tout = torch.maximum(t0, t1)
    inside = (ro >= lo) & (ro < hi)
    tin = torch.where(deg, torch.where(inside, -_BIG, _BIG), tin)
    tout = torch.where(deg, torch.where(inside, _BIG, -_BIG), tout)
    return tin, tout


def _consume_state(m: int, device):
    z = lambda dt: torch.zeros(m, dtype=dt, device=device)
    return dict(ptr=z(torch.int32), resolved=z(torch.bool),
                hit=z(torch.bool), t=z(torch.float32), ks=z(torch.int32),
                ca=z(torch.int32), cb=z(torch.int32))


def _slab_pass(o_f, ro3, rd3, nb9, s_valid: int, a_size: int, b_size: int,
               flip: bool, ta: int = 3, tb: int = 3):
    """One candidate slab per row: packed-neighbourhood lookup + exact
    ta x tb cell AABB tests. ``ro3`` / ``rd3`` are (s, a, b) component
    tuples of [m] tensors. Returns (anyhit, t_entry, k, ca, cb) with t in
    rd3's parametrization and t_entry = max(entry, 0)."""
    f32 = torch.float32
    i32 = torch.int32
    ra, rb = (ta - 1) // 2, (tb - 1) // 2
    k = (float(s_valid) - 1.0 - o_f) if flip else o_f
    ro_s, ro_a, ro_b = ro3
    rd_s, rd_a, rd_b = rd3
    t_c = (k + 0.5 - ro_s) / rd_s          # rd_s never ~0 (axis choice)
    pa = ro_a + rd_a * t_c
    pb = ro_b + rd_b * t_c
    ca = torch.floor(pa)
    cb = torch.floor(pb)

    # Look the mask up at the CLAMPED centre: in-bounds footprint cells of
    # an out-of-bounds centre still lie in the clamped centre's window,
    # their bit slot shifted by the clamp offset (cells needing a shift
    # past r are outside the grid and masked by inb_a / inb_b).
    ca_c = ca.clamp(0.0, a_size - 1.0)
    cb_c = cb.clamp(0.0, b_size - 1.0)
    sh_a = (ca - ca_c).to(i32)
    sh_b = (cb - cb_c).to(i32)
    fi = ((o_f * a_size + ca_c) * b_size + cb_c).to(i32)
    mask = torch.take(nb9, fi.clamp(0, nb9.numel() - 1).long()).to(i32)

    das = [float(i - ra) for i in range(ta)]
    dbs = [float(i - rb) for i in range(tb)]
    ts_in, ts_out = _axis_interval(ro_s, rd_s, k, k + 1.0)
    tia = [_axis_interval(ro_a, rd_a, ca + da, ca + da + 1.0) for da in das]
    tib = [_axis_interval(ro_b, rd_b, cb + db, cb + db + 1.0) for db in dbs]
    inb_a = [(ca + da >= 0) & (ca + da < a_size) for da in das]
    inb_b = [(cb + db >= 0) & (cb + db < b_size) for db in dbs]

    best_t = torch.full(pa.shape, _BIG, dtype=f32, device=pa.device)
    best_ca = torch.zeros(pa.shape, dtype=f32, device=pa.device)
    best_cb = torch.zeros(pa.shape, dtype=f32, device=pa.device)
    for ia, da in enumerate(das):
        for ib, db in enumerate(dbs):
            sia = ia + sh_a
            sib = ib + sh_b
            slot_ok = (sia >= 0) & (sia <= ta - 1) & (sib >= 0) & (sib <= tb - 1)
            slot = (sia * tb + sib).clamp(0, ta * tb - 1)
            bit = (mask >> slot) & 1
            tin = torch.maximum(ts_in, torch.maximum(tia[ia][0], tib[ib][0]))
            tout = torch.minimum(ts_out, torch.minimum(tia[ia][1], tib[ib][1]))
            valid = ((bit != 0) & slot_ok & inb_a[ia] & inb_b[ib]
                     & (tin <= tout) & (tout > 0.0))
            t_cell = torch.where(valid, torch.clamp(tin, min=0.0), _BIG)
            better = t_cell < best_t
            best_t = torch.where(better, t_cell, best_t)
            best_ca = torch.where(better, ca + da, best_ca)
            best_cb = torch.where(better, cb + db, best_cb)
    return best_t < _BIG, best_t, k, best_ca, best_cb


def _consume_round(st, c_bits, ro3, rd3, nb9, s_valid: int, a_size: int,
                   b_size: int, flip: bool, ta: int = 3, tb: int = 3):
    ptr, resolved = st["ptr"], st["resolved"]
    has, o_i = first_set_from(c_bits, ptr)
    act = ~resolved & has
    anyhit, t_min, k, wca, wcb = _slab_pass(
        o_i.to(torch.float32), ro3, rd3, nb9, s_valid, a_size, b_size, flip,
        ta, tb)
    newly = act & anyhit
    miss = act & ~anyhit
    exh = ~resolved & ~has
    return dict(
        ptr=torch.where(miss, o_i + 1, ptr),
        resolved=resolved | newly | exh,
        hit=st["hit"] | newly,
        t=torch.where(newly, t_min, st["t"]),
        ks=torch.where(newly, k.to(torch.int32), st["ks"]),
        ca=torch.where(newly, wca.to(torch.int32), st["ca"]),
        cb=torch.where(newly, wcb.to(torch.int32), st["cb"]),
    )


def _consume_ladder(bits, ptr0, ro3, rd3, nb9, s_valid: int, a_size: int,
                    b_size: int, flip: bool, max_rounds: int, ta: int = 3,
                    tb: int = 3):
    """Consume rounds until every row is resolved (or ``max_rounds``).

    ``bits`` int32[m, C] candidate words per row, ``ptr0`` int32[m] the
    first eligible slab, ``ro3`` / ``rd3`` (s, a, b) tuples of [m]
    tensors. Returns (state dict over the m rows, rounds run).

    The reference runs the rounds on a ladder of fixed-width stages and
    leaves rows past a stage's width unresolved, counted as overflow.
    Here every round runs on exactly the rows still unresolved, gathered
    with a boolean index, so the compaction never drops a row: overflow
    is 0 by construction.
    """
    st = _consume_state(ptr0.shape[0], ptr0.device)
    st["ptr"] = ptr0.clone()
    act = torch.arange(ptr0.shape[0], device=ptr0.device)
    rounds = 0
    while rounds < max_rounds and act.numel():
        sub = {k: v[act] for k, v in st.items()}
        out = _consume_round(sub, bits[act], tuple(r[act] for r in ro3),
                             tuple(r[act] for r in rd3), nb9, s_valid,
                             a_size, b_size, flip, ta, tb)
        for k, v in out.items():
            st[k][act] = v
        rounds += 1
        act = act[~out["resolved"]]
    return st, rounds


# --------------------------------------------------------------------------
# scene-level preparation (host)
# --------------------------------------------------------------------------

def _pick_taps(ext_a: float, ext_b: float):
    """Smallest (ta, tb) tap window covering the per-axis footprint
    extents, or None: (3, 3) while both fit in +-1; one axis may widen to
    5 taps (+-2), not both (ta * tb <= 15 keeps the weights f32-exact)."""
    need = lambda e: 3 if e <= 0.999 else (5 if e <= 1.999 else None)
    na, nb_ = need(ext_a), need(ext_b)
    if na is None or nb_ is None or na * nb_ > 15:
        return None
    return na, nb_


def sweep_exact_setup(volume, grid_origin, voxel_size, camera_pos, view,
                      max_inter: int = 1024, density: float = 6.0,
                      layouts=None, device: DeviceLike = None):
    """Host gate + configuration of the exact sweep for one pose.

    Returns (ok, cfg): ok=False when the pose leaves the exactness
    envelope (interior eye, or footprint + pad past the tap window). cfg
    holds the sweep case, the bf16 sweep-order volume ``occ_sw`` and its
    packed neighbourhood ``nb9`` (both kept in ``layouts``, the caller's
    per-scene :class:`slab_sweep.SweepLayouts`, built anew when None),
    the frame scalars ``scal_np``, the lattice ``IH`` x ``IW`` and the
    taps ``ta`` x ``tb``. ``density``: lattice texels per voxel;
    exactness does not depend on it.
    """
    dev = resolve_device(device)
    layouts = _scene_layouts(volume, ..., layouts, dev)
    origin = np.asarray(_host(grid_origin), np.float32)
    vox = float(_host(voxel_size))
    axis_world, flip, (S, A, B), eyes, window, crop_lo = _sweep_geometry(
        layouts.volume.shape, origin, vox, camera_pos, view)
    if crop_lo != 0:
        return False, None                          # interior eye
    eye_s, eye_a, eye_b, z0 = eyes
    a_min, a_max, b_min, b_max = window
    # A ray can hit a boundary cell with its slab-centre position up to one
    # footprint half-width outside [0, ext]; widen the lattice window by 1
    # per side so the in-window dead test and clamped lookup stay supersets.
    a_min, a_max = a_min - 1.0, a_max + 1.0
    b_min, b_max = b_min - 1.0, b_max + 1.0
    IH, IW = _auto_inter((a_min, a_max, b_min, b_max), max_inter, density)
    dz = abs(z0 - eye_s)
    # max |1/s_scale| over slabs (monotone in k: check the ends)
    inv_max = max(abs((k + 0.5 - eye_s) / (z0 - eye_s)) for k in (0, S - 1))
    ha = 0.5 * (a_max - a_min) / IH
    hb = 0.5 * (b_max - b_min) / IW
    half_a_max = 0.5 * max(abs(a_min - eye_a), abs(a_max - eye_a)) / dz
    half_b_max = 0.5 * max(abs(b_min - eye_b), abs(b_max - eye_b)) / dz
    taps = _pick_taps(half_a_max + ha * (inv_max + 0.5 / dz),
                      half_b_max + hb * (inv_max + 0.5 / dz))
    if taps is None:
        return False, None
    ta, tb = taps
    flip = bool(flip)
    scal_np = _frame_scalars_np(
        eye_s, eye_a, eye_b, z0, a_min, a_max, b_min, b_max, 0.0, 0.0, vox,
        S, origin, np.asarray(camera_pos, np.float32), view)
    cfg = dict(axis_world=axis_world, flip=flip, S=S, A=A, B=B,
               occ_sw=layouts.get("volume", axis_world, flip, S, 0),
               nb9=_nb9_for(layouts, axis_world, flip, S, ta, tb),
               scal_np=scal_np, IH=IH, IW=IW, ta=ta, tb=tb, layouts=layouts)
    return True, cfg


# --------------------------------------------------------------------------
# pixel rays
# --------------------------------------------------------------------------

def _rays_sab_from_xy(xf, yf, scal, consts, axis_world: int, width: int,
                      height: int):
    """Ray directions as (s, a, b) component tensors for pixel coordinates
    (xf, yf): render/camera.py::generate_rays' math (normalize in view
    space, rotate, normalize in world space) one component at a time.
    ``consts`` is :func:`slab_sweep._view_consts` on the device."""
    tan_half, rot = consts[0], consts[1:10].reshape(3, 3)
    aspect = scal[9]
    nxf = (_fdiv(xf + 0.5, width) * 2.0 - 1.0) * aspect * tan_half
    nyf = (1.0 - _fdiv(yf + 0.5, height) * 2.0) * tan_half
    inv1 = 1.0 / _sqrt(nxf * nxf + nyf * nyf + 1.0)
    dv = (nxf * inv1, nyf * inv1, -inv1)
    dw = [dv[0] * rot[c, 0] + dv[1] * rot[c, 1] + dv[2] * rot[c, 2]
          for c in range(3)]
    inv2 = 1.0 / _sqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
    dw = [c * inv2 for c in dw]
    return tuple(dw[i] for i in _SAB_IDX[axis_world])


def _pixel_rays_sab(scal, consts, axis_world: int, width: int, height: int):
    """Full-frame (s, a, b) ray components [N] (row major from the top)."""
    f32 = torch.float32
    dev = scal.device
    yg, xg = torch.meshgrid(torch.arange(height, dtype=f32, device=dev),
                            torch.arange(width, dtype=f32, device=dev),
                            indexing="ij")
    return _rays_sab_from_xy(xg.reshape(-1), yg.reshape(-1), scal, consts,
                             axis_world, width, height)


# --------------------------------------------------------------------------
# the camera-independent shadow field (once per scene and light)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShadowField:
    """Exact shadow-ray field for one (scene, light).

    ``bits[texel, word]``: the per-slab candidate bit field of the
    light-space texel lattice (orthographic sweep along the light's
    dominant axis); ``nb9``: the packed neighbourhood occupancy in the
    same layout; ``l_sab``: the shared ray direction (-light) in (s, a, b)
    components of the light sweep, world-length parametrization (voxel
    coordinates per world unit).
    """

    bits: torch.Tensor
    nb9: torch.Tensor
    l_sab: torch.Tensor
    axis_l: int
    flip_l: bool
    S: int
    A: int
    B: int
    sp: int
    aa_min: float
    aa_span: float
    ab_min: float
    ab_span: float
    inter_h: int
    inter_w: int
    sa: float
    sb: float
    ta: int = 3
    tb: int = 3


def build_shadow_field(volume, light_dir, voxel_size, max_inter: int = 1024,
                       layouts=None,
                       device: DeviceLike = None) -> Optional[ShadowField]:
    """The exact shadow-ray detection field, once per scene and light, or
    None when the light's lateral slope leaves no room for the lattice pad
    (|slope| / 2 + pad past the tap window): callers then trace shadows
    with the DDA. ``layouts``: the scene's :class:`slab_sweep.SweepLayouts`
    (its sweep-order volume and packed neighbourhood are kept there)."""
    dev = resolve_device(device)
    layouts = _scene_layouts(volume, ..., layouts, dev)
    l = np.asarray(light_dir, np.float64)
    l = l / np.linalg.norm(l)
    d_world = -l                                     # ray direction
    axis_l = int(np.argmax(np.abs(d_world)))
    sel = _AXIS_SELECTORS[axis_l]
    rd = np.array([d_world @ np.asarray(c, np.float64) for c in sel])
    rd = rd / float(_host(voxel_size))               # world-t parametrization
    flip_l = bool(rd[0] < 0)
    dz, dy, dx = layouts.volume.shape[:3]
    S, A, B = {0: (dx, dy, dz), 1: (dy, dx, dz), 2: (dz, dx, dy)}[axis_l]
    sa = float(rd[1] / rd[0])
    sb = float(rd[2] / rd[0])

    # intercept bounds over any origin within the grid + a 4-voxel margin
    m = 4.0
    aa_lo = -m - max(sa * -m, sa * (S + m))
    aa_hi = (A + m) - min(sa * -m, sa * (S + m))
    ab_lo = -m - max(sb * -m, sb * (S + m))
    ab_hi = (B + m) - min(sb * -m, sb * (S + m))
    aa_span = aa_hi - aa_lo
    ab_span = ab_hi - ab_lo

    def dim(span):
        t = int(math.ceil(6.0 * max(span, 1.0) / 128.0)) * 128
        return max(128, min(max_inter, t))

    IHs, IWs = dim(aa_span), dim(ab_span)
    taps = _pick_taps(abs(sa) * 0.5 + 0.5 * aa_span / IHs,
                      abs(sb) * 0.5 + 0.5 * ab_span / IWs)
    if taps is None:
        return None
    ta, tb = taps
    occ_sw = layouts.get("volume", axis_l, flip_l, S, 0)
    sp = occ_sw.shape[0]
    hats = _ortho_hats(sa, sb, aa_lo, aa_span, ab_lo, ab_span, sp, S, A, B,
                       IHs, IWs, flip_l, ta, tb, dev)
    bits = mesh_grid._sweep_candidates(
        (occ_sw > 0).to(torch.bfloat16), hats, IHs, IWs,
        exact_acc=(ta > 3 or tb > 3))
    return ShadowField(
        bits=bits, nb9=_nb9_for(layouts, axis_l, flip_l, S, ta, tb),
        l_sab=torch.as_tensor(rd, dtype=torch.float32, device=dev),
        axis_l=axis_l, flip_l=flip_l, S=S, A=A, B=B, sp=sp,
        aa_min=float(aa_lo), aa_span=float(aa_span), ab_min=float(ab_lo),
        ab_span=float(ab_span), inter_h=IHs, inter_w=IWs, sa=sa, sb=sb,
        ta=ta, tb=tb)


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

def _texel_map(rd3, scal, flip: bool, IH: int, IW: int):
    """(geo_ok, ti, tj): whether each ray points into the sweep and meets
    the reference plane inside the lattice window, and its texel there
    (the hat lattice's own formulas)."""
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]
    rd_s = rd3[0]
    forward = (rd_s < 0) if flip else (rd_s > 0)
    safe = torch.where(rd_s.abs() < _DEG, 1.0, rd_s)
    ua = eye_a + (z0 - eye_s) * rd3[1] / safe
    ub = eye_b + (z0 - eye_s) * rd3[2] / safe
    in_win = (ua >= a_min) & (ua <= a_max) & (ub >= b_min) & (ub <= b_max)
    ti = torch.floor((ua - a_min) / (a_max - a_min) * IH).to(
        torch.int32).clamp(0, IH - 1)
    tj = torch.floor((ub - b_min) / (b_max - b_min) * IW).to(
        torch.int32).clamp(0, IW - 1)
    return forward & in_win, ti, tj



def _primary_core(cfg, scal_np, width: int, height: int):
    """Detection sweep + exact consume of every pixel ray that can hit.

    Returns dict over the live rows (pixels that pass the dead test):
    pix (int64 pixel index), hit, t (world), ks / ca / cb (hit voxel in
    sweep coordinates), dirs1 / origins1 (world components per row),
    rounds, unresolved and syncs (host syncs: the live-row compaction and
    one per consume round).

    The dead test (the pixel's texel has no candidate slab at all) looks
    the texel any-flag table (f32 +-1) up through
    :func:`warp_kernel.warp_lookup` with ``lin = (ti << 10) | tj``.
    """
    occ_sw, nb9 = cfg["occ_sw"], cfg["nb9"]
    axis_world, flip = cfg["axis_world"], cfg["flip"]
    S, A, B, IH, IW = cfg["S"], cfg["A"], cfg["B"], cfg["IH"], cfg["IW"]
    ta, tb = cfg["ta"], cfg["tb"]
    dev = occ_sw.device
    sp = occ_sw.shape[0]
    scal = torch.as_tensor(scal_np, device=dev)
    consts = torch.as_tensor(_view_consts(scal_np), device=dev)
    vs = scal[10]

    hats = _widened_perspective_hats(scal, sp, S, A, B, IH, IW, flip, ta, tb)
    bits_tex = mesh_grid._sweep_candidates(
        (occ_sw > 0).to(torch.bfloat16), hats, IH, IW,
        exact_acc=(ta > 3 or tb > 3))

    rd3 = tuple(c / vs for c in _pixel_rays_sab(scal, consts, axis_world,
                                               width, height))
    geo_ok, ti, tj = _texel_map(rd3, scal, flip, IH, IW)
    any_t = torch.where((bits_tex != 0).any(dim=1), 1.0, -1.0).reshape(IH, IW)
    lin = torch.where(geo_ok, (ti << 10) | tj, -1).reshape(height, width)
    any_pix = warp_lookup(any_t, lin).reshape(-1)
    pix = torch.nonzero(geo_ok & (any_pix >= 0.0)).squeeze(1)
    m = int(pix.shape[0])
    rd3 = tuple(c[pix] for c in rd3)
    ro3 = tuple(scal[c].expand(m) for c in range(3))
    texrow = (ti * IW + tj)[pix].long()
    st, rounds = _consume_ladder(
        bits_tex[texrow], torch.zeros(m, dtype=torch.int32, device=dev), ro3,
        rd3, nb9, S, A, B, flip, sp + 8, ta, tb)
    inv_perm = [_SAB_IDX[axis_world].index(c) for c in range(3)]
    return dict(
        pix=pix, hit=st["hit"], t=st["t"], ks=st["ks"], ca=st["ca"],
        cb=st["cb"], rounds=rounds,
        unresolved=int((~st["resolved"] & ~st["hit"]).sum()),
        syncs=2 + rounds,
        dirs1=tuple(rd3[inv_perm[c]] * vs for c in range(3)),
        origins1=tuple(scal[15 + c].expand(m) for c in range(3)))


def _leaf_normal(hit, t, ks, ca, cb, origins3, dirs3, leaf_flat, leaf_S: int,
                 axis_world: int, org3, vs):
    """Hit point and leaf-node normal normalize(p - nodeCenter)
    (RayTracerBVH.cpp:283-287) from one leaf-volume lookup at the hit
    voxel; (point3, nrm3) as xyz tuples of [M] tensors."""
    f32, i32 = torch.float32, torch.int32
    inv_perm = [_SAB_IDX[axis_world].index(c) for c in range(3)]
    sab = (ks, ca, cb)
    v3 = [sab[inv_perm[c]] for c in range(3)]        # voxel xyz
    idx = (v3[2] * leaf_S + v3[1]) * leaf_S + v3[0]
    byte = torch.take(leaf_flat, idx.clamp(0, leaf_flat.numel() - 1).long()
                      ).to(i32)
    level = (byte >> 1) & 15
    csize = torch.bitwise_left_shift(torch.ones_like(level), level).to(f32)
    point3, nrm3 = [], []
    for c in range(3):
        p_c = origins3[c] + dirs3[c] * t
        cmin = ((v3[c] >> level) << level).to(f32)
        cen = org3[c] + (cmin + 0.5 * csize) * vs
        point3.append(p_c)
        nrm3.append(p_c - cen)
    n2 = nrm3[0] * nrm3[0] + nrm3[1] * nrm3[1] + nrm3[2] * nrm3[2]
    inv = 1.0 / torch.clamp(_sqrt(n2), min=1e-30)
    return point3, [torch.where(hit, n_c * inv, 0.0) for n_c in nrm3]


def _shadow_occluded(field: ShadowField, o_vox3, s_live):
    """Exact occlusion of shadow rays (the field's shared direction) from
    origins ``o_vox3`` (voxel xyz components of [M] tensors); rows with
    ``s_live`` False are not traced. Returns (occluded bool[M], rounds,
    unresolved, host syncs)."""
    i32 = torch.int32
    f = field
    ro3 = tuple(o_vox3[i] for i in _SAB_IDX[f.axis_l])
    m = ro3[0].shape[0]
    aa = ro3[1] - f.sa * ro3[0]
    ab = ro3[2] - f.sb * ro3[0]
    ti = torch.floor(_fdiv(aa - f.aa_min, f.aa_span) * f.inter_h).to(
        i32).clamp(0, f.inter_h - 1)
    tj = torch.floor(_fdiv(ab - f.ab_min, f.ab_span) * f.inter_w).to(
        i32).clamp(0, f.inter_w - 1)
    k0 = torch.floor(ro3[0]).to(i32)
    o0 = (f.S - 1 - k0) if f.flip_l else k0
    rows = torch.nonzero(s_live & (o0 < f.S)).squeeze(1)
    n = int(rows.shape[0])
    st, rounds = _consume_ladder(
        f.bits[(ti * f.inter_w + tj)[rows].long()],
        torch.clamp(o0[rows], min=0), tuple(r[rows] for r in ro3),
        tuple(f.l_sab[i].expand(n) for i in range(3)), f.nb9, f.S, f.A, f.B,
        f.flip_l, f.sp + 8, f.ta, f.tb)
    occluded = torch.zeros(m, dtype=torch.bool, device=s_live.device)
    occluded[rows] = st["hit"]
    return (occluded, rounds,
            int((~st["resolved"] & ~st["hit"]).sum()), 2 + rounds)


def _trace_rows(cfg, scal_np, leaf_vol, width: int, height: int):
    """:func:`_primary_core` over the live rows, with each row's hit
    point and leaf-node normal (:func:`_leaf_normal`): (res, t, point3,
    nrm3), ``t`` 0 on misses."""
    res = _primary_core(cfg, scal_np, width, height)
    leaf_vol = leaf_vol.to(res["hit"].device)
    t1 = torch.where(res["hit"], res["t"], 0.0)
    org3 = tuple(float(v) for v in scal_np[12:15])
    point3, nrm3 = _leaf_normal(
        res["hit"], t1, res["ks"], res["ca"], res["cb"], res["origins1"],
        res["dirs1"], leaf_vol.reshape(-1), int(leaf_vol.shape[0]),
        cfg["axis_world"], org3, float(scal_np[10]))
    return res, t1, point3, nrm3


def _trace_pixels(cfg, scal_np, leaf_vol, width: int, height: int):
    """Full-width primary trace for one pose inside the envelope: dict(hit,
    t, point, normal) of [N] / [N, 3] tensors and the stats."""
    res, t1, point3, nrm3 = _trace_rows(cfg, scal_np, leaf_vol, width,
                                        height)
    dev = t1.device
    f32 = torch.float32
    N = width * height
    pix = res["pix"]
    hit = torch.zeros(N, dtype=torch.bool, device=dev)
    t = torch.zeros(N, dtype=f32, device=dev)
    point = torch.as_tensor(scal_np[15:18], device=dev).repeat(N, 1)
    nrm = torch.zeros((N, 3), dtype=f32, device=dev)
    hit[pix] = res["hit"]
    t[pix] = t1
    point[pix] = torch.stack(point3, dim=1)
    nrm[pix] = torch.stack(nrm3, dim=1)
    return dict(hit=hit, t=t, point=point, normal=nrm, rounds=res["rounds"],
                overflow=0, unresolved=res["unresolved"], syncs=res["syncs"])


def _frame_scal(cfg, fov_deg, aspect, light_dir=(0.0, 0.0, 0.0),
                base_color=(0.0, 0.0, 0.0), ambient=(0.0, 0.0, 0.0)):
    scal = cfg["scal_np"].copy()
    scal[8], scal[9] = fov_deg, aspect
    scal[34:37] = light_dir
    scal[37:40] = base_color
    scal[40:43] = ambient
    return scal


def trace_pixels_sweep_exact(volume, leaf_vol, grid_origin, voxel_size,
                             cam_pos, view, width: int, height: int,
                             fov_deg: float, aspect: float, layouts=None,
                             device: DeviceLike = None):
    """Exact per-pixel primary trace (``trace_octree`` semantics) through
    the sweep: dict(hit bool[N], t f32[N], point f32[N, 3], normal
    f32[N, 3], rounds, overflow, unresolved, syncs), or None outside the
    exactness envelope (callers fall back to the DDA tracer).
    ``leaf_vol`` is ``core/octree.build_leaf_volume``'s; ``layouts`` the
    scene's :class:`slab_sweep.SweepLayouts`."""
    ok, cfg = sweep_exact_setup(volume, grid_origin, voxel_size, cam_pos,
                                view, layouts=layouts, device=device)
    if not ok:
        return None
    return _trace_pixels(cfg, _frame_scal(cfg, fov_deg, aspect),
                         leaf_vol.to(cfg["occ_sw"].device), width, height)


def render_exact_frame(volume, leaf_vol, grid_origin, voxel_size, cam_pos,
                       view, width: int, height: int, fov_deg: float,
                       aspect: float, light_dir=(-1.0, -1.0, -1.0),
                       base_color=(1.0, 0.8, 0.6), ambient=(0.1, 0.1, 0.1),
                       shadows: bool = True,
                       shadow_field: Optional[ShadowField] = None,
                       layouts=None, device: DeviceLike = None):
    """Exact full frame (primary + per-hit shadow ray toward the light),
    the image of ``models/octree_raytracer.py::render_octree_image``:
    (img f32[H, W, 4], stats), or None when the pose or the light is
    outside the sweep-exact envelope.

    ``stats``: rounds / s_rounds (consume rounds of the primary and the
    shadow rays), overflow / s_overflow (0: every row is consumed to its
    end), unresolved / s_unresolved, live (primary rows consumed) and
    syncs (host syncs of the frame). ``shadow_field`` is
    :func:`build_shadow_field`'s for this volume and light (built here
    when None); ``layouts`` the scene's :class:`slab_sweep.SweepLayouts`.
    """
    dev = resolve_device(device)
    layouts = _scene_layouts(volume, ..., layouts, dev)
    ok, cfg = sweep_exact_setup(layouts.volume, grid_origin, voxel_size,
                                cam_pos, view, layouts=layouts, device=dev)
    if not ok:
        return None
    if shadows and shadow_field is None:
        shadow_field = build_shadow_field(layouts.volume, light_dir,
                                          voxel_size, layouts=layouts,
                                          device=dev)
        if shadow_field is None:
            return None
    scal_np = _frame_scal(cfg, fov_deg, aspect, light_dir, base_color,
                          ambient)
    res, _, point3, nrm3 = _trace_rows(cfg, scal_np, leaf_vol, width,
                                       height)
    scal = torch.as_tensor(scal_np, device=dev)
    org3 = tuple(scal[12 + c] for c in range(3))
    vs = scal[10]
    hit1 = res["hit"]

    # shade() (RayTracerBVH.cpp:331-336), as render_octree_image's
    l = _unit(scal[34:37])
    ndotl = torch.clamp(-(nrm3[0] * l[0] + nrm3[1] * l[1] + nrm3[2] * l[2]),
                        min=0.0)
    color3 = [torch.where(hit1, scal[37 + c] * ndotl + scal[40 + c], 0.0)
              for c in range(3)]
    stats = dict(rounds=res["rounds"], overflow=0,
                 unresolved=res["unresolved"], s_rounds=0, s_overflow=0,
                 s_unresolved=0, live=int(res["pix"].shape[0]),
                 syncs=res["syncs"])
    if shadows:
        o_vox3 = tuple((point3[c] + nrm3[c] * (vs * 2.0) - org3[c]) / vs
                       for c in range(3))
        occluded, s_rounds, s_unres, s_syncs = _shadow_occluded(
            shadow_field, o_vox3, hit1)
        color3 = [torch.where(occluded, scal[40 + c], color3[c])
                  for c in range(3)]
        stats.update(s_rounds=s_rounds, s_unresolved=s_unres,
                     syncs=stats["syncs"] + s_syncs)
    N = width * height
    img = torch.zeros((N, 4), dtype=torch.float32, device=dev)
    img[:, 3] = 1.0
    img[res["pix"], :3] = torch.stack(color3, dim=1)
    return img.reshape(height, width, 4), stats
