"""Sweep-exact machinery: widened detection hats and exact consume rounds.

Counterpart of the part of ``ray_tracing_octrees_tpu/trace/
sweep_exact.py`` that the exact fast frame (:mod:`.fast_exact`) runs:

1. DETECTION hats whose per-slab footprint is WIDENED by the texel
   half-cell, so a texel's candidate bits are a proven superset of the
   solid crossings of every pixel ray through its lattice cell (bit o =
   "some cell the ray crosses in slab o is solid").
2. CONSUME rounds on the actual pixel rays: each round takes one
   candidate slab per unresolved ray, fetches the packed ta x tb
   neighbourhood occupancy of its footprint (one lookup) and runs exact
   ray/AABB tests on those cells. Cells of slab o span s in [k, k + 1],
   so slab order is t order: the first slab with a valid solid crossing
   holds the nearest hit, t = max(entry, 0) — the reference's
   tNear-of-solid-leaf semantics (RayTracerBVH.cpp:283-287).

Exactness envelope (host gate, :func:`sweep_exact_setup`): the eye
outside the volume along the sweep axis, and footprints within a 3-tap
window per axis, or 5 taps on one axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
    _SAB_IDX, _auto_inter, _fdiv, _frame_scalars_np, _host, _scene_layouts,
    _sqrt, _sweep_geometry, first_set_from,
)

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
