"""Slab-sweep first-hit frame (perspective shear-warp factorization).

Counterpart of the main path of ``ray_tracing_octrees_tpu/trace/
slab_sweep.py``. The viewing transform is factored a la Lacroute-Levoy:
volume slices perpendicular to the dominant view axis project onto a
reference plane by a uniform scale+translate, separable into two small
products with 1-D linear-interpolation ("hat") matrices. Slices sweep
front to back in chunks of 32, keeping a per-texel first-hit slab; the
packed table (``k + 0.5`` [+2048 where shadowed] or ``-1``) then maps to
the image by one per-pixel warp, fused with shading in
:mod:`~ray_tracing_octrees_tpu_torch.trace.warp_kernel`. Shadows come from
a once-per-(scene, light) orthographic sweep, :func:`shadow_volume`.
The exact DDA tracer's conservative seeds come from the same sweep over a
dilated volume (:func:`sweep_seed`) and, for shadow rays, from an
orthographic candidate bit field (:func:`build_shadow_seed`).

Numerics follow the reference: the sweep's products take bf16 inputs,
accumulate in f32 and round once to bf16 (XLA's
``preferred_element_type=bf16``); the shadow sweep's take bf16 values
and keep f32 results. On CUDA both run with TF32 and cuBLAS's
reduced-precision bf16 reduction switched off (:func:`_exact_matmul`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.trace.warp_kernel import (
    _SAB_IDX, frame_scalars, unpack_frame_rgb, warp_frame, warp_lookup,
)

CH = 32   # sweep chunk: slabs per product

# selectors: world-axis unit vectors for (sweep, A, B) per sweep axis,
# matching the volume transposes in _layout_volume.
_AXIS_SELECTORS = {
    0: (np.array([1.0, 0, 0], np.float32), np.array([0, 1.0, 0], np.float32),
        np.array([0, 0, 1.0], np.float32)),
    1: (np.array([0, 1.0, 0], np.float32), np.array([1.0, 0, 0], np.float32),
        np.array([0, 0, 1.0], np.float32)),
    2: (np.array([0, 0, 1.0], np.float32), np.array([1.0, 0, 0], np.float32),
        np.array([0, 1.0, 0], np.float32)),
}
# (Z, Y, X) -> sweep order (S, A, B) per sweep axis
_TO_SWEEP = {0: (2, 1, 0), 1: (1, 2, 0), 2: (0, 2, 1)}

# Per-frame scalars, one f32 vector. Layout: 0 eye_s, 1 eye_a, 2 eye_b,
# 3 z0, 4 a_min, 5 a_max, 6 b_min, 7 b_max, 8 fov_deg, 9 aspect,
# 10 voxel_size, 11 S, 12..14 origin, 15..17 cam_pos, 18..33 view (row
# major), 34..36 light_dir, 37..39 base_color, 40..42 ambient.
_SCAL_N = 43


@contextlib.contextmanager
def _exact_matmul():
    """Full-precision products on CUDA: no TF32 for f32 products, and f32
    accumulation with one final rounding for bf16 ones (cuBLAS may
    otherwise reduce bf16 partial sums in reduced precision, which the
    reference's f32-accumulate-then-round einsums never do)."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def _fdiv(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` for a Python number ``n``, rounded as one IEEE division on
    every device: on CUDA, dividing by a Python number multiplies by its
    rounded reciprocal instead, which can differ from the CPU's (and the
    reference's) quotient in the last bit."""
    return x / torch.full((), n, dtype=x.dtype, device=x.device)


def _cdiv(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the reference's compiled form
    rounds it: ``x`` times the f32 reciprocal of ``c`` (XLA rewrites a
    division by a constant so). One f32 product, so every device gives the
    same bits."""
    return x * float(np.float32(1.0) / np.float32(c))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device. The CPU's
    vectorized f32 ``torch.sqrt`` is an ulp off on some inputs, where the
    card's is exact; through f64 both round once."""
    return torch.sqrt(x.double()).to(x.dtype)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|`` for a 3-vector, rounded alike on every device."""
    return v / _sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


# --------------------------------------------------------------------------
# host-side geometry
# --------------------------------------------------------------------------

def _frame_scalars_np(eye_s, eye_a, eye_b, z0, a_min, a_max, b_min, b_max,
                      fov_deg, aspect, voxel_size, s_valid, origin, cam_pos,
                      view, light_dir=(0, 0, 0), base=(0, 0, 0), amb=(0, 0, 0)):
    scal = np.zeros(_SCAL_N, np.float32)
    scal[0:8] = (eye_s, eye_a, eye_b, z0, a_min, a_max, b_min, b_max)
    scal[8:12] = (fov_deg, aspect, voxel_size, s_valid)
    scal[12:15] = origin
    scal[15:18] = cam_pos
    scal[18:34] = np.asarray(view, np.float32).reshape(-1)
    scal[34:37] = light_dir
    scal[37:40] = base
    scal[40:43] = amb
    return scal


def _auto_inter(window, max_dim: int = 1024,
                density: float = 6.0) -> Tuple[int, int]:
    """Table resolution fitted to the projected volume extent: ``density``
    texels per voxel, rounded up to 128, within [256, max_dim]."""
    a_min, a_max, b_min, b_max = window

    def dim(span: float) -> int:
        t = int(math.ceil(density * max(span, 1.0) / 128.0)) * 128
        return max(256, min(max_dim, t))

    return dim(a_max - a_min), dim(b_max - b_min)


def _sweep_geometry(volume_shape, grid_origin, voxel_size, camera_pos, view):
    """Sweep axis, flip, eye coords, table window and crop (host-side).

    Exterior cameras pick the most view-aligned axis with the eye outside
    the slab range. Interior cameras sweep the forward half-volume along
    the most view-aligned axis, the slabs before it cropped out
    (``crop_lo``). ``volume_shape`` is (Z, Y, X).
    """
    look = -np.asarray(view)[2, :3]
    axis_world = int(np.argmax(np.abs(look)))
    cam_vox = (np.asarray(camera_pos, np.float64)
               - np.asarray(grid_origin, np.float64)) / float(voxel_size)
    dz, dy, dx = tuple(volume_shape)[:3]
    exts = {0: dx, 1: dy, 2: dz}
    order = list(np.argsort(-np.abs(look)))
    crop_lo = 0
    s_keep = None
    for ax in order:
        e = float(cam_vox @ np.asarray(_AXIS_SELECTORS[int(ax)][0], np.float64))
        if e < 0.0 or e > exts[int(ax)]:
            axis_world = int(ax)
            break
    else:
        axis_world = int(order[0])
        sel0 = np.asarray(_AXIS_SELECTORS[axis_world][0], np.float64)
        e = float(cam_vox @ sel0)
        s_full = exts[axis_world]
        if float(look @ sel0) >= 0.0:
            crop_lo = min(int(np.floor(e)) + 1, s_full - 1)
            s_keep = s_full - crop_lo
        else:
            crop_lo = 0
            s_keep = max(int(np.floor(e)), 1)
    sel = _AXIS_SELECTORS[axis_world]
    eye_s = float(cam_vox @ np.asarray(sel[0], np.float64)) - crop_lo
    eye_a = float(cam_vox @ np.asarray(sel[1], np.float64))
    eye_b = float(cam_vox @ np.asarray(sel[2], np.float64))
    S, A, B = {0: (dx, dy, dz), 1: (dy, dx, dz), 2: (dz, dx, dy)}[axis_world]
    if s_keep is not None:
        S = s_keep
    flip = eye_s > S / 2
    k0 = (S - 1.0) if flip else 0.0
    z0 = k0 + 0.5
    s_far_k = 0.0 if flip else (S - 1.0)
    s_far = (z0 - eye_s) / (s_far_k + 0.5 - eye_s)
    a_min = min(0.0, (0.0 - eye_a) * s_far + eye_a)
    a_max = max(float(A), (float(A) - eye_a) * s_far + eye_a)
    b_min = min(0.0, (0.0 - eye_b) * s_far + eye_b)
    b_max = max(float(B), (float(B) - eye_b) * s_far + eye_b)
    return (axis_world, flip, (S, A, B), (eye_s, eye_a, eye_b, z0),
            (a_min, a_max, b_min, b_max), crop_lo)


# --------------------------------------------------------------------------
# volume layouts
# --------------------------------------------------------------------------

def _relayout_sweep(vol_zyx: torch.Tensor, axis_world: int, flip: bool,
                    sp: int, crop_lo: int = 0, s_keep: int = 0):
    """(Z, Y, X) -> bf16 sweep order (S, A, B): cropped to
    [crop_lo, crop_lo + s_keep), reversed when ``flip``, zero-padded to
    ``sp`` slabs."""
    v = vol_zyx.permute(*_TO_SWEEP[axis_world])
    if crop_lo or (s_keep and s_keep != v.shape[0]):
        v = v[crop_lo: crop_lo + (s_keep or v.shape[0])]
    if flip:
        v = v.flip(0)
    out = torch.zeros((sp,) + tuple(v.shape[1:]), dtype=torch.bfloat16,
                      device=v.device)
    out[: v.shape[0]] = v
    return out


def _layout_volume(volume: torch.Tensor, axis_world: int, flip: bool, S: int,
                   crop_lo: int = 0):
    """bf16 sweep-order volume, padded to a whole number of chunks."""
    return _relayout_sweep(volume, axis_world, flip, S + (-S) % CH,
                           crop_lo, S)


class SweepLayouts:
    """The per-scene layouts the frame reuses across poses.

    Holds the scene's occupancy (f32[Z, Y, X]) and shadow volume, and
    their bf16 sweep-order copies for each (axis, flip, crop) a pose
    needs. Keep one per scene and pass it to :func:`render_fast_frame`;
    it takes the place of the reference's id-keyed layout cache.
    """

    def __init__(self, volume: torch.Tensor,
                 shadow: Optional[torch.Tensor] = None):
        self.volume = volume
        self.shadow = shadow
        self._cache = {}

    def get(self, which: str, axis_world: int, flip: bool, S: int,
            crop_lo: int) -> torch.Tensor:
        key = (which, axis_world, bool(flip), S, crop_lo)
        return self.derived(key, lambda: _layout_volume(
            self.volume if which == "volume" else self.shadow,
            axis_world, flip, S, crop_lo))

    def without_shadow(self) -> "SweepLayouts":
        """These layouts for frames drawn without the shadow volume: the
        same volume and the same kept copies."""
        out = SweepLayouts(self.volume)
        out._cache = self._cache
        return out

    def derived(self, key: tuple, build):
        """A per-scene value built once by ``build()`` and kept under
        ``key`` (the exact tracers' packed neighbourhoods, for example)."""
        out = self._cache.get(key)
        if out is None:
            out = build()
            self._cache[key] = out
        return out


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

def _slab_coords(scal, sp: int, s_valid: int, inter_h: int, inter_w: int,
                 flip: bool, o_base: float = 0.0):
    """Texel centres projected onto each of ``sp`` layout slabs: (pa f32[sp,
    IH], pb f32[sp, IW]) in voxel units of the A and B axes. ``o_base``
    offsets the local slab rows into global ones (a slab segment of a
    larger sweep)."""
    f32 = torch.float32
    dev = scal.device
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]
    ua = a_min + _fdiv((a_max - a_min) * (
        torch.arange(inter_h, dtype=f32, device=dev) + 0.5), inter_h)
    ub = b_min + _fdiv((b_max - b_min) * (
        torch.arange(inter_w, dtype=f32, device=dev) + 0.5), inter_w)
    o_all = torch.arange(sp, dtype=f32, device=dev) + float(o_base)
    k_all = (float(s_valid) - 1.0 - o_all) if flip else o_all
    s_all = (z0 - eye_s) / (k_all + 0.5 - eye_s)
    pa_all = (ua[None, :] - eye_a) / s_all[:, None] + eye_a
    pb_all = (ub[None, :] - eye_b) / s_all[:, None] + eye_b
    return pa_all, pb_all


def _hats_from_coords(pa_all, pb_all, a_size: int, b_size: int):
    """bf16 linear-interpolation hats [sp, IH, A] and [sp, IW, B] of the
    projected texel centres of :func:`_slab_coords`."""
    f32, bf16 = torch.float32, torch.bfloat16
    ia = torch.arange(a_size, dtype=f32, device=pa_all.device)
    ib = torch.arange(b_size, dtype=f32, device=pa_all.device)
    ma_all = torch.clamp(1.0 - (pa_all[..., None] - 0.5 - ia).abs(),
                         min=0.0).to(bf16)
    mb_all = torch.clamp(1.0 - (pb_all[..., None] - 0.5 - ib).abs(),
                         min=0.0).to(bf16)
    return ma_all, mb_all


def _bilinear_hats(scal, sp: int, s_valid: int, a_size: int, b_size: int,
                   inter_h: int, inter_w: int, flip: bool):
    """The sweep's [sp, IH, A] and [sp, IW, B] bf16 linear-interpolation
    hat stacks: texel centres projected onto each slab."""
    return _hats_from_coords(
        *_slab_coords(scal, sp, s_valid, inter_h, inter_w, flip), a_size,
        b_size)


def _sweep_core(vol_bf, scal, s_valid: int, a_size: int, b_size: int,
                inter_h: int, inter_w: int, flip: bool, shadow_sw=None):
    """Hats + chunked first-hit loop.

    ``scal`` is the f32 per-frame scalar tensor on the volume's device.
    Returns (first_o f32[IH, IW]: layout row of the first hit, s_valid + 1
    on a miss; sh_first f32[IH, IW]: the shadow sample at that hit).
    """
    f32 = torch.float32
    dev = vol_bf.device
    sp = vol_bf.shape[0]
    ma_all, mb_all = _bilinear_hats(scal, sp, s_valid, a_size, b_size,
                                    inter_h, inter_w, flip)

    big_o = float(s_valid + 1)
    first_o = torch.full((inter_h, inter_w), big_o, dtype=f32, device=dev)
    sh_first = torch.zeros((inter_h, inter_w), dtype=f32, device=dev)
    with _exact_matmul():
        for c0 in range(0, sp, CH):
            ma = ma_all[c0:c0 + CH]
            mb = mb_all[c0:c0 + CH]
            # a-contraction first: [c, b, h], then the [c, h, w] table
            hb = torch.einsum("cab,cha->cbh", vol_bf[c0:c0 + CH], ma)
            sh = torch.einsum("cbh,cwb->chw", hb, mb)
            hits = sh > 0.5
            # first slab of the chunk that hits (argmax returns the first
            # maximum; bool input is not accepted, hence the cast)
            am = torch.argmax(hits.to(torch.uint8), dim=0)
            cand = torch.where(hits.any(dim=0), (am + c0).to(f32), big_o)
            upd = cand < first_o
            if shadow_sw is not None:
                hbs = torch.einsum("cab,cha->cbh", shadow_sw[c0:c0 + CH], ma)
                shs = torch.einsum("cbh,cwb->chw", hbs, mb)
                sh_at = torch.gather(shs, 0, am[None]).squeeze(0).to(f32)
                sh_first = torch.where(upd, sh_at, sh_first)
            first_o = torch.where(upd, cand, first_o)
    return first_o, sh_first


def _pack_first_o(first_o, sh_first, s_valid: int, flip: bool, has_sh: bool):
    """(first_o, sh_first) -> packed ``hit ? k + 0.5 [+2048*sh] : -1``."""
    hit_i = first_o < float(s_valid)
    k_first = (float(s_valid) - 1.0 - first_o) if flip else first_o
    packed = k_first + 0.5
    if has_sh:
        packed = packed + torch.where(sh_first > 0.5, 2048.0, 0.0)
    return torch.where(hit_i, packed, -1.0)


def _sweep_all(vol_bf, scal, s_valid: int, a_size: int, b_size: int,
               inter_h: int, inter_w: int, flip: bool, shadow_sw=None):
    """Sweep + packing: the packed f32[IH, IW] table. With ``shadow_sw``
    (the shadow volume in the same sweep layout) the shadow sample at the
    first hit rides in the same value as the +2048 bit."""
    first_o, sh_first = _sweep_core(
        vol_bf, scal, s_valid, a_size, b_size, inter_h, inter_w, flip,
        shadow_sw=shadow_sw)
    return _pack_first_o(first_o, sh_first, s_valid, flip,
                         shadow_sw is not None)


# --------------------------------------------------------------------------
# the shadow volume (once per scene and light)
# --------------------------------------------------------------------------

def _shadow_hats(S: int, A: int, B: int, da: float, db: float,
                 pa_lo: int, pa_hi: int, pb_lo: int, pb_hi: int, device):
    """Shear/unshear hat matrices for the shadow sweep (host numpy f32,
    then bf16 on ``device``)."""
    f32 = np.float32
    OA = A + pa_lo + pa_hi
    OB = B + pb_lo + pb_hi
    m = np.arange(S, dtype=f32)
    oa = np.arange(OA, dtype=f32)[None, :] - f32(pa_lo) - m[:, None] * f32(da)
    ob = np.arange(OB, dtype=f32)[None, :] - f32(pb_lo) - m[:, None] * f32(db)
    ia = np.arange(A, dtype=f32)
    ib = np.arange(B, dtype=f32)
    ua = np.arange(A, dtype=f32)[None, :] + f32(pa_lo) + m[:, None] * f32(da)
    ub = np.arange(B, dtype=f32)[None, :] + f32(pb_lo) + m[:, None] * f32(db)
    io = np.arange(OA, dtype=f32)
    ip = np.arange(OB, dtype=f32)

    def hat(x, i):
        w = np.maximum(0.0, 1.0 - np.abs(x[..., None] - i)).astype(f32)
        return torch.from_numpy(w).to(device).to(torch.bfloat16)

    return hat(oa, ia), hat(ob, ib), hat(ua, io), hat(ub, ip)


def _shadow_apply(vol, ma, mb, wa, wb, flip: bool, inv):
    """Shadow sweep given the hats: 4 batched products + an exclusive
    cumulative sum. Products take bf16 values and keep f32 results: they
    run as f32 products of bf16-valued inputs (exact products, f32 sums)."""
    f32, bf16 = torch.float32, torch.bfloat16
    bfv = lambda x: x.to(bf16).to(f32)
    vols = vol.flip(0) if flip else vol
    with _exact_matmul():
        sh = torch.einsum("soa,sab->sob", ma.to(f32), bfv(vols))
        sh = torch.einsum("sob,spb->sop", bfv(sh), mb.to(f32))
        cum = torch.cumsum(sh, dim=0) - sh
        occ = torch.clamp(cum, max=1.0)
        out = torch.einsum("sao,sop->sap", wa.to(f32), bfv(occ))
        out = torch.einsum("sap,sbp->sab", bfv(out), wb.to(f32))
    if flip:
        out = out.flip(0)
    return out.permute(*inv).contiguous()


def shadow_volume(volume, light_dir, device: DeviceLike = None) -> torch.Tensor:
    """Per-voxel shadowing from a directional light (world space).

    ``volume`` f32[Z, Y, X] occupancy; ``light_dir`` points toward the
    light. Returns f32[Z, Y, X]: ~1 where some solid voxel lies toward
    the light, 0 where directly lit.
    """
    dev = resolve_device(device)
    vol_zyx = torch.as_tensor(volume, dtype=torch.float32, device=dev)
    l = np.asarray(light_dir, np.float64)
    l = l / np.linalg.norm(l)
    axis = int(np.argmax(np.abs(l)))
    inv = {0: (2, 1, 0), 1: (2, 0, 1), 2: (0, 2, 1)}[axis]
    vol = vol_zyx.permute(*_TO_SWEEP[axis])
    sel = _AXIS_SELECTORS[axis]
    l_s = float(l @ sel[0])
    l_a = float(l @ sel[1])
    l_b = float(l @ sel[2])
    # the sweep starts on the light side: high slice indices when l_s > 0
    flip = l_s > 0
    step_s = -1.0 if flip else 1.0
    da = -(l_a / l_s) * step_s
    db = -(l_b / l_s) * step_s
    S, A, B = (int(n) for n in vol.shape)
    pa_lo = int(math.ceil(max(0.0, -(S - 1) * da)))
    pa_hi = int(math.ceil(max(0.0, (S - 1) * da)))
    pb_lo = int(math.ceil(max(0.0, -(S - 1) * db)))
    pb_hi = int(math.ceil(max(0.0, (S - 1) * db)))
    hats = _shadow_hats(S, A, B, da, db, pa_lo, pa_hi, pb_lo, pb_hi, dev)
    return _shadow_apply(vol, *hats, bool(flip), inv)


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

def render_fast_frame(
    volume,          # f32[Z, Y, X] occupancy
    shadow_vol,      # f32[Z, Y, X] from shadow_volume(), or None
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
    layouts: Optional[SweepLayouts] = None,
    device: DeviceLike = None,
    fused: bool = True,
) -> torch.Tensor:
    """Slab-sweep frame with Lambert + shadow shading: f32[H, W, 4] rgba.

    Primary visibility from the sweep, normals ``normalize(p -
    voxelCenter)`` (RayTracerBVH.cpp:283-287), the shadow term carried
    through the sweep as the packed +2048 bit; the per-pixel half runs in
    :func:`warp_kernel.warp_frame`. ``layouts`` (one per scene, built
    from this ``volume`` and ``shadow_vol``) keeps the sweep-order copies
    across frames; without it they are built anew. ``grid_origin`` and
    ``voxel_size`` are best host values (a CUDA tensor costs a wait).

    ``fused=False`` runs the per-pixel half as separate stages instead:
    ray set-up, :func:`warp_kernel.warp_lookup` of the table, then the
    shading in plain tensor ops (unquantized colours; the fused kernel
    packs 8-bit ones).
    """
    table, scal_np, axis_world, has_shadow = _frame_parts(
        volume, shadow_vol, grid_origin, voxel_size, camera_pos, view,
        fov_deg, aspect, light_dir, base_color, ambient, inter_h, inter_w,
        layouts, device)
    if fused:
        out = warp_frame(table, frame_scalars(scal_np), axis_world, width,
                         height, has_shadow)
        return unpack_frame_rgb(out, width, height)
    ih, iw = table.shape
    scal = torch.as_tensor(scal_np, device=table.device)
    lin, behind, dirs, d_s_n = _warp_setup(
        scal, axis_world, ih, iw, width, height,
        torch.as_tensor(_view_consts(scal_np), device=table.device))
    w_val = _warp_values(table, lin, ih, iw, width, height)
    return _finish_shade(w_val, behind, dirs, d_s_n, scal, width, height,
                         has_shadow)


def _frame_table(volume, shadow_vol, grid_origin, voxel_size, camera_pos,
                 view, fov_deg, aspect, light_dir=(-1.0, -1.0, -1.0),
                 base_color=(1.0, 0.8, 0.6), ambient=(0.1, 0.1, 0.1),
                 inter_h=None, inter_w=None, layouts=None, device=None):
    """The frame up to the per-pixel kernel: the packed f32[IH, IW] table
    from the sweep, the kernel's scalars (host f32[35]), the sweep axis
    and whether the table carries the shadow bit."""
    table, scal_np, axis_world, has_shadow = _frame_parts(
        volume, shadow_vol, grid_origin, voxel_size, camera_pos, view,
        fov_deg, aspect, light_dir, base_color, ambient, inter_h, inter_w,
        layouts, device)
    return table, frame_scalars(scal_np), axis_world, has_shadow


def _frame_parts(volume, shadow_vol, grid_origin, voxel_size, camera_pos,
                 view, fov_deg, aspect, light_dir, base_color, ambient,
                 inter_h, inter_w, layouts, device):
    """(table, host frame scalars f32[43], sweep axis, shadow flag)."""
    dev = resolve_device(device)
    layouts = _scene_layouts(volume, shadow_vol, layouts, dev)
    origin = np.asarray(_host(grid_origin), np.float32)
    vox = float(_host(voxel_size))
    axis_world, flip, (S, A, B), eyes, window, crop_lo = _sweep_geometry(
        layouts.volume.shape, origin, vox, camera_pos, view)
    auto_h, auto_w = _auto_inter(window)
    inter_h = auto_h if inter_h is None else inter_h
    inter_w = auto_w if inter_w is None else inter_w
    origin_c = origin + _AXIS_SELECTORS[axis_world][0] * np.float32(crop_lo * vox)
    scal_np = _frame_scalars_np(
        *eyes[:3], eyes[3], *window, fov_deg, aspect, vox, S,
        origin_c, np.asarray(camera_pos, np.float32),
        view, light_dir, base_color, ambient)
    flip = bool(flip)
    vol_bf = layouts.get("volume", axis_world, flip, S, crop_lo)
    has_shadow = layouts.shadow is not None
    shv = layouts.get("shadow", axis_world, flip, S, crop_lo) \
        if has_shadow else None
    scal = torch.as_tensor(scal_np, device=dev)
    table = _sweep_all(vol_bf, scal, S, A, B, inter_h, inter_w, flip,
                       shadow_sw=shv)
    return table, scal_np, axis_world, has_shadow


def _scene_layouts(volume, shadow_vol, layouts, dev) -> SweepLayouts:
    """The caller's per-scene layouts, checked against the scene, or new
    ones for a single frame. ``shadow_vol=...`` checks the volume only."""
    if layouts is None:
        as_dev = lambda x: None if x is None or x is ... else \
            torch.as_tensor(x, dtype=torch.float32, device=dev)
        layouts = SweepLayouts(as_dev(volume), as_dev(shadow_vol))
    elif layouts.volume is not volume or (
            shadow_vol is not ... and layouts.shadow is not shadow_vol):
        raise ValueError("layouts belong to another volume or shadow volume")
    if layouts.volume.device != dev:
        raise ValueError(f"volume is on {layouts.volume.device}, not {dev}")
    return layouts


def _host(x):
    """A host (numpy) value from a tensor, array or number. Pass host
    values per frame: reading a CUDA tensor waits for the device."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# the split per-pixel path (ray setup, lookup, shade as separate stages)
# --------------------------------------------------------------------------

def _view_consts(scal_np) -> np.ndarray:
    """f32[10]: tan(fov / 2) and the rotation ``inv(view)[:3, :3]`` (row
    major) of the packed frame scalars, computed on the host in f32 so the
    card and the CPU trace the very same rays (a device inverse, tangent
    or small matmul rounds differently on each)."""
    scal_np = np.asarray(scal_np, np.float32)
    tan_half = np.tan(scal_np[8] * np.float32(math.pi / 360.0))
    rot = np.linalg.inv(scal_np[18:34].reshape(4, 4))[:3, :3]
    return np.concatenate([[tan_half], rot.reshape(-1)]).astype(np.float32)


def _warp_setup(scal, axis_world: int, inter_h: int, inter_w: int,
                width: int, height: int, consts=None):
    """Per-pixel table index + ray geometry: (lin, behind, dirs, d_s_n).

    ``lin`` is ``iu * inter_w + iv``, or -1 for pixels that cannot hit:
    rays pointing away from the reference plane or meeting it outside
    the table window. ``scal`` is the f32 scalar tensor on the device;
    ``consts`` its :func:`_view_consts` on the same device (read back from
    ``scal`` when not given). Every op is one f32 elementwise op, so the
    card and the CPU give the same bits.
    """
    f32 = torch.float32
    dev = scal.device
    if consts is None:
        consts = torch.as_tensor(_view_consts(_host(scal)), device=dev)
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]
    aspect, voxel_size = scal[9], scal[10]
    tan_half, rot = consts[0], consts[1:10].reshape(3, 3)

    px = _fdiv(torch.arange(width, dtype=f32, device=dev) + 0.5,
               width) * 2.0 - 1.0
    py = 1.0 - _fdiv(torch.arange(height, dtype=f32, device=dev) + 0.5,
                     height) * 2.0
    nx = px * aspect * tan_half
    ny = py * tan_half
    nyg, nxg = torch.meshgrid(ny, nx, indexing="ij")
    nxg, nyg = nxg.reshape(-1), nyg.reshape(-1)
    # d_world = (nx, ny, -1) @ inv(view)[:3, :3].T, summed in order
    dw = [nxg * rot[c, 0] + nyg * rot[c, 1] - rot[c, 2] for c in range(3)]
    d_world = torch.stack(dw, -1)

    s_i, a_i, b_i = _SAB_IDX[axis_world]
    d_s, d_a, d_b = dw[s_i], dw[a_i], dw[b_i]
    denom = d_s / voxel_size
    t_ref = (z0 - eye_s) / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    a_ref = eye_a + d_a / voxel_size * t_ref
    b_ref = eye_b + d_b / voxel_size * t_ref
    behind = t_ref <= 0

    uu = (a_ref - a_min) / (a_max - a_min) * inter_h
    vv = (b_ref - b_min) / (b_max - b_min) * inter_w
    oow = (uu < 0) | (uu >= inter_h) | (vv < 0) | (vv >= inter_w)
    iu = uu.to(torch.int32).clamp(0, inter_h - 1)
    iv = vv.to(torch.int32).clamp(0, inter_w - 1)
    lin = torch.where(behind | oow, -1, iu * inter_w + iv)
    d_len = _sqrt(dw[0] * dw[0] + dw[1] * dw[1] + dw[2] * dw[2])
    dirs = d_world / d_len[:, None]
    d_s_n = d_s / d_len
    return lin, behind, dirs, d_s_n


def _warp_values(packed, lin, inter_h: int, inter_w: int, width: int,
                 height: int):
    """Per-pixel lookup of the packed f32[IH, IW] table through
    :func:`warp_kernel.warp_lookup`; -1 where ``lin`` is -1. ``lin`` is
    ``iu * inter_w + iv`` (flat); the kernel takes ``(iu << 10) | iv``."""
    lin10 = torch.where(lin < 0, -1,
                        ((lin // inter_w) << 10) | (lin % inter_w))
    out = warp_lookup(packed.reshape(inter_h, inter_w),
                      lin10.to(torch.int32).reshape(height, width))
    return out.reshape(-1)


def _finish_sweep(w_val, behind, dirs, d_s_n, scal):
    """(hit, t, point, dirs) from the looked-up packed values."""
    eye_s, voxel_size, cam_pos = scal[0], scal[10], scal[15:18]
    hit = (w_val >= 0.0) & ~behind
    z_f = torch.clamp(w_val, min=0.0)
    t_world = (z_f - eye_s) * voxel_size / d_s_n
    t_world = torch.where(hit, t_world, 0.0)
    point = cam_pos[None, :] + dirs * t_world[:, None]
    return hit, t_world, point, dirs


def sweep_first_hit(
    volume,          # f32[Z, Y, X] occupancy (0/1)
    grid_origin,
    voxel_size,
    camera_pos,
    view,
    fov_deg: float,
    aspect: float,
    width: int,
    height: int,
    inter_h: int = 1024,
    inter_w: int = 1024,
    layouts: Optional[SweepLayouts] = None,
    device: DeviceLike = None,
):
    """First-hit trace of a full frame via the slab sweep.

    The sweep's packed table (no shadow channel) maps to pixels through
    :func:`warp_kernel.warp_lookup`. Returns (hit bool[N], t f32[N], point
    f32[N, 3], dirs f32[N, 3]) with N = width * height, pixel order row
    major from the top row. ``layouts`` as for :func:`render_fast_frame`
    (only its volume is used).
    """
    dev = resolve_device(device)
    layouts = _scene_layouts(volume, ..., layouts, dev)
    origin = np.asarray(_host(grid_origin), np.float32)
    vox = float(_host(voxel_size))
    axis_world, flip, (S, A, B), eyes, window, crop_lo = _sweep_geometry(
        layouts.volume.shape, origin, vox, camera_pos, view)
    origin_c = origin + _AXIS_SELECTORS[axis_world][0] * np.float32(crop_lo * vox)
    scal_np = _frame_scalars_np(
        *eyes[:3], eyes[3], *window, fov_deg, aspect, vox, S, origin_c,
        np.asarray(camera_pos, np.float32), view)
    scal = torch.as_tensor(scal_np, device=dev)
    vol_bf = layouts.get("volume", axis_world, bool(flip), S, crop_lo)
    packed = _sweep_all(vol_bf, scal, S, A, B, inter_h, inter_w, bool(flip))
    lin, behind, dirs, d_s_n = _warp_setup(
        scal, axis_world, inter_h, inter_w, width, height,
        torch.as_tensor(_view_consts(scal_np), device=dev))
    w_val = _warp_values(packed, lin, inter_h, inter_w, width, height)
    return _finish_sweep(w_val, behind, dirs, d_s_n, scal)


def _finish_shade(w_val, behind, dirs, d_s_n, scal, width: int, height: int,
                  has_shadow: bool):
    """Unpack depth + shadow, rebuild the hit point, Lambert-shade:
    f32[H, W, 4] rgba, unquantized. ``w_val`` is the looked-up packed
    value per pixel (-1 where ``lin`` was -1)."""
    eye_s = scal[0]
    voxel_size = scal[10]
    grid_origin = scal[12:15]
    cam_pos = scal[15:18]
    light_dir = scal[34:37]
    base_color = scal[37:40]
    ambient = scal[40:43]

    hit = (w_val >= 0.0) & ~behind
    sh_bit = w_val >= 2048.0
    z_f = torch.clamp(w_val - torch.where(sh_bit, 2048.0, 0.0), min=0.0)
    t_world = (z_f - eye_s) * voxel_size / d_s_n
    t_world = torch.where(hit, t_world, 0.0)
    point = cam_pos[None, :] + dirs * t_world[:, None]

    p_in = point + dirs * (0.25 * voxel_size)
    center = grid_origin[None, :] + (
        torch.floor((p_in - grid_origin[None, :]) / voxel_size) + 0.5
    ) * voxel_size
    nrm = point - center
    nlen = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(nlen, min=1e-12)

    l = light_dir / torch.linalg.norm(light_dir)
    ndotl = torch.clamp(-(nrm * l[None, :]).sum(-1), min=0.0)
    color = base_color[None, :] * ndotl[:, None] + ambient[None, :]
    if has_shadow:
        color = torch.where(sh_bit[:, None], ambient[None, :], color)
    color = torch.where(hit[:, None], color, 0.0)
    rgba = torch.cat([color, torch.ones_like(color[:, :1])], -1)
    return rgba.reshape(height, width, 4)


# --------------------------------------------------------------------------
# conservative seeds of the exact DDA tracer
# --------------------------------------------------------------------------

SEED_DILATION = 3


def dilate_occupancy(volume, radius: int = SEED_DILATION,
                     device: DeviceLike = None) -> torch.Tensor:
    """Chebyshev dilation of a 0/1 occupancy volume, padded by ``radius``
    on every side: bf16[Z + 2r, Y + 2r, X + 2r] (0/1 is exact).

    For :func:`sweep_seed`: a ray crossing an edge voxel can have its
    slab-centre sample up to 2 cells outside the array, where the
    resample taps would read 0 whatever the dilation; the pad keeps every
    tap of every in-bounds crossing inside dilated cells. The grid origin
    moves by -radius voxels; the seed functions do this themselves.
    """
    occ = torch.as_tensor(volume, device=resolve_device(device)) > 0
    r = int(radius)
    occ = F.pad(occ.to(torch.float32), (r,) * 6)
    dil = F.max_pool3d(occ[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    return dil.to(torch.bfloat16)


def _shift3(a: torch.Tensor, off_zyx) -> torch.Tensor:
    """``result[i] = a[i - off]`` per axis, False past the edges."""
    for ax, off in enumerate(off_zyx):
        n = a.shape[ax]
        if off == 0:
            continue
        out = torch.zeros_like(a)
        if abs(off) < n:
            if off > 0:
                out.narrow(ax, off, n - off).copy_(a.narrow(ax, 0, n - off))
            else:
                out.narrow(ax, 0, n + off).copy_(a.narrow(ax, -off, n + off))
        a = out
    return a


def light_blocked_volume(volume_dilated: torch.Tensor, to_light: tuple,
                         doublings: int = 10) -> torch.Tensor:
    """Conservative per-voxel "any solid toward the light" flag, on the
    volume's device.

    bool over :func:`dilate_occupancy`'s padded cube: False proves that a
    ray from anywhere in the voxel toward ``to_light`` crosses no solid
    voxel (the exact frame's shadow rays die at step 0 there); True means
    "trace it". Directional doubling: B_0 = the dilated occupancy,
    B_{k+1} = maxpool3(B_k) | shift(maxpool3(B_k), round(2^k * step))
    with step = -to_light scaled to a largest axis of 1. The per-step 3^3
    dilation absorbs the rounding of the fractional shift and the lateral
    path within a step, so the union of the swept occupancy lies in B_K.
    """
    d = -np.asarray(to_light, np.float64)
    step_xyz = d / max(np.max(np.abs(d)), 1e-12)
    B = torch.as_tensor(volume_dilated) > 0
    for k in range(doublings):
        B = F.max_pool3d(B.to(torch.float32)[None, None], 3, stride=1,
                         padding=1)[0, 0] > 0
        off = np.rint((2.0 ** k) * step_xyz).astype(np.int64)
        # a voxel reads the region the ray reaches: x is occludable if
        # x + 2^k * step is in B (zyx order)
        B = B | _shift3(B, (-int(off[2]), -int(off[1]), -int(off[0])))
    return B


def sweep_seed(volume_dilated, grid_origin, voxel_size, camera_pos, view,
               fov_deg: float, aspect: float, width: int, height: int,
               layouts: Optional[SweepLayouts] = None,
               device: DeviceLike = None):
    """Conservative per-pixel seeds of the exact DDA tracer from one sweep
    of the dilated grid: (live bool[N], t_seed f32[N], exterior bool).

    ``volume_dilated`` is :func:`dilate_occupancy`'s; ``grid_origin`` is
    the original grid's (the pad shift happens here). ``layouts``: a
    :class:`SweepLayouts` over ``volume_dilated``, kept across frames.

    For an exterior camera (exterior=True): live[i] False proves that
    ray i hits no solid voxel (the dilation makes the 0.5-threshold
    bilinear slab test conservative while the frame's lateral slope is at
    most 4, checked here on the host), and t_seed[i] is at most the
    world t at which ray i first enters a solid voxel (2.5 slabs of
    margin cover the slab-centre quantization). An interior eye, a
    cropped sweep or a steeper frame gives (all live, zeros, False):
    callers then ignore the seeds. The warp to pixels runs
    :func:`warp_kernel.warp_lookup`.
    """
    dev = resolve_device(device)
    if layouts is None:
        layouts = SweepLayouts(torch.as_tensor(volume_dilated, device=dev))
    vol = layouts.volume
    vox = float(_host(voxel_size))
    origin_p = (np.asarray(_host(grid_origin), np.float32)
                - np.float32(SEED_DILATION) * np.float32(vox))
    axis_world, flip, (S, A, B), eyes, window, crop_lo = _sweep_geometry(
        vol.shape, origin_p, vox, camera_pos, view)
    n = width * height
    cam_vox = (np.asarray(camera_pos, np.float64)
               - np.asarray(origin_p, np.float64)) / vox
    dz_, dy_, dx_ = vol.shape[:3]
    inside = bool((0 <= cam_vox[0] <= dx_) and (0 <= cam_vox[1] <= dy_)
                  and (0 <= cam_vox[2] <= dz_))
    a_min, a_max, b_min, b_max = window
    eye_s, eye_a, eye_b, z0 = eyes
    span = abs(z0 - eye_s)
    slope_max = max(abs(a_min - eye_a), abs(a_max - eye_a),
                    abs(b_min - eye_b), abs(b_max - eye_b)) / max(span, 1e-9)
    if inside or crop_lo != 0 or slope_max > 4.0:
        return (torch.ones(n, dtype=torch.bool, device=dev),
                torch.zeros(n, dtype=torch.float32, device=dev), False)
    inter_h, inter_w = _auto_inter(window)
    vol_bf = layouts.get("volume", axis_world, bool(flip), S, 0)
    scal_np = _frame_scalars_np(eye_s, eye_a, eye_b, z0, a_min, a_max, b_min,
                                b_max, fov_deg, aspect, vox, S, origin_p,
                                np.asarray(camera_pos, np.float32), view)
    scal = torch.as_tensor(scal_np, device=dev)
    packed = _sweep_all(vol_bf, scal, S, A, B, inter_h, inter_w, bool(flip))
    lin, behind, _, d_s_n = _warp_setup(
        scal, axis_world, inter_h, inter_w, width, height,
        torch.as_tensor(_view_consts(scal_np), device=dev))
    w_val = _warp_values(packed, lin, inter_h, inter_w, width, height)
    live = (w_val >= 0.0) & ~behind
    # the dilated hit slab's entry, 2.5 slabs earlier along the ray
    # (toward the eye: sign(d_s_n) is the travel direction in slabs)
    z_f = w_val - 2.5 * torch.sign(d_s_n)
    t_seed = (z_f - scal[0]) * scal[10] / d_s_n
    t_seed = torch.where(live, torch.clamp(t_seed, min=0.0), 0.0)
    return live, t_seed, True


@dataclasses.dataclass(frozen=True)
class ShadowSeed:
    """Per-(scene, light) sheared candidate bit field for shadow rays."""

    bits2d: torch.Tensor  # i32[OA * OB, C] travel-slab candidate words
    axis_world: int       # dominant |D| axis of the shadow direction (xyz)
    flip: bool            # True when the shadow direction descends the axis
    da: float             # lateral drift (a axis) per +1 travel slab
    db: float
    pa_lo: int
    pb_lo: int
    S: int                # travel-slab count (sweep extent of the volume)
    OA: int
    OB: int
    d_s_abs: float        # |D_s| of the unit shadow direction (world)


def build_shadow_seed(volume_dilated, to_light,
                      device: DeviceLike = None) -> ShadowSeed:
    """The seed for shadow rays travelling toward ``to_light``, once per
    (scene, light) like :func:`shadow_volume`. ``volume_dilated`` is
    :func:`dilate_occupancy`'s. Each ray's lateral column is constant
    along the light direction, so one orthographic sweep marks, per
    column and travel slab, whether the dilated footprint holds solid."""
    f32 = torch.float32
    dev = resolve_device(device)
    D = np.asarray(to_light, np.float64)
    D = D / np.linalg.norm(D)
    axis_world = int(np.argmax(np.abs(D)))
    sel = _AXIS_SELECTORS[axis_world]
    d_s = float(D @ np.asarray(sel[0], np.float64))
    d_a = float(D @ np.asarray(sel[1], np.float64))
    d_b = float(D @ np.asarray(sel[2], np.float64))
    flip = d_s < 0.0
    da = d_a / abs(d_s)   # per +1 slab along the travel direction
    db = d_b / abs(d_s)
    vol = torch.as_tensor(volume_dilated, device=dev).permute(
        *_TO_SWEEP[axis_world])
    S, A, B = (int(x) for x in vol.shape)
    vols = vol.flip(0) if flip else vol    # vols[m] = slab at travel step m
    pa_lo = int(math.ceil((S - 1) * max(da, 0.0))) + 1
    pa_hi = int(math.ceil((S - 1) * max(-da, 0.0))) + 1
    pb_lo = int(math.ceil((S - 1) * max(db, 0.0))) + 1
    pb_hi = int(math.ceil((S - 1) * max(-db, 0.0))) + 1
    # column of lateral a at travel step m: o = a - m * da + pa_lo
    ma, mb, _, _ = _shadow_hats(S, A, B, -da, -db, pa_lo, pa_hi, pb_lo,
                                pb_hi, dev)
    # bf16 values, f32 products and sums, a bf16 intermediate
    with _exact_matmul():
        sh = torch.einsum("soa,sab->sob", ma.to(f32),
                          vols.to(torch.bfloat16).to(f32))
        sh = torch.einsum("sob,spb->sop", sh.to(torch.bfloat16).to(f32),
                          mb.to(f32))
    hits = sh >= 0.5
    OA, OB = int(hits.shape[1]), int(hits.shape[2])
    C = -(-S // 32)
    if C * 32 != S:
        hits = torch.cat([hits, torch.zeros((C * 32 - S, OA, OB),
                                            dtype=torch.bool, device=dev)])
    hb = hits.reshape(C, 32, OA, OB).to(torch.int32)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[None, :, None,
                                                            None]
    # distinct bits: the int32 sum is their OR (bit 31 included)
    words = torch.bitwise_left_shift(hb, shifts).sum(1, dtype=torch.int32)
    bits2d = words.permute(1, 2, 0).reshape(OA * OB, C).contiguous()
    return ShadowSeed(bits2d=bits2d, axis_world=axis_world, flip=bool(flip),
                      da=float(da), db=float(db), pa_lo=pa_lo, pb_lo=pb_lo,
                      S=S, OA=OA, OB=OB, d_s_abs=abs(d_s))


def query_shadow_seed(seed: ShadowSeed, shadow_o: torch.Tensor, grid_origin,
                      voxel_size):
    """Conservative (live bool[N], t_start f32[N]) for shadow origins
    f32[N, 3], on their device. ``grid_origin`` / ``voxel_size`` are the
    original grid's. live=False proves the ray hits nothing; t_start
    lower-bounds its first-hit t. Out-of-field rays stay live at 0."""
    f32, i32 = torch.float32, torch.int32
    dev = shadow_o.device
    vs = torch.as_tensor(voxel_size, dtype=f32, device=dev).reshape(())
    origin_p = (torch.as_tensor(grid_origin, dtype=f32, device=dev)
                - np.float32(SEED_DILATION) * vs)
    pv = (shadow_o - origin_p[None, :]) / vs        # dilated-volume voxels
    ax = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}[seed.axis_world]
    s_p, a_p, b_p = pv[:, ax[0]], pv[:, ax[1]], pv[:, ax[2]]
    m_p = (float(seed.S) - s_p) if seed.flip else s_p
    col_a = torch.round(a_p - m_p * seed.da + float(seed.pa_lo)).to(i32)
    col_b = torch.round(b_p - m_p * seed.db + float(seed.pb_lo)).to(i32)
    in_range = ((col_a >= 0) & (col_a < seed.OA) & (col_b >= 0)
                & (col_b < seed.OB) & (m_p < float(seed.S)))
    row = (col_a * seed.OB + col_b).clamp(0, seed.OA * seed.OB - 1)
    words = seed.bits2d[row.long()]
    m_lo = (torch.floor(m_p).to(i32) - 1).clamp(0, seed.S)
    has, o = first_set_from(words, m_lo)
    live = has | ~in_range
    # the candidate slab's entry less a full-slab cushion, in world t
    t_seed = _fdiv((o.to(f32) - m_p - 1.25) * vs, seed.d_s_abs)
    t_seed = torch.where(has & in_range, torch.clamp(t_seed, min=0.0), 0.0)
    return live, t_seed


# --------------------------------------------------------------------------
# candidate bit words
# --------------------------------------------------------------------------

def first_set_from(bits, ptr):
    """Per row: the first set bit index >= ptr, as (has bool[m], o i32[m]).

    ``bits`` int32[m, W] little-endian 32-bit words (bit b of word w = slab
    w * 32 + b), ``ptr`` int32[m] the first slab still eligible.
    """
    i32 = torch.int32
    wi = torch.arange(bits.shape[1], dtype=i32, device=bits.device)[None, :]
    wptr = (ptr >> 5)[:, None]
    minus_one = torch.full_like(ptr, -1)
    mask_word = torch.bitwise_left_shift(minus_one, ptr & 31)  # bits >= ptr&31
    m = torch.where(wi > wptr, bits,
                    torch.where(wi == wptr, bits & mask_word[:, None], 0))
    nz = m != 0
    has = nz.any(dim=1)
    fw = torch.argmax(nz.to(torch.uint8), dim=1)
    word = torch.gather(m, 1, fw[:, None])[:, 0]
    # the lowest set bit, a power of two (-2^31 when it is bit 31); its
    # index is frexp's exponent - 1 (frexp is exact on powers of two)
    lsb = (word & -word).to(torch.float64).abs()
    b = torch.frexp(lsb).exponent - 1        # -1 for a zero word
    o = fw.to(i32) * 32 + torch.clamp(b, min=0).to(i32)
    return has, o
