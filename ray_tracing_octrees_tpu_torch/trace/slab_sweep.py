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

Numerics follow the reference: the sweep's products take bf16 inputs,
accumulate in f32 and round once to bf16 (XLA's
``preferred_element_type=bf16``); the shadow sweep's take bf16 values
and keep f32 results. On CUDA both run with TF32 and cuBLAS's
reduced-precision bf16 reduction switched off (:func:`_exact_matmul`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.trace.warp_kernel import (
    frame_scalars, unpack_frame_rgb, warp_frame,
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
        out = self._cache.get(key)
        if out is None:
            src = self.volume if which == "volume" else self.shadow
            out = _layout_volume(src, axis_world, flip, S, crop_lo)
            self._cache[key] = out
        return out


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

def _sweep_core(vol_bf, scal, s_valid: int, a_size: int, b_size: int,
                inter_h: int, inter_w: int, flip: bool, shadow_sw=None):
    """Hats + chunked first-hit loop.

    ``scal`` is the f32 per-frame scalar tensor on the volume's device.
    Returns (first_o f32[IH, IW]: layout row of the first hit, s_valid + 1
    on a miss; sh_first f32[IH, IW]: the shadow sample at that hit).
    """
    f32, bf16 = torch.float32, torch.bfloat16
    dev = vol_bf.device
    sp = vol_bf.shape[0]
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]

    ua = a_min + (a_max - a_min) * (
        torch.arange(inter_h, dtype=f32, device=dev) + 0.5) / inter_h
    ub = b_min + (b_max - b_min) * (
        torch.arange(inter_w, dtype=f32, device=dev) + 0.5) / inter_w
    o_all = torch.arange(sp, dtype=f32, device=dev)
    k_all = (float(s_valid) - 1.0 - o_all) if flip else o_all
    s_all = (z0 - eye_s) / (k_all + 0.5 - eye_s)
    pa_all = (ua[None, :] - eye_a) / s_all[:, None] + eye_a
    pb_all = (ub[None, :] - eye_b) / s_all[:, None] + eye_b
    ia = torch.arange(a_size, dtype=f32, device=dev)
    ib = torch.arange(b_size, dtype=f32, device=dev)
    # [sp, IH, A] and [sp, IW, B] bf16 hat stacks
    ma_all = torch.clamp(1.0 - (pa_all[..., None] - 0.5 - ia).abs(),
                         min=0.0).to(bf16)
    mb_all = torch.clamp(1.0 - (pb_all[..., None] - 0.5 - ib).abs(),
                         min=0.0).to(bf16)

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
) -> torch.Tensor:
    """Slab-sweep frame with Lambert + shadow shading: f32[H, W, 4] rgba.

    Primary visibility from the sweep, normals ``normalize(p -
    voxelCenter)`` (RayTracerBVH.cpp:283-287), the shadow term carried
    through the sweep as the packed +2048 bit; the per-pixel half runs in
    :func:`warp_kernel.warp_frame`. ``layouts`` (one per scene, built
    from this ``volume`` and ``shadow_vol``) keeps the sweep-order copies
    across frames; without it they are built anew. ``grid_origin`` and
    ``voxel_size`` are best host values (a CUDA tensor costs a wait).
    """
    table, kscal, axis_world, has_shadow = _frame_table(
        volume, shadow_vol, grid_origin, voxel_size, camera_pos, view,
        fov_deg, aspect, light_dir, base_color, ambient, inter_h, inter_w,
        layouts, device)
    out = warp_frame(table, kscal, axis_world, width, height, has_shadow)
    return unpack_frame_rgb(out, width, height)


def _frame_table(volume, shadow_vol, grid_origin, voxel_size, camera_pos,
                 view, fov_deg, aspect, light_dir=(-1.0, -1.0, -1.0),
                 base_color=(1.0, 0.8, 0.6), ambient=(0.1, 0.1, 0.1),
                 inter_h=None, inter_w=None, layouts=None, device=None):
    """The frame up to the per-pixel kernel: the packed f32[IH, IW] table
    from the sweep, the kernel's scalars (host f32[35]), the sweep axis
    and whether the table carries the shadow bit."""
    dev = resolve_device(device)
    if layouts is None:
        layouts = SweepLayouts(
            torch.as_tensor(volume, dtype=torch.float32, device=dev),
            None if shadow_vol is None else
            torch.as_tensor(shadow_vol, dtype=torch.float32, device=dev))
    elif layouts.volume is not volume or layouts.shadow is not shadow_vol:
        raise ValueError("layouts belong to another volume or shadow volume")
    if layouts.volume.device != dev:
        raise ValueError(f"volume is on {layouts.volume.device}, not {dev}")
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
    return table, frame_scalars(scal_np), axis_world, has_shadow


def _host(x):
    """A host (numpy) value from a tensor, array or number. Pass host
    values per frame: reading a CUDA tensor waits for the device."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# the split per-pixel path (ray setup, lookup, shade as separate stages)
# --------------------------------------------------------------------------

def _warp_setup(scal, axis_world: int, inter_h: int, inter_w: int,
                width: int, height: int):
    """Per-pixel table index + ray geometry: (lin, behind, dirs, d_s_n).

    ``lin`` is ``iu * inter_w + iv``, or -1 for pixels that cannot hit:
    rays pointing away from the reference plane or meeting it outside
    the table window. ``scal`` is the f32 scalar tensor on the device.
    """
    f32 = torch.float32
    dev = scal.device
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]
    fov_deg, aspect, voxel_size = scal[8], scal[9], scal[10]
    view = scal[18:34].reshape(4, 4)

    tan_half = torch.tan(fov_deg * np.float32(math.pi / 360.0))
    px = (torch.arange(width, dtype=f32, device=dev) + 0.5) / width * 2.0 - 1.0
    py = 1.0 - (torch.arange(height, dtype=f32, device=dev) + 0.5) / height * 2.0
    nx = px * aspect * tan_half
    ny = py * tan_half
    nyg, nxg = torch.meshgrid(ny, nx, indexing="ij")
    d_view = torch.stack([nxg, nyg, -torch.ones_like(nxg)], -1).reshape(-1, 3)
    inv_view = torch.linalg.inv(view)
    with _exact_matmul():
        d_world = d_view @ inv_view[:3, :3].T

    sel = [torch.as_tensor(s, device=dev) for s in _AXIS_SELECTORS[axis_world]]
    d_s = (d_world * sel[0]).sum(-1)
    d_a = (d_world * sel[1]).sum(-1)
    d_b = (d_world * sel[2]).sum(-1)
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
    d_len = torch.linalg.norm(d_world, dim=-1)
    dirs = d_world / d_len[:, None]
    d_s_n = d_s / d_len
    return lin, behind, dirs, d_s_n


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
