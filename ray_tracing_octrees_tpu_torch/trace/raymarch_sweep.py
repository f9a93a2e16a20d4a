"""Sweep-space volume raymarcher: the production frame of VOLUME_RAYCAST.

Counterpart of ``ray_tracing_octrees_tpu/trace/raymarch_sweep.py``; its
oracle is the per-ray march of :mod:`.raymarch`. On binary density
volumes every shaded sample of the reference shader takes alpha
a = min(0.9999, 0.95 + noise*0.02), so the accumulated alpha passes the
0.95 cutoff at the first shaded sample: the march is "first shadeable
sample -> full shading stack -> post-processing". That factors onto the
slab sweep (:mod:`.slab_sweep`):

  1. first-hit detection: one bilinear-hat sweep over the DETECTION
     volume ((density > 0.5) | (edge_factor > 0.1), less radiation-carved
     voxels: the shader's do_shade condition, raycastFS.glsl:763-815);
  2. the shading inputs at the hit: the 10 per-voxel fields the shader
     samples (ao, grad_mag, edge_factor, grad_dir, indirect, shadow) ride
     the same sweep as exact 24-bit packed channels: 8-bit quantized per
     voxel, concatenated along the lateral b axis, fetched with floor
     one-hot hats and packed by {1, 256, 65536} weights in the
     b-contraction, which runs in f32 on f32 copies of the bf16 operands
     (exact: one nonzero term per output) without TF32;
  3. the shader's 8-step shadow march becomes a windowed blocker fraction
     volume (:func:`shadow_fraction_volume`), once per scene state;
  4. per pixel: the stacked table (first hit + 4 channels) is read by
     ``warp_kernel.warp_lookup_multi`` (the CUDA kernel
     ``csrc/warp_lookup.cu`` on the card), then the calculateShading
     stack and the post-processing run as elementwise tensor ops.

Divergences from the oracle (bounded by the tests): hits are
slab-quantized along the sweep axis; fields are nearest-voxel 8-bit; the
shadow is the exact windowed fraction instead of 8 samples; the
stochastic step jitter and TAA accumulation are dropped, the per-pixel
noise and dither of the post stack kept.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.trace.raymarch import (
    EDGE_THRESHOLD, MAIN_LIGHT_DIR, VolumeTextures, _cdiv, _check_textures,
    _consts, _hash, _light_terms, _norm, detect_building_boundaries,
    get_building_color, is_window_position,
)
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
    CH, _AXIS_SELECTORS, _TO_SWEEP, _auto_inter, _exact_matmul,
    _frame_scalars_np, _hats_from_coords, _host, _layout_volume,
    _shadow_hats, _slab_coords, _sweep_geometry, _view_consts, _warp_setup,
)
from ray_tracing_octrees_tpu_torch.trace.warp_kernel import warp_lookup_multi

f32 = torch.float32
bf16 = torch.bfloat16

# warp_lookup_multi's table width limit (its lin packs iv in 10 bits)
MAX_TABLE_W = 1024


# --------------------------------------------------------------------------
# static scene preparation
# --------------------------------------------------------------------------

def _detection_volume(density, edge_factor, radiation) -> torch.Tensor:
    """Shadeable-voxel indicator (do_shade analog, raycastFS.glsl:763-815)."""
    shadeable = (density > EDGE_THRESHOLD) | (edge_factor > 0.1)
    carved = radiation > 0.05
    return (shadeable & ~carved).to(f32)


def _shadow_fraction_apply(blocker, hats, flip: bool, window_slabs: int,
                           inv) -> torch.Tensor:
    """Windowed cumulative occlusion along the light (blocker fraction).

    The shear + cumsum of ``slab_sweep.shadow_volume``, but the per-voxel
    result is the MEAN blocker occupancy over the next ``window_slabs``
    sweep steps toward the light: the quantity the reference's 8 shadow
    samples over its 5-unit march estimate (raycastFS.glsl:223-272).
    Products take bf16 values and keep f32 results, as f32 products of
    bf16-valued inputs (exact products, f32 sums).
    """
    ma, mb, wa, wb = (h.to(f32) for h in hats)
    bfv = lambda x: x.to(bf16).to(f32)
    vols = blocker.flip(0) if flip else blocker
    S = vols.shape[0]
    w = window_slabs
    with _exact_matmul():
        sh = torch.einsum("soa,sab->sob", ma, bfv(vols))
        sh = torch.einsum("sob,spb->sop", bfv(sh), mb)
        # exclusive cumsum; windowed sum over the PRECEDING w steps (the
        # sweep runs from the light side, so "toward the light" is earlier)
        cum = torch.cumsum(sh, dim=0) - sh
        shifted = torch.zeros_like(cum)
        if w < S:
            shifted[w:] = cum[:-w]
        frac = torch.clamp(_cdiv(cum - shifted, float(w)), 0.0, 1.0)
        out = torch.einsum("sao,sop->sap", wa, bfv(frac))
        out = torch.einsum("sap,sbp->sab", bfv(out), wb)
    if flip:
        out = out.flip(0)
    return out.permute(*inv).contiguous()


def shadow_fraction_volume(density, radiation, to_light, range_world: float,
                           voxel_size: float) -> torch.Tensor:
    """f32[Z,Y,X] blocker fraction over ``range_world`` toward the light,
    on ``density``'s device.

    Blockers are the shader's occluders: density > 0.5 and not
    radiation-carved (raycastFS.glsl:252-260).
    """
    l = np.asarray(to_light, np.float64)
    l = l / np.linalg.norm(l)
    axis = int(np.argmax(np.abs(l)))
    inv = {0: (2, 1, 0), 1: (2, 0, 1), 2: (0, 2, 1)}[axis]
    blocker = ((density > EDGE_THRESHOLD) & (radiation < 0.5)).to(f32)
    vol = blocker.permute(*_TO_SWEEP[axis])
    sel = _AXIS_SELECTORS[axis]
    l_s, l_a, l_b = (float(l @ s) for s in sel)
    flip = l_s > 0
    step_s = -1.0 if flip else 1.0
    da = -(l_a / l_s) * step_s
    db = -(l_b / l_s) * step_s
    S, A, B = (int(n) for n in vol.shape)
    # one sweep step spans voxel_size/|l_s| world units along the light
    w = int(max(1, min(S - 1, round(range_world * abs(l_s)
                                    / max(voxel_size, 1e-9)))))
    pa_lo = int(math.ceil(max(0.0, -(S - 1) * da)))
    pa_hi = int(math.ceil(max(0.0, (S - 1) * da)))
    pb_lo = int(math.ceil(max(0.0, -(S - 1) * db)))
    pb_hi = int(math.ceil(max(0.0, (S - 1) * db)))
    hats = _shadow_hats(S, A, B, da, db, pa_lo, pa_hi, pb_lo, pb_hi,
                        density.device)
    return _shadow_fraction_apply(vol, hats, bool(flip), w, inv)


def _q8(x: torch.Tensor) -> torch.Tensor:
    """Quantize [0, 1] -> integers 0..255 as f32 (bf16-exact values)."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(f32)


@dataclasses.dataclass
class VolumeSweepScene:
    """Static sweep form of VolumeTextures: detection + packed field volumes.

    ``bundles`` holds per-channel field triples quantized to 8-bit
    integers, each field a separate f32[Z,Y,X] volume (concatenated along
    the lateral axis at layout time; the {1,256,65536} packing happens in
    the b-contraction weights). ``layouts`` keeps the bf16 sweep-order
    copies of the current sweep case (one at a time); ``sticky_inter`` the
    table dims the last automatic choice took.
    """

    det: torch.Tensor                     # f32[Z,Y,X] detection indicator
    bundles: List[List[torch.Tensor]]     # channels of 1..3 8-bit fields
    box_min: np.ndarray                   # host copies, read every frame
    box_max: np.ndarray
    voxel_size: float
    layouts: Dict = dataclasses.field(default_factory=dict)
    # orbiting cameras cross _auto_inter's 128-texel buckets every few
    # frames; reuse the previous dims while they still cover the window
    sticky_inter: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.det.device


def prepare_volume_scene(tex: VolumeTextures, voxel_size: float,
                         shadow_range_world: float = 5.0,
                         working: Optional[torch.Tensor] = None,
                         device: DeviceLike = None) -> VolumeSweepScene:
    """Bind VolumeTextures (on ``device``) for sweep rendering, once per
    scene state.

    Rebuild after radiation carving or a precompute refresh, exactly when
    the reference re-dispatches its precompute (VolumeRaycastRenderer.cpp:
    843-905). ``working``: an optional frustum working volume; voxels
    outside it are dropped from detection (raycastFS.glsl:704-714).
    """
    _check_textures(tex, device)
    density = tex.vol_mips[0]
    det = _detection_volume(density, tex.edge_factor, tex.radiation)
    if working is not None:
        det = torch.where(working >= 0.001, det, 0.0)
    shadow = shadow_fraction_volume(density, tex.radiation, MAIN_LIGHT_DIR,
                                    shadow_range_world, float(voxel_size))
    gd = tex.grad_dir
    bundles = [
        [_q8(tex.ao), _q8(tex.grad_mag), _q8(tex.edge_factor)],
        [_q8(gd[..., c] * 0.5 + 0.5) for c in range(3)],
        [_q8(tex.indirect[..., c]) for c in range(3)],
        [_q8(shadow)],
    ]
    return VolumeSweepScene(
        det=det, bundles=bundles,
        box_min=tex.box_min.cpu().numpy().astype(np.float32),
        box_max=tex.box_max.cpu().numpy().astype(np.float32),
        voxel_size=float(voxel_size))


def _layout_bundle(scene: VolumeSweepScene, axis_world: int, flip: bool,
                   S: int, crop_lo: int):
    """(det_bf, cats): the bf16 sweep-order detection volume and, per
    channel, its fields concatenated along B; kept in ``scene.layouts``
    for the current sweep case."""
    key = (axis_world, bool(flip), S, crop_lo)
    ent = scene.layouts.get(key)
    if ent is None:
        lay = lambda v: _layout_volume(v, axis_world, flip, S, crop_lo)
        ent = (lay(scene.det),
               [torch.cat([lay(fv) for fv in ch], dim=2)
                for ch in scene.bundles])
        scene.layouts.clear()
        scene.layouts[key] = ent
    return ent


# --------------------------------------------------------------------------
# the per-frame sweep: detection + packed field channels
# --------------------------------------------------------------------------

def _volume_sweep_core(det_bf, cats, scal, s_valid: int, a_size: int,
                       b_size: int, inter_h: int, inter_w: int, flip: bool,
                       nf: Tuple[int, ...], o_base: float = 0.0):
    """First-hit detection + field values at the hit.

    Returns (first_o f32[IH, IW]: GLOBAL layout-row index of the first
    hit, ``s_valid + 1`` on a miss; vals: tuple of f32[IH, IW] 24-bit
    packed field integers per channel at that hit). ``o_base`` offsets
    local slab rows into global ones (a slab segment of a larger sweep:
    the global first hit is the least first_o of the segments).
    """
    dev = det_bf.device
    sp = det_bf.shape[0]
    pa_all, pb_all = _slab_coords(scal, sp, s_valid, inter_h, inter_w, flip,
                                  o_base)
    # bilinear hats for detection; floor one-hots for the nearest fetch
    ma_all, mb_all = _hats_from_coords(pa_all, pb_all, a_size, b_size)
    ia = torch.arange(a_size, dtype=f32, device=dev)
    ib = torch.arange(b_size, dtype=f32, device=dev)
    da = pa_all[..., None] - ia
    maN_all = ((da >= 0) & (da < 1)).to(bf16)
    del da
    dbn = pb_all[..., None] - ib
    mbN_all = ((dbn >= 0) & (dbn < 1)).to(f32)
    del dbn

    big_o = float(s_valid + 1)
    first_o = torch.full((inter_h, inter_w), big_o, dtype=f32, device=dev)
    vals = [torch.zeros((inter_h, inter_w), dtype=f32, device=dev)
            for _ in nf]
    with _exact_matmul():
        for c0 in range(0, sp, CH):
            ma = ma_all[c0:c0 + CH]
            hb = torch.einsum("cab,cha->cbh", det_bf[c0:c0 + CH], ma)
            sh = torch.einsum("cbh,cwb->chw", hb, mb_all[c0:c0 + CH])
            hits = sh > 0.5
            am = torch.argmax(hits.to(torch.uint8), dim=0)
            cand = torch.where(hits.any(dim=0),
                               (am + c0).to(f32) + float(o_base), big_o)
            upd = cand < first_o
            maN = maN_all[c0:c0 + CH]
            mbN = mbN_all[c0:c0 + CH]
            for j, k in enumerate(nf):
                # one one-hot tap per output: the bf16 result is the 8-bit
                # field value exactly
                hbx = torch.einsum("cab,cha->cbh", cats[j][c0:c0 + CH], maN)
                # field i of the channel at b-offset i*B, weight 256^i: one
                # nonzero product per field, so the f32 sum is exact
                mbx = torch.cat([mbN * float(256 ** i) for i in range(k)],
                                dim=2)
                shx = torch.einsum("cbh,cwb->chw", hbx.to(f32), mbx)
                v_at = torch.gather(shx, 0, am[None]).squeeze(0)
                vals[j] = torch.where(upd, v_at, vals[j])
            first_o = torch.where(upd, cand, first_o)
    return first_o, tuple(vals)


def _pack_volume_first_o(first_o, vals, s_valid: int, flip: bool):
    """first_o/vals -> (packed k+0.5 or -1, flat vals), split from the
    sweep so a segmented sweep packs after its combine."""
    hit_i = first_o < float(s_valid)
    k_first = (float(s_valid) - 1.0 - first_o) if flip else first_o
    packed = torch.where(hit_i, k_first + 0.5, -1.0).reshape(-1)
    return packed, tuple(v.reshape(-1) for v in vals)


def _volume_sweep(det_bf, cats, scal, s_valid: int, a_size: int, b_size: int,
                  inter_h: int, inter_w: int, flip: bool,
                  nf: Tuple[int, ...]):
    """Detection sweep + pack: (packed f32[IH*IW], vals f32[IH*IW] per
    channel)."""
    first_o, vals = _volume_sweep_core(det_bf, cats, scal, s_valid, a_size,
                                       b_size, inter_h, inter_w, flip, nf)
    return _pack_volume_first_o(first_o, vals, s_valid, flip)


# --------------------------------------------------------------------------
# per-pixel: table lookup, shading epilogue (calculateShading + post)
# --------------------------------------------------------------------------

def _unpack3(v: torch.Tensor):
    c2 = torch.floor(v / 65536.0)
    r = v - c2 * 65536.0
    c1 = torch.floor(r / 256.0)
    c0 = r - c1 * 256.0
    return _cdiv(c0, 255.0), _cdiv(c1, 255.0), _cdiv(c2, 255.0)


def _gather_table(packed, vals, lin, inter_h: int, inter_w: int, width: int,
                  height: int):
    """The stacked per-texel record (first hit + channels) at each pixel,
    through :func:`warp_kernel.warp_lookup_multi`: (w_depth f32[N], -1
    where ``lin < 0``; w_vals, f32[N] per channel, 0 there). ``lin`` is
    ``iu * inter_w + iv``; the kernel takes ``(iu << 10) | iv``."""
    tables = torch.stack((packed,) + tuple(vals)).reshape(
        1 + len(vals), inter_h, inter_w)
    lin10 = torch.where(lin < 0, -1,
                        ((lin // inter_w) << 10) | (lin % inter_w))
    rows = warp_lookup_multi(tables, lin10.to(torch.int32).reshape(
        height, width)).reshape(1 + len(vals), -1)
    return rows[0], tuple(rows[1:])


def _shade_pixels(w_depth, w_vals, behind, dirs, d_s_n, scal,
                  time_value: float, width: int, height: int) -> dict:
    """calculateShading (raycastFS.glsl:274-351) + post (:943-986)."""
    dev = w_depth.device
    n = width * height
    eye_s, voxel_size, cam_pos = scal[0], scal[10], scal[15:18]
    tv = np.float32(time_value)

    hit = (w_depth >= 0.0) & ~behind
    z_f = torch.clamp(w_depth, min=0.0)
    t_world = torch.where(hit, (z_f - eye_s) * voxel_size / d_s_n, 0.0)
    pos = cam_pos[None, :] + dirs * t_world[:, None]

    ao_q, gm_q, ef_q = _unpack3(w_vals[0])
    normal = torch.stack(_unpack3(w_vals[1]), -1) * 2.0 - 1.0
    normal = normal / torch.clamp(_norm(normal), min=1e-6)[:, None]
    indirect = torch.stack(_unpack3(w_vals[2]), -1)
    sh_frac = _cdiv(w_vals[3], 255.0)

    boundary = detect_building_boundaries(pos)
    edge_factor = torch.where(boundary < 0.4,
                              torch.maximum(ef_q, 1.0 - boundary * 2.0), ef_q)
    window = is_window_position(pos, normal)
    base = get_building_color(pos, scal[43:46], scal[46:49])
    # shadow: boundary dimming less 1.6 x the windowed blocker fraction
    # (the 8-sample march's analog), clamped (raycastFS.glsl:236-272)
    sh_init = torch.where(boundary < 0.6, 0.8 + 0.2 * boundary, 1.0)
    shadow = torch.clamp(sh_init - 1.6 * sh_frac, min=0.2)
    ao, light, rim, edge_dark = _light_terms(normal, dirs, boundary,
                                             edge_factor, 1.0 - ao_q * 0.7,
                                             shadow)
    lit = base * (light + indirect * 3.0) * (ao * edge_dark)[..., None] + rim
    lit = torch.where(window[..., None], _consts(dev).window, lit)

    # compositing: the first (only) shaded sample (raycastFS.glsl:884-898)
    px = torch.arange(width, dtype=f32, device=dev).repeat(height)
    py = torch.arange(height, dtype=f32, device=dev).repeat_interleave(width)
    frag_xy = torch.stack([px, py], -1)

    def frag_hash(w):
        return _hash(torch.cat([frag_xy, torch.full(
            (n, 1), float(np.float32(w)), dtype=f32, device=dev)], -1))

    pixel_noise = frag_hash(tv * np.float32(1111.0))
    a = torch.clamp(0.95 + pixel_noise * 0.02, max=0.9999)
    a = torch.where(ef_q > 0.5, 0.9999, a)
    alpha = torch.where(hit, a, 0.0)
    color = a[:, None] * lit

    # post-processing (:943-986)
    nonzero = (alpha >= 0.1)[..., None]
    final = torch.where(nonzero, color.abs() ** float(np.float32(1.0 / 2.2)),
                        0.0)
    dither = (frag_hash(tv * np.float32(591.3)) - 0.5) * 0.01
    final = torch.where(nonzero, final + dither[..., None], final)
    final = torch.where(nonzero, final / (final + 0.15), final)
    fog = (1.0 - torch.exp(-t_world * 0.0001)) * 0.15
    final = torch.where(nonzero, final + fog[..., None] * (
        _consts(dev).fog - final), final)
    rgba = torch.cat([final, torch.ones((n, 1), dtype=f32, device=dev)], -1)
    return dict(
        color=rgba.reshape(height, width, 4),
        depth=torch.where(hit, t_world, 0.0).reshape(height, width),
        normal=torch.where(hit[:, None], normal, 0.0).reshape(height, width,
                                                               3),
        alpha=alpha.reshape(height, width))


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

# scalar slots appended past the slab_sweep layout for the shading epilogue
_SCAL_EXT = 49   # 43..45 box_min, 46..48 box_max


def _volume_frame_inputs(scene: VolumeSweepScene, grid_origin, camera_pos,
                         view, fov_deg: float, aspect: float,
                         inter_h: Optional[int] = None,
                         inter_w: Optional[int] = None):
    """Host-side frame set-up: sweep geometry, sticky table dims, layouts,
    packed scalars. Returns (det_bf, cats, scal_np f32[49], meta)."""
    vox = scene.voxel_size
    origin = np.asarray(_host(grid_origin), np.float32)
    axis_world, flip, (S, A, B), eyes, window, crop_lo = _sweep_geometry(
        scene.det.shape, origin, vox, camera_pos, view)
    auto_h, auto_w = _auto_inter(window)
    if inter_h is None or inter_w is None:
        st = scene.sticky_inter
        if (st is not None and st[0] >= auto_h and st[1] >= auto_w
                and st[0] * st[1] <= 3 * auto_h * auto_w):
            auto_h, auto_w = st
        else:
            auto_h = min(1024, -(-auto_h // 256) * 256)
            auto_w = min(MAX_TABLE_W, -(-auto_w // 256) * 256)
            scene.sticky_inter = (auto_h, auto_w)
    inter_h = auto_h if inter_h is None else int(inter_h)
    inter_w = auto_w if inter_w is None else int(inter_w)
    if inter_w > MAX_TABLE_W:
        raise ValueError(f"inter_w {inter_w} is over {MAX_TABLE_W}, the "
                         f"widest table warp_lookup_multi reads")
    flip = bool(flip)
    det_bf, cats = _layout_bundle(scene, axis_world, flip, S, crop_lo)
    origin_c = origin + _AXIS_SELECTORS[axis_world][0] * np.float32(
        crop_lo * vox)
    scal_np = np.zeros(_SCAL_EXT, np.float32)
    scal_np[:43] = _frame_scalars_np(
        *eyes[:3], eyes[3], *window, fov_deg, aspect, vox, S, origin_c,
        np.asarray(camera_pos, np.float32), view)
    scal_np[43:46] = scene.box_min
    scal_np[46:49] = scene.box_max
    nf = tuple(len(ch) for ch in scene.bundles)
    meta = dict(axis_world=axis_world, flip=flip, S=S, A=A, B=B,
                inter_h=inter_h, inter_w=inter_w, nf=nf)
    return det_bf, cats, scal_np, meta


def render_volume_frame(scene: VolumeSweepScene, grid_origin, camera_pos,
                        view, fov_deg: float, aspect: float, width: int,
                        height: int, time_value: float = 0.0,
                        inter_h: Optional[int] = None,
                        inter_w: Optional[int] = None,
                        device: DeviceLike = None) -> dict:
    """Sweep-space volume raymarch frame on ``device`` (the scene's; CUDA
    unless ``device="cpu"``).

    Returns dict(color f32[H,W,4], depth, normal, alpha): the
    :func:`raymarch.raymarch_volume` fields the app reads. ``inter_w``
    over 1024 raises (the lookup kernel's limit).
    """
    dev = resolve_device(device)
    if scene.device != dev:
        raise ValueError(f"the scene is on {scene.device}, not {dev}")
    det_bf, cats, scal_np, m = _volume_frame_inputs(
        scene, grid_origin, camera_pos, view, fov_deg, aspect, inter_h,
        inter_w)
    ih, iw = m["inter_h"], m["inter_w"]
    scal = torch.as_tensor(scal_np, device=dev)
    packed, vals = _volume_sweep(det_bf, cats, scal, m["S"], m["A"], m["B"],
                                 ih, iw, m["flip"], m["nf"])
    lin, behind, dirs, d_s_n = _warp_setup(
        scal, m["axis_world"], ih, iw, width, height,
        torch.as_tensor(_view_consts(scal_np), device=dev))
    w_depth, w_vals = _gather_table(packed, vals, lin, ih, iw, width, height)
    return _shade_pixels(w_depth, w_vals, behind, dirs, d_s_n, scal,
                         time_value, width, height)
