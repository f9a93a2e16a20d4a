"""Volume raymarching with advanced shading: the per-ray oracle of the
VolumeRaycast pipeline.

Counterpart of ``ray_tracing_octrees_tpu/trace/raymarch.py``, the port of
``shaders/raycastFS.glsl`` (the reference's 991-line fragment shader)
vectorized over all pixels under one loop: per-ray front-to-back
compositing with

  * adaptive step sizing (distance-, density-, edge- and angle-driven),
  * empty-space skipping via the volume mip pyramid and the precomputed
    skip-distance texture (getOptimizedSkipDistance, raycastFS.glsl:421-508),
  * frustum-culling visibility from the working volume (:644-706),
  * radiation-carve holes (:707-716),
  * TAA-style halton jitter when the camera moves (:533-546) and
    procedural blue-noise dithering (:404-414),
  * 6-iteration binary-search edge refinement (:835-861) exported as the
    depth/normal buffers,
  * the full shading stack (calculateShading, :274-351),
  * gamma, contrast, fog and dither post-processing (:965-986).

Divergent GLSL ``continue`` branches become masked state updates; every
ray advances each iteration through exactly one of the branch families.
The loop stops when it has run ``max_steps`` iterations or no ray is left,
checked on the host after every iteration, as the reference's loop
condition. The periodic skip (every fifth iteration) is computed only on
those iterations: on the others it changes nothing.

The reference's row bands with segmented marches (``resume_state``,
``segment_steps``, ``return_state``) exist because long dispatches killed
the remote TPU worker; they are not carried over. :func:`raymarch_volume`
keeps ``row0`` / ``full_height``, and :func:`raymarch_volume_banded`
loops over row bands with one whole march each.

The pixel rays are products of f32 values summed in a fixed order, so
the card and the CPU trace the same rays; ``sin``, ``exp`` and ``pow``
may differ in the last bit between devices, and the blue-noise terms
amplify that through ``fract``.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.ops.sampling import (
    MipStack, _geometry, sample_lod, sample_trilinear,
)
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _cdiv, _sqrt

f32 = torch.float32

# Lighting constants (raycastFS.glsl:28-37)
MAIN_LIGHT_DIR = np.array([0.5, 0.9, 0.4], np.float32)
MAIN_LIGHT_DIR = MAIN_LIGHT_DIR / np.linalg.norm(MAIN_LIGHT_DIR)
MAIN_LIGHT_COLOR = np.array([1.0, 0.98, 0.9], np.float32) * 4.0
SKY_LIGHT_COLOR = np.array([0.6, 0.7, 0.9], np.float32) * 0.4
GROUND_LIGHT_COLOR = np.array([0.3, 0.25, 0.2], np.float32) * 0.2
EDGE_THRESHOLD = 0.5
ALPHA_CUTOFF = 0.95
WINDOW_DENSITY = 0.4
WINDOW_WIDTH = 0.3
WINDOW_HEIGHT = 0.7

HALTON_JITTER = np.array(
    [
        [0.5000, 0.3333], [0.2500, 0.6667], [0.7500, 0.1111], [0.1250, 0.4444],
        [0.6250, 0.7778], [0.3750, 0.2222], [0.8750, 0.5556], [0.0625, 0.8889],
    ],
    np.float32,
)

_HASH_K = np.array([0.1031, 0.1030, 0.0973], np.float32)
_HASH_INV_K = np.float32(1.0) / _HASH_K
_PALETTE = np.array(
    [
        [0.90, 0.85, 0.75], [0.73, 0.68, 0.62], [0.86, 0.75, 0.65],
        [0.65, 0.62, 0.58], [0.81, 0.71, 0.65], [0.78, 0.82, 0.76],
    ],
    np.float32,
)
_WINDOW_COLOR = (0.2, 0.25, 0.3)
_FOG_COLOR = (0.15, 0.17, 0.2)


@dataclasses.dataclass(frozen=True)
class VolumeTextures:
    """The renderer's eight 3D textures as tensors
    (VolumeRaycastRenderer.h:92-99). Frozen: a change makes a new object
    (``dataclasses.replace``), which is how the sweep scene notices it."""

    vol_mips: List[torch.Tensor]   # f32[Z,Y,X] mip chain (density 0/1)
    working: torch.Tensor          # f32[Z,Y,X] frustum-culled copy
    radiation: torch.Tensor        # f32[Z,Y,X]
    grad_mag: torch.Tensor         # f32[Z,Y,X]
    grad_dir: torch.Tensor         # f32[Z,Y,X,3]
    edge_factor: torch.Tensor      # f32[Z,Y,X]
    ao: torch.Tensor               # f32[Z,Y,X]
    indirect: torch.Tensor         # f32[Z,Y,X,3]
    skip: torch.Tensor             # f32[sz,sy,sx] normalized skip distances
    box_min: torch.Tensor          # f32[3]
    box_max: torch.Tensor          # f32[3]

    @property
    def device(self) -> torch.device:
        return self.box_min.device


def _const(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


@functools.lru_cache(maxsize=None)
def _consts(dev: torch.device) -> SimpleNamespace:
    """The shader's constant vectors on ``dev``, made once per device
    (never written to): the march reads them every iteration, and making
    them anew would copy from the host each time."""
    return SimpleNamespace(
        hash_k=_const(_HASH_K, dev), hash_inv_k=_const(_HASH_INV_K, dev),
        palette=_const(_PALETTE, dev), light_dir=_const(MAIN_LIGHT_DIR, dev),
        light_color=_const(MAIN_LIGHT_COLOR, dev),
        sky=_const(SKY_LIGHT_COLOR, dev),
        ground=_const(GROUND_LIGHT_COLOR, dev),
        window=_const(_WINDOW_COLOR, dev), fog=_const(_FOG_COLOR, dev))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add: the form
    the reference's compiled sums of products take. Through f64, where
    the product of two f32 values is exact, so every device gives the same
    bits (up to a double rounding, about once in 2^29)."""
    return (a.double() * b + c).float()


def _hash(p: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """hash() (raycastFS.glsl:52-56) over the last dim of size 3.

    Its fract amplifies the last bit of its sums of products, which the
    reference's compiled programs round in two ways: as fused
    multiply-adds in the per-ray march (``fused``), as separate products
    and sums in the sweep frame's shading. Both forms are kept so each
    path rounds as its reference does.
    """
    c = _consts(p.device)
    fl = torch.floor(p * c.hash_k)
    p = _fma(-fl, c.hash_inv_k, p) if fused else p - fl * c.hash_inv_k
    p = p * c.hash_k
    p = p - torch.floor(p)
    p0, p1, p2 = p[..., 0], p[..., 1], p[..., 2]
    if fused:
        q01, q2 = _fma(p0, p1, 33.33), _fma(p2, p2, 33.33)
    else:
        q01, q2 = p0 * p1 + 33.33, p2 * p2 + 33.33
    s = (q01 + q01) + q2      # p.x * p.y twice: the swizzle pairs x, y
    p0, p1, p2 = p0 + s, p1 + s, p2 + s
    v = (p0 + p1) * p2
    return v - torch.floor(v)


def _fract(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def _smoothstep(e0: float, e1: float, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(_cdiv(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _intersect_box(ro, rd, bmin, bmax):
    """intersectBox (raycastFS.glsl:66-88): (tmin, tmax) over the last dim."""
    safe = torch.where(rd.abs() < 1e-10, torch.where(rd >= 0, 1e10, -1e10),
                       1.0 / rd)
    t1 = (bmin - ro) * safe
    t2 = (bmax - ro) * safe
    return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)


def _dot(a: torch.Tensor, b) -> torch.Tensor:
    """a . b over the last dim of size 3: a chain of fused multiply-adds,
    as the reference's compiled sums of products round."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1],
                                           a[..., 0] * b[..., 0]))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last dim of size 3 (:func:`_dot` with itself)."""
    return _sqrt(_dot(v, v))


def is_window_position(pos: torch.Tensor, normal: torch.Tensor):
    """isWindowPosition (raycastFS.glsl:123-158)."""
    rand_off = _hash(torch.floor(_cdiv(pos, 5.0))) * 0.2
    wd, ww, wh = WINDOW_DENSITY, WINDOW_WIDTH, WINDOW_HEIGHT

    def band(g, width):
        return (g > (1.0 - width) * 0.5) & (g < (1.0 + width) * 0.5)

    win_x = band(_fract(pos[..., 1] * wd + rand_off), ww) & band(
        _fract(pos[..., 2] * (wd * 0.7)), wh)
    win_z = band(_fract(pos[..., 0] * wd + rand_off), ww) & band(
        _fract(pos[..., 1] * (wd * 0.7)), wh)
    win_d = win_z     # the reference's default branch reads (x, y) as well
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    return torch.where(
        nx.abs() > 0.7, win_x,
        torch.where(nz.abs() > 0.7, win_z,
                    ~((ny > 0.7) | (ny < -0.7)) & win_d))


def get_building_color(pos: torch.Tensor, box_min, box_max) -> torch.Tensor:
    """getBuildingColor (raycastFS.glsl:162-203)."""
    bpos = torch.floor(_cdiv(pos, 8.0))
    bid = _hash(bpos)
    sel = torch.where(
        bid < 0.17, 0,
        torch.where(bid < 0.34, 1,
                    torch.where(bid < 0.50, 2,
                                torch.where(bid < 0.67, 3,
                                            torch.where(bid < 0.84, 4, 5)))))
    base = _consts(pos.device).palette[sel]
    height = (pos[..., 1] - box_min[1]) / (box_max[1] - box_min[1])
    base = base * (1.0 + 0.15 * (height * 0.3))[..., None]
    mx = torch.remainder(pos[..., 0], 8.0)
    mz = torch.remainder(pos[..., 2], 8.0)
    dist_edge = torch.minimum(
        torch.minimum((mx - 0.1).abs(), (mx - 7.9).abs()),
        torch.minimum((mz - 0.1).abs(), (mz - 7.9).abs()))
    ef = _smoothstep(0.0, 0.2, dist_edge)
    base = torch.where((dist_edge < 0.2)[..., None],
                       base * (0.7 + 0.3 * ef)[..., None], base)
    return base * (0.9 + 0.2 * _hash(bpos * 42.1))[..., None]


def detect_building_boundaries(pos: torch.Tensor) -> torch.Tensor:
    """detectBuildingBoundaries (raycastFS.glsl:207-220)."""
    cell = _fract(_cdiv(pos, 8.0))
    d = torch.minimum(cell, 1.0 - cell)
    min_dist = torch.clamp(torch.minimum(d[..., 0], d[..., 2]), max=0.5)
    return _smoothstep(0.0, 0.1, min_dist)


class _Packed:
    """The textures one step of the march reads at the same points, packed
    as channels so each set is one gather (the same arithmetic per
    channel as separate samples): ``occl`` (density, radiation) for the
    shadow march, ``fields`` (radiation, grad_mag, grad_dir, edge_factor)
    at the sample, ``shade`` (ao, indirect) for the shading, and the mip
    chain as a :class:`MipStack`. Built once per frame."""

    def __init__(self, tex: VolumeTextures):
        one = lambda t: t[..., None]
        self.occl = torch.stack([tex.vol_mips[0], tex.radiation], -1)
        self.fields = torch.cat([one(tex.radiation), one(tex.grad_mag),
                                 tex.grad_dir, one(tex.edge_factor)], -1)
        self.shade = torch.cat([one(tex.ao), tex.indirect], -1)
        self.mips = MipStack(tex.vol_mips)


def calculate_shadow(tex: VolumeTextures, pos: torch.Tensor,
                     light_dir: torch.Tensor, occl=None) -> torch.Tensor:
    """calculateShadow (raycastFS.glsl:223-272): 8-step occlusion march.
    The 8 sample points are known up front, so they are read at once;
    ``occl`` is :class:`_Packed`'s (density, radiation) texture."""
    if occl is None:
        occl = torch.stack([tex.vol_mips[0], tex.radiation], -1)
    ro = pos + light_dir * 0.05
    t_near, t_far_raw = _intersect_box(ro, light_dir, tex.box_min,
                                       tex.box_max)
    no_hit = t_near > t_far_raw
    t = torch.clamp(t_near, min=0.0)
    t_far = torch.clamp(t_far_raw, max=5.0)
    step = _cdiv(t_far - t, 10.0)
    ts = [t]
    for _ in range(7):
        ts.append(ts[-1] + step)
    ts = torch.stack(ts)                                  # [8, ...]
    uvw = (ro + light_dir * ts[..., None] - tex.box_min) / (
        tex.box_max - tex.box_min)
    inside = ((uvw >= 0.0) & (uvw <= 1.0)).all(-1)
    s = sample_trilinear(occl, torch.clamp(uvw, 0.0, 1.0))
    occludes = (inside & (ts <= t_far) & (s[..., 0] > EDGE_THRESHOLD)
                & (s[..., 1] < 0.5))
    boundary = detect_building_boundaries(pos)
    shadow = torch.where(boundary < 0.6, 0.8 + 0.2 * boundary, 1.0)
    for k in range(8):
        shadow = torch.where(occludes[k], shadow - 0.2, shadow)
    shadow = torch.clamp(shadow, min=0.2)
    return torch.where(no_hit, 1.0, shadow)


def _light_terms(normal, ray_dir, boundary, edge_factor, ao, shadow):
    """The shading stack after the texture reads (raycastFS.glsl:
    300-351): (ambient factor, direct + sky + ground, rim, edge dark)."""
    c = _consts(normal.device)
    ao = torch.where(boundary < 0.5, ao * (0.7 + 0.3 * boundary), ao)
    ndotl = torch.clamp(_dot(normal, c.light_dir), min=0.0)
    direct = c.light_color * (ndotl * shadow)[..., None]
    sky = c.sky * (0.5 + 0.5 * normal[..., 1])[..., None]
    ground = c.ground * (0.5 - 0.5 * normal[..., 1])[..., None]
    rim_f = (1.0 - torch.clamp(_dot(normal, -ray_dir), min=0.0)) ** 3
    rim = (rim_f * 0.3)[..., None].expand(rim_f.shape + (3,))
    rim = torch.where((boundary < 0.6)[..., None],
                      rim * (2.0 * (1.0 - boundary))[..., None], rim)
    edge_dark = torch.where(
        edge_factor > 0.7, 0.7,
        torch.where(edge_factor > 0.3,
                    0.85 + 0.15 * _cdiv(0.7 - edge_factor, 0.4), 1.0))
    edge_dark = torch.where(boundary < 0.4, edge_dark * (0.6 + 0.4 * boundary),
                            edge_dark)
    return ao, direct + sky + ground, rim, edge_dark


def calculate_shading(tex: VolumeTextures, pos, normal, ray_dir,
                      edge_factor, packed: "_Packed" = None) -> torch.Tensor:
    """calculateShading (raycastFS.glsl:274-351)."""
    base = get_building_color(pos, tex.box_min, tex.box_max)
    boundary = detect_building_boundaries(pos)
    edge_factor = torch.where(boundary < 0.4,
                              torch.maximum(edge_factor, 1.0 - boundary * 2.0),
                              edge_factor)
    window = is_window_position(pos, normal)
    uvw = torch.clamp((pos - tex.box_min) / (tex.box_max - tex.box_min),
                      0.0, 1.0)
    shade = torch.cat([tex.ao[..., None], tex.indirect], -1) \
        if packed is None else packed.shade
    s = sample_trilinear(shade, uvw)           # ao, indirect
    c = _consts(pos.device)
    shadow = calculate_shadow(tex, pos, c.light_dir.expand_as(pos),
                              None if packed is None else packed.occl)
    ao, light, rim, edge_dark = _light_terms(normal, ray_dir, boundary,
                                             edge_factor,
                                             1.0 - s[..., 0] * 0.7, shadow)
    lit = base * (light + s[..., 1:] * 3.0) * (ao * edge_dark)[..., None] + rim
    return torch.where(window[..., None], c.window, lit)


@functools.lru_cache(maxsize=None)
def _cell_size(dz: int, dy: int, dx: int, dev: torch.device):
    """f32 (1/X, 1/Y, 1/Z) of a volume, kept per shape and device."""
    return _const(np.float32(1.0) / np.array([dx, dy, dz], np.float32), dev)


def get_optimized_skip_distance(tex: VolumeTextures, cam_pos, ray_dir, pos,
                                enable_octree_skip: bool, use_mip_skip: bool,
                                max_mip_level: int, mips=None):
    """getOptimizedSkipDistance (raycastFS.glsl:421-508). ``mips``: the
    chain's :class:`MipStack` (made from ``tex.vol_mips`` by default);
    the levels are read at once."""
    mips = MipStack(tex.vol_mips) if mips is None else mips
    box_ext = tex.box_max - tex.box_min
    npos = (pos - tex.box_min) / box_ext
    inside = ((npos >= 0.0) & (npos <= 1.0)).all(-1)
    ncl = torch.clamp(npos, 0.0, 1.0)
    skip = torch.zeros(pos.shape[:-1], dtype=f32, device=pos.device)
    if use_mip_skip:
        top = min(max_mip_level, 4, mips.n - 1)
        levels = torch.arange(top, -1, -1, device=pos.device)
        dens = mips.sample(ncl.expand((top + 1,) + ncl.shape),
                           levels.reshape((-1,) + (1,) * skip.ndim)
                           .expand((top + 1,) + skip.shape))
        found = torch.zeros_like(inside)
        for j, mip in enumerate(range(top, -1, -1)):
            shape = tuple(int(d) for d in mips.shapes[mip])
            tex_size = _geometry(*shape, pos.device)[2]
            cell_size = _cell_size(*shape, pos.device)
            cell_min = torch.floor(npos * tex_size) * cell_size
            cell_max = cell_min + cell_size
            inset = float(np.float32(0.001 + mip * 0.001))
            cell_min = cell_min + cell_size * inset
            cell_max = cell_max - cell_size * inset
            wmin = tex.box_min + cell_min * box_ext
            wmax = tex.box_min + cell_max * box_ext
            _, t_far = _intersect_box(pos, ray_dir, wmin, wmax)
            exit_dist = torch.clamp(
                t_far - float(np.float32(0.01 * (mip + 1.0))), min=0.0)
            thresh = 0.001 if mip > 2 else 0.01
            take = (~found) & (dens[j] < thresh) & (exit_dist > 0.0)
            skip = torch.where(
                take, torch.maximum(skip, exit_dist * float(
                    np.float32(1.0 - mip * 0.05))), skip)
            found = found | take
    if enable_octree_skip:
        pre = sample_trilinear(tex.skip, ncl)
        skip = torch.where(skip == 0.0, pre * _norm(box_ext), skip)
    skip = skip * (0.9 if use_mip_skip else 0.95)
    if use_mip_skip and not enable_octree_skip:
        return torch.where(inside, skip, 0.0)
    nd = torch.clamp(_cdiv(_norm(pos - cam_pos), 50.0), 0.0, 1.0)
    scale = 0.001 + (12.0 - 0.001) * nd ** 3.5
    return torch.where(inside, skip * scale, 0.0)


def _mat4_apply(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m.T`` for x [..., 4]: f32 products summed pairwise, as the
    reference's full-precision product rounds, and alike on every device
    (no TF32, no reordered sums)."""
    return torch.stack([(x[..., 0] * m[r, 0] + x[..., 1] * m[r, 1])
                        + (x[..., 2] * m[r, 2] + x[..., 3] * m[r, 3])
                        for r in range(4)], dim=-1)


def _check_textures(tex: VolumeTextures, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if tex.device != dev:
        raise ValueError(f"textures are on {tex.device}, not {dev}")
    return dev


def _check_textures(tex: VolumeTextures, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if tex.device != dev:
        raise ValueError(f"textures are on {tex.device}, not {dev}")
    return dev


# the march state a frame returns, by its output name
_OUT = {"T": "t_final", "alpha": "alpha", "color": "color",
        "steps": "steps", "edge_depth": "depth", "edge_normal": "normal"}


def _march_iteration(i: int, c: SimpleNamespace, R: dict, S: dict) -> dict:
    """One iteration of traceRay's loop (raycastFS.glsl:560-940) over the
    rays in ``R`` (per-ray constants) and ``S`` (their state): the new
    state. A ray that is done changes nothing that a frame returns."""
    tex, cam, box_ext = c.tex, c.cam, c.box_ext
    ray_dir, base_step, df = R["ray_dir"], R["base_step"], R["dist_factor"]
    T = S["T"]
    alive = (~S["done"] & (T <= R["t_far"]) & (S["alpha"] <= ALPHA_CUTOFF)
             & (S["steps"] < R["max_steps"]))
    handled = ~alive
    pos = cam + ray_dir * T[..., None]

    # periodic skip check (raycastFS.glsl:627-637): every fifth iteration
    if (c.octree_skip or c.mip_skip) and i % 5 == 0:
        skip_d = get_optimized_skip_distance(
            tex, cam, ray_dir, pos, c.octree_skip, c.mip_skip, c.max_mip,
            c.packed.mips)
        skipped = alive & (skip_d > 0.0)
        T = torch.where(skipped, T + skip_d, T)
        handled = handled | skipped

    pos = pos + R["noise_pos"]
    uvw = (pos - tex.box_min) / box_ext

    # mip-mode frustum boundary (raycastFS.glsl:644-672)
    if c.frustum and c.mip_skip:
        visf = sample_trilinear(tex.working, torch.clamp(uvw, 0.0, 1.0))
        hard = ~handled & alive & (visf < 0.001)
        T = torch.where(hard, T + base_step * 4.0, T)
        handled = handled | hard
        falloff = _smoothstep(0.0, 0.1, visf)
        soft = ~handled & alive & (visf < 0.1) & (falloff < 0.2)
        T = torch.where(soft, T + base_step * (1.0 + (1.0 - falloff) * 3.0),
                        T)
        handled = handled | soft

    # outside-volume handling (:675-700)
    outside_dist = torch.clamp(torch.maximum(-uvw, uvw - 1.0),
                               min=0.0).amax(-1)
    is_outside = outside_dist > 0.0
    far_outside = ~handled & alive & is_outside & (outside_dist >= 0.05)
    T = torch.where(far_outside, T + base_step * (3.0 + outside_dist * 10.0),
                    T)
    handled = handled | far_outside
    near_boundary = is_outside & (outside_dist < 0.05)
    uvw = torch.where(near_boundary[..., None],
                      torch.clamp(uvw, 0.001, 0.999), uvw)
    boundary_ctr = torch.where(near_boundary, S["boundary_ctr"] + 1.0,
                               torch.clamp(S["boundary_ctr"] - 0.5, min=0.0))
    uvc = torch.clamp(uvw, 0.0, 1.0)

    # plain frustum-culling check (:704-714)
    if c.frustum:
        vis = sample_trilinear(tex.working, uvc)
        culled = ~handled & alive & (vis < 0.001)
        T = torch.where(culled, T + base_step * (
            1.0 + 3.0 * (1.0 - vis * 10.0)), T)
        handled = handled | culled

    # the fields at the sample: radiation, grad_mag, grad_dir, edge_factor
    fld = sample_trilinear(c.packed.fields, uvc)
    rad_val, grad_mag = fld[..., 0], fld[..., 1]
    normal, edge_dist = fld[..., 2:5], fld[..., 5]

    # density sampling (:718-760)
    pn = R["pixel_noise"]
    if c.mip_skip:
        # the four offset reads in one (every sample takes this branch, so
        # the standard-quality read is never used)
        lod = R["lod"]
        so = c.hq_offsets[:, None, :] * (lod + 0.5)[None, :, None]
        d = sample_lod(c.packed.mips, torch.clamp(uvw + so, 0.0, 1.0), lod)
        den = (((d[0] + d[1]) + d[2]) + d[3]) / 4.0
    else:
        hq = near_boundary | (boundary_ctr > 0.0) | (df < 0.5)
        so = c.lq_offsets[:, None, :] * (1.0 + pn * 0.5)[None, :, None]
        pts = torch.cat([torch.clamp(uvw + R["noise_offset"] * 0.001, 0.0,
                                     1.0)[None],
                         torch.clamp(uvw + so, 0.0, 1.0)])
        d = sample_trilinear(tex.vol_mips[0], pts)
        den_std = sample_lod(c.packed.mips, uvc, df * 2.0)
        den = torch.where(hq, _cdiv((d[0] + d[1]) + d[2], 3.0), den_std)
    den = den + (pn - 0.5) * 0.01

    # carved-by-radiation step (:763-777)
    empty_ctr = S["empty_ctr"]
    rad_step = ~handled & alive & (rad_val > 0.05)
    ec1 = empty_ctr + 1.0
    var_step = base_step * (1.0 + 3.0 * torch.clamp(_cdiv(ec1, 15.0),
                                                    max=1.0))
    var_step = var_step * (1.0 + 0.1 * R["sin_dir"])
    T = torch.where(rad_step, T + var_step * (1.0 + 0.5 * rad_val), T)
    handled = handled | rad_step

    # empty voxel step (:780-812)
    empty_step = ~handled & alive & (den < 0.01)
    vstep = base_step * (1.5 + 4.5 * torch.clamp(_cdiv(ec1, 25.0), max=1.0))
    if c.mip_skip:
        vstep = vstep * (0.7 + 0.3 * _smoothstep(0.0, 30.0, ec1))
        vstep = vstep * torch.where(df < 0.3, 0.6, 0.9)
        vstep = vstep * (0.9 + 0.1 * R["tj"])
    vstep = vstep * (1.0 + 0.1 * R["sin_y20"])
    near_or_ctr = near_boundary | (boundary_ctr > 0.0)
    vstep = torch.where(near_or_ctr, vstep * 0.3, vstep)
    T = torch.where(empty_step, T + vstep, T)

    took_empty = rad_step | empty_step
    empty_ctr = torch.where(took_empty, empty_ctr + 1.0, empty_ctr)
    was_empty = S["was_empty"] | took_empty
    detail_ctr = torch.where(took_empty, 0.0, S["detail_ctr"])
    handled = handled | empty_step

    # non-empty sample: shading path (:815-940)
    shade_ray = alive & ~handled
    was_empty = was_empty & ~shade_ray
    empty_ctr = torch.where(shade_ray, 0.0, empty_ctr)
    is_inside = den > EDGE_THRESHOLD
    crossing = shade_ray & ((is_inside != S["was_inside"])
                            | ((den - S["prev_density"]).abs() > 0.15))

    do_shade = shade_ray & ((edge_dist > 0.1) | is_inside)
    detail_ctr = torch.where(do_shade, detail_ctr + 1.0, detail_ctr)
    boundary_ctr = torch.where(crossing, 5.0, boundary_ctr)
    was_inside = torch.where(shade_ray, is_inside, S["was_inside"])
    prev_density = torch.where(shade_ray, den, S["prev_density"])

    # the edge refinement and the shading change only the rays at a
    # crossing or a shaded sample: run them on those rays alone
    edge_depth, edge_normal = S["edge_depth"], S["edge_normal"]
    alpha, color = S["alpha"], S["color"]
    sub = torch.nonzero(crossing | do_shade).squeeze(1)
    if sub.numel():
        cr, sh = crossing[sub], do_shade[sub]
        rd, t_s = ray_dir[sub], T[sub]
        nb_s = near_boundary[sub]
        inside_s = is_inside[sub]

        # binary-search edge refinement (:835-861)
        refine_ok = cr & ~nb_s if i > 0 else torch.zeros_like(cr)
        prev_t = t_s - S["cur_step"][sub]
        cur_t = t_s
        for _ in range(6):
            mid_t = 0.5 * (prev_t + cur_t)
            mid_uvw = (cam + rd * mid_t[..., None] - tex.box_min) / box_ext
            mid_in = ((mid_uvw >= 0.0) & (mid_uvw <= 1.0)).all(-1)
            mid_den = sample_trilinear(tex.vol_mips[0],
                                       torch.clamp(mid_uvw, 0.0, 1.0))
            same = (mid_den > EDGE_THRESHOLD) == inside_s
            upd = refine_ok & mid_in
            cur_t = torch.where(upd & same, mid_t, cur_t)
            prev_t = torch.where(upd & ~same, mid_t, prev_t)
        refined_t = torch.where(refine_ok, cur_t, t_s)
        refined_uvw = torch.clamp(
            (cam + rd * refined_t[..., None] - tex.box_min) / box_ext,
            0.0, 1.0)
        edge_normal = edge_normal.index_put((sub,), torch.where(
            cr[..., None], sample_trilinear(tex.grad_dir, refined_uvw),
            edge_normal[sub]))
        edge_depth = edge_depth.index_put((sub,), torch.where(
            cr, refined_t, edge_depth[sub]))

        # compositing (:862-898)
        ef_s = edge_dist[sub]
        a = torch.clamp(0.95 + pn[sub] * 0.02, max=0.9999)
        a = torch.where(ef_s > 0.5, 0.9999, a)
        a = torch.where(nb_s, torch.clamp(a * 0.9, max=0.95), a)
        lit = calculate_shading(tex, pos[sub], normal[sub], rd, ef_s,
                                c.packed)
        al = alpha[sub]
        weight = (1.0 - al) * a
        color = color.index_put((sub,), torch.where(
            sh[..., None], color[sub] + weight[..., None] * lit, color[sub]))
        alpha = alpha.index_put((sub,), torch.where(sh, al + weight, al))

    # shaded step size (:900-927)
    detail_factor = torch.clamp(_cdiv(detail_ctr, 20.0), max=1.0)
    bss_uniform = 0.2 + (0.1 - 0.2) * detail_factor
    bss_uniform = bss_uniform + (0.5 - bss_uniform) * df
    bss = torch.where(
        (edge_dist > 0.5) | near_boundary, 0.02 + 0.08 * df,
        torch.where((edge_dist > 0.2) | (grad_mag > 0.8), 0.05 + 0.15 * df,
                    torch.where(grad_mag > 0.6, 0.1 + 0.2 * df,
                                bss_uniform)))
    shade_step = base_step * bss * (1.0 + R["dir_jit"])

    # non-shaded in-volume step (:929-940)
    idle_scale = torch.where(near_boundary | (boundary_ctr > 0.0),
                             R["idle_scale"] * 0.3, R["idle_scale"])
    cur_step = torch.where(do_shade, shade_step,
                           torch.where(shade_ray, base_step * idle_scale,
                                       S["cur_step"]))
    T = torch.where(shade_ray, T + cur_step, T)
    return dict(T=T, alpha=alpha, color=color, was_inside=was_inside,
                was_empty=was_empty, prev_density=prev_density,
                empty_ctr=empty_ctr, detail_ctr=detail_ctr,
                boundary_ctr=boundary_ctr, cur_step=cur_step,
                steps=S["steps"] + alive.to(torch.int32),
                edge_depth=edge_depth, edge_normal=edge_normal,
                done=S["done"] | ~alive)


def raymarch_volume(
    tex: VolumeTextures,
    cam_pos,
    inv_view,
    inv_proj,
    width: int,
    height: int,
    time_value: float = 0.0,
    octree_skip_t: float = 0.0,
    prev_cam_pos=None,
    prev_look_dir=None,
    use_frustum_culling: bool = False,
    enable_octree_skip: bool = True,
    use_mip_skip: bool = True,
    max_steps: int = 800,
    row0: int = 0,
    full_height: int = 0,
    device: DeviceLike = None,
) -> dict:
    """Full-frame volume raymarch (traceRay, raycastFS.glsl:511-986).

    ``tex`` on ``device`` (CUDA unless ``device="cpu"``); ``cam_pos``,
    ``inv_view`` and ``inv_proj`` host f32 values (invert the camera in
    float64 first: an f32 inverse of the far/near = 50000 projection
    corrupts the rays). Returns dict: color f32[H, W, 4], depth f32[H, W]
    (refined first-edge t, 0 where none), normal f32[H, W, 3] (gradient at
    the refined edge), alpha, steps (int32), iters (int), t_final, t_near
    and t_far.

    ``row0`` / ``full_height``: render only the ``height`` pixel rows
    starting at row ``row0`` of a ``full_height``-row frame, equal to
    those rows of the whole frame (every per-pixel term derives from the
    absolute pixel coordinate).

    The loop runs while a ray is left and fewer than ``max_steps``
    iterations have run, checked on the host after each. When at least
    half of the rays it carries are done, it keeps only the others (a done
    ray changes nothing the frame returns).
    """
    dev = _check_textures(tex, device)
    cam = _const(cam_pos, dev)
    inv_view = _const(inv_view, dev)
    inv_proj = _const(inv_proj, dev)
    tv = float(np.float32(time_value))
    prev_cam = _const(cam_pos if prev_cam_pos is None else prev_cam_pos, dev)
    prev_look = _const((0.0, 0.0, -1.0) if prev_look_dir is None
                       else prev_look_dir, dev)

    n = width * height
    fh = full_height if full_height else height
    px = torch.arange(width, dtype=f32, device=dev).repeat(height)
    py = torch.arange(height, dtype=f32, device=dev).repeat_interleave(
        width) + float(row0)
    frag_xy = torch.stack([px, py], -1)
    # pixel centre -> ndc, rounded as the reference's compiled form: the
    # coordinate (p + 0.5) / size as a product with 1 / size, fused with
    # the jitter, or with 2 / size and the -1 where there is none
    xs, ys = px + 0.5, py + 0.5
    rw = float(np.float32(1.0) / np.float32(width))
    rh = float(np.float32(1.0) / np.float32(fh))

    def ray_from_ndc(ndc):
        clip = torch.cat([ndc, torch.ones_like(ndc)], -1)
        view = _mat4_apply(clip, inv_proj)
        view = view / view[..., 3:4]
        world = _mat4_apply(view, inv_view)[..., :3]
        d = world - cam
        return world, d / _norm(d)[..., None]

    _, ray_dir0 = ray_from_ndc(torch.stack(
        [_fma(xs, 2.0 * rw, -1.0), _fma(-ys, 2.0 * rh, 1.0)], -1))
    frame_number = int(np.mod(np.float32(tv) * np.float32(60.0),
                              np.float32(16.0)).astype(np.int32))
    look_n = prev_look / torch.clamp(_norm(prev_look), min=1e-30)
    moving = (_norm(cam - prev_cam) > 0.001) | (
        _dot(look_n.expand_as(ray_dir0), ray_dir0) < 0.9999)
    vol0 = tex.vol_mips[0]
    jitter = HALTON_JITTER[frame_number % 8] * np.float32(1.5) / np.array(
        [vol0.shape[2], vol0.shape[1]], np.float32)
    cx = _fma(xs, rw, torch.where(moving, float(jitter[0]), 0.0))
    cy = _fma(ys, rh, torch.where(moving, float(jitter[1]), 0.0))
    world_pt, ray_dir = ray_from_ndc(torch.stack([2.0 * cx - 1.0,
                                                  1.0 - 2.0 * cy], -1))

    t_near_raw, t_far = _intersect_box(cam, ray_dir, tex.box_min, tex.box_max)
    t_near = torch.clamp(t_near_raw, min=0.0)
    skip_t = float(np.float32(octree_skip_t))
    if skip_t > 0.0:
        t_near = torch.clamp(t_near, min=skip_t)

    view_dist = _norm(world_pt - cam)
    dist_factor = torch.clamp(_cdiv(view_dist, 500.0), 0.0, 1.0)
    box_ext = tex.box_max - tex.box_min
    box_diag = _norm(box_ext)
    span = t_far - t_near
    base_step = (
        torch.minimum(_cdiv(box_diag, 2048.0), _cdiv(span, 2048.0))
        * (1 - dist_factor)
        + torch.minimum(_cdiv(box_diag, 1024.0), _cdiv(span, 1024.0))
        * dist_factor)

    # blue-noise offset (raycastFS.glsl:404-414)
    nxy = frag_xy + _const([np.float32(tv) * np.float32(0.11),
                            np.float32(tv) * np.float32(0.17)], dev)

    def h2(k, m):
        # fract(sin(dot(nxy, k)) * m): the dot as a fused multiply-add and
        # the sine correctly rounded, since fract amplifies their last bit
        arg = _fma(nxy[..., 1], float(np.float32(k[1])),
                   nxy[..., 0] * float(np.float32(k[0])))
        s = torch.sin(arg.double()).float() * m
        return s - torch.floor(s)

    noise_offset = (torch.stack([h2((127.1, 311.7), 43758.5453123),
                                 h2((269.5, 183.3), 41749.6721234),
                                 h2((419.2, 371.9), 81749.8975432)], -1)
                    * 2.0 - 1.0) * 0.001

    def frag_hash(w: float):
        return _hash(torch.cat([frag_xy, torch.full(
            (n, 1), float(np.float32(w)), dtype=f32, device=dev)], -1),
            fused=True)

    pixel_noise = frag_hash(np.float32(tv) * np.float32(1111.0))
    t0 = t_near + base_step * pixel_noise * 0.5
    t0 = t0 + ray_dir[..., 1].abs() * 0.1 * base_step

    R = dict(
        ray_dir=ray_dir, t_far=t_far, base_step=base_step,
        dist_factor=dist_factor, pixel_noise=pixel_noise,
        noise_offset=noise_offset,
        noise_pos=noise_offset * (0.5 + 1.5 * dist_factor)[..., None],
        max_steps=max_steps - (dist_factor * 350.0).to(torch.int32),
        sin_dir=torch.sin(_dot(ray_dir, _const([1.0, 3.0, 2.0], dev)
                               .expand_as(ray_dir)) * 10.0 + tv),
        sin_y20=torch.sin(ray_dir[..., 1] * 20.0 + tv),
        dir_jit=0.1 * torch.sin(ray_dir[..., 1] * 15.0 + tv
                                + pixel_noise * 6.28),
        idle_scale=1.5 * (1.0 + 0.1 * torch.sin(
            ray_dir[..., 1] * 10.0 + frag_xy[..., 0] * 0.01)),
        idx=torch.arange(n, device=dev))
    if use_mip_skip:
        R["tj"] = torch.sin(tv * 3.0 + frag_hash(0.0) * 6.28) * 0.5 + 0.5
        R["lod"] = torch.clamp(dist_factor * 2.0, 0.0, 3.0) + _fract(
            float(np.float32(tv) * np.float32(0.1)) + pixel_noise * 0.5) * 0.5

    zeros = lambda dt=f32: torch.zeros(n, dtype=dt, device=dev)
    S = dict(T=t0, alpha=zeros(), color=torch.zeros((n, 3), dtype=f32,
                                                   device=dev),
             was_inside=zeros(torch.bool), was_empty=zeros(torch.bool),
             prev_density=zeros(), empty_ctr=zeros(), detail_ctr=zeros(),
             boundary_ctr=zeros(), cur_step=base_step,
             steps=zeros(torch.int32), edge_depth=zeros(),
             edge_normal=torch.zeros((n, 3), dtype=f32, device=dev),
             done=t_near > t_far)
    out = {k: S[k].clone() for k in _OUT}

    def keep(rows):
        """Write the dropped rays' state out; keep ``rows``."""
        gone = ~rows
        for k in _OUT:
            out[k][R["idx"][gone]] = S[k][gone]
        for d in (R, S):
            for k in d:
                d[k] = d[k][rows]

    c = SimpleNamespace(
        tex=tex, cam=cam, box_ext=box_ext, packed=_Packed(tex),
        mip_skip=use_mip_skip, octree_skip=enable_octree_skip,
        frustum=use_frustum_culling, max_mip=len(tex.vol_mips) - 1,
        hq_offsets=_const([[0, 0, 0], [0.001, 0.001, 0.001],
                           [-0.001, 0.001, -0.001], [0.001, -0.001, 0.001]],
                          dev),
        lq_offsets=_const([[0.001, 0.001, 0.001], [-0.001, 0.001, -0.001]],
                          dev))
    i = 0
    while i < max_steps:
        rows = S["done"].numel()
        n_done = int(S["done"].sum())
        if n_done == rows:
            break
        if 2 * n_done >= rows:
            keep(~S["done"])
        S = _march_iteration(i, c, R, S)
        i += 1
    keep(torch.zeros_like(S["done"]))

    # post-processing (:943-986)
    alpha, color = out["alpha"], out["color"]
    nonzero = (alpha >= 0.1)[..., None]
    final = torch.where(nonzero, color.abs() ** float(np.float32(1.0 / 2.2)),
                        0.0)
    dither = (frag_hash(np.float32(tv) * np.float32(591.3)) - 0.5) * 0.01
    final = torch.where(nonzero, final + dither[..., None], final)
    final = torch.where(nonzero, final / (final + 0.15), final)
    fog = (1.0 - torch.exp(-view_dist * 0.0001)) * 0.15
    final = torch.where(nonzero, final + fog[..., None] * (
        _consts(dev).fog - final), final)
    if use_mip_skip:
        tn = _cdiv(noise_offset, 0.001) * 0.5 + 0.5   # blueNoise in [0, 1]
        final = torch.where(
            nonzero, final + 0.4 * (final * (0.97 + tn[..., :1] * 0.06)
                                    - final), final)
    rgba = torch.cat([final, torch.ones((n, 1), dtype=f32, device=dev)], -1)
    hw = (height, width)
    res = {name: out[k].reshape(hw + tuple(out[k].shape[1:]))
           for k, name in _OUT.items()}
    res["color"] = rgba.reshape(hw + (4,))
    return dict(res, iters=i, t_near=t_near.reshape(hw),
                t_far=t_far.reshape(hw))


def raymarch_volume_banded(tex: VolumeTextures, cam_pos, inv_view, inv_proj,
                           width: int, height: int, band_rows: int = 32,
                           device: DeviceLike = None, **kwargs) -> dict:
    """:func:`raymarch_volume` over row bands of ``band_rows`` rows, one
    whole march a band: equal to the whole frame, since every per-pixel
    term derives from the absolute pixel coordinate. ``iters`` is the
    largest band's. Keeps a march's working set to a band's rays."""
    dev = _check_textures(tex, device)
    if height % band_rows:
        raise ValueError(f"height {height} is not a multiple of band_rows "
                         f"{band_rows}")
    outs = [raymarch_volume(tex, cam_pos, inv_view, inv_proj, width,
                            band_rows, row0=r0, full_height=height,
                            device=dev, **kwargs)
            for r0 in range(0, height, band_rows)]
    return {k: max(o[k] for o in outs) if k == "iters"
            else torch.cat([o[k] for o in outs], dim=0) for k in outs[0]}
