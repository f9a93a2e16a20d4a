"""Exact-semantics fast frame: the slab sweep with a carried bit cube.

Counterpart of ``ray_tracing_octrees_tpu/trace/fast_exact.py``. The frame
returns the exact tracer's hit and t per pixel (the reference's
intersectOctreeIterative first solid-leaf entry, RayTracerBVH.cpp:
239-327) at sweep cost:

1. DETECTION: the widened tap products of
   :func:`sweep_exact._widened_perspective_hats` give, per (texel, slab),
   the ta x tb neighbourhood-occupancy word and the footprint candidate
   flag. The chunk loop carries per texel o1 = the first candidate slab,
   the occupancy words at slabs o1, o1 + 1, o1 + 2 (the "cube"), a shadow
   bit per cube slab, and the per-slab candidate bit words.
2. WARP: three 24-bit-exact f32 planes go to pixels through
   :func:`warp_kernel.warp_lookup_multi`.
3. PIXEL epilogue: each pixel recomputes its ray and its texel's cells in
   closed form and runs an exact ray/AABB mini-DDA over the cube, slabs
   in sweep order (slab order is t order).
4. FALLBACK: pixels whose cube runs out (candidate run longer than three
   slabs) go through sweep_exact's consume rounds from slab o1 + 3;
   exactness never depends on the cube depth.

Envelope: :func:`sweep_exact.sweep_exact_setup`'s (exterior eye,
footprint within the tap window); outside it the entry points return
None.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.trace import sweep_exact as se
from ray_tracing_octrees_tpu_torch.trace.mesh_grid import (
    candidate_chunk, pack_chunk,
)
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
    CH, SweepLayouts, _SAB_IDX, _bilinear_hats, _exact_matmul, _fdiv,
    _scene_layouts, _sqrt, _view_consts,
)
from ray_tracing_octrees_tpu_torch.trace.warp_kernel import (
    unpack_frame_rgb, warp_lookup_multi,
)

_BIGI = 1 << 20


# --------------------------------------------------------------------------
# detection sweep with carried cube
# --------------------------------------------------------------------------

def _plane_layout(nb: int):
    """Bit layout of the three packed planes for an nb-bit tap word
    (nb = ta*tb <= 15): plane 1 holds c0 and the low r1 bits of c1;
    plane 2 the high bits of c1, then c2, then the shadow bits s1, s2
    (s0 rides plane 0's +2048 flag)."""
    r1 = min(24 - nb, nb)          # bits of c1 stored in plane 1
    hi1 = nb - r1                  # bits of c1 stored in plane 2
    assert hi1 + nb + 2 <= 24
    return r1, hi1


def _cube_sweep(occ_sw, shadow_sw, scal, s_valid: int, a_size: int,
                b_size: int, inter_h: int, inter_w: int, flip: bool,
                ta: int, tb: int):
    """Detection sweep: (planes f32[3, IH, IW], words int32[IH*IW, C]).

    planes[0]: the packed value k1 + 0.5 [+2048 shadowed], -1 with no
    candidate; planes[1], planes[2]: the cube's occupancy words and shadow
    bits (:func:`_plane_layout`); words: the per-slab candidate bits (bit
    o & 31 of word o >> 5), the fallback's input. ``shadow_sw`` (bf16, the
    shadow volume in the sweep layout) or None.
    """
    i32 = torch.int32
    dev = occ_sw.device
    sp = occ_sw.shape[0]
    nb = ta * tb
    r1, hi1 = _plane_layout(nb)
    hats = se._widened_perspective_hats(
        scal, sp, s_valid, a_size, b_size, inter_h, inter_w, flip, ta, tb)
    has_shadow = shadow_sw is not None
    if has_shadow:
        sma, smb = _bilinear_hats(scal, sp, s_valid, a_size, b_size,
                                  inter_h, inter_w, flip)

    shape = (inter_h, inter_w)
    o1 = torch.full(shape, _BIGI, dtype=i32, device=dev)
    cube = [torch.zeros(shape, dtype=i32, device=dev) for _ in range(3)]
    shb = [torch.zeros(shape, dtype=i32, device=dev) for _ in range(3)]
    words = torch.empty((sp // CH, inter_h * inter_w), dtype=i32, device=dev)

    for ci in range(sp // CH):
        lo, hi = ci * CH, (ci + 1) * CH
        # bit-exact weighted tap words (the split-chain form on wide taps)
        det_i, cand = candidate_chunk(occ_sw, hats, lo, hi,
                                      wide=(ta > 3 or tb > 3))
        words[ci] = pack_chunk(cand)

        any_c = cand.any(dim=0)
        f_rel = torch.argmax(cand.to(torch.uint8), dim=0).to(i32)
        o1 = torch.where(o1 < _BIGI, o1,
                         torch.where(any_c, lo + f_rel, _BIGI))

        if has_shadow:
            # bf16 values, f32 products and sums, no rounding between the
            # two contractions: the reference asks for a bf16 intermediate,
            # but XLA keeps it at f32 inside the jit (excess precision)
            with _exact_matmul():
                shh = torch.einsum("cab,cha->cbh", shadow_sw[lo:hi].float(),
                                   sma[lo:hi].float())
                shs = torch.einsum("cbh,cwb->chw", shh, smb[lo:hi].float())
            sh_bit = (shs > 0.5).to(i32)

        for j in range(3):
            rel = o1 + j - lo
            inside = (rel >= 0) & (rel < CH)
            at = rel.clamp(0, CH - 1).long()[None]
            have = (o1 + j) < lo
            sel = torch.where(inside, torch.gather(det_i, 0, at)[0], 0)
            cube[j] = torch.where(have, cube[j], sel)
            if has_shadow:
                sel_s = torch.where(inside, torch.gather(sh_bit, 0, at)[0], 0)
                shb[j] = torch.where(have, shb[j], sel_s)

    c0, c1, c2 = cube
    s0, s1, s2 = shb
    found = o1 < _BIGI
    o1c = o1.clamp(max=s_valid - 1)
    k1 = (s_valid - 1 - o1c) if flip else o1c
    p0 = torch.where(found, k1.float() + 0.5 + torch.where(s0 != 0, 2048.0,
                                                             0.0), -1.0)
    p1 = (c0 | ((c1 & ((1 << r1) - 1)) << nb)).float()
    p2 = ((c1 >> r1) | (c2 << hi1) | (s1 << (hi1 + nb))
          | (s2 << (hi1 + nb + 1))).float()
    return torch.stack([p0, p1, p2]), words.t().contiguous()


# --------------------------------------------------------------------------
# per-pixel epilogue: closed-form cube DDA
# --------------------------------------------------------------------------

def _pixel_cube_resolve(pv0, pv1, pv2, rd3, scal, flip: bool, S: int,
                        IH: int, IW: int, ti, tj, geo_ok, ta: int, tb: int):
    """Each pixel's exact first hit from its warped cube planes.

    ``rd3`` (s, a, b) ray components per pixel, ``ti`` / ``tj`` /
    ``geo_ok`` from :func:`sweep_exact._texel_map`. Returns dict(hit, t,
    ks, ca, cb, sh, suspicious, o1) of [N] tensors; ``suspicious`` rows (cube run out
    with candidates possibly left) carry o1 for the fallback's start.
    """
    f32 = torch.float32
    i32 = torch.int32
    N = pv0.shape[0]
    dev = pv0.device
    nb = ta * tb
    ra, rb = (ta - 1) // 2, (tb - 1) // 2
    r1, hi1 = _plane_layout(nb)
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]

    found = geo_ok & (pv0 >= 0.0)
    sh0 = found & (pv0 >= 2048.0)
    k1 = torch.clamp(pv0 - torch.where(sh0, 2048.0, 0.0) - 0.5, min=0.0)
    o1 = (float(S) - 1.0 - k1) if flip else k1          # sweep-order slab
    w1 = pv1.to(i32)
    w2 = pv2.to(i32)
    cube = [w1 & ((1 << nb) - 1),
            ((w1 >> nb) & ((1 << r1) - 1)) | ((w2 & ((1 << hi1) - 1)) << r1),
            (w2 >> hi1) & ((1 << nb) - 1)]
    shbits = [sh0.to(i32), (w2 >> (hi1 + nb)) & 1, (w2 >> (hi1 + nb + 1)) & 1]

    # texel-centre window coordinates (the hat lattice exactly)
    ua0 = a_min + _fdiv((a_max - a_min) * (ti.to(f32) + 0.5), IH)
    ub0 = b_min + _fdiv((b_max - b_min) * (tj.to(f32) + 0.5), IW)

    got = torch.zeros(N, dtype=torch.bool, device=dev)
    t_hit = torch.zeros(N, dtype=f32, device=dev)
    ks_h = torch.zeros(N, dtype=i32, device=dev)
    ca_h = torch.zeros(N, dtype=i32, device=dev)
    cb_h = torch.zeros(N, dtype=i32, device=dev)
    sh_h = torch.zeros(N, dtype=torch.bool, device=dev)

    # per-axis reciprocals hoisted: each cell interval is then one
    # multiply-add; the origin is the eye for every pixel
    def axis_prep(ro, rd):
        deg = rd.abs() < se._DEG
        inv = 1.0 / torch.where(deg, 1.0, rd)
        return ro, inv, deg, inv < 0

    def axis_iv(prep, lo):
        """(tin, tout) of [lo, lo + 1); degenerate axes by position."""
        ro, inv, deg, neg = prep
        t0 = (lo - ro) * inv
        tin = torch.where(neg, t0 + inv, t0)
        tout = torch.where(neg, t0, t0 + inv)
        inside = (ro >= lo) & (ro < lo + 1.0)
        tin = torch.where(deg, torch.where(inside, -se._BIG, se._BIG), tin)
        tout = torch.where(deg, torch.where(inside, se._BIG, -se._BIG), tout)
        return tin, tout

    prep_s = axis_prep(eye_s, rd3[0])
    prep_a = axis_prep(eye_a, rd3[1])
    prep_b = axis_prep(eye_b, rd3[2])

    for j in range(3):
        oj = o1 + float(j)
        k = (float(S) - 1.0 - oj) if flip else oj
        # texel floor cells: the hats' pa_all formula verbatim
        inv_s = (k + 0.5 - eye_s) / (z0 - eye_s)
        ca0 = torch.floor(eye_a + (ua0 - eye_a) * inv_s)
        cb0 = torch.floor(eye_b + (ub0 - eye_b) * inv_s)
        ts0, ts1 = axis_iv(prep_s, k)
        tia = [axis_iv(prep_a, ca0 + (ia - ra)) for ia in range(ta)]
        tib = [axis_iv(prep_b, cb0 + (ib - rb)) for ib in range(tb)]
        best = torch.full((N,), se._BIG, dtype=f32, device=dev)
        bca = torch.zeros(N, dtype=f32, device=dev)
        bcb = torch.zeros(N, dtype=f32, device=dev)
        for ia in range(ta):
            for ib in range(tb):
                bit = (cube[j] >> (ia * tb + ib)) & 1
                tin = torch.maximum(ts0, torch.maximum(tia[ia][0], tib[ib][0]))
                tout = torch.minimum(ts1, torch.minimum(tia[ia][1], tib[ib][1]))
                ok = (bit != 0) & (tin <= tout) & (tout > 0.0)
                t_c = torch.where(ok, torch.clamp(tin, min=0.0), se._BIG)
                better = t_c < best
                best = torch.where(better, t_c, best)
                bca = torch.where(better, ca0 + (ia - ra), bca)
                bcb = torch.where(better, cb0 + (ib - rb), bcb)
        newly = ~got & found & (oj < float(S)) & (best < se._BIG)
        got = got | newly
        t_hit = torch.where(newly, best, t_hit)
        ks_h = torch.where(newly, k.to(i32), ks_h)
        ca_h = torch.where(newly, bca.to(i32), ca_h)
        cb_h = torch.where(newly, bcb.to(i32), cb_h)
        sh_h = torch.where(newly, shbits[j] != 0, sh_h)

    return dict(hit=got, t=t_hit, ks=ks_h, ca=ca_h, cb=cb_h, sh=sh_h,
                suspicious=found & ~got,
                o1=torch.where(found, o1.to(i32), 0))


# --------------------------------------------------------------------------
# fallback: sweep_exact's consume rounds on the suspicious pixels
# --------------------------------------------------------------------------

def _run_fallback(res, words, nb9, scal, consts, axis_world: int,
                  flip: bool, S: int, A: int, B: int, IH: int, IW: int,
                  width: int, height: int, ta: int, tb: int):
    """Exact consume for the suspicious pixels, from slab o1 + 3.

    Returns (pix int64[M]: the suspicious pixels, state over them, rd3 of
    their rays, rounds). Every suspicious pixel is consumed (no fixed
    stage width), so none is dropped; the round cap, 8 + the padded slab
    count, exceeds the number of candidate slabs a row can have.
    """
    pix = torch.nonzero(res["suspicious"]).squeeze(1)
    xf = (pix % width).to(torch.float32)
    yf = (pix // width).to(torch.float32)
    rd3 = tuple(c / scal[10] for c in se._rays_sab_from_xy(
        xf, yf, scal, consts, axis_world, width, height))
    _, ti, tj = se._texel_map(rd3, scal, flip, IH, IW)
    m = pix.shape[0]
    ro3 = tuple(scal[c].expand(m) for c in range(3))
    st, rounds = se._consume_ladder(
        words[(ti * IW + tj).long()], res["o1"][pix] + 3, ro3, rd3, nb9, S,
        A, B, flip, 8 + words.shape[1] * 32, ta, tb)
    return pix, st, rd3, rounds


# --------------------------------------------------------------------------
# frame assembly
# --------------------------------------------------------------------------

def _shade_components(hit, t, ks, ca, cb, sh, rd3, scal, axis_world: int,
                      has_shadow: bool):
    """Lambert + shadow shading from sweep-space hit cells: packed
    0xRRGGBB int32 per row (the fused kernel's output convention)."""
    f32 = torch.float32
    vs = scal[10]
    light = scal[34:37]
    l = light / _sqrt(light[0] * light[0] + light[1] * light[1]
                      + light[2] * light[2])
    inv_perm = [_SAB_IDX[axis_world].index(c) for c in range(3)]
    sab_cell = (ks.to(f32), ca.to(f32), cb.to(f32))
    ndl = torch.zeros_like(t)
    n2 = torch.zeros_like(t)
    for c in range(3):
        d_c = rd3[inv_perm[c]] * vs               # unit world direction
        p_c = scal[15 + c] + d_c * t
        n_c = p_c - (scal[12 + c] + (sab_cell[inv_perm[c]] + 0.5) * vs)
        n2 = n2 + n_c * n_c
        ndl = ndl + n_c * l[c]
    ndotl = torch.clamp(-ndl / torch.clamp(_sqrt(n2), min=1e-12),
                        min=0.0)
    packed = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for c in range(3):
        col = scal[37 + c] * ndotl + scal[40 + c]
        if has_shadow:
            col = torch.where(sh, scal[40 + c], col)
        col = torch.where(hit, col, 0.0)
        q = torch.clamp(col * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)
        packed = (packed << 8) | q
    return packed


def _warp_planes(planes, lin2):
    """The three packed planes at each pixel: one
    :func:`warp_kernel.warp_lookup_multi` call. Returns (pv0, pv1, pv2)
    flat [N]; pixels with ``lin2 < 0`` read -1, 0, 0."""
    pv = warp_lookup_multi(planes, lin2).reshape(3, -1)
    return pv[0], pv[1], pv[2]


def _fast_exact_frame(cfg, scal_np, shadow_sw, width: int, height: int,
                      want_image: bool, mark=None):
    """The frame for one pose inside the envelope: (rgba f32[H, W, 4] or
    dict(hit, t, rd3), stats). ``mark(stage)``, when given, is called
    after each of the stages "cube_sweep", "resolve" and "fallback"."""
    dev = cfg["occ_sw"].device
    axis_world, flip = cfg["axis_world"], cfg["flip"]
    S, A, B, IH, IW = cfg["S"], cfg["A"], cfg["B"], cfg["IH"], cfg["IW"]
    ta, tb = cfg["ta"], cfg["tb"]
    mark = mark or (lambda stage: None)
    scal = torch.as_tensor(scal_np, device=dev)
    consts = torch.as_tensor(_view_consts(scal_np), device=dev)
    N = width * height

    planes, words = _cube_sweep(cfg["occ_sw"], shadow_sw, scal, S, A, B,
                                IH, IW, flip, ta, tb)
    mark("cube_sweep")

    rd3 = tuple(c / scal[10] for c in se._pixel_rays_sab(
        scal, consts, axis_world, width, height))
    geo_ok, ti, tj = se._texel_map(rd3, scal, flip, IH, IW)
    lin = torch.where(geo_ok, (ti << 10) | tj, -1)
    pv0, pv1, pv2 = _warp_planes(planes, lin.reshape(height, width))
    res = _pixel_cube_resolve(pv0, pv1, pv2, rd3, scal, flip, S, IH, IW,
                              ti, tj, geo_ok, ta, tb)
    mark("resolve")

    pix, st1, fb_rd3, rounds = _run_fallback(
        res, words, cfg["nb9"], scal, consts, axis_world, flip, S, A, B,
        IH, IW, width, height, ta, tb)
    mark("fallback")
    stats = dict(rounds=rounds, overflow=0,
                 suspicious=int(pix.shape[0]),
                 unresolved=int((~st1["resolved"] & ~st1["hit"]).sum()))

    if want_image:
        has_shadow = shadow_sw is not None
        packed = _shade_components(
            res["hit"], res["t"], res["ks"], res["ca"], res["cb"], res["sh"],
            rd3, scal, axis_world, has_shadow)
        # the fallback's shadow: the sweep-order shadow volume at the
        # resolved cell (nearest cell; the cube path thresholds the
        # bilinear sample at its texel), as the reference does
        if has_shadow:
            sp = shadow_sw.shape[0]
            o_s = torch.where(st1["hit"], (S - 1 - st1["ks"]) if flip
                              else st1["ks"], 0)
            fi = ((o_s.clamp(0, sp - 1) * A + st1["ca"].clamp(0, A - 1)) * B
                  + st1["cb"].clamp(0, B - 1))
            sh1 = torch.take(shadow_sw, fi.long()).float() > 0.5
        else:
            sh1 = torch.zeros_like(st1["hit"])
        packed[pix] = _shade_components(
            st1["hit"], torch.where(st1["hit"], st1["t"], 0.0), st1["ks"],
            st1["ca"], st1["cb"], sh1, fb_rd3, scal, axis_world, has_shadow)
        return unpack_frame_rgb(packed.reshape(height, width), width,
                                height), stats

    hit = res["hit"].clone()
    t = res["t"].clone()
    hit[pix] = st1["hit"]
    t[pix] = torch.where(st1["hit"], st1["t"], 0.0)
    return dict(hit=hit, t=t, rd3=rd3), stats


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def fast_exact_setup(volume, grid_origin, voxel_size, camera_pos, view,
                     max_inter: int = 1024, density: float = 3.5,
                     layouts: Optional[SweepLayouts] = None,
                     device: DeviceLike = None):
    """Host gate + configuration: :func:`sweep_exact.sweep_exact_setup`'s
    envelope at 3.5 texels per voxel (exactness does not depend on the
    lattice; the cube absorbs the wider footprints)."""
    return se.sweep_exact_setup(volume, grid_origin, voxel_size, camera_pos,
                                view, max_inter, density, layouts=layouts,
                                device=device)


def render_fast_exact_frame(volume, shadow_vol, grid_origin, voxel_size,
                            camera_pos, view, fov_deg: float, aspect: float,
                            width: int, height: int,
                            light_dir=(-1.0, -1.0, -1.0),
                            base_color=(1.0, 0.8, 0.6),
                            ambient=(0.1, 0.1, 0.1),
                            with_stats: bool = False,
                            layouts: Optional[SweepLayouts] = None,
                            device: DeviceLike = None, mark=None):
    """Exact-semantics frame, f32[H, W, 4] rgba, or None outside the
    envelope; with ``with_stats`` (rgba, stats).

    Shading as :func:`slab_sweep.render_fast_frame`'s, with hit and t of
    the exact tracer. ``stats``: rounds (consume rounds run), suspicious
    (pixels sent to the fallback), unresolved and overflow (both 0: every
    suspicious pixel is consumed to its end). ``layouts``: the scene's
    :class:`slab_sweep.SweepLayouts` (built from this ``volume`` and
    ``shadow_vol``), kept across frames. ``mark`` as for
    :func:`_fast_exact_frame`.
    """
    dev = resolve_device(device)
    layouts = _scene_layouts(volume, shadow_vol, layouts, dev)
    ok, cfg = fast_exact_setup(layouts.volume, grid_origin, voxel_size,
                               camera_pos, view, layouts=layouts, device=dev)
    if not ok:
        return None
    scal = cfg["scal_np"].copy()
    scal[8], scal[9] = fov_deg, aspect
    scal[34:37] = light_dir
    scal[37:40] = base_color
    scal[40:43] = ambient
    shadow_sw = None if layouts.shadow is None else layouts.get(
        "shadow", cfg["axis_world"], cfg["flip"], cfg["S"], 0)
    img, stats = _fast_exact_frame(cfg, scal, shadow_sw, width, height, True,
                                   mark)
    return (img, stats) if with_stats else img


def fast_exact_first_hit(volume, grid_origin, voxel_size, camera_pos, view,
                         fov_deg: float, aspect: float, width: int,
                         height: int, with_stats: bool = False,
                         layouts: Optional[SweepLayouts] = None,
                         device: DeviceLike = None):
    """Exact (hit bool[N], t f32[N], point f32[N, 3], dirs f32[N, 3]) via
    the cube path, or None outside the envelope; with ``with_stats``
    (that tuple, stats). Matches the exact tracer's hit and t per pixel
    (:func:`slab_sweep.sweep_first_hit`'s signature)."""
    ok, cfg = fast_exact_setup(volume, grid_origin, voxel_size, camera_pos,
                               view, layouts=layouts, device=device)
    if not ok:
        return None
    scal = cfg["scal_np"].copy()
    scal[8], scal[9] = fov_deg, aspect
    res, stats = _fast_exact_frame(cfg, scal, None, width, height, False)
    vs = float(scal[10])
    inv_perm = [_SAB_IDX[cfg["axis_world"]].index(c) for c in range(3)]
    dirs = torch.stack([res["rd3"][inv_perm[c]] * vs for c in range(3)], 1)
    cam = torch.as_tensor(scal[15:18], device=dirs.device)
    t = res["t"]
    out = (res["hit"], t, cam[None, :] + dirs * t[:, None], dirs)
    return (out, stats) if with_stats else out
