"""Filled-triangle z-buffer rasterizer with the reference's Phong shading.

Counterpart of ``ray_tracing_octrees_tpu/render/raster.py``: the headless
replacement of the reference's GL mesh pipeline (453-skeleton/shaders/
test.vert + test.frag, drawn at main.cpp:1252-1259): MVP transform,
barycentric coverage, depth test and test.frag's lighting (ambient 0.3,
Lambert diffuse, specular 0.5 * max(r.v, 0)^32, a white point light at
(100, 100, 100), all times the triangle's colour). The specular view
vector is ``normalize(-FragPos)``, test.frag's viewer at the world origin.

Every triangle rasterizes a ``samples x samples`` pixel grid clamped to
its screen bounding box, in chunks of ``chunk`` triangles. Per-triangle
data are flat per-component tensors with the triangle axis first.

Depth resolution, in two passes over the chunks:

1. ``scatter_reduce_`` "amin" of each covered sample's depth per pixel
   (the uncovered ones to spare slots past the pixels); each chunk's
   samples (slot and depth) are kept for pass 2;
2. ``scatter_reduce_`` "amax" of the triangle index over the samples
   whose depth equals their pixel's minimum: the winner of a tie is the
   highest triangle index, as the reference's ordered scatter-set leaves
   it (a triangle covers a pixel at most once).

The winner's colour is then shaded once per pixel, at the pixel's
barycentrics in the winning triangle (the same elementwise arithmetic as
the passes, so the same bits). Min and max are order-free, so the image
does not depend on ``chunk`` and is the same on the card and the CPU.
Nothing here waits for the device.

The sums of products that decide coverage and depth are rounded as the
reference's compiled form rounds them on the CPU: the projection's
4-term rows as two unfused pairs, the 2-D edge functions and the
barycentric depth as multiply-adds (``_fma``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import upload
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _cdiv, _sqrt

f32 = torch.float32

_LIGHT_POS = (100.0, 100.0, 100.0)   # test.frag:8
_AMBIENT = 0.3                       # test.frag:12
_SPECULAR = 0.5                      # test.frag:22
_SHININESS = 32                      # test.frag:25, as five squarings
_FAR = 2.0                           # the empty z-buffer's depth
# slots past the pixels for the uncovered samples' scatters, spread over
# this many addresses: on the card, atomics on one address serialize
# (a voxel-scale triangle covers a few of its 256 samples)
_SPARE = 1 << 16


def _pow32(x: torch.Tensor) -> torch.Tensor:
    """x^32 rounded once to f32: five squarings in f64 (exact to far
    below an f32 ulp, the same bits on every device). The reference's
    ``power`` is within an ulp of it."""
    x = x.double()
    for _ in range(_SHININESS.bit_length() - 1):
        x = x * x
    return x.float()


def _dot3(a0, a1, a2, b0, b1, b2):
    """a0 b0 + a1 b1 + a2 b2 as the reference's compiled form rounds a
    written 3-term sum: a0 b0 fused onto a1 b1, then a2 b2 fused on."""
    return _fma(a2, b2, _fma(a0, b0, a1 * b1))


def _rsum3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last dim of size 3 as the reference's compiled
    reduction rounds it: a0 b0, then two multiply-adds."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return _fma(a2, b2, _fma(a1, b1, a0 * b0))


def phong_shade(pos: torch.Tensor, nrm: torch.Tensor,
                base_color: torch.Tensor) -> torch.Tensor:
    """test.frag:7-29 over [..., 3] tensors (one device, f32)."""
    light = _on_device(_LIGHT_POS, pos.device)
    unit = lambda v: v / torch.clamp(_sqrt(_rsum3(v, v))[..., None],
                                     min=1e-30)
    n = unit(nrm)
    ldir = unit(light - pos)
    ndl = _rsum3(n, ldir)
    diff = torch.clamp(ndl, min=0.0)
    view = unit(-pos)
    refl = _fma(2.0 * ndl[..., None], n, -ldir)
    spec = _SPECULAR * _pow32(torch.clamp(_rsum3(view, refl), min=0.0))
    inten = _AMBIENT + diff + spec
    return inten[..., None] * base_color


def _project(xs: Sequence[torch.Tensor], vp: torch.Tensor):
    """Clip coordinates (4 tensors) of points with world components
    ``xs``: each row of ``[x, y, z, 1] @ vp.T`` summed in two pairs,
    unfused, as the reference's compiled 4-term dot on the CPU."""
    x, y, z = xs
    return [(x * vp[r, 0] + y * vp[r, 1]) + (z * vp[r, 2] + vp[r, 3])
            for r in range(4)]


def _screen(tris: torch.Tensor, vp: torch.Tensor, width: int, height: int):
    """Per vertex (sx, sy, sz) lists of [T] tensors and the per-triangle
    in-front flag (every w > 1e-6, every |z_ndc| <= 1)."""
    sx, sy, sz = [], [], []
    ok = torch.ones(tris.shape[0], dtype=torch.bool, device=tris.device)
    for v in range(3):
        cx, cy, cz, w = _project(tris[:, v].unbind(-1), vp)
        ok = ok & (w > 1e-6)
        wc = torch.clamp(w, min=1e-6)
        nx, ny, nz = cx / wc, cy / wc, cz / wc
        sx.append((nx * 0.5 + 0.5) * (width - 1))
        sy.append((0.5 - ny * 0.5) * (height - 1))
        sz.append(nz)
    for z in sz:
        ok = ok & (z.abs() <= 1.0)
    return sx, sy, sz, ok


def _on_device(x, dev) -> torch.Tensor:
    """An f32 host array or tensor on ``dev``; a host array is queued from
    pinned memory, so the host does not wait for the device."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=f32)
    return upload(np.asarray(x, np.float32), dev)


def _edge(ax, ay, bx, by, px, py):
    """(ax - px) (by - py) - (ay - py) (bx - px), the second product
    rounded and subtracted in one multiply-add."""
    return _fma(ax - px, by - py, -((ay - py) * (bx - px)))


class _Raster:
    """The screen-space triangles of one call and their per-sample
    geometry, chunk by chunk."""

    def __init__(self, tris, vp, width, height, valid, samples):
        self.width, self.height = width, height
        self.count, self.device = tris.shape[0], tris.device
        self.sx, self.sy, self.sz, ok = _screen(tris, vp, width, height)
        self.ok = ok if valid is None else ok & valid.to(torch.bool)
        self.gx = torch.arange(samples, dtype=torch.int32,
                               device=tris.device)

    def coverage(self, lo: int, hi: int):
        """(cover bool[C, S, S], depth f32[C, S, S], pix int64[C, S, S])
        of triangles [lo, hi)."""
        W, H = self.width, self.height
        (ax, bx, cx), (ay, by, cy), (az, bz, cz) = (
            [v[lo:hi, None, None] for v in comp]
            for comp in (self.sx, self.sy, self.sz))
        x0 = torch.floor(torch.minimum(torch.minimum(ax, bx), cx)).clamp(
            0, W - 1).to(torch.int32)
        y0 = torch.floor(torch.minimum(torch.minimum(ay, by), cy)).clamp(
            0, H - 1).to(torch.int32)
        x1 = torch.ceil(torch.maximum(torch.maximum(ax, bx), cx)).clamp(
            0, W - 1).to(torch.int32)
        y1 = torch.ceil(torch.maximum(torch.maximum(ay, by), cy)).clamp(
            0, H - 1).to(torch.int32)
        px = x0 + self.gx[None, None, :]
        py = y0 + self.gx[None, :, None]
        pxf, pyf = px.to(f32), py.to(f32)
        cover = (px <= x1) & (py <= y1) & self.ok[lo:hi, None, None]
        b0, b1, b2, inside = self.barycentrics(lo, hi, pxf, pyf)
        cover = cover & inside
        depth = _dot3(b0, b1, b2, az, bz, cz)
        return cover, depth, (py * W + px).to(torch.int64)

    def barycentrics(self, sel, sel_hi, pxf, pyf):
        """(b0, b1, b2, inside) at pixel centres ``pxf``, ``pyf`` of the
        triangles ``[sel, sel_hi)`` (a slice) or ``sel`` (an index tensor,
        ``sel_hi`` None), broadcast against the pixels."""
        if sel_hi is None:
            pick = lambda v: v[sel]
        else:
            pick = lambda v: v[sel:sel_hi, None, None]
        ax, bx, cx = (pick(v) for v in self.sx)
        ay, by, cy = (pick(v) for v in self.sy)
        area = _edge(bx, by, cx, cy, ax, ay)
        e0 = _edge(bx, by, cx, cy, pxf, pyf)
        e1 = _edge(cx, cy, ax, ay, pxf, pyf)
        e2 = _edge(ax, ay, bx, by, pxf, pyf)
        s = torch.sign(area)
        nonflat = area.abs() > 1e-12
        inside = (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0) & nonflat
        one = torch.ones((), dtype=f32, device=area.device)
        inv_area = one / torch.where(nonflat, area, one)
        return e0 * inv_area, e1 * inv_area, e2 * inv_area, inside


def rasterize_triangles(
    tris: torch.Tensor,        # f32[T, 3, 3] world-space triangles
    normals: torch.Tensor,     # f32[T, 3] per-triangle normals (world)
    colors: torch.Tensor,      # f32[T, 3] per-triangle base colours
    view_proj,                 # f32[4, 4] P @ V (host array or tensor)
    width: int,
    height: int,
    valid: Optional[torch.Tensor] = None,   # bool[T]
    cam_pos=None,              # f32[3]; normals flip to face the camera
    samples: int = 16,
    chunk: int = 65536,
):
    """Filled, z-buffered, Phong-shaded triangles on ``tris``' device:
    (rgba f32[height, width, 4], zbuf f32[height, width], 2.0 where
    empty). Shading uses the triangle's flat normal at the interpolated
    world position. The output does not depend on ``chunk``: on an H100
    the depth pass over the 256^3 sphere's 493 816 MC triangles at
    1920x1080 took 26.5 ms in chunks of 65536 against 36.4-45.3 ms in the
    reference's 16384, at a peak of 3.59 against 3.22 GiB
    (``chip_smoke.py`` phase 31)."""
    tris = tris.to(f32)
    r = _Raster(tris, _on_device(view_proj, tris.device), width, height,
                valid, samples)
    zbuf, kept = depth_pass(r, chunk)
    win = winner_pass(zbuf, kept)
    del kept   # the samples' memory, before the shading's
    rgb = shade_winners(r, tris, normals, colors, win, zbuf, cam_pos)
    return (rgb.reshape(height, width, 4),
            zbuf[:width * height].reshape(height, width))


def depth_pass(r: "_Raster", chunk: int):
    """Pass 1: the nearest covered depth per pixel, f32[H * W + _SPARE]
    (the slots past the pixels take the uncovered samples), and each
    chunk's samples (first triangle, slot int64[C, S, S], depth) for
    pass 2."""
    npx = r.width * r.height
    zbuf = torch.full((npx + _SPARE,), _FAR, dtype=f32, device=r.device)
    kept, spare = [], None
    for lo in range(0, r.count, chunk):
        cover, depth, pix = r.coverage(lo, min(lo + chunk, r.count))
        if spare is None:   # the first chunk is the largest
            spare = npx + (torch.arange(cover.numel(), device=r.device)
                           & (_SPARE - 1))
        slot = torch.where(cover, pix, spare[:cover.numel()].view_as(pix))
        depth = torch.where(cover, depth, _FAR)
        zbuf.scatter_reduce_(0, slot.reshape(-1), depth.reshape(-1), "amin")
        kept.append((lo, slot, depth))
    return zbuf, kept


def winner_pass(zbuf: torch.Tensor, kept) -> torch.Tensor:
    """Pass 2, over the samples pass 1 kept: per pixel the highest
    triangle index among the samples at the pixel's depth, int64[H * W]
    (-1 where none). A sample that loses scatters -1 to its own slot,
    which changes nothing there."""
    npx = zbuf.shape[0] - _SPARE
    win = torch.full(zbuf.shape, -1, dtype=torch.int64, device=zbuf.device)
    for lo, slot, depth in kept:
        at = (slot < npx) & (depth <= zbuf[slot])
        tri = torch.arange(lo, lo + slot.shape[0], device=zbuf.device)
        win.scatter_reduce_(0, slot.reshape(-1),
                            torch.where(at, tri[:, None, None], -1).reshape(
                                -1), "amax")
    return win[:npx]


def shade_winners(r: "_Raster", tris, normals, colors, win, zbuf, cam_pos):
    """The winners' colours, shaded once per pixel at the pixel's
    barycentrics in the winning triangle: f32[H * W, 4]."""
    npx = r.width * r.height
    if cam_pos is not None:
        normals = _face_camera(tris, normals.to(f32), cam_pos)
    tri = win.clamp(min=0)
    pix = torch.arange(npx, device=r.device)
    b0, b1, b2, _ = r.barycentrics(tri, None, (pix % r.width).to(f32),
                                   (pix // r.width).to(f32))
    wx, wy, wz = (_dot3(b0, b1, b2, tris[tri, 0, c], tris[tri, 1, c],
                        tris[tri, 2, c]) for c in range(3))
    rgb = _shade_flat(wx, wy, wz, normals[tri].to(f32), colors[tri].to(f32))
    # the background is black
    rgb = torch.where((zbuf[:npx] < _FAR)[:, None], rgb.clamp(0.0, 1.0), 0.0)
    return torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=-1)


def _face_camera(tris, normals, cam_pos):
    """Normals flipped to face ``cam_pos`` from the triangle centroid
    (two-sided shading of MC/DC meshes). The centroid is the vertex sum
    times the f32 reciprocal of 3; the facing test a 3-term dot."""
    cam = _on_device(cam_pos, tris.device)
    center = _cdiv(tris[:, 0] + tris[:, 1] + tris[:, 2], 3.0)
    facing = _rsum3(normals, cam[None, :] - center) >= 0
    return torch.where(facing[:, None], normals, -normals)


def _shade_flat(wx, wy, wz, nrm, col):
    """test.frag:7-29 on separated components: f32[N, 3]."""
    nx, ny, nz = nrm.unbind(-1)
    nl = _sqrt(torch.clamp(_dot3(nx, ny, nz, nx, ny, nz), min=1e-30))
    nx, ny, nz = nx / nl, ny / nl, nz / nl
    lx, ly, lz = _LIGHT_POS
    ldx, ldy, ldz = lx - wx, ly - wy, lz - wz
    ll = _sqrt(torch.clamp(_dot3(ldx, ldy, ldz, ldx, ldy, ldz), min=1e-30))
    ldx, ldy, ldz = ldx / ll, ldy / ll, ldz / ll
    ndl = _dot3(nx, ny, nz, ldx, ldy, ldz)
    diff = torch.clamp(ndl, min=0.0)
    vl = _sqrt(torch.clamp(_dot3(wx, wy, wz, wx, wy, wz), min=1e-30))
    vx, vy, vz = -wx / vl, -wy / vl, -wz / vl
    # 2 ndl n - l, the doubled normal exact and l subtracted in one rounding
    rx, ry, rz = (_fma(ndl, 2.0 * n, -l) for n, l in
                  ((nx, ldx), (ny, ldy), (nz, ldz)))
    spec = _pow32(torch.clamp(_dot3(vx, vy, vz, rx, ry, rz), min=0.0))
    inten = (diff + _AMBIENT) + spec * _SPECULAR
    return inten[:, None] * col


def line_samples(samples: int) -> np.ndarray:
    """f32[samples]: the reference's ``linspace(0, 1, samples)``, whose
    compiled form multiplies the index by the f32 reciprocal of
    ``samples - 1`` and ends on exactly 1."""
    if samples < 2:
        return np.zeros(samples, np.float32)
    i = np.arange(samples - 1, dtype=np.float32)
    step = i * (np.float32(1.0) / np.float32(samples - 1))
    return np.concatenate([step, [np.float32(1.0)]]).astype(np.float32)


def rasterize_lines(
    img: torch.Tensor,         # f32[H, W, 4] to draw over
    zbuf: torch.Tensor,        # f32[H, W] depth from rasterize_triangles
    segs: torch.Tensor,        # f32[L, 2, 3] world-space segments
    view_proj,
    width: int,
    height: int,
    color=(1.0, 1.0, 1.0),
    valid: Optional[torch.Tensor] = None,
    samples: int = 64,
    depth_bias: float = 1e-3,
) -> torch.Tensor:
    """Depth-tested line overlay (the reference's wireframe draw, the
    same program with overrideColor, main.cpp:1404-1408): a new
    f32[H, W, 4] image. Every drawn sample writes the same colour, so the
    order of writes does not matter."""
    dev = segs.device
    segs = segs.to(f32)
    vp = _on_device(view_proj, dev)
    ends = []
    ok = torch.ones(segs.shape[0], dtype=torch.bool, device=dev)
    if valid is not None:
        ok = ok & valid.to(torch.bool)
    for v in range(2):
        cx, cy, cz, w = _project(segs[:, v].unbind(-1), vp)
        ok = ok & (w > 1e-6)
        wc = torch.clamp(w, min=1e-6)
        ends.append((cx / wc * 0.5 + 0.5, 0.5 - cy / wc * 0.5, cz / wc))
    t = upload(line_samples(samples), dev)[None, :]
    (hx0, hy0, sz0), (hx1, hy1, sz1) = [
        [c[:, None] for c in e] for e in ends]
    # the reference's compiled form fuses the screen scale of the far end
    # into the span: (h1 s - h0 s) as one multiply-add, then start + span t
    px = _fma(_fma(hx1, width - 1, -(hx0 * (width - 1))), t,
              hx0 * (width - 1))
    py = _fma(_fma(hy1, height - 1, -(hy0 * (height - 1))), t,
              hy0 * (height - 1))
    pz = _fma(sz1 - sz0, t, sz0)
    ix = torch.round(px).to(torch.int64)
    iy = torch.round(py).to(torch.int64)
    npx = width * height
    inb = ((ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
           & (pz.abs() <= 1.0) & ok[:, None])
    pix = torch.where(inb, iy * width + ix, npx).reshape(-1)
    zflat = torch.cat([zbuf.reshape(-1).to(f32),
                       torch.full((1,), _FAR, dtype=f32, device=dev)])
    vis = inb.reshape(-1) & (pz.reshape(-1) <= zflat[pix] + depth_bias)
    drawn = torch.zeros(npx + 1, dtype=torch.bool, device=dev)
    drawn.index_fill_(0, torch.where(vis, pix, npx), True)
    col = _on_device(tuple(color) + (1.0,), dev)
    out = img.reshape(npx, 4).to(f32)
    return torch.where(drawn[:npx, None], col, out).reshape(height, width, 4)
