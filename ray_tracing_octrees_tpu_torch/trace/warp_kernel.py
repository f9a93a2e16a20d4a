"""Fused per-pixel frame: ray -> table texel -> lookup -> shade -> packed RGB.

Counterpart of ``ray_tracing_octrees_tpu/trace/warp_kernel.py``'s fused
frame (``_warp_frame_kernel``, ``frame_scalars_kernel``, ``warp_frame``,
``unpack_frame_rgb``). The slab sweep leaves a packed f32 table
``[TH, TW]`` in sheared reference-plane space (``k + 0.5`` at the first
hit slab, ``+2048`` where shadowed, ``-1`` for no hit); per screen pixel
this module intersects the view ray with the reference plane, reads the
texel, rebuilds the hit point and its voxel-centre normal, and shades
Lambert + ambient (ambient only under shadow) into one ``0xRRGGBB`` int32.

On a CUDA tensor :func:`warp_frame` launches the hand-written kernel
``csrc/warp_frame.cu``; on a CPU tensor it runs the plain PyTorch version
:func:`warp_frame_reference`. There is no other path. The kernel packs a
shadowed hit, and a lit one facing away from the light, to
:func:`ambient_word` without shading it, and divides by a power-of-two
voxel size by multiplying with :func:`vox_reciprocal`: each exact against
the plain version by construction.

The module also holds the plain per-pixel lookups of the unfused paths,
counterparts of the reference's ``warp_lookup`` and ``warp_lookup_multi``:
:func:`warp_lookup` and :func:`warp_lookup_multi` launch
``csrc/warp_lookup.cu`` on CUDA tensors and run
:func:`warp_lookup_reference` / :func:`warp_lookup_multi_reference` on CPU
ones. The single-plane kernel comes in two forms, chosen by
:func:`lookup_forms` and counted in :data:`LOOKUP_FORM_LAUNCHES`.
"""

from __future__ import annotations

import array
import ctypes
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch.trace import _build

# kscal layout (f32[35]), the JAX package's _KS_* slots
_KS_AXF, _KS_TANH, _KS_EYE_S, _KS_EYE_A, _KS_EYE_B, _KS_Z0 = range(6)
_KS_AMIN, _KS_SCA, _KS_BMIN, _KS_SCB, _KS_VOX = range(6, 11)
_KS_ORG, _KS_CAM, _KS_L, _KS_BASE, _KS_AMB, _KS_R = 11, 14, 17, 20, 23, 26
_KS_N = 35

# world-axis index of (sweep, A, B) per sweep axis
_SAB_IDX = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}


def lu_inverse(m) -> np.ndarray:
    """f32[4, 4] inverse of a 4x4 matrix on the host, rounded as the
    reference's f32 ``jnp.linalg.inv`` on the CPU rounds it: LAPACK's LU
    with partial pivoting (left-looking: each column's updates are dot
    products summed as multiply-adds; the pivot's reciprocal scales the
    column below it), then the unit-lower and upper triangular solves of
    the permuted identity (multiply-adds, the diagonal's reciprocal).
    Equal to it on the rotation block of every view measured; numpy's
    and torch's LAPACK inverses differ from it by an ulp in about one
    entry in four, which moves a grazing ray into the next leaf.

    Scalar Python floats, each op rounded to f32 once by storing it in
    an f32 array (a multiply-add rounds its exact f64 sum, as
    ``raymarch._fma``; a reciprocal of 0 is inf, as in f32): a few times
    faster than numpy scalars."""
    buf = array.array("f", [0.0])

    def r32(x: float) -> float:
        buf[0] = x
        return buf[0]

    def recip(x: float) -> float:
        return r32(1.0 / x) if x else math.copysign(math.inf, x)

    n = 4
    a = [[float(v) for v in row]
         for row in np.asarray(m, np.float32).reshape(n, n)]
    perm = list(range(n))
    for j in range(n):
        for i in range(1, n):
            s = 0.0
            for k in range(min(i, j)):
                s = r32(a[i][k] * a[k][j] + s)
            a[i][j] = r32(a[i][j] - s)
        p = max(range(j, n), key=lambda i: abs(a[i][j]))
        if p != j:
            a[j], a[p] = a[p], a[j]
            perm[j], perm[p] = perm[p], perm[j]
        r = recip(a[j][j])
        for i in range(j + 1, n):
            a[i][j] = r32(a[i][j] * r)
    out = np.zeros((n, n), np.float32)
    for c in range(n):
        b = [1.0 if perm[i] == c else 0.0 for i in range(n)]
        for k in range(n):                  # L y = P e_c, unit diagonal
            for i in range(k + 1, n):
                b[i] = r32(-b[k] * a[i][k] + b[i])
        for k in range(n - 1, -1, -1):      # U x = y
            b[k] = r32(b[k] * recip(a[k][k]))
            for i in range(k):
                b[i] = r32(-b[k] * a[i][k] + b[i])
        out[:, c] = b
    return out


def view_rotation(fov_deg, view):
    """(tan(fov / 2) f32, the rotation ``inv(view)[:3, :3]`` f32[3, 3]),
    on the host: a device tangent or inverse rounds differently on each
    device. Every path takes its rays' rotation from here, the fused
    frame's scalars included."""
    tan_half = np.tan(np.float32(fov_deg) * np.float32(math.pi / 360.0))
    return np.float32(tan_half), lu_inverse(view)[:3, :3]


def frame_scalars(scal) -> np.ndarray:
    """The fused kernel's f32[35] scalars from the packed per-frame scalars
    (slab_sweep layout), on the host in f32 — the rotation through
    :func:`view_rotation`, as every split path takes it."""
    f32 = np.float32
    scal = np.asarray(scal, f32)
    aspect = scal[9]
    tan_half, R = view_rotation(scal[8], scal[18:34].reshape(4, 4))
    light = scal[34:37]
    l = light / np.linalg.norm(light)
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]
    return np.concatenate([
        np.array([aspect * tan_half, tan_half, scal[0], scal[1], scal[2],
                  scal[3], a_min, f32(1.0) / (a_max - a_min),
                  b_min, f32(1.0) / (b_max - b_min), scal[10]], f32),
        scal[12:15],          # grid origin
        scal[15:18],          # cam pos
        l,
        scal[37:40],          # base color
        scal[40:43],          # ambient
        R.reshape(-1),
    ]).astype(f32)


def ambient_word(kscal) -> int:
    """The packed 0xRRGGBB of a shadowed hit: each ambient channel of
    ``kscal`` through the kernel's f32 ``fminf(fmaxf(c * 255 + 0.5, 0),
    255)`` and truncation. The kernel writes it for every shadowed hit
    when shadows are on."""
    f32 = np.float32
    ks = np.asarray(kscal, f32)
    word = 0
    for c in range(3):
        q = np.fmin(np.fmax(ks[_KS_AMB + c] * f32(255.0) + f32(0.5), f32(0.0)),
                    f32(255.0))
        word = (word << 8) | int(q)
    return word


def vox_reciprocal(vox) -> float:
    """The f32 reciprocal of ``vox`` where it is exact (its product with
    ``vox``, exact in f64, is 1: ``vox`` is a power of two), else 0. Then
    ``x * r`` and ``x / vox`` are the same real number rounded once, equal
    for every f32 ``x``; the kernel multiplies by it."""
    v = np.float32(vox)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        r = np.float32(1.0) / v
    exact = bool(np.isfinite(r)) and float(r) * float(v) == 1.0
    return float(r) if exact else 0.0


def _check(table: torch.Tensor, kscal, axis_world: int, width: int,
           height: int) -> np.ndarray:
    """Validate the arguments; return kscal with SCA/SCB rescaled from
    1/range to texels per unit by the table dims (as the reference
    wrapper does)."""
    if not torch.is_tensor(table) or table.dtype != torch.float32:
        raise TypeError(f"table must be a float32 tensor, got "
                        f"{getattr(table, 'dtype', type(table))}")
    if table.ndim != 2 or min(table.shape) < 1:
        raise ValueError(f"table must be [TH, TW], got {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if axis_world not in _SAB_IDX:
        raise ValueError(f"axis_world must be 0, 1 or 2, got {axis_world}")
    if width < 1 or height < 1:
        raise ValueError(f"bad image size {width}x{height}")
    ks = np.asarray(kscal)
    if ks.dtype != np.float32 or ks.shape != (_KS_N,):
        raise ValueError(f"kscal must be f32[{_KS_N}], got "
                         f"{ks.dtype}{list(ks.shape)}")
    th, tw = table.shape
    ks = ks.copy()
    ks[_KS_SCA] *= np.float32(th)
    ks[_KS_SCB] *= np.float32(tw)
    return ks


def _pixel_steps(width: int, height: int):
    return np.float32(2.0 / width), np.float32(2.0 / height)


def warp_frame(table: torch.Tensor, kscal, axis_world: int, width: int,
               height: int, has_shadow: bool) -> torch.Tensor:
    """Packed-RGB int32[height, width] from the packed f32 table + scalars.

    ``kscal`` from :func:`frame_scalars` (SCA/SCB slots hold 1/range; the
    wrapper rescales them by the table dims). A CUDA ``table`` launches
    the CUDA kernel on the current stream; a CPU one runs
    :func:`warp_frame_reference`.
    """
    ks = _check(table, kscal, axis_world, width, height)
    if table.device.type == "cpu":
        return _reference(table, ks, axis_world, width, height, has_shadow)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    out = _launch(_build.load("warp_frame"), table, ks, axis_world, width,
                  height, has_shadow)
    warp_frame.launches += 1
    return out


warp_frame.launches = 0   # kernel launches, counted where they happen


def _launch(lib, table, ks, axis_world, width, height, has_shadow,
            inv_vox=None):
    """Launch ``lib``'s warp_frame kernel on the current stream; ``ks`` is
    the checked, rescaled scalar vector from :func:`_check`. ``inv_vox``
    0.0 makes the kernel divide by vox even where :func:`vox_reciprocal`
    (the default) finds the reciprocal exact."""
    fn = lib.warp_frame_launch
    if fn.argtypes is None:
        c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [c_ptr, c_int, c_int, c_ptr, c_ptr, c_int, c_int,
                       c_float, c_float, c_int, c_int, ctypes.c_int32,
                       c_float, c_int, c_ptr]
        fn.restype = c_int
    th, tw = table.shape
    sx, sy = _pixel_steps(width, height)
    ks = np.ascontiguousarray(ks, np.float32)
    # the back-facing exit packs the ambient word, which base * +-0 + amb
    # equals only for finite base colours
    back_exit = bool(np.isfinite(ks[_KS_BASE:_KS_BASE + 3]).all())
    with torch.cuda.device(table.device):
        out = torch.empty((height, width), dtype=torch.int32,
                          device=table.device)
        rc = fn(table.data_ptr(), th, tw, ks.ctypes.data, out.data_ptr(),
                width, height, float(sx), float(sy), axis_world,
                int(bool(has_shadow)), ambient_word(ks),
                vox_reciprocal(ks[_KS_VOX]) if inv_vox is None else inv_vox,
                int(back_exit),
                torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"warp_frame launch failed: cudaError {rc}")
    return out


def warp_frame_reference(table: torch.Tensor, kscal, axis_world: int,
                         width: int, height: int,
                         has_shadow: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel, op for op in f32, on the
    table's device (the reference's ``_warp_frame_kernel`` arithmetic)."""
    ks = _check(table, kscal, axis_world, width, height)
    return _reference(table, ks, axis_world, width, height, has_shadow)


def _texels(th, tw, ks, axis_world, width, height, dev):
    """The kernel's ray and texel per pixel: (scalars on ``dev``, ray
    direction components, behind, invalid, iu, iv), iu = iv = 0 where
    invalid."""
    f32 = torch.float32
    k = torch.as_tensor(ks, device=dev)
    sx, sy = (float(v) for v in _pixel_steps(width, height))
    yy = torch.arange(height, dtype=f32, device=dev)[:, None]
    xx = torch.arange(width, dtype=f32, device=dev)[None, :]
    nx = ((xx + 0.5) * sx - 1.0) * k[_KS_AXF]
    ny = (1.0 - (yy + 0.5) * sy) * k[_KS_TANH]
    d3 = [nx * k[_KS_R + 3 * r] + ny * k[_KS_R + 3 * r + 1]
          - k[_KS_R + 3 * r + 2] for r in range(3)]
    si, ai, bi = _SAB_IDX[axis_world]
    d_s, d_a, d_b = d3[si], d3[ai], d3[bi]

    vox = k[_KS_VOX]
    eye_s = k[_KS_EYE_S]
    denom = d_s / vox
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t_rp = (k[_KS_Z0] - eye_s) / denom
    a_ref = k[_KS_EYE_A] + d_a / vox * t_rp
    b_ref = k[_KS_EYE_B] + d_b / vox * t_rp
    behind = t_rp <= 0
    uu = (a_ref - k[_KS_AMIN]) * k[_KS_SCA]
    vv = (b_ref - k[_KS_BMIN]) * k[_KS_SCB]
    invalid = behind | (uu < 0) | (uu >= th) | (vv < 0) | (vv >= tw)
    iu = torch.where(invalid, 0, uu.to(torch.int32).clamp(0, th - 1))
    iv = torch.where(invalid, 0, vv.to(torch.int32).clamp(0, tw - 1))
    return k, d3, behind, invalid, iu, iv


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device, as the
    kernel's ``sqrtf``. The CPU's vectorized f32 ``torch.sqrt`` is an ulp
    off on some inputs, where the card's is exact; through f64 both round
    once. (``slab_sweep._sqrt``, which every module imports from there.)"""
    return torch.sqrt(x.double()).to(x.dtype)


def _reference(table, ks, axis_world, width, height, has_shadow):
    f32 = torch.float32
    dev = table.device
    th, tw = table.shape
    k, d3, behind, invalid, iu, iv = _texels(th, tw, ks, axis_world, width,
                                             height, dev)
    vox, eye_s = k[_KS_VOX], k[_KS_EYE_S]
    d_s = d3[_SAB_IDX[axis_world][0]]
    val = torch.where(invalid, -1.0, table[iu.long(), iv.long()])

    hit = (val >= 0.0) & ~behind
    sh_bit = val >= 2048.0
    z_f = torch.clamp(val - torch.where(sh_bit, 2048.0, 0.0), min=0.0)
    d_len = _sqrt(d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2])
    t_w = (z_f - eye_s) * vox * d_len / d_s
    t_w = torch.where(hit, t_w, 0.0)

    nudge = 0.25 * vox
    ndl = torch.zeros((height, width), dtype=f32, device=dev)
    nrm2 = torch.zeros((height, width), dtype=f32, device=dev)
    for c in range(3):
        dir_c = d3[c] / d_len
        p_c = k[_KS_CAM + c] + dir_c * t_w
        pin_c = p_c + dir_c * nudge
        org_c = k[_KS_ORG + c]
        cen_c = org_c + (torch.floor((pin_c - org_c) / vox) + 0.5) * vox
        n_c = p_c - cen_c
        nrm2 = nrm2 + n_c * n_c
        ndl = ndl + n_c * k[_KS_L + c]
    ndotl = torch.clamp(-ndl / torch.clamp(_sqrt(nrm2), min=1e-12),
                        min=0.0)

    packed = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for c in range(3):
        col = k[_KS_BASE + c] * ndotl + k[_KS_AMB + c]
        if has_shadow:
            col = torch.where(sh_bit, k[_KS_AMB + c], col)
        col = torch.where(hit, col, 0.0)
        q = torch.clamp(col * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)
        packed = (packed << 8) | q
    return packed


def unpack_frame_rgb(packed: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """int32[H', W'] packed 0xRRGGBB -> f32[height, width, 4] rgba."""
    p = packed[:height, :width]
    r = ((p >> 16) & 255).to(torch.float32)
    g = ((p >> 8) & 255).to(torch.float32)
    b = (p & 255).to(torch.float32)
    a = torch.full_like(r, 255.0)
    return torch.stack([r, g, b, a], dim=-1) * (1.0 / 255.0)


# --------------------------------------------------------------------------
# per-pixel table lookups: T[lin >> 10, lin & 1023], the miss sentinel at
# lin < 0
# --------------------------------------------------------------------------

def _check_lookup(tables: torch.Tensor, lin: torch.Tensor):
    """Validate a [P, TH, TW] f32 table stack and an int32 ``lin`` field."""
    if not torch.is_tensor(tables) or tables.dtype != torch.float32:
        raise TypeError(f"table must be a float32 tensor, got "
                        f"{getattr(tables, 'dtype', type(tables))}")
    if not torch.is_tensor(lin) or lin.dtype != torch.int32:
        raise TypeError(f"lin must be an int32 tensor, got "
                        f"{getattr(lin, 'dtype', type(lin))}")
    if tables.ndim != 3:
        raise ValueError(f"tables must be [P, TH, TW], got "
                         f"{tuple(tables.shape)}")
    p, th, tw = tables.shape
    if min(p, th, tw) < 1 or tw > 1024 or th > (1 << 21):
        raise ValueError(f"table must be [TH <= 2^21, TW <= 1024], got "
                         f"{tuple(tables.shape[1:])}")
    if not (tables.is_contiguous() and lin.is_contiguous()):
        raise ValueError("table and lin must be contiguous")
    if tables.device != lin.device:
        raise ValueError(f"table on {tables.device}, lin on {lin.device}")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tables.device}")


def _one_plane(table):
    """A [TH, TW] table as a one-plane stack."""
    if torch.is_tensor(table) and table.ndim != 2:
        raise ValueError(f"table must be [TH, TW], got {tuple(table.shape)}")
    return table[None] if torch.is_tensor(table) else table


def _lookup_reference(tables: torch.Tensor, lin: torch.Tensor):
    """Plain version of the lookup kernel: flat ``torch.take`` per plane.
    Indices past the table clamp to its edge, as the kernel's do."""
    _, th, tw = tables.shape
    miss = lin < 0
    iu = (lin >> 10).clamp(max=th - 1)
    iv = (lin & 1023).clamp(max=tw - 1)
    flat = torch.where(miss, 0, iu * tw + iv).long()
    out = [torch.where(miss, -1.0 if p == 0 else 0.0, torch.take(t, flat))
           for p, t in enumerate(tables)]
    return torch.stack(out)


# the single-plane kernel's forms, by their codes in csrc/warp_lookup.cu
LOOKUP_FORM_CODE = {"general": 0, "vector": 1}
LOOKUP_FORM_LAUNCHES: Dict[str, int] = {"vector": 0, "general": 0}


def lookup_forms(lin: torch.Tensor) -> List[Tuple[str, int]]:
    """The single-plane lookup kernel's launches for ``lin``, in order, as
    (form, pixels): where its data is 16-byte aligned and its pixel count
    n below 2^31, the vector form over the first n & ~3 pixels (the output
    is a fresh, aligned allocation); the general form over the rest, which
    is the last 1-3 pixels of such a field, or all of any other."""
    n = lin.numel()
    n_vec = n & ~3 if lin.data_ptr() % 16 == 0 and n < 2 ** 31 else 0
    return [(f, k) for f, k in (("vector", n_vec), ("general", n - n_vec))
            if k]


def _lookup_launch(tables: torch.Tensor, lin: torch.Tensor,
                   out: torch.Tensor, form: Optional[int] = None,
                   start: int = 0, n: Optional[int] = None):
    """Launch ``csrc/warp_lookup.cu`` on the current stream into ``out``:
    the multi-plane entry where ``form`` is None, else the single-plane
    entry in the form of that code, over ``n`` pixels of the flat ``lin``
    from ``start`` (all of them by default)."""
    lib = _build.load("warp_lookup")
    single = form is not None
    fn = lib.warp_lookup_launch if single else lib.warp_lookup_multi_launch
    if fn.argtypes is None:
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = ([c_ptr] + [c_int] * (2 if single else 3)
                       + [c_ptr, c_ptr, ctypes.c_int64]
                       + [c_int] * single + [c_ptr])
        fn.restype = c_int
    p, th, tw = tables.shape
    n = lin.numel() - start if n is None else n
    with torch.cuda.device(tables.device):
        stream = torch.cuda.current_stream(tables.device).cuda_stream
        rc = fn(tables.data_ptr(), *((th, tw) if single else (p, th, tw)),
                lin.data_ptr() + 4 * start, out.data_ptr() + 4 * start, n,
                *((form,) if single else ()), stream)
    if rc != 0:
        raise RuntimeError(f"warp_lookup launch failed: cudaError {rc}")


def warp_lookup(table: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """``out = table[lin >> 10, lin & 1023]``, -1 where ``lin < 0``.

    ``table`` f32[TH, TW] with TW <= 1024; ``lin`` int32 of any shape,
    packed ``(iu << 10) | iv``; the result has ``lin``'s shape. A CUDA
    ``table`` launches the kernel of ``csrc/warp_lookup.cu`` (the port of
    the reference's ``_warp_onehot_kernel``) on the current stream, in the
    forms :func:`lookup_forms` chooses; a CPU one runs
    :func:`warp_lookup_reference`.
    """
    tables = _one_plane(table)
    _check_lookup(tables, lin)
    if tables.device.type == "cpu":
        return _lookup_reference(tables, lin)[0]
    out = torch.empty(lin.shape, dtype=torch.float32, device=lin.device)
    start = 0
    for form, n in lookup_forms(lin):
        _lookup_launch(tables, lin, out, LOOKUP_FORM_CODE[form], start, n)
        warp_lookup.launches += 1
        LOOKUP_FORM_LAUNCHES[form] += 1
        start += n
    return out


warp_lookup.launches = 0   # kernel launches, counted where they happen


def warp_lookup_reference(table: torch.Tensor,
                          lin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_lookup`, on the table's device."""
    tables = _one_plane(table)
    _check_lookup(tables, lin)
    return _lookup_reference(tables, lin)[0]


def warp_lookup_multi(tables: torch.Tensor,
                      lin: torch.Tensor) -> torch.Tensor:
    """The same lookup for P planes from one ``lin`` field: f32[P, *lin].

    ``tables`` f32[P, TH, TW]. Where ``lin < 0`` plane 0 gives -1 and the
    other planes 0. A CUDA ``tables`` launches the kernel of
    ``csrc/warp_lookup.cu`` (the port of the reference's
    ``_warp_multi_kernel``): one index decode feeds every plane. A CPU one
    runs :func:`warp_lookup_multi_reference`.
    """
    _check_lookup(tables, lin)
    if tables.device.type == "cpu":
        return _lookup_reference(tables, lin)
    out = torch.empty((tables.shape[0],) + tuple(lin.shape),
                      dtype=torch.float32, device=tables.device)
    _lookup_launch(tables, lin, out)
    warp_lookup_multi.launches += 1
    return out


warp_lookup_multi.launches = 0   # kernel launches, counted where they happen


def warp_lookup_multi_reference(tables: torch.Tensor,
                                lin: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_lookup_multi`."""
    _check_lookup(tables, lin)
    return _lookup_reference(tables, lin)
