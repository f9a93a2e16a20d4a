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
:func:`warp_frame_reference`. There is no other path.
"""

from __future__ import annotations

import ctypes
import math

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


def frame_scalars(scal) -> np.ndarray:
    """The fused kernel's f32[35] scalars from the packed per-frame scalars
    (slab_sweep layout), on the host in f32 — ``inv(view)`` included, as
    the reference computes it in f32."""
    f32 = np.float32
    scal = np.asarray(scal, f32)
    fov_deg, aspect = scal[8], scal[9]
    tan_half = np.tan(fov_deg * f32(math.pi / 360.0))
    view = scal[18:34].reshape(4, 4)
    R = np.linalg.inv(view)[:3, :3]
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


def _launch(lib, table, ks, axis_world, width, height, has_shadow):
    """Launch ``lib``'s warp_frame kernel on the current stream; ``ks`` is
    the checked, rescaled scalar vector from :func:`_check`."""
    fn = lib.warp_frame_launch
    if fn.argtypes is None:
        c_int, c_float, c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = [c_ptr, c_int, c_int, c_ptr, c_ptr, c_int, c_int,
                       c_float, c_float, c_int, c_int, c_int, c_int, c_ptr]
        fn.restype = c_int
    th, tw = table.shape
    sx, sy = _pixel_steps(width, height)
    s, a, b = _SAB_IDX[axis_world]
    ks = np.ascontiguousarray(ks, np.float32)
    with torch.cuda.device(table.device):
        out = torch.empty((height, width), dtype=torch.int32,
                          device=table.device)
        rc = fn(table.data_ptr(), th, tw, ks.ctypes.data, out.data_ptr(),
                width, height, float(sx), float(sy), s, a, b,
                int(bool(has_shadow)),
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


def _reference(table, ks, axis_world, width, height, has_shadow):
    f32 = torch.float32
    dev = table.device
    th, tw = table.shape
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
    val = torch.where(invalid, -1.0, table[iu.long(), iv.long()])

    hit = (val >= 0.0) & ~behind
    sh_bit = val >= 2048.0
    z_f = torch.clamp(val - torch.where(sh_bit, 2048.0, 0.0), min=0.0)
    d_len = torch.sqrt(d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2])
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
    ndotl = torch.clamp(-ndl / torch.clamp(torch.sqrt(nrm2), min=1e-12),
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
