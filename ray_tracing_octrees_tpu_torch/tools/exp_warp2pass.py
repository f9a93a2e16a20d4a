"""Two-pass scanline warp: the port of ``tools/exp_warp2pass.py``.

``out[y, x] = T[iu, iv]`` decomposed a la Catmull-Smith:

- pass 1, ``M[y, v] = T[u*(y, v), v]``, with ``u*`` from the closed-form
  inverse of the row homography (:func:`inverse_row_homography`). Per
  8 x 128 block of ``iustar``, ``umin = clip(min, 0, U - 64)``, and
  ``M[y, v] = 0 <= iustar - umin < 64 ? 0 + T[iustar, v] : 0``;
- pass 2, ``out[y, x] = M[y, iv]``, which the TPU ran on the transposed
  ``M`` and ``iv``, zero-padded on the y axis to a multiple of 128. Per
  tile of 8 x by 128 y, ``vmin = clip(min ivT, 0, V - 256)``, the padded
  zeros included (so in the last y-tile, when H % 128 != 0, ``vmin`` is 0
  and every pixel with ``iv >= 256`` comes out 0), and
  ``out[y, x] = 0 <= iv - vmin < 256 ? 0 + M[y, iv] : 0``.

On CUDA tensors pass 1 launches kernel 3 and pass 2 kernel 4 of
``trace/csrc/exp_warp.cu`` (each wrapper counts its own launches); on
CPU tensors they run their plain versions. The wrappers raise for
``U < 64`` or ``V < 256``.

    python -m ray_tracing_octrees_tpu_torch.tools.exp_warp2pass
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.tools import (
    check_index, check_table, device_line, event_ms, kernel_wrapper,
    tile_min, valid_mismatch,
)
from ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp import (
    TH, TW, bench_pose_inputs,
)
from ray_tracing_octrees_tpu_torch.tools.exp_warp_kernel import (
    row_window_reference, split_lin,
)
from ray_tracing_octrees_tpu_torch.trace import exp_warp
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _AXIS_SELECTORS

WIN1 = 64    # pass-1 window over table rows u per (8, 128) block
WIN2 = 256   # pass-2 window over table cols v per (8 x, 128 y) block


def _check_pass1(t2: torch.Tensor, iustar: torch.Tensor):
    check_index("iustar", iustar, 8, 128)
    check_table("T2", t2, torch.float32, iustar)
    u, v = t2.shape
    if u < WIN1 or v < WIN2:
        raise ValueError(f"T2 must be [U >= {WIN1}, V >= {WIN2}], got "
                         f"{tuple(t2.shape)}")
    if iustar.shape[1] != v:
        raise ValueError(f"iustar must be [H, {v}], got "
                         f"{tuple(iustar.shape)}")
    return t2, iustar, None, WIN1


def _check_pass2(m: torch.Tensor, iv: torch.Tensor):
    check_index("iv", iv, 8, 8)
    check_table("M", m, torch.float32, iv)
    if m.shape[0] != iv.shape[0] or m.shape[1] < WIN2:
        raise ValueError(f"M must be [{iv.shape[0]}, V >= {WIN2}], got "
                         f"{tuple(m.shape)}")
    return m, iv, WIN2


def _check_two_pass(t2: torch.Tensor, iustar: torch.Tensor,
                    iv: torch.Tensor) -> None:
    _check_pass1(t2, iustar)
    check_index("iv", iv, 8, 8)
    if iv.shape[0] != iustar.shape[0] or iv.device != iustar.device:
        raise ValueError(f"iv {tuple(iv.shape)} on {iv.device} and iustar "
                         f"{tuple(iustar.shape)} on {iustar.device} must "
                         f"share H and device")


def pass2_vmin(iv: torch.Tensor, v: int, win: int) -> torch.Tensor:
    """Each pixel's ``vmin`` under pass 2's rule: ``clip(min, 0, v -
    win)`` over its tile of 8 x by 128 y, ``iv`` padded with zeros to a
    multiple of 128 rows (so a tile that reaches past the last row takes
    0)."""
    h, w = iv.shape
    hp = -(-h // 128) * 128
    ivp = torch.zeros((hp, w), dtype=iv.dtype, device=iv.device)
    ivp[:h] = iv
    return tile_min(ivp, 128, 8)[:h].clamp(0, v - win)


def _pass2(m: torch.Tensor, iv: torch.Tensor, win: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 4 (pass 2), unchecked."""
    h = iv.shape[0]
    v = m.shape[1]
    vmin = pass2_vmin(iv, v, win)
    rel = iv.long() - vmin.long()
    inwin = (rel >= 0) & (rel < win)
    rows = torch.arange(h, device=iv.device)[:, None]
    flat = torch.where(inwin, rows * v + iv.long(), 0)
    return torch.where(inwin, torch.take(m, flat), 0.0) + 0.0


warp_pass1 = kernel_wrapper(
    "warp_pass1", _check_pass1, row_window_reference, exp_warp.row_window,
    "Pass 1: f32 ``T2`` [U, V], int32 ``iustar`` [H, V] (H % 8, V % 128) "
    "-> ``M`` f32 [H, V].")
warp_pass2 = kernel_wrapper(
    "warp_pass2", _check_pass2, _pass2, exp_warp.col_window,
    "Pass 2: f32 ``M`` [H, V], int32 ``iv`` [H, W] (H % 8, W % 8) -> f32 "
    "[H, W].")
warp_pass1_reference = warp_pass1.reference
warp_pass2_reference = warp_pass2.reference


def warp_two_pass(T2: torch.Tensor, iustar: torch.Tensor,
                  iv: torch.Tensor) -> torch.Tensor:
    """f32 ``T2`` [U, V], int32 ``iustar`` [H, V], int32 ``iv`` [H, W]
    -> f32 [H, W]: :func:`warp_pass1`, then :func:`warp_pass2`."""
    _check_two_pass(T2, iustar, iv)
    return warp_pass2(warp_pass1(T2, iustar), iv)


def warp_two_pass_reference(T2: torch.Tensor, iustar: torch.Tensor,
                            iv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`warp_two_pass`."""
    _check_two_pass(T2, iustar, iv)
    return _pass2(row_window_reference(T2, iustar, None, WIN1), iv, WIN2)


def inverse_row_homography(scal_np, axis_world, inter_h, inter_w,
                           width, height):
    """u*(y, v): table row hit by image row y in table column v (closed form).

    For fixed image row y (fixed ny), every sweep-space quantity is a ratio
    of affines in nx; solving vv = v + 0.5 for nx and substituting into uu
    gives u* exactly. Host numpy in f64, op for op the experiment's."""
    eye_s, eye_a, eye_b, z0 = scal_np[0], scal_np[1], scal_np[2], scal_np[3]
    a_min, a_max, b_min, b_max = scal_np[4:8]
    fov_deg, aspect = scal_np[8], scal_np[9]
    view = scal_np[18:34].reshape(4, 4)
    R = np.linalg.inv(view)[:3, :3].astype(np.float64)
    sel = _AXIS_SELECTORS[axis_world]
    s0, s1, s2 = (np.asarray(s, np.float64) for s in sel)
    G = float(z0 - eye_s)

    tan_half = math.tan(math.radians(float(fov_deg)) / 2.0)
    ny = (1.0 - (np.arange(height, dtype=np.float64) + 0.5) / height * 2.0) \
        * tan_half                                             # [H]
    # nx coefficients: d = nx*R[:,0] + ny*R[:,1] - R[:,2]
    P = R[:, 0] @ s0
    Pa = R[:, 0] @ s1
    Pb = R[:, 0] @ s2
    gam = ny * (R[:, 1] @ s0) - (R[:, 2] @ s0)                 # [H]
    alp = ny * (R[:, 1] @ s1) - (R[:, 2] @ s1)
    bet = ny * (R[:, 1] @ s2) - (R[:, 2] @ s2)

    v = np.arange(inter_w, dtype=np.float64)
    Bv = b_min + (v + 0.5) * (b_max - b_min) / inter_w         # [V]
    num = G * bet[:, None] - (Bv[None, :] - eye_b) * gam[:, None]
    den = (Bv[None, :] - eye_b) * P - G * Pb
    den = np.where(np.abs(den) < 1e-30, 1e-30, den)
    nx = num / den                                             # [H, V]
    d_s = gam[:, None] + P * nx
    d_s = np.where(np.abs(d_s) < 1e-30, 1e-30, d_s)
    d_a = alp[:, None] + Pa * nx
    a_ref = eye_a + G * d_a / d_s
    uu = (a_ref - a_min) / (a_max - a_min) * inter_h
    uu = np.where(np.isfinite(uu), uu, 0.0)
    return np.clip(np.floor(uu), 0, inter_h - 1).astype(np.int32)


def run(device: DeviceLike = None, dim: int = 256, width: int = 1920,
        height: int = 1088) -> dict:
    """The experiment's ``main()`` at the bench pose: how often the
    inverse homography's ``u*`` agrees with the frame's ``iu``, the
    windows each pass needs, the mismatch share against the direct gather
    on valid pixels, and (on CUDA) the time beside one ``torch.take``."""
    dev = resolve_device(device)
    pose = bench_pose_inputs(dim, width, height, 1, dev)[0]
    t2, lin = pose["table"], pose["lin"]
    iu, iv = split_lin(lin)
    ius_np = inverse_row_homography(pose["scal"], pose["axis"], TH, TW,
                                    width, height)
    iu_np, iv_np = iu.cpu().numpy(), iv.cpu().numpy()
    pred = ius_np[np.arange(height)[:, None], iv_np]
    agree = float((pred == iu_np).mean())
    far = float((np.abs(pred - iu_np) > 1).mean())
    # window bounds (pass 2 runs transposed: tiles are (8 x, 128 y))
    bl = ius_np.reshape(height // 8, 8, TW // 128, 128)
    r1 = int((bl.max(axis=(1, 3)) - bl.min(axis=(1, 3))).max())
    hp = (-height) % 128
    ivt = np.pad(iv_np.T, ((0, 0), (0, hp)), mode="edge")
    bv = ivt.reshape(width // 8, 8, (height + hp) // 128, 128)
    r2 = int((bv.max(axis=(1, 3)) - bv.min(axis=(1, 3))).max())
    iustar = torch.as_tensor(ius_np, device=dev)
    out = warp_two_pass(t2, iustar, iv)
    mm = valid_mismatch(out, t2, lin)
    lines = [f"inverse-homography agreement: {agree:.5f} (|diff|>1: "
             f"{far:.6f})",
             f"pass1 u-window needed {r1} (have {WIN1}); pass2 v-window "
             f"needed {r2} (have {WIN2})",
             f"two-pass mismatch on valid pixels = {mm:.5f}"]
    ms = {}
    if dev.type == "cuda":
        flat = torch.where(lin < 0, 0, lin).reshape(-1).long()
        for name, fn in [("torch.take", lambda k: torch.take(t2, flat)),
                         ("two-pass", lambda k: warp_two_pass(t2, iustar,
                                                              iv))]:
            ms[name] = event_ms(fn)
            lines.append(f"{name:18s} {ms[name]:8.4f} ms (CUDA events)")
    lines.append(device_line(dev))
    return dict(lines=lines, agreement=agree, windows_needed=(r1, r2),
                mismatch={"two-pass": mm}, ms=ms,
                inputs=dict(table=t2, iustar=iustar, iv=iv, lin=lin))


def main() -> None:
    for line in run()["lines"]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
