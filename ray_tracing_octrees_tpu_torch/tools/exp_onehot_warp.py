"""One-hot window warp: the port of ``tools/exp_onehot_warp.py``.

The experiment replaced the frame's final gather ``out[y, x] = T[iu, iv]``
by a one-hot MXU contraction on the bf16 hi/lo split of the f32 table,
per tile of 8 x 128 pixels, over a window of ``win`` table rows. What it
computes, and what the port reproduces bit for bit, is the window rule:

- per pixel ``invalid = lin < 0``, ``iu = invalid ? TH-1 : lin >> 10``,
  ``iv = lin & 1023``;
- per tile ``umin = (clip(min iu, 0, TH - win) >> 3) << 3``;
- per pixel ``u' = umin + clip(iu - umin, 0, win - 1)`` and
  ``out = invalid ? -1 : f32(hi[u', iv]) + f32(lo[u', iv])``.

So a pixel whose ``iu`` leaves its tile's window reads the window's edge
row, and the value is the hi/lo reconstruction, which equals ``T`` only
where the split is exact (the packed ``k + 0.5`` encoding is). The
grouped form (``onehot_warp_grouped``) contracts only the 128-column
groups the tile spans and gives the same values. Precondition: the table
is finite (the TPU kernel's one-hot product turns an inf in the window's
column into NaN; the port reads the texel alone). Any int32 ``lin`` is
valid input: indices past the table clamp into the window.

On CUDA tensors both wrappers launch kernel 1 of ``trace/csrc/
exp_warp.cu``; on CPU tensors they run :func:`onehot_reference`.

    python -m ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.core.grid import (
    building_center, make_sphere_grid,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.tools import (
    check_index, check_table, device_line, event_ms, kernel_wrapper,
    tile_min, valid_mismatch,
)
from ray_tracing_octrees_tpu_torch.trace import exp_warp, slab_sweep as ss

TH = 1024  # table rows (u)
TW = 1024  # table cols (v)


def split_hi_lo(packed2d: torch.Tensor) -> torch.Tensor:
    """f32 [TH, TW] -> bf16 [2 TH, TW]: the round-to-nearest-even bf16 of
    each texel, then the bf16 of its remainder."""
    hi = packed2d.to(torch.bfloat16)
    lo = (packed2d - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=0)


def check_onehot(t_hl: torch.Tensor, lin2d: torch.Tensor, ty: int, tx: int,
                 win: int) -> tuple:
    """The one-hot kernels' arguments, returned as given: bf16 ``t_hl``
    [2 TH, TW], int32 ``lin2d`` [H, W] in whole ``ty x tx`` tiles,
    ``1 <= win <= TH``."""
    if min(ty, tx) < 1:
        raise ValueError(f"bad tile {ty}x{tx}")
    check_index("lin2d", lin2d, ty, tx)
    check_table("t_hl", t_hl, torch.bfloat16, lin2d)
    if tuple(t_hl.shape) != (2 * TH, TW):
        raise ValueError(f"t_hl must be [{2 * TH}, {TW}], got "
                         f"{tuple(t_hl.shape)}")
    if not 1 <= win <= TH:
        raise ValueError(f"win must be in [1, {TH}], got {win}")
    return t_hl, lin2d, ty, tx, win


def window_rows(lin2d: torch.Tensor, ty: int, tx: int, win: int):
    """(invalid, iu, iv, umin, rel_u) of the window rule, per pixel."""
    invalid = lin2d < 0
    iu = torch.where(invalid, TH - 1, lin2d >> 10)
    iv = lin2d & (TW - 1)
    umin = (tile_min(iu, ty, tx).clamp(0, TH - win) >> 3) << 3
    rel_u = (iu - umin).clamp(0, win - 1)
    return invalid, iu, iv, umin, rel_u


def onehot_reference(t_hl: torch.Tensor, lin2d: torch.Tensor, ty: int,
                     tx: int, win: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 1 (tile ``ty x tx``, window
    ``win``), on the inputs' device. Arguments as :func:`check_onehot`."""
    invalid, _, iv, umin, rel_u = window_rows(lin2d, ty, tx, win)
    flat = ((umin + rel_u) * TW + iv).long()
    hi = torch.take(t_hl[:TH], flat).to(torch.float32)
    lo = torch.take(t_hl[TH:], flat).to(torch.float32)
    return torch.where(invalid, -1.0, hi + lo)


def _tile_8x128(t_hl: torch.Tensor, lin2d: torch.Tensor, win: int):
    return check_onehot(t_hl, lin2d, 8, 128, win)


def onehot_kernel(name: str, check=check_onehot, doc: str = ""):
    """A wrapper of kernel 1 (:func:`~ray_tracing_octrees_tpu_torch.tools.
    kernel_wrapper`) whose arguments ``check`` turns into the kernel's
    ``(t_hl, lin2d, ty, tx, win)``; by default the caller gives those."""
    return kernel_wrapper(name, check, onehot_reference,
                          exp_warp.onehot_window, doc or (
                              f"{name}: bf16 t_hl [2 TH, TW], int32 lin2d "
                              f"[H, W] (H % ty, W % tx), ty, tx, win -> f32 "
                              f"[H, W] by the window rule."))


onehot_warp = onehot_kernel("onehot_warp", _tile_8x128, (
    "bf16 ``t_hl`` [2 TH, TW] (hi rows then lo rows), int32 ``lin2d`` "
    "[H, W] (H % 8, W % 128), ``win`` -> f32 [H, W], by the window rule "
    "of the module docstring on 8 x 128 tiles."))
onehot_warp_grouped = onehot_kernel("onehot_warp_grouped", _tile_8x128, (
    "The grouped form of :func:`onehot_warp`: the same arguments and "
    "values (on the TPU it contracted only the 128-column groups the tile "
    "spans)."))
onehot_warp_reference = onehot_warp.reference
onehot_warp_grouped_reference = onehot_warp_grouped.reference


def bench_pose_inputs(dim: int = 256, width: int = 1920, height: int = 1088,
                      n_poses: int = 4, device: DeviceLike = None) -> List[dict]:
    """The experiments' inputs on ``make_sphere_grid(dim)``: per pose
    ``theta = 0.9 + 0.02 i`` (the bench pose first, then its orbit
    neighbours), the sweep's packed f32 [TH, TW] ``table`` (no shadow
    channel), the int32 [height, width] ``lin`` (``iu * TW + iv``, -1
    where a ray cannot hit), the frame scalars ``scal`` (host f32) and
    the sweep ``axis``."""
    dev = resolve_device(device)
    grid = make_sphere_grid(dim, device=dev)
    vol = (grid.occ > 0).to(torch.float32)
    origin = grid.origin.cpu().numpy().astype(np.float32)
    vox = float(grid.voxel_size.cpu())
    extent = float((grid.world_max - grid.world_min).max().cpu())
    target = building_center(grid)
    out = []
    for i in range(n_poses):
        cam = Camera(theta=0.9 + 0.02 * i, phi=0.8, radius=0.75 * extent)
        cam.set_target(target)
        aw, flip, (S, A, B), eyes, window, _crop = ss._sweep_geometry(
            vol.shape, origin, vox, cam.get_pos(), cam.get_view())
        vol_bf = ss._layout_volume(vol, aw, bool(flip), S)
        scal_np = ss._frame_scalars_np(
            *eyes[:3], eyes[3], *window, 45.0, width / height, vox, S,
            origin, np.asarray(cam.get_pos(), np.float32), cam.get_view())
        scal = torch.as_tensor(scal_np, device=dev)
        packed = ss._sweep_all(vol_bf, scal, S, A, B, TH, TW, bool(flip))
        lin = ss._warp_setup(scal, aw, TH, TW, width, height)[0]
        out.append(dict(table=packed.reshape(TH, TW),
                        lin=lin.reshape(height, width), scal=scal_np,
                        axis=aw))
    return out


def run(device: DeviceLike = None, dim: int = 256, width: int = 1920,
        height: int = 1088) -> dict:
    """The experiment's ``main()``: the bench pose and three orbit
    neighbours, the hi/lo split's exactness, each kernel's mismatch share
    against the direct gather on valid pixels, and (on CUDA) each form's
    time beside one ``torch.take`` of the flat index."""
    dev = resolve_device(device)
    poses = bench_pose_inputs(dim, width, height, 4, dev)
    tables = [split_hi_lo(p["table"]) for p in poses]
    lins = [p["lin"] for p in poses]
    t2, lin = poses[0]["table"], lins[0]
    hl = tables[0].to(torch.float32)
    exact = float((hl[:TH] + hl[TH:] == t2).float().mean())
    lines = [f"hi/lo split exact: {exact == 1.0} (share {exact:.7f})"]
    mismatch = {}
    for name, fn, win in (("plain", onehot_warp, 64),
                          ("plain", onehot_warp, 128),
                          ("grouped", onehot_warp_grouped, 64)):
        mm = valid_mismatch(fn(tables[0], lin, win), t2, lin)
        mismatch[f"{name} win={win}"] = mm
        lines.append(f"{name} win={win}: mismatch on valid pixels = {mm:.7f}")
    ms = {}
    if dev.type == "cuda":
        flat = torch.where(lin < 0, 0, lin).reshape(-1).long()
        packed_flat = t2.reshape(-1)
        for name, fn in [
            ("torch.take", lambda k: torch.take(packed_flat, flat)),
            ("onehot warp w64", lambda k: onehot_warp(
                tables[k % 4], lins[k % 4], 64)),
            ("onehot warp w128", lambda k: onehot_warp(
                tables[k % 4], lins[k % 4], 128)),
            ("grouped warp w64", lambda k: onehot_warp_grouped(
                tables[k % 4], lins[k % 4], 64)),
            ("grouped warp w128", lambda k: onehot_warp_grouped(
                tables[k % 4], lins[k % 4], 128)),
        ]:
            ms[name] = event_ms(fn)
            lines.append(f"{name:18s} {ms[name]:8.4f} ms (CUDA events)")
    lines.append(device_line(dev))
    return dict(lines=lines, hi_lo_exact_share=exact, mismatch=mismatch,
                ms=ms, inputs=dict(tables=[p["table"] for p in poses],
                                   t_hl=tables, lins=lins))


def main() -> None:
    for line in run()["lines"]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
