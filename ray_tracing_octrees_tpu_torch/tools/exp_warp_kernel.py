"""Windowed row-select warp: the port of ``tools/exp_warp_kernel.py``.

The experiment read ``out[y, x] = T[iu, iv]`` per 8 x 128 block through a
64-row window: a loop over the window's rows, each broadcast and gathered
along lanes, kept where the pixel's row matched. The rule, which the port
reproduces bit for bit:

- per 8 x 128 tile ``umin = clip(min iu, 0, TH - 64)`` (no rounding);
- per pixel ``out = 0 <= iu - umin < 64 ? 0 + T[iu, iv] : 0``.

A pixel outside its tile's window comes out 0; ``0 + t`` turns a -0 texel
into +0. ``iu`` may be negative (the experiment feeds -1 for pixels that
cannot hit, which pulls the tile's window down to row 0). ``iv`` must lie
in ``[0, C)``: the wrapper raises otherwise. On CUDA tensors
:func:`warp_pallas` launches kernel 3 of ``trace/csrc/exp_warp.cu``; on
CPU tensors it runs :func:`warp_pallas_reference`.

    python -m ray_tracing_octrees_tpu_torch.tools.exp_warp_kernel
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.tools import (
    check_index, check_table, device_line, event_ms, kernel_wrapper,
    tile_min, valid_mismatch,
)
from ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp import (
    TW, bench_pose_inputs,
)
from ray_tracing_octrees_tpu_torch.trace import exp_warp

WIN = 64


def row_window_reference(table: torch.Tensor, row_idx: torch.Tensor,
                         col_idx: Optional[torch.Tensor],
                         win: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 3: per 8 x 128 tile of ``row_idx``,
    ``umin = clip(min, 0, TH - win)``, and ``0 + table[row, col]`` where
    ``0 <= row - umin < win``, else 0. ``col_idx`` None takes the pixel's
    own column."""
    th, tc = table.shape
    umin = tile_min(row_idx, 8, 128).clamp(0, th - win)
    rel = row_idx.long() - umin.long()
    inwin = (rel >= 0) & (rel < win)
    col = (torch.arange(row_idx.shape[1], device=row_idx.device)
           .expand(row_idx.shape) if col_idx is None else col_idx.long())
    flat = torch.where(inwin, row_idx.long() * tc + col, 0)
    return torch.where(inwin, torch.take(table, flat), 0.0) + 0.0


def _check(t2: torch.Tensor, iu: torch.Tensor, iv: torch.Tensor):
    check_index("iu", iu, 8, 128)
    check_index("iv", iv, 8, 128)
    check_table("T2", t2, torch.float32, iu)
    if iu.shape != iv.shape or iu.device != iv.device:
        raise ValueError(f"iu {tuple(iu.shape)} on {iu.device} and iv "
                         f"{tuple(iv.shape)} on {iv.device} must match")
    if t2.shape[0] < WIN:
        raise ValueError(f"T2 needs at least {WIN} rows, got {t2.shape[0]}")
    lo, hi = (int(v) for v in torch.aminmax(iv))
    if lo < 0 or hi >= t2.shape[1]:
        raise ValueError(f"iv must lie in [0, {t2.shape[1]}), got "
                         f"[{lo}, {hi}]")
    return t2, iu, iv, WIN


warp_pallas = kernel_wrapper(
    "warp_pallas", _check, row_window_reference, exp_warp.row_window,
    "f32 ``T2`` [TH >= 64, C], int32 ``iu``, ``iv`` [H, W] (H % 8, "
    "W % 128, ``iv`` in [0, C)) -> f32 [H, W] by the rule of the module "
    "docstring.")
warp_pallas_reference = warp_pallas.reference


def split_lin(lin: torch.Tensor):
    """``iu = lin // TW`` and ``iv = lin % TW`` with Python's floor rules,
    as the experiments decode: -1 gives ``iu = -1``, ``iv = TW - 1``."""
    iu = torch.div(lin, TW, rounding_mode="floor").to(torch.int32)
    return iu, torch.remainder(lin, TW).to(torch.int32)


def run(device: DeviceLike = None, dim: int = 256, width: int = 1920,
        height: int = 1088) -> dict:
    """The experiment's ``main()`` at the bench pose: the widest ``iu``
    range of a tile against the window, the mismatch share against the
    direct gather on valid pixels, and (on CUDA) the time beside one
    ``torch.take``."""
    dev = resolve_device(device)
    pose = bench_pose_inputs(dim, width, height, 1, dev)[0]
    t2, lin = pose["table"], pose["lin"]
    iu, iv = split_lin(lin)
    blk = iu.reshape(height // 8, 8, width // 128, 128)
    span = int((blk.amax(dim=(1, 3)) - blk.amin(dim=(1, 3))).max())
    out = warp_pallas(t2, iu, iv)
    mm = valid_mismatch(out, t2, lin)
    lines = [f"max iu block range: {span} (window {WIN})",
             f"pallas warp mismatch on valid pixels = {mm:.7f}"]
    ms = {}
    if dev.type == "cuda":
        flat = (iu.reshape(-1).long() * TW + iv.reshape(-1).long())
        flat = torch.where(lin.reshape(-1) < 0, 0, flat)
        for name, fn in [("torch.take", lambda k: torch.take(t2, flat)),
                         ("pallas warp", lambda k: warp_pallas(t2, iu, iv))]:
            ms[name] = event_ms(fn)
            lines.append(f"{name:14s} {ms[name]:8.4f} ms (CUDA events)")
    lines.append(device_line(dev))
    return dict(lines=lines, max_block_range=span, mismatch={"warp": mm},
                ms=ms, inputs=dict(table=t2, iu=iu, iv=iv, lin=lin))


def main() -> None:
    for line in run()["lines"]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
