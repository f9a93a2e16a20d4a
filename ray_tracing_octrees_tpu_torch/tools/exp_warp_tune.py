"""Tile and window sweep of the grouped one-hot warp: the port of
``tools/exp_warp_tune.py``.

``warp(t_hl, lin2d, ty, tx, win, mxu_sel)`` is the grouped one-hot
kernel with the tile ``(ty, tx)``, the window ``win`` and the select
method as parameters. Its values are the window rule of
:mod:`~ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp` on ``ty x tx``
tiles; ``mxu_sel`` (the TPU's final select as a product with ones instead
of a masked sum) changes how the TPU reached them, not the values, and
is accepted and ignored. On CUDA tensors it launches kernel 1 of
``trace/csrc/exp_warp.cu``; on CPU tensors it runs the plain version.

    python -m ray_tracing_octrees_tpu_torch.tools.exp_warp_tune
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.tools import device_line, event_ms
from ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp import (
    TH, TW, check_onehot, onehot_kernel, split_hi_lo,
)

NG = TW // 128
# (ty, tx, win, mxu_sel), the experiment's list
CONFIGS = [
    (8, 128, 64, False),
    (8, 128, 64, True),
    (16, 128, 64, False),
    (16, 256, 128, False),
    (16, 256, 128, True),
    (32, 128, 128, False),
]


def _check(t_hl: torch.Tensor, lin2d: torch.Tensor, ty: int, tx: int,
           win: int, mxu_sel: bool = False):
    return check_onehot(t_hl, lin2d, ty, tx, win)


warp = onehot_kernel("warp", _check, (
    "bf16 ``t_hl`` [2 TH, TW], int32 ``lin2d`` [H, W] (H % ty, W % tx), "
    "``ty``, ``tx``, ``win``, ``mxu_sel=False`` (ignored) -> f32 [H, W] by "
    "the window rule on ``ty x tx`` tiles."))
warp_reference = warp.reference


def synthetic_inputs(height: int = 1088, width: int = 1920,
                     n: int = 4) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The experiment's seeded fields: a table of ``k + 0.5`` values (as
    the packed sweep encoding, so the hi/lo split is exact) and ``n``
    smooth ``lin`` fields shaped like real poses (``iu`` rising 0.35 a
    row, ``iv`` 0.52 a column)."""
    rng = np.random.default_rng(0)
    t2 = rng.uniform(0, 512, (TH, TW)).astype(np.float32)
    t2 = np.round(t2) + 0.5
    yy = np.arange(height)[:, None]
    xx = np.arange(width)[None, :]
    lins = []
    for k in range(n):
        iu = np.clip((yy * 0.35 + xx * 0.02 + k).astype(np.int32), 0, TH - 1)
        iv = np.clip((xx * 0.52 + yy * 0.01 + 3 * k).astype(np.int32), 0,
                     TW - 1)
        lins.append((iu * TW + iv).astype(np.int32))
    return t2, lins


def run(device: DeviceLike = None, height: int = 1088,
        width: int = 1920) -> dict:
    """The experiment's ``main()``: every config that tiles the image,
    with its mismatch share against the direct gather and (on CUDA) its
    time beside one ``torch.take``."""
    dev = resolve_device(device)
    t2_np, lin_nps = synthetic_inputs(height, width)
    t2 = torch.as_tensor(t2_np, device=dev)
    t_hl = split_hi_lo(t2)
    lins = [torch.as_tensor(x, device=dev) for x in lin_nps]
    ref = torch.take(t2, lins[0].long())
    lines, mismatch, ms = [], {}, {}
    for ty, tx, win, sel in CONFIGS:
        if width % tx or height % ty:
            continue
        name = f"tile({ty:2d},{tx:3d}) win={win:3d} mxu_sel={int(sel)}"
        mismatch[name] = float((warp(t_hl, lins[0], ty, tx, win, sel)
                                != ref).float().mean())
        line = f"{name}: mismatch={mismatch[name]:.7f}"
        if dev.type == "cuda":
            ms[name] = event_ms(lambda k: warp(t_hl, lins[k % 4], ty, tx,
                                               win, sel))
            line += f"  {ms[name]:8.4f} ms (CUDA events)"
        lines.append(line)
    if dev.type == "cuda":
        flat = lins[0].reshape(-1).long()
        ms["torch.take"] = event_ms(lambda k: torch.take(t2, flat))
        lines.append(f"torch.take {ms['torch.take']:8.4f} ms (CUDA events)")
    lines.append(device_line(dev))
    return dict(lines=lines, mismatch=mismatch, ms=ms,
                inputs=dict(table=t2, t_hl=t_hl, lins=lins))


def main() -> None:
    for line in run()["lines"]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
