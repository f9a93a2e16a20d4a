"""Ablations of the one-hot warp: the port of ``tools/exp_warp_ablate.py``.

The experiment stripped the one-hot kernel down to find its per-tile
cost. Each ablation keeps the grid and specs of the real kernel (8 x 128
tiles, a 64-row window) and writes a value that is not an image. With
``umin`` and ``rel_u = clip(iu - umin, 0, 63)`` as in
:mod:`~ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp`, and -1 where
``lin < 0`` for every kind but ``null``:

- ``null`` writes 0;
- ``intops`` writes ``f32(rel_u + iv + umin)``;
- ``twload`` writes ``f32(hi[umin, x mod 128]) + f32(rel_u)``, the lane's
  column of the window's first hi row;
- ``select`` writes ``3 iv``.

``make_call(kind)`` returns that kind's wrapper, which launches kernel 2
of ``trace/csrc/exp_warp.cu`` on CUDA tensors and runs
:func:`ablate_reference` on CPU ones. The experiment's "full" variant is
``exp_onehot_warp.onehot_warp_grouped`` at ``win`` 64.

    python -m ray_tracing_octrees_tpu_torch.tools.exp_warp_ablate
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.tools import (
    device_line, event_ms, kernel_wrapper, valid_mismatch,
)
from ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp import (
    TH, TW, check_onehot, onehot_warp_grouped, split_hi_lo, window_rows,
)
from ray_tracing_octrees_tpu_torch.trace import exp_warp

WIN = 64
KINDS = ("null", "intops", "twload", "select")   # kernel 2's kind 0-3


def _ablate(t_hl, lin2d, kind):
    """Plain PyTorch version of ablation ``kind``, unchecked."""
    if kind == "null":
        return torch.zeros(lin2d.shape, dtype=torch.float32,
                           device=lin2d.device)
    invalid, _, iv, umin, rel_u = window_rows(lin2d, 8, 128, WIN)
    if kind == "intops":
        val = (rel_u + iv + umin).to(torch.float32)
    elif kind == "twload":
        lane = torch.arange(lin2d.shape[1], device=lin2d.device) % 128
        first = torch.take(t_hl[:TH], (umin * TW + lane).long())
        val = first.to(torch.float32) + rel_u.to(torch.float32)
    else:
        val = (3 * iv).to(torch.float32)
    return torch.where(invalid, -1.0, val)


def _wrapper(kind: str):
    def check(t_hl: torch.Tensor, lin2d: torch.Tensor):
        check_onehot(t_hl, lin2d, 8, 128, WIN)
        return t_hl, lin2d, kind

    return kernel_wrapper(
        f"ablate_{kind}", check, _ablate,
        lambda t_hl, lin2d, k: exp_warp.ablate(t_hl, lin2d, KINDS.index(k)),
        f"Ablation {kind!r}: bf16 t_hl [2 TH, TW], int32 lin2d [H, W] "
        f"(H % 8, W % 128) -> f32 [H, W].")


_CALLS = {kind: _wrapper(kind) for kind in KINDS}


def make_call(kind: str):
    """The wrapper of ablation ``kind`` (one per kind, with its own launch
    count ``make_call(kind).launches``)."""
    if kind not in _CALLS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return _CALLS[kind]


def ablate_reference(t_hl: torch.Tensor, lin2d: torch.Tensor,
                     kind: str) -> torch.Tensor:
    """Plain PyTorch version of ablation ``kind``, on the inputs' device."""
    return make_call(kind).reference(t_hl, lin2d)


def synthetic_inputs(height: int = 1088, width: int = 1920,
                     n: int = 4) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The experiment's seeded fields: a uniform(0, 512) f32 table (not
    rounded, so its hi/lo split is not exact) and ``n`` int32 ``lin``
    fields whose ``iu`` spans ~53 rows per 8 x 128 tile."""
    rng = np.random.default_rng(0)
    t2 = rng.uniform(0, 512, (TH, TW)).astype(np.float32)
    lins = []
    for k in range(n):
        base_u = rng.integers(0, TH - 60)
        iu = np.clip(base_u + (np.arange(height)[:, None] // 24) % 50
                     + rng.integers(0, 4, (height, width)), 0, TH - 1)
        iv = np.clip((np.arange(width)[None, :] // 2 + k * 7) % TW
                     + rng.integers(0, 4, (height, width)), 0, TW - 1)
        lins.append((iu * TW + iv).astype(np.int32))
    return t2, lins


def run(device: DeviceLike = None, height: int = 1088,
        width: int = 1920) -> dict:
    """The experiment's ``main()``: the four ablations and the full grouped
    kernel on the seeded fields, with (on CUDA) each one's time."""
    dev = resolve_device(device)
    t2_np, lin_nps = synthetic_inputs(height, width)
    t2 = torch.as_tensor(t2_np, device=dev)
    t_hl = split_hi_lo(t2)
    lins = [torch.as_tensor(x, device=dev) for x in lin_nps]
    hl = t_hl.to(torch.float32)
    exact = float((hl[:TH] + hl[TH:] == t2).float().mean())
    full = onehot_warp_grouped(t_hl, lins[0], WIN)
    mm = valid_mismatch(full, t2, lins[0])
    lines = [f"hi/lo split exact share {exact:.7f}",
             f"full grouped w64: mismatch on valid pixels = {mm:.7f}"]
    variants = [(kind, make_call(kind)) for kind in KINDS] + [
        ("full grouped w64", lambda t, l: onehot_warp_grouped(t, l, WIN))]
    ms = {}
    for name, fn in variants:
        out = fn(t_hl, lins[0])
        if out.shape != lins[0].shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: bad output")
        if dev.type == "cuda":
            ms[name] = event_ms(lambda k: fn(t_hl, lins[k % 4]))
            lines.append(f"{name:18s} {ms[name]:8.4f} ms (CUDA events)")
    if dev.type == "cuda":
        flat = lins[0].reshape(-1).long()
        ms["torch.take"] = event_ms(lambda k: torch.take(t2, flat))
        lines.append(f"{'torch.take':18s} {ms['torch.take']:8.4f} ms "
                     f"(CUDA events)")
    lines.append(device_line(dev))
    return dict(lines=lines, hi_lo_exact_share=exact,
                mismatch={"full grouped w64": mm}, ms=ms,
                inputs=dict(table=t2, t_hl=t_hl, lins=lins))


def main() -> None:
    for line in run()["lines"]:
        print(line, flush=True)


if __name__ == "__main__":
    main()
