"""Second tuning round of the grouped one-hot warp: the port of
``tools/exp_warp_tune2.py``.

On the TPU ``warp_slim`` summed the per-group hi and lo products into a
``[P, win]`` scratch and ``warp_persel`` applied the select per group
into a ``[ty, tx]`` accumulator. Both give the values of
:func:`~ray_tracing_octrees_tpu_torch.tools.exp_warp_tune.warp`: the
window rule on ``ty x tx`` tiles. Each launches kernel 1 of
``trace/csrc/exp_warp.cu`` on CUDA tensors, with its own launch count,
and runs the plain version on CPU tensors.

    python -m ray_tracing_octrees_tpu_torch.tools.exp_warp_tune2
"""

from __future__ import annotations

import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.tools import device_line, event_ms
from ray_tracing_octrees_tpu_torch.tools.exp_onehot_warp import (
    onehot_kernel, split_hi_lo,
)
from ray_tracing_octrees_tpu_torch.tools.exp_warp_tune import (
    synthetic_inputs, warp as warp_ctrl,
)


warp_slim = onehot_kernel("warp_slim")
warp_persel = onehot_kernel("warp_persel")
warp_slim_reference = warp_slim.reference
warp_persel_reference = warp_persel.reference


# (name, ty, tx, win), the experiment's list; "ctrl" is exp_warp_tune.warp
CONFIGS = [
    ("ctrl", 32, 128, 128),
    ("slim", 32, 128, 128),
    ("slim", 16, 128, 64),
    ("persel", 32, 128, 128),
    ("persel", 16, 128, 64),
]
_FNS = {"ctrl": warp_ctrl, "slim": warp_slim, "persel": warp_persel}


def run(device: DeviceLike = None, height: int = 1088,
        width: int = 1920) -> dict:
    """The experiment's ``main()`` on ``exp_warp_tune``'s seeded fields:
    each config's mismatch share against the direct gather and (on CUDA)
    its time beside one ``torch.take``."""
    dev = resolve_device(device)
    t2_np, lin_nps = synthetic_inputs(height, width)
    t2 = torch.as_tensor(t2_np, device=dev)
    t_hl = split_hi_lo(t2)
    lins = [torch.as_tensor(x, device=dev) for x in lin_nps]
    ref = torch.take(t2, lins[0].long())
    lines, mismatch, ms = [], {}, {}
    for name, ty, tx, win in CONFIGS:
        if width % tx or height % ty:
            continue
        fn = _FNS[name]
        key = f"{name:6s} tile({ty:2d},{tx:3d}) win={win:3d}"
        mismatch[key] = float((fn(t_hl, lins[0], ty, tx, win)
                               != ref).float().mean())
        line = f"{key}: mismatch={mismatch[key]:.7f}"
        if dev.type == "cuda":
            ms[key] = event_ms(lambda k: fn(t_hl, lins[k % 4], ty, tx, win))
            line += f"  {ms[key]:8.4f} ms (CUDA events)"
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
