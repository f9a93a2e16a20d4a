"""Ports of the retired TPU warp experiments under ``tools/``.

One module per experiment, with the experiment's file name and public
names: ``exp_onehot_warp``, ``exp_warp_ablate``, ``exp_warp_tune``,
``exp_warp_tune2``, ``exp_warp_kernel`` and ``exp_warp2pass``. Each
wrapper of a TPU kernel runs its plain PyTorch version on CPU tensors and
launches one of the four CUDA kernels of ``trace/csrc/exp_warp.cu`` on
CUDA tensors, counting the launch on the wrapper (``fn.launches``). Each
module's ``run(device=None)`` is the experiment's ``main()`` on the card
(``device="cpu"`` runs the plain versions and times nothing), and
``python -m ray_tracing_octrees_tpu_torch.tools.<module>`` prints its
lines.

This module holds what the experiments share: the wrapper factory, the
per-tile min of an index field, the mismatch share against the direct
gather, and the CUDA event timer.
"""

from __future__ import annotations

from typing import Callable

import torch


def kernel_wrapper(name: str, check: Callable, plain: Callable,
                   launch: Callable, doc: str):
    """The public wrapper ``name(*args, **kw)`` of one CUDA kernel.

    ``check(*args, **kw)`` validates the caller's arguments and returns
    the kernel's own, a tensor first, all tensors on one device. On CPU
    tensors the wrapper returns ``plain(*kernel_args)``; on CUDA tensors
    it returns ``launch(*kernel_args)`` and adds one to
    ``wrapper.launches``, where the kernel is launched and nowhere else.
    ``wrapper.reference`` is the checked plain version, on any device.
    """

    def wrapper(*args, **kw):
        kargs = check(*args, **kw)
        if kargs[0].device.type == "cpu":
            return plain(*kargs)
        out = launch(*kargs)
        wrapper.launches += 1
        return out

    def reference(*args, **kw):
        return plain(*check(*args, **kw))

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    reference.__name__ = reference.__qualname__ = f"{name}_reference"
    reference.__doc__ = f"Plain PyTorch version of :func:`{name}`."
    wrapper.reference = reference
    wrapper.launches = 0   # kernel launches, counted where they happen
    return wrapper


def tile_min(x: torch.Tensor, ty: int, tx: int) -> torch.Tensor:
    """The min of each ``ty x tx`` tile of ``x`` [H, W], broadcast back to
    every pixel of the tile (H % ty == 0 and W % tx == 0)."""
    h, w = x.shape
    m = x.reshape(h // ty, ty, w // tx, tx).amin(dim=(1, 3), keepdim=True)
    return m.expand(h // ty, ty, w // tx, tx).reshape(h, w)


def check_index(name: str, x: torch.Tensor, ty: int = 1, tx: int = 1):
    """``x`` must be a contiguous int32 [H, W] tensor on the CPU or a CUDA
    device, with H % ty == 0 and W % tx == 0."""
    if not torch.is_tensor(x) or x.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor, got "
                        f"{getattr(x, 'dtype', type(x))}")
    if x.ndim != 2 or x.shape[0] % ty or x.shape[1] % tx:
        raise ValueError(f"{name} must be [H, W] with H % {ty} == 0 and "
                         f"W % {tx} == 0, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def check_table(name: str, t: torch.Tensor, dtype: torch.dtype, like):
    """``t`` must be a contiguous 2-D ``dtype`` tensor on ``like``'s
    device."""
    if not torch.is_tensor(t) or t.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                         f"{tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, indices on {like.device}")


def valid_mismatch(out: torch.Tensor, table: torch.Tensor,
                   lin: torch.Tensor) -> float:
    """Share of valid pixels (``lin >= 0``, ``lin = iu * TW + iv``) where
    ``out`` differs from the direct gather ``table.flatten()[lin]``."""
    valid = lin >= 0
    ref = torch.take(table, torch.where(valid, lin, 0).long())
    return float((out != ref)[valid].float().mean())


def event_ms(fn: Callable[[int], object], iters: int = 20,
             windows: int = 3) -> float:
    """Device time of one ``fn(k)`` call by CUDA events: the best of
    ``windows`` windows of ``iters`` back-to-back calls (``k`` counts the
    calls, so a caller can vary its inputs), after ``iters // 4 + 1``
    calls that warm the card's clocks and caches."""
    for k in range(iters // 4 + 1):
        fn(k)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(iters):
            fn(k)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_line(dev: torch.device) -> str:
    """The run's device: its name and the number of cards."""
    if dev.type == "cuda":
        return (f"device: {torch.cuda.get_device_name(dev)} "
                f"(count {torch.cuda.device_count()})")
    return "device: cpu (plain versions; no time is measured)"
