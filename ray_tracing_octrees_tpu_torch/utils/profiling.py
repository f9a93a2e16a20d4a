"""Profiling: stage timers, an FPS counter and a throughput registry.

Counterpart of ``ray_tracing_octrees_tpu/utils/profiling.py``, the
upgrade of the reference's inline chrono instrumentation (octree-traversal
ms and triangle counts at main.cpp:194-199, per-second FPS prints at
main.cpp:1415-1431): a stage given ``sync`` tensors waits for their CUDA
device before reading the clock, so it times device work; without it the
stage times the host. Rays/s and triangles/s come from ``items``.
``StageTimer(trace_dir=...)`` labels each stage in ``torch.profiler``
traces with ``record_function``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    items: float = 0.0  # rays, triangles, voxels...

    @property
    def mean_ms(self) -> float:
        return self.total_s / max(self.calls, 1) * 1e3

    @property
    def rate(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else 0.0


def _synchronize(sync) -> None:
    """Wait for the CUDA devices of the tensors in ``sync`` (a tensor or a
    nest of lists, tuples and dicts of them); others need no wait."""
    devices = set()

    def visit(x):
        if torch.is_tensor(x):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(sync)
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Named stage timing with an optional device wait and profiler labels."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.stats: Dict[str, StageStats] = defaultdict(StageStats)
        self._trace_dir = trace_dir

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0, sync=None):
        ctx = (
            torch.profiler.record_function(name)
            if self._trace_dir
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with ctx:
            yield
            if sync is not None:
                _synchronize(sync)
        dt = time.perf_counter() - t0
        s = self.stats[name]
        s.calls += 1
        s.total_s += dt
        s.items += items

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            rate = f"  {s.rate / 1e6:.2f} M/s" if s.items else ""
            lines.append(f"{name}: {s.mean_ms:.2f} ms x{s.calls}{rate}")
        return "\n".join(lines)


class FrameProfiler:
    """Once-per-second FPS + mode reporting (main.cpp:1415-1431)."""

    def __init__(self, log=print):
        self._log = log
        self._count = 0
        self._last = time.perf_counter()
        self.fps = 0.0

    def tick(self, mode: str = "") -> Optional[float]:
        self._count += 1
        now = time.perf_counter()
        if now - self._last >= 1.0:
            self.fps = self._count / (now - self._last)
            self._log(f"FPS: {self.fps:.1f}  mode: {mode}")
            self._count = 0
            self._last = now
            return self.fps
        return None
