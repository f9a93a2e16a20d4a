"""Where a frame's device time goes, on the card.

    python -m ray_tracing_octrees_tpu_torch.profile_frame

Renders the bench cell (the 256^3 sphere with its shadow volume, 1920x1080,
the bench pose stepped by phi += 1e-4 per frame) under ``torch.profiler``
and prints, per frame: the wall time, the host's enqueue time, the device
time summed over every kernel, the device's idle share of the window, and
the kernels that take the most device time, grouped by stage. Needs a CUDA
device.
"""

from __future__ import annotations

import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tracing_octrees_tpu_torch.core.grid import (
    building_center, make_sphere_grid,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import slab_sweep

W, H, N = 1920, 1080, 10


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _stage(name: str) -> str:
    n = name.lower()
    if "warp_frame" in n:
        return "warp_frame kernel"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "sm90", "xmma")):
        return "sweep products (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "elementwise / reductions"


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    grid = make_sphere_grid(256, device=dev)
    vol = (grid.occ > 0).to(torch.float32)
    to_light = (0.5, 0.9, 0.4)
    shadow = slab_sweep.shadow_volume(vol, to_light, device=dev)
    origin = grid.origin.cpu().numpy()
    vox = float(grid.voxel_size.cpu())
    extent = float((grid.world_max - grid.world_min).max().cpu())
    cam = Camera(theta=0.9, phi=0.8, radius=0.75 * extent)
    cam.set_target(building_center(grid))
    layouts = slab_sweep.SweepLayouts(vol, shadow)

    def frame():
        cam.phi += 1e-4
        return slab_sweep.render_fast_frame(
            vol, shadow, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
            W / H, W, H, light_dir=tuple(-c for c in to_light),
            layouts=layouts, device=dev)

    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N):
            frame()
        t_enq = time.perf_counter() - t0
        torch.cuda.synchronize()
        t_wall = time.perf_counter() - t0
    # the kernels themselves (CPU-side ops also carry their kernels' time)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and _device_us(e) > 0]
    print(f"card: {smi}")
    if not events:
        print(f"frames {N}: wall {t_wall / N * 1e3:.3f} ms/frame; the "
              "profiler recorded no device time: not measured")
        return
    busy_us = sum(_device_us(e) for e in events)
    wall_us = t_wall * 1e6
    print(f"frames {N} at {W}x{H}: wall {t_wall / N * 1e3:.3f} ms/frame "
          f"(profiler on), host enqueue {t_enq / N * 1e3:.3f} ms/frame, "
          f"device busy {busy_us / N / 1e3:.3f} ms/frame, idle share "
          f"{max(0.0, 1 - busy_us / wall_us):.3f}")
    stages = {}
    for e in events:
        k = _stage(e.key)
        stages[k] = stages.get(k, 0.0) + _device_us(e)
    for k, us in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  stage {k:28s} {us / N / 1e3:8.3f} ms/frame "
              f"({us / busy_us:.1%} of device time)")
    for e in sorted(events, key=lambda e: -_device_us(e))[:12]:
        print(f"  {_device_us(e) / N / 1e3:8.3f} ms/frame  {e.count / N:6.1f} "
              f"calls/frame  {e.key[:90]}")


if __name__ == "__main__":
    main()
