"""Measure what FMA contraction does to the warp_frame kernel, on the card.

    python -m ray_tracing_octrees_tpu_torch.trace.fmad_check

Builds ``csrc/warp_frame.cu`` twice, with the shipped flags
(``-fmad=false``) and with nvcc's default contraction (``-fmad=true``),
and runs both on the sweep tables of three 1920x1080 poses of the 256^3
sphere against the plain PyTorch version. Prints, per build and pose, the
share of packed pixels bitwise equal to the plain version, the share
within 1.5/255 on every channel, and the kernel's time (CUDA events).
Needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import torch

from ray_tracing_octrees_tpu_torch.core.grid import (
    building_center, make_sphere_grid,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import _build, slab_sweep, warp_kernel


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    W, H = 1920, 1080
    flags_fma = tuple("-fmad=true" if f == "-fmad=false" else f
                      for f in _build.NVCC_FLAGS)
    libs = {"fmad=false": _build.load("warp_frame"),
            "fmad=true": _build.load("warp_frame", flags_fma)}
    grid = make_sphere_grid(256, device=dev)
    vol = (grid.occ > 0).to(torch.float32)
    to_light = (0.5, 0.9, 0.4)
    shadow = slab_sweep.shadow_volume(vol, to_light, device=dev)
    origin = grid.origin.cpu().numpy()
    vox = float(grid.voxel_size.cpu())
    center = building_center(grid)
    layouts = slab_sweep.SweepLayouts(vol, shadow)
    poses = {
        "bench": Camera(theta=0.9, phi=0.8, radius=0.75, target=center.copy()),
        "opposite": Camera(theta=-0.9, phi=0.8 + 3.14159, radius=0.75,
                           target=center.copy()),
        "interior": Camera(theta=0.05, phi=0.1, radius=0.05,
                           target=center + [0.0, 0.0, 0.3]),
    }
    print(f"card: {smi}")
    for pname, cam in poses.items():
        table, kscal, aw, hs = slab_sweep._frame_table(
            vol, shadow, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
            W / H, tuple(-c for c in to_light), layouts=layouts, device=dev)
        ks = warp_kernel._check(table, kscal, aw, W, H)
        ref = warp_kernel.warp_frame_reference(table, kscal, aw, W, H, hs)
        ref_rgb = warp_kernel.unpack_frame_rgb(ref, W, H)
        for lname, lib in libs.items():
            run = lambda: warp_kernel._launch(lib, table, ks, aw, W, H, hs)
            out = run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / 200
            bitwise = float((out == ref).float().mean())
            diff = (warp_kernel.unpack_frame_rgb(out, W, H) - ref_rgb).abs()
            close = float((diff.amax(-1) <= 1.5 / 255).float().mean())
            print(f"{pname:8s} {lname:10s} bitwise {bitwise:.6f} "
                  f"within 1.5/255 {close:.6f} differing px "
                  f"{int((out != ref).sum())} kernel {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
