#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one flushed line; any failure raises, exit non-zero):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA kernel of the path with nvcc (in parallel)
  3. scene    the reference's 256^3 sphere and its directional shadow volume
  4. frame    1920x1080 frames at the bench pose through render_fast_frame,
              with every kernel's launch count read around the run; the
              frame must hold lit, shadowed and background pixels, and a
              small frame on the card must agree with the same frame on
              the CPU (plain versions)
  5. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes, for three poses
  6. timing   frame ms, Mrays/s, and each kernel's time beside its bound
  7. lines    the kernels JSON line, the nvidia-smi line, and last the
              {"ok": true, "device": {...}} line

Imports nothing of JAX or of the JAX package. Without a CUDA device, or
without the port package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()

WIDTH, HEIGHT = 1920, 1080
SPHERE_DIM = 256
TO_LIGHT = (0.5, 0.9, 0.4)
N_FRAMES = 20
# The H100 SXM's published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# f32 operations per pixel in warp_frame.cu, counted from the source
# (ray 20, plane + texel 13, depth 12, normal 3x16 + 1, Lambert 5, colour 18)
WARP_OPS_PER_PIXEL = 117
MATCH_TOL = 1.5 / 255.0
MATCH_SHARE = 0.995


def log(phase: str, msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:6.1f}s] {phase}: {msg}",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def frame_classes(img):
    """(lit, shadowed, background) pixel counts of an rgba frame rendered
    with the default ambient 0.1 (quantized to 26/255)."""
    rgb = img[..., :3]
    mx = rgb.amax(-1)
    amb = 26 / 255.0   # int(0.1 * 255 + 0.5)
    background = mx == 0
    shadowed = (rgb - amb).abs().amax(-1) < 1e-6
    lit = ~background & ~shadowed
    return int(lit.sum()), int(shadowed.sum()), int(background.sum())


def rgb_agreement(a, b):
    """Share of pixels within MATCH_TOL on every channel, and the max
    abs channel difference, of two packed int32 frames."""
    from ray_tracing_octrees_tpu_torch.trace.warp_kernel import unpack_frame_rgb

    h, w = a.shape
    ua = unpack_frame_rgb(a, w, h)
    ub = unpack_frame_rgb(b, w, h)
    diff = (ua - ub).abs().amax(-1)
    return (float((diff <= MATCH_TOL).float().mean()),
            float(diff.max()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from ray_tracing_octrees_tpu_torch.core.grid import (
            building_center, make_sphere_grid,
        )
        from ray_tracing_octrees_tpu_torch.render.camera import Camera
        from ray_tracing_octrees_tpu_torch.trace import _build, slab_sweep
        from ray_tracing_octrees_tpu_torch.trace import warp_kernel
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 1

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    # 2. build: one nvcc per kernel source, all started together
    t = time.perf_counter()
    kernels = ["warp_frame"]
    _build.build(kernels)
    log("build", f"{kernels} in {time.perf_counter() - t:.2f} s wall; "
        + ", ".join(f"{k} {s:.2f} s" for k, s in _build.BUILD_SECONDS.items()))
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name} ptxas: {line.strip()}")

    # 3. scene
    t = time.perf_counter()
    grid = make_sphere_grid(SPHERE_DIM, device=dev)
    vol = (grid.occ > 0).to(torch.float32)
    shadow = slab_sweep.shadow_volume(vol, TO_LIGHT, device=dev)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t
    origin = grid.origin.cpu().numpy()
    vox = float(grid.voxel_size.cpu())
    extent = float((grid.world_max - grid.world_min).max().cpu())
    center = building_center(grid)
    log("scene", f"sphere {SPHERE_DIM}^3, shadow volume "
        f"{tuple(shadow.shape)} in {scene_s:.2f} s (build + first use); "
        f"shadowed share {float((shadow > 0.5).float().mean()):.4f}")

    light_dir = tuple(-c for c in TO_LIGHT)
    aspect = WIDTH / HEIGHT
    layouts = slab_sweep.SweepLayouts(vol, shadow)

    def bench_camera():
        cam = Camera(theta=0.9, phi=0.8, radius=0.75 * extent)
        cam.set_target(center)
        return cam

    def frame(cam):
        return slab_sweep.render_fast_frame(
            vol, shadow, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
            aspect, WIDTH, HEIGHT, light_dir=light_dir, layouts=layouts,
            device=dev)

    # 4. frame: the main path, with the launch counts read around it
    cam = bench_camera()
    warp_kernel.warp_frame.launches = 0
    img = frame(cam)
    torch.cuda.synchronize()
    windows, enqueue = [], []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(N_FRAMES):
            cam.phi += 1e-4
            img_last = frame(cam)
        enqueue.append((time.perf_counter() - t) / N_FRAMES * 1e3)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t) / N_FRAMES * 1e3)
    launches = {"warp_frame": warp_kernel.warp_frame.launches}
    n_main = 1 + 3 * N_FRAMES
    log("frame", f"{n_main} frames at {WIDTH}x{HEIGHT}; launches {launches}")
    if launches["warp_frame"] < n_main:
        raise RuntimeError(f"warp_frame launched {launches['warp_frame']} "
                           f"times in {n_main} frames")
    if tuple(img.shape) != (HEIGHT, WIDTH, 4) or not bool(
            torch.isfinite(img).all()):
        raise RuntimeError(f"bad frame {tuple(img.shape)}")
    lit, shadowed, background = frame_classes(img)
    log("frame", f"lit {lit}, shadowed {shadowed}, background {background} px")
    if min(lit, shadowed, background) == 0:
        raise RuntimeError("the frame lacks lit, shadowed or background pixels")
    if not bool((img_last[..., 3] == 1).all()):
        raise RuntimeError("bad alpha in the last timed frame")

    # small frame on the card against the same frame on the CPU
    small = make_sphere_grid(32, device="cpu")
    svol = (small.occ > 0).to(torch.float32)
    ssh = slab_sweep.shadow_volume(svol, TO_LIGHT, device="cpu")
    scam = Camera(theta=0.5, phi=0.8, radius=2.2)
    sargs = (small.origin.numpy(), float(small.voxel_size), scam.get_pos(),
             scam.get_view(), 45.0, 4.0, 256, 64)
    skw = dict(light_dir=light_dir, inter_h=256, inter_w=256)
    s_cpu = slab_sweep.render_fast_frame(svol, ssh, *sargs, **skw,
                                         device="cpu")
    s_gpu = slab_sweep.render_fast_frame(
        svol.to(dev), slab_sweep.shadow_volume(svol.to(dev), TO_LIGHT,
                                               device=dev),
        *sargs, **skw, device=dev).cpu()
    s_share = float(((s_gpu - s_cpu).abs().amax(-1) <= MATCH_TOL)
                    .float().mean())
    s_exact = float((s_gpu == s_cpu).all(-1).float().mean())
    log("frame", f"32^3 sphere 256x64, card vs CPU: {s_share:.6f} within "
        f"1.5/255, {s_exact:.6f} equal")
    if s_share <= MATCH_SHARE:
        raise RuntimeError("the card's frame disagrees with the CPU's")

    # 5. kernels against their plain versions, three poses at full size
    poses = {
        "bench": bench_camera(),
        # from below: the sweep runs the other way (flip differs from bench)
        "opposite": Camera(theta=-0.9, phi=0.8 + 3.14159,
                           radius=0.75 * extent, target=center.copy()),
        "interior": Camera(theta=0.05, phi=0.1, radius=0.05,
                           target=center + [0.0, 0.0, 0.3]),
    }
    checks = {}
    tables = {}
    for name, pc in poses.items():
        table, kscal, axis_world, has_sh = slab_sweep._frame_table(
            vol, shadow, origin, vox, pc.get_pos(), pc.get_view(), 45.0,
            aspect, light_dir, layouts=layouts, device=dev)
        tables[name] = (table, kscal, axis_world, has_sh)
        flip = slab_sweep._sweep_geometry(vol.shape, origin, vox,
                                          pc.get_pos(), pc.get_view())[1]
        out = warp_kernel.warp_frame(table, kscal, axis_world, WIDTH, HEIGHT,
                                     has_sh)
        ref = warp_kernel.warp_frame_reference(table, kscal, axis_world,
                                               WIDTH, HEIGHT, has_sh)
        torch.cuda.synchronize()
        bitwise = float((out == ref).float().mean())
        share, max_err = rgb_agreement(out, ref)
        hit = float((table >= 0).float().mean())
        checks[name] = (bitwise, share, max_err)
        log("kernels", f"warp_frame {name} pose (axis {axis_world}, flip "
            f"{flip}, table "
            f"{tuple(table.shape)}, hit texels {hit:.4f}): bitwise "
            f"{bitwise:.6f}, within 1.5/255 {share:.6f}, max abs err "
            f"{max_err:.6f}")
    if any(share <= MATCH_SHARE for _, share, _ in checks.values()):
        raise RuntimeError(f"warp_frame disagrees with its plain version: "
                           f"{checks}")

    # 6. timing
    frame_ms = min(windows)
    mrays = 2 * WIDTH * HEIGHT / (frame_ms / 1e3) / 1e6
    table, kscal, axis_world, has_sh = tables["bench"]
    warp_ms = cuda_ms(lambda: warp_kernel.warp_frame(
        table, kscal, axis_world, WIDTH, HEIGHT, has_sh), 200)
    plain_ms = cuda_ms(lambda: warp_kernel.warp_frame_reference(
        table, kscal, axis_world, WIDTH, HEIGHT, has_sh), 20)
    cam = bench_camera()
    sweep_ms = cuda_ms(lambda: slab_sweep._frame_table(
        vol, shadow, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
        aspect, light_dir, layouts=layouts, device=dev), 10)
    t = time.perf_counter()
    slab_sweep.shadow_volume(vol, TO_LIGHT, device=dev)
    torch.cuda.synchronize()
    shadow_s = time.perf_counter() - t
    bytes_moved = table.numel() * 4 + 35 * 4 + WIDTH * HEIGHT * 4
    ops = WARP_OPS_PER_PIXEL * WIDTH * HEIGHT
    bound_bytes_ms = bytes_moved / PEAK_BYTES_S * 1e3
    bound_ops_ms = ops / PEAK_F32_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    log("timing", f"[{smi}] frame {frame_ms:.3f} ms (best of 3 windows of "
        f"{N_FRAMES}: {', '.join(f'{w:.3f}' for w in windows)}), "
        f"{mrays:.1f} Mrays/s (2 rays per pixel); host enqueue "
        f"{', '.join(f'{e:.3f}' for e in enqueue)} ms per frame")
    log("timing", f"[{smi}] warp_frame kernel {warp_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us (bytes "
        f"{bound_bytes_ms * 1e3:.2f} us, f32 ops {bound_ops_ms * 1e3:.2f} us); "
        f"sweep + pack {sweep_ms:.3f} ms; shadow volume {shadow_s:.3f} s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 7. lines
    record = {"kernels": [{
        "name": "warp_frame",
        "route": "cuda",
        "source": "ray_tracing_octrees_tpu_torch/trace/csrc/warp_frame.cu",
        "replaces": "ray_tracing_octrees_tpu/trace/warp_kernel.py:309",
        "launches": launches["warp_frame"],
        "launches_per_frame": launches["warp_frame"] / n_main,
        "max_abs_err": max(e for _, _, e in checks.values()),
        "bitwise_share": {k: b for k, (b, _, _) in checks.items()},
        "match_bar": "share of pixels within 1.5/255 on every channel > 0.995",
        "match_share": {k: s for k, (_, s, _) in checks.items()},
        "match_ok": True,
        "ms": warp_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": None,
    }], "frame_ms": frame_ms, "mrays_per_s": mrays, "sweep_ms": sweep_ms,
        "card": smi}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
