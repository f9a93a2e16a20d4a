#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one flushed line; any failure raises, exit non-zero):
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA kernel of the paths with nvcc (one process
              per source, all started together); print each kernel's
              registers, spills and stack frame (ptxas -v); refuse a spill
              or a stack frame in any source
  3. scene    the reference's 256^3 sphere and its directional shadow volume
  4. frame    1920x1080 frames at the bench pose through render_fast_frame,
              with every kernel's launch count read around the run; the
              frame must hold lit, shadowed and background pixels, and a
              small frame on the card must agree with the same frame on
              the CPU (plain versions)
  5. kernels  warp_frame against its plain PyTorch version on the card,
              bitwise, at the main path's shapes for three poses, and in
              every instantiation (sweep axis x shadow flag x multiplying
              by vox's exact reciprocal or dividing, forced on the bench
              pose's table) at 1920x1080 and at a width that is not a
              multiple of 4
  6. timing   frame ms, Mrays/s, and warp_frame's time beside its bound and
              beside its instantiation that divides by vox (in turns); the
              bound counts the operations each pixel's class runs (the
              class-weighted count) at the f32 rate without FMA
  7. first hit  sweep_first_hit at 1920x1080 and the bench pose, its
              launch counts read around the run
  8. exact    1920x1080 frames of render_fast_exact_frame with the shadow
              volume at the bench angles and radius 2.0 x extent (the
              headline radius is outside the exact envelope), launch
              counts read around the run; overflow 0, lit, shadowed and
              background pixels, ms per frame split into cube sweep,
              per-pixel resolve and fallback
  9. parity   hit mismatch and depth RMS (voxels) against the port's DDA
              oracle trace_octree on the card: sweep_first_hit at 240x136
              (bench pose, the headline's aspect, as bench.py's parity
              line), fast_exact_first_hit at 480x270 (radius 2.0),
              where every mismatch must be a grazing crossing; then both
              on the 32^3 sphere on the card and on the CPU, which must
              give equal hit masks and equal t
  10. lookups warp_lookup on sweep_first_hit's 1024^2 table and 1080p lin
              and on edge fields made from it (a view at a 4-byte offset, a
              pixel count not a multiple of 4, all and no misses), each
              launching the forms lookup_forms chooses (a ragged field:
              the vector form, then the general form for its last 1-3
              pixels) and timed warm; warp_lookup_multi on
              the exact frame's three planes at both radius-2.0 poses; each
              bitwise against its plain version; their times warm and cold
              (N_COLD copies of lin) beside the byte bound, the plain
              version and one torch.take of the decoded index (warm and
              cold), and warp_lookup's bodies in turns: the first port's
              (the multi-plane kernel at one plane) and the vector form
  11. experiments  the six warp experiments' drivers (tools/exp_*warp*),
              each run("cuda") once at 1920x1088 with every launch count
              set to 0 before it and read after it; then every wrapper of
              csrc/exp_warp.cu bitwise (f32 bit patterns) against its plain
              version on the drivers' inputs and on seeded edge fields
              (windows that clamp, all-invalid tiles, H % 128 != 0 for the
              two-pass warp, index fields at a storage offset, a tile of
              no instantiation, 45 tiles); each row's kernel ms beside its
              byte bound, its plain version and one torch.take of the flat
              index, warm (the same inputs back to back) and cold (rotating
              through N_COLD copies of the index fields, over twice the
              50 MB L2, so each launch finds them in device memory); the
              launches of kernels 1, 3 and 4 by form on the drivers' inputs
              and on each edge set; kernel 4's forms timed in turns, warm
              and cold, and each pass of the two-pass warp beside its own
              bound
  12. bench   the port's bench (ray_tracing_octrees_tpu_torch/bench.py main,
              at its defaults) with the frame kernels' launch counts set to
              0 before it and read after it: its one short line, its
              record's sections (headline, parity line equal to phase 9's,
              the exact section, which must take the DDA ladder at the
              headline pose, the 16-pose ensemble)
  13. dda     the DDA frame of the JAX bench's exact section
              (render_octree_image over the leaf volume with sweep_seed's
              seeds and ball skipping) at 1920x1088 with shadows at the
              bench pose: ms per frame, the primary rays' steps (median,
              largest), compactions and host syncs per frame, the
              device-busy share under torch.profiler
  14. dda parity  the same trace's hit mask at 240x136 (the headline's
              aspect) against trace_octree, where the slope gate leaves it
              unseeded; then the seeded trace at radius 2.0 x extent: the
              seed table's warp_lookup held bitwise, its hit mask against
              trace_octree; every mismatch a grazing crossing
  15. sweep exact  render_exact_frame at 1920x1088 with shadows at the
              bench angles and radius 2.0 x extent: ms, stats (overflow
              and unresolved 0), idle share; warp_lookup launched on its
              dead test, counts set to 0 before and read after, each call
              bitwise against warp_lookup_reference on its own table and lin
  16. unfused render_fast_frame(fused=False) at 1920x1080 at the bench
              pose: warp_lookup launched and each call held bitwise, the
              image within 1.5/255 of the fused frame's, ms per frame
  17. tracer  OctreeRayTracer.render at 1920x1080 with shadows: the default
              config at both poses (the DDA at the headline radius,
              sweep-exact at 2.0), use_sweep_exact=False (the seeded DDA),
              use_fast_exact=True and fast=True, the path each took, with
              warp_frame's, warp_lookup's and warp_lookup_multi's counts set
              to 0 before and read after (each must launch), every call of
              them held bitwise against its plain version on its inputs
  18. card vs CPU  generate_rays at 128x72 made on the card and on the
              CPU, bitwise; trace_octree_fast on each device's own rays
              (hit, t, point, normal bitwise) and the sweep-exact primary
              (hit and t bitwise) on the 32^3 sphere; the host's time a
              call of view_rotation and lu_inverse beside numpy's inverse
  19. volume init  VolumeRaycastRenderer(device="cuda").init on the 256^3
              sphere, each texture pass timed (build_mip_chain,
              precompute_volume, ambient_occlusion, build_skip_distance),
              then update_indirect_lighting, one splat's
              dispatch_radiation, carve_at_screen at the frame centre
              (which must hit), the precompute it asks for and
              prepare_volume_scene; peak device memory
  20. volume frame  draw_fast at 1920x1080 at the bench pose, 3 windows of
              N_VOLUME frames: warp_lookup_multi's count set to 0 before
              and read after (it must launch), its calls in one frame kept
              and held bitwise against warp_lookup_multi_reference; lit and
              background pixels, misses black; ms (min and median of the
              windows), Mrays/s, the idle share under torch.profiler, the
              stages (layouts, sweep, ray set-up + gather, shade) by CUDA
              events
  21. volume oracle  draw at 480x272 at the same pose: ms, iterations,
              steps p50 / max, the idle share over the march's first
              ORACLE_PROFILED iterations; its hit mask must agree with
              draw_fast's at 480x272 on more than 0.92 of pixels
  22. volume card vs CPU  on the 32^3 sphere at 96x96: _volume_sweep's
              packed table and four field channels bitwise equal on the
              same inputs, draw_fast's image within 1e-4 on all but 0.5% of
              pixels, draw's hit masks equal on at least 99%
  23. linear octree  build_linear_octree on the 256^3 sphere (numpy on
              the host, then to the card): 374921 nodes and 328056 leaves,
              the JAX package's counts; its time and build_node_id_volume's;
              find_node_vol equal to find_node on every leaf corner and on
              2^16 seeded queries, some out of the cube (-1 there)
  24. extraction  at the bench pose (a 16:9 projection, the config's
              extraction margin 50), unculled and culled:
              MarchingCubesRenderer.render (493816 triangles unculled),
              VoxelBlockRenderer.render (399372), adaptive_dual_contouring
              through the node-id volume with tree_meta, rows on the card
              and on the host (228288, the two equal), and
              dual_contour_uniform on the 64^3 sphere; each one's warm ms
              (min of 3 runs), triangles/s, peak memory, DC's idle share
              under torch.profiler; every kernel's count must stay 0
              (extraction is plain PyTorch)
  25. extraction card vs CPU  on the 32^3 and 64^3 spheres: the tree and
              node-id volume, MC and blocks bitwise; adaptive DC (also
              with the non-default QEF_ALT / DC_ALT toggles) and uniform
              DC equal counts, vertices within 2e-6 and normals within 2e-4
              (the CPU tests' bars)
  26. linear tree  OctreeRayTracer.set_octree(tree=...) and update_frustum
              at the bench pose (visible_count against a recount of
              visible_node_mask, children in range or -1), then render at
              1920x1080 (fast=True at the bench pose, the default route
              at radius 2.0) with every kernel call held bitwise; the
              volume renderer's update_frustum_culling(tree=...) (voxels
              kept beside the 8^3-cell working volume's) and draw_fast at
              1920x1080 with warp_lookup_multi counted and held
  27. mesh frame  the MC mesh frame of the JAX benchmarks' config 4:
              prepare_mc_scene on the 128^3 sphere, render_mc_mesh_frame
              at 1920x1088 (1024^2 texels, max_rounds 8, tol_texels 512)
              over 3 windows of MESH_FRAMES distinct poses: ms (min and
              median), Mrays/s at 2 rays a pixel, hit fraction, rounds,
              unresolved, host syncs a frame, the idle share under
              torch.profiler, stage ms by CUDA events, peak memory;
              warp_lookup's count set to 0 before and read after (it must
              launch), one frame's calls held bitwise against
              warp_lookup_reference; lit, shadowed and background pixels;
              then one window on the 256^3 sphere, its calls held too
  28. lbvh    build_lbvh over the 128^3 sphere's 123352 MC triangles (the
              JAX package's count), trace_lbvh at 480x270 (primary, then
              shadow rays toward the light): ms, steps, syncs, hit
              fraction; the texel trace at 256^2 against the oracle on its
              own rays with tests/test_mesh_grid.py's bars
  29. ingest  the seeded city of ingest/city.py in the Calgary CSV format
              (2000 box buildings, bad lines included) through the native
              runtime:
              build, parse (equal to numpy's), assembly, voxelizer at 5 m;
              voxelize_triangles_dense on the card equal to the native grid
              bitwise, and load_csv_into_voxel_grid equal to both; then the
              recentred city's mesh frame at 1920x1088 with its
              warp_lookup calls held
  30. mesh card vs CPU  on the 32^3 sphere at 128^2 texels, three poses
              (one with the 2x2 footprint): trace_mc_mesh_texels' hit,
              case, tri, t, normal and shadow, build_lbvh's arrays,
              trace_lbvh's hit, tri and t, and a 128x128 frame bitwise
  31. app     Application(device="cuda").setup on the 256^3 sphere at
              1920x1080, each of the five modes for a cold frame and 14
              frames after orbit(5, 0): the schedule (extract + raster,
              raster, render, replay), rendered and replayed ms, the
              host copy's ms, the launches of rows 1-3 (counts set to 0
              before, read after; none on the extraction modes), one
              rendered frame with every kernel call held bitwise (the
              volume mode must launch warp_lookup_multi, the ray trace
              warp_lookup), host syncs a rendered frame, the idle share
              under torch.profiler, peak memory, the tracer's last_path;
              for the extraction modes the JAX package's triangle counts,
              the extraction ms and the rasterizer's depth, winner and
              shade passes by CUDA events
  32. app extras  the wireframe (S) in MC mode (12 x 87381 lines, the
              cap of max_lines // 12 leaves), a click at the centre in
              volume mode (it must hit, and the next rendered frame
              differ), DC twice at one pose (the second from the
              triangle cache, with an equal count)
  33. bootstrap  load_scene on the seeded city of ingest/city.py: the
              CSV route writes the cache, the second call loads it, the
              grids equal
  34. pipeline  render_fast_frames_pipelined over 20 poses of the bench
              orbit at 1920x1080 (shadows, 1024^2 table) against a loop
              of render_fast_frame(fused=False): bitwise, warp_lookup's
              calls held; ms a frame of both (best of 3 windows, in
              turns), device busy share and kernel overlap under
              torch.profiler
  35. cli     rto-render (render/app.main) for VOLUME_RAYCAST, 2 frames,
              and the demo (examples/render_demo.main), into temporary
              directories: every PNG read back with zlib at 960x540;
              rows 1-3 counted and held on both
  36. app card vs CPU  on the 32^3 sphere at 128x128: rasterize_triangles'
              image and z-buffer, octree_wireframe's segments,
              rasterize_lines over them, and one Application frame of
              each extraction mode, bitwise
  37. multichip 1 rank  the multi-device paths of parallel/ on a world-1
              NCCL group (initialize_distributed with a file:// store):
              sweep_frame_segmented and volume_frame_segmented on a ("sp",)
              mesh at 1920x1080 at the bench pose, bitwise
              render_fast_frame(fused=False) and render_volume_frame on the
              phase-19 scene, warp_lookup and warp_lookup_multi counted
              (set to 0 before, read after) and held; marching_cubes_halo
              on make_mesh(1) bitwise dense MC; trace_sharded,
              trace_shardmap, trace_segmented and render_image_sharded
              (shadows) at 480x272 bitwise trace_octree /
              render_octree_image; the four-slab trace min-combined in
              this process against the single trace; ms a frame of each
              segmented frame beside its single-device frame (best of 3
              windows, CUDA events)
  38. multichip 4 ranks  four gloo ranks spawned on the one card, on the
              same scene and pose: both segmented frames at 1920x1080,
              marching_cubes_halo with tp = 4 and trace_segmented at
              (dp, tp) = (1, 4); rank 0's outputs bitwise phase 37's
              (MC by counts and by triangles as multisets of lattice
              keys); rows 2 and 3 counted and held in every rank; rank 0's
              ms a frame (the ranks share the card: the collectives' cost)
  39. ladder  the config ladder (benchmarks.config1 ... config6 at the JAX
              ladder's sizes: MC on the 64^3 sphere, trace_octree and
              sweep_first_hit at 512x512, adaptive DC or the skipped line,
              the mesh frame and the LBVH oracle, the 3840x2160 fly-through,
              the volume frames and oracles), each config with rows 1-3's
              counts set to 0 before and read after and every call of them
              held bitwise against its plain version; each JSON row logged
              and kept; no row may carry an error; the phase's wall time
  40. entry   graft_entry.entry()'s step on the card (ms, launches) against
              the same step on the CPU, the whole image bitwise;
              dryrun_multichip(1) on a world-1 NCCL group and
              dryrun_multichip(4) on gloo ranks sharing the card, each rank
              holding its sharded and segmented frames to the one-device
              frames and reporting its launches
  41. lines   the kernels JSON line (each kernel's calls held on the
              exact tracers', the volume frame's, the linear tree's, the
              mesh frames', the app's, the pipeline's, the CLI's, the
              demo's, the segmented frames' and the ladder's paths under
              "held_on_paths"; the extraction paths' launches, all 0; the
              ladder's and the entry points' launches by path), the whole
              run's wall time, the nvidia-smi line, and last the
              {"ok": true, "device": {...}} line

Imports nothing of JAX or of the JAX package. Without a CUDA device, or
without the port package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys
import time
import timeit

T0 = time.perf_counter()

WIDTH, HEIGHT = 1920, 1080
SPHERE_DIM = 256
TO_LIGHT = (0.5, 0.9, 0.4)
N_FRAMES = 20
# The H100 SXM's published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# ... counted without FMA: the rate counts an FMA as two operations, and
# warp_frame.cu's -fmad=false build issues each operation alone
PEAK_F32_NOFMA_S = PEAK_F32_S / 2
# f32 operations per pixel in warp_frame.cu, counted from the source
# (ray 20, plane + texel 13, depth 12, normal 3x16 + 1, Lambert 5, colour 18)
WARP_OPS_PER_PIXEL = 117
# f32 operations of a pixel that stops after its texel (a miss, or a
# shadowed hit with shadows on): the ray 20 and the plane + texel 13
WARP_OPS_EARLY_EXIT = 33
# ... and of a lit pixel whose normal faces away from the light: all but
# the normal's length (6), Lambert (5) and the colour (18)
WARP_OPS_BACK_FACING = 88
# frame sizes of the instantiation checks: the store form of widths that
# are a multiple of 4, and the general form
FRAME_SIZES = ((WIDTH, HEIGHT), (WIDTH - 3, HEIGHT - 1))
# what a kernel's "ms" is: its own device time under torch.profiler, or,
# where the profiler records none, CUDA events around back-to-back calls
# of its Python wrapper (which then include the wrapper's host time)
MS_SOURCE = {True: "torch.profiler: the kernel's device time",
             False: "CUDA events over back-to-back wrapper calls"}
MATCH_TOL = 1.5 / 255.0
MATCH_SHARE = 0.995
N_EXACT = 5           # exact frames per timed window
EXACT_RADIUS = 2.0    # x extent: the bench angles inside the exact envelope
N_COLD = 16           # copies of a row's index fields in its cold timings
EW, EH = 1920, 1088   # the exact frames of phases 13 and 15 (the JAX bench's)


def log(phase: str, msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:6.1f}s] {phase}: {msg}",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, windows: int = 3) -> float:
    """Device time of one ``fn()`` call by the port's CUDA event timer
    (``tools.event_ms``): the best of ``windows`` windows of ``iters``
    back-to-back calls, after ``iters // 4 + 1`` warm-up calls."""
    from ray_tracing_octrees_tpu_torch.tools import event_ms

    return event_ms(lambda _k: fn(), iters, windows)


def distinct(flat, valid) -> int:
    """How many distinct texels the flat indices ``flat`` name where
    ``valid``: what a bound reads once, whatever a kernel reads again."""
    import torch

    return int(torch.unique(flat[valid]).numel())


def bound(nbytes: int, ops: int, ops_rate: float = PEAK_F32_S):
    """(least ms, what bounds it): ``nbytes`` at the memory rate or ``ops``
    at ``ops_rate`` (operations a second), the larger."""
    b_ms = nbytes / PEAK_BYTES_S * 1e3
    o_ms = ops / ops_rate * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def profiled(fn, iters: int):
    """(wall ms per call, {kernel name: device ms per call}) of ``iters``
    calls of ``fn()`` under ``torch.profiler``; the dict is empty when
    the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / iters * 1e3
    per = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = max(float(getattr(e, k, 0.0) or 0.0) for k in (
            "self_device_time_total", "self_cuda_time_total"))
        if us > 0:
            per[e.key] = per.get(e.key, 0.0) + us / iters / 1e3
    return wall, per


def equal_share(a, b) -> float:
    """Share of elements of ``a`` equal to ``b``, from the exact count of
    those that differ (an f32 mean of 2 M ones need not round to 1)."""
    return 1.0 - int((a != b).sum()) / a.numel()


def rotating(fn, copies):
    """``fn(*copies[k % len(copies)])`` on the k-th call: each call reads
    other index fields, so with enough copies none is left in L2."""
    k = itertools.count()
    return lambda: fn(*copies[next(k) % len(copies)])


def ptxas_report(log: str) -> dict:
    """{kernel (mangled name): {"registers", "spill_bytes",
    "stack_frame_bytes"}} from the output of ``nvcc -Xptxas=-v``."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, dict(registers=0, spill_bytes=0,
                                    stack_frame_bytes=0))
            continue
        if not fn:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[fn]["stack_frame_bytes"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def kernel_resources(report: dict, name: str) -> dict:
    """{mangled kernel name: ptxas figures} of the kernels whose name
    holds ``name`` (a kernel function's name, as it appears mangled)."""
    return {fn: r for fn, r in report.items() if name in fn}


def time_vox_division(table, kscal, axis_world, has_sh):
    """Device ms of warp_frame as shipped (multiplying by vox's exact
    reciprocal) and of its instantiation that divides by vox, on the same
    inputs, timed in turns (reciprocal, divide, divide, reciprocal) under
    the profiler, 50 calls each; the outputs must be equal."""
    import torch

    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    ks = wk._check(table, kscal, axis_world, WIDTH, HEIGHT)
    lib = wk._build.load("warp_frame")
    runs = {"reciprocal": None, "divide": 0.0}
    outs = [wk._launch(lib, table, ks, axis_world, WIDTH, HEIGHT, has_sh, inv)
            for inv in runs.values()]
    torch.cuda.synchronize()
    if not torch.equal(*outs):
        raise RuntimeError("warp_frame differs when it divides by vox")
    times = {k: [] for k in runs}
    for k in ("reciprocal", "divide", "divide", "reciprocal"):
        _, per = profiled(lambda: wk._launch(
            lib, table, ks, axis_world, WIDTH, HEIGHT, has_sh, runs[k]), 50)
        times[k].append(sum(v for n, v in per.items()
                            if "warp_frame_kernel" in n))
    log("timing", "warp_frame device ms in turns, multiplying by vox's "
        "reciprocal / dividing by vox: " + ", ".join(
            f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in times.items()))
    return {k: min(v) for k, v in times.items()}


def lookup_edge_inputs(lin):
    """{label: (lin field, warp_lookup's launches by form on it)} made
    from a real lin field: a view at a 4-byte storage offset, a pixel
    count that is not a multiple of 4, every pixel a miss, none."""
    import torch

    flat = lin.reshape(-1)
    buf = torch.empty(flat.numel() + 1, dtype=lin.dtype, device=lin.device)
    buf[1:] = flat
    return {"offset view": (buf[1:].view(lin.shape), {"general": 1}),
            "ragged": (flat[:-3].clone(), {"vector": 1, "general": 1}),
            "all miss": (torch.full_like(lin, -1), {"vector": 1}),
            "no miss": (torch.where(lin < 0, 0, lin), {"vector": 1})}


def compare_lookup_bodies(tab, ln, lins, dev_ms_of):
    """Device ms, warm and cold, of the single-plane lookup's first-port
    body (the multi-plane kernel at one plane) and of its vector form, in
    turns (first port, vector, vector, first port)."""
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    bodies = {"first port": (lambda x: wk.warp_lookup_multi(tab[None], x),
                             ("warp_lookup_kernel",)),
              "vector": (lambda x: wk.warp_lookup(tab, x),
                         ("warp_lookup_vector_kernel",))}
    times = {}
    for k in ("first port", "vector", "vector", "first port"):
        fn, names = bodies[k]
        warm = dev_ms_of(lambda: fn(ln), names)
        cold = dev_ms_of(rotating(fn, lins), names)
        times.setdefault(k, []).append((warm, cold))
    log("lookups", "warp_lookup bodies in turns, device ms warm/cold: "
        + ", ".join(f"{k} " + " ".join(f"{w:.4f}/{c:.4f}" for w, c in v)
                    for k, v in times.items()))
    best = {k: (min(w for w, _ in v), min(c for _, c in v))
            for k, v in times.items()}
    return {"first_port_ms": best["first port"][0],
            "first_port_ms_cold": best["first port"][1],
            "vector_in_turns_ms": best["vector"][0],
            "vector_in_turns_ms_cold": best["vector"][1]}


def frame_classes(img, amb: float = 26 / 255.0):
    """(lit, shadowed, background) pixel counts of an rgba frame rendered
    with the default ambient 0.1: quantized to 26/255 (int(0.1 * 255 +
    0.5)) by the fused kernels, 0.1 in f32 in the exact frames."""
    rgb = img[..., :3]
    mx = rgb.amax(-1)
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


def grazing_failures(idx, o, d, t_a, t_b, occ, origin, vs):
    """Mismatched rays (flat indices ``idx``) that are NOT grazing
    crossings: the grazing rule of tests/test_fast_exact.py, scaled by the
    voxel size. March each ray to its farther t plus a voxel; the first
    solid voxel met must be crossed over an interval shorter than 2e-3
    voxels."""
    import numpy as np

    bad = []
    dz, dy, dx = occ.shape
    for i in idx:
        ts = np.arange(0.0, max(t_a[i], t_b[i]) + vs, 2.5e-4 * vs)
        v = np.floor((o[i] + d[i] * ts[:, None] - origin) / vs).astype(int)
        inb = ((v >= 0).all(1) & (v[:, 0] < dx) & (v[:, 1] < dy)
               & (v[:, 2] < dz))
        solid = np.zeros(len(ts), bool)
        solid[inb] = occ[v[inb, 2], v[inb, 1], v[inb, 0]] > 0
        if not solid.any():
            bad.append(int(i))
            continue
        lo = origin + v[int(np.argmax(solid))] * vs
        t0 = (lo - o[i]) / d[i]
        t1 = (lo + vs - o[i]) / d[i]
        if np.maximum(t0, t1).min() - np.minimum(t0, t1).max() >= 2e-3 * vs:
            bad.append(int(i))
    return bad


def parity(hit, t, ref, vs):
    """(hit mismatch fraction, depth RMS in voxels on agreed hits)."""
    import torch

    both = hit & ref["hit"]
    se = torch.where(both, (t - ref["t"]) ** 2, 0.0).sum()
    rms = float(torch.sqrt(se / both.sum().clamp(min=1))) / vs
    return float((hit != ref["hit"]).float().mean()), rms


def held_calls(targets):
    """Wrap each ``(module, name)`` of ``targets`` so every call keeps its
    arguments and a copy of its output; returns (calls by name, restore).
    A name wrapped in two modules shares one list."""
    calls, undo = {}, []
    for module, name in targets:
        real = getattr(module, name)
        kept = calls.setdefault(name, [])

        def rec(*args, _real=real, _kept=kept):
            out = _real(*args)
            _kept.append((args, out.clone()))
            return out

        setattr(module, name, rec)
        undo.append((module, name, real))

    def restore():
        for module, name, real in undo:
            setattr(module, name, real)
    return calls, restore


def hold(calls, reference) -> dict:
    """Each kept kernel call's output against ``reference`` (its plain
    version) on the same inputs: dict(calls, bitwise_share (the least),
    max_abs_err)."""
    shares, err = [], 0.0
    for args, out in calls:
        ref = reference(*args)
        shares.append(equal_share(out, ref))
        err = max(err, float((out.double() - ref.double()).abs().max()))
    return dict(calls=len(calls), bitwise_share=min(shares, default=None),
                max_abs_err=err)


def require_held(label: str, held: dict) -> None:
    """Fail unless every kept call of every kernel in ``held`` (name ->
    :func:`hold`'s dict) equals its plain version bit for bit."""
    for name, h in held.items():
        if h["calls"] < 1 or h["bitwise_share"] != 1.0:
            raise RuntimeError(f"{label}: {name} on its path differs from "
                               f"its plain version or was not called: {h}")


# The warp experiments' rows of the kernel table: (the TPU kernel body
# they replace, the CUDA kernels their wrappers launch)
EXP_ROWS = {
    4: ("tools/exp_onehot_warp.py:39", ("onehot_window_kernel",)),
    5: ("tools/exp_warp_ablate.py:44", ("ablate_kernel",)),
    6: ("tools/exp_warp_kernel.py:30", ("row_window_kernel",)),
    7: ("tools/exp_warp_tune.py:27", ("onehot_window_kernel",)),
    8: ("tools/exp_warp_tune2.py:42", ("onehot_window_kernel",)),
    9: ("tools/exp_warp2pass.py:34", ("row_window_kernel",
                                      "col_window")),
}
# the kernels with forms (trace/exp_warp.FORM_LAUNCHES) each row launches
FORM_KERNELS = {4: ("onehot_window",), 6: ("row_window",),
                7: ("onehot_window",), 8: ("onehot_window",),
                9: ("row_window", "col_window")}
# kernel 4's forms, by the code col_window_launch takes
COL_FORMS = {"general": 0, "vector": 1}
EXP_LIBRARY = "torch.take of the flat index (equal where the window covers)"


def experiments(smi: str) -> list:
    """Phase 11: the warp experiments' drivers on the card, every kernel
    of csrc/exp_warp.cu against its plain version, and each row's times.
    Returns the rows 4-9 of the kernels JSON line."""
    import torch

    from ray_tracing_octrees_tpu_torch.tools import (
        cases, exp_onehot_warp, exp_warp2pass, exp_warp_ablate,
        exp_warp_kernel, exp_warp_tune, exp_warp_tune2,
    )
    from ray_tracing_octrees_tpu_torch.trace import exp_warp

    wrappers = cases.wrappers()
    row_names = {row: [n for n, (r, _) in wrappers.items() if r == row]
                 for row in EXP_ROWS}
    drivers = {4: exp_onehot_warp, 5: exp_warp_ablate, 6: exp_warp_kernel,
               7: exp_warp_tune, 8: exp_warp_tune2, 9: exp_warp2pass}
    launches = {}    # per row: its wrappers' launches in its own driver
    forms = {}       # per row: kernels 1 and 3's launches by form, the same
                     # run
    results = {}
    for row, mod in drivers.items():
        for _, fn in wrappers.values():
            fn.launches = 0
        for k in exp_warp.FORM_LAUNCHES:
            exp_warp.FORM_LAUNCHES[k] = 0
        t = time.perf_counter()
        res = mod.run("cuda")
        torch.cuda.synchronize()
        got = {name: fn.launches for name, (_, fn) in wrappers.items()}
        forms[row] = {k: v for k, v in exp_warp.FORM_LAUNCHES.items() if v}
        results[row] = res
        launches[row] = {n: got[n] for n in row_names[row]}
        for line in res["lines"]:
            log("experiments", f"{mod.__name__.rsplit('.', 1)[1]}: {line}")
        log("experiments", f"row {row} driver in "
            f"{time.perf_counter() - t:.2f} s; launches "
            f"{ {k: v for k, v in got.items() if v} }, by form {forms[row]}")
        missing = [n for n in row_names[row] if got[n] == 0]
        if missing:
            raise RuntimeError(f"row {row}'s driver launched no {missing}")

    # every wrapper against its plain version, on the drivers' inputs and
    # on the edge fields
    def one_hot_inputs(row):
        inp = results[row]["inputs"]
        return dict(t_hl=inp["t_hl"][0] if row == 4 else inp["t_hl"],
                    lin=inp["lins"][0])

    inputs = {"row 4 driver": one_hot_inputs(4),
              "row 5 driver": one_hot_inputs(5),
              "row 7 driver": one_hot_inputs(7),
              "row 6 driver": {k: results[6]["inputs"][k]
                               for k in ("table", "iu", "iv")},
              "row 9 driver": dict(t9=results[9]["inputs"]["table"],
                                   iustar=results[9]["inputs"]["iustar"],
                                   iv9=results[9]["inputs"]["iv"]),
              **{f"edge set {k}": v
                 for k, v in cases.edge_inputs("cuda").items()}}
    shares = {row: {} for row in EXP_ROWS}
    max_err = {row: 0.0 for row in EXP_ROWS}
    input_forms = {}   # per input set: kernels 1, 3 and 4's launches by form
    for k in exp_warp.FORM_LAUNCHES:
        exp_warp.FORM_LAUNCHES[k] = 0
    for label, kw in inputs.items():
        before = dict(exp_warp.FORM_LAUNCHES)
        for row, name, fn, plain, args in cases.kernel_cases(**kw):
            out = fn(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            share = cases.bits_equal_share(out, ref)
            shares[row][f"{label}: {name}"] = share
            max_err[row] = max(max_err[row],
                               float((out - ref).abs().max()))
            if share != 1.0:
                raise RuntimeError(f"{name} on the {label} differs from its "
                                   f"plain version: bitwise share {share}")
        input_forms[label] = {k: v - before[k] for k, v in
                              exp_warp.FORM_LAUNCHES.items() if v != before[k]}
        if "iv9" in kw:
            # kernel 4: the vector form unless iv is not 16-byte aligned
            want = "general" if label == "edge set offset views" else "vector"
            got = {k: v for k, v in input_forms[label].items()
                   if k.startswith("col_window")}
            if got != {f"col_window {want}": 1}:
                raise RuntimeError(f"warp_pass2 on the {label}: launches by "
                                   f"form {got}, want col_window {want}")
        log("experiments", f"{label}: launches by form {input_forms[label]}")
    two = inputs["row 9 driver"]
    out = exp_warp2pass.warp_two_pass(two["t9"], two["iustar"], two["iv9"])
    ref = exp_warp2pass.warp_two_pass_reference(two["t9"], two["iustar"],
                                                two["iv9"])
    if cases.bits_equal_share(out, ref) != 1.0:
        raise RuntimeError("warp_two_pass differs from its plain version")
    check_forms = {k: v for k, v in exp_warp.FORM_LAUNCHES.items() if v}
    log("experiments", "bitwise equal to the plain versions on "
        + ", ".join(f"row {r}: {len(s)} cases" for r, s in shares.items())
        + f"; kernels 1, 3 and 4 by form {check_forms}")
    if not all(check_forms.get(f"{k} {f}") for k in (
            "onehot_window", "row_window", "col_window")
            for f in ("general", "vector")):
        raise RuntimeError(f"a form went unchecked: {check_forms}")

    # times at the drivers' shapes: each row's variants, the first its
    # headline, with the plain version and torch.take timed beside it.
    # Each bound reads the distinct texels the variant's pixels read (the
    # window rule's flat index, or the plain version run on a table of
    # texel numbers 1..N, which returns each pixel's texel and 0 for none),
    # the index fields and the output once; its operations are the window
    # rule's ~10 index and add operations a pixel, at the f32 rate (the
    # data sheet gives no int32 rate).
    o4, o5, o7 = (one_hot_inputs(r) for r in (4, 5, 7))
    r6, r9 = results[6]["inputs"], results[9]["inputs"]
    n_px = o4["lin"].numel()
    TW = exp_onehot_warp.TW

    def one_hot(o, fn, *args):
        return (lambda lin: fn(o["t_hl"], lin, *args)), (o["lin"],)

    def one_hot_bound(o, ty, tx, win):
        inv, _, iv, umin, rel_u = exp_onehot_warp.window_rows(
            o["lin"], ty, tx, win)
        texels = distinct((umin + rel_u).long() * TW + iv, ~inv)
        return 8 * n_px + 4 * texels, 10 * n_px     # hi and lo bf16 planes

    def ablate_bound(kind):
        if kind == "null":
            return 4 * n_px, n_px
        if kind != "twload":
            return 8 * n_px, 10 * n_px
        inv, _, _, umin, _ = exp_onehot_warp.window_rows(o5["lin"], 8, 128,
                                                         exp_warp_ablate.WIN)
        lane = torch.arange(o5["lin"].shape[1], device=inv.device) % 128
        return (8 * n_px + 2 * distinct(umin.long() * TW + lane, ~inv),
                10 * n_px)

    def numbered_texels(plain, table, *idx):
        num = torch.arange(1, table.numel() + 1, dtype=torch.float32,
                           device=table.device).reshape(table.shape)
        got = plain(num, *idx)
        return distinct(got.long(), got > 0)

    # each variant: (label, call, its index fields, bound); call(*fields)
    # runs it. Row 9 is warp_two_pass as a function: T2's texels, iustar,
    # iv and out; its intermediate M is not the function's to move
    variants = {
        4: [(f"onehot_warp w{w}", *one_hot(o4, exp_onehot_warp.onehot_warp,
                                           w),
             one_hot_bound(o4, 8, 128, w)) for w in (64, 128)],
        5: [(f"ablate {k}", *one_hot(o5, exp_warp_ablate.make_call(k)),
             ablate_bound(k)) for k in ("twload", "null", "intops", "select")],
        6: [("warp_pallas", lambda iu, iv: exp_warp_kernel.warp_pallas(
            r6["table"], iu, iv), (r6["iu"], r6["iv"]),
            (12 * n_px + 4 * numbered_texels(
                exp_warp_kernel.warp_pallas_reference, r6["table"], r6["iu"],
                r6["iv"]), 10 * n_px))],
        7: [(f"warp ({ty},{tx}) w{w}",
             *one_hot(o7, exp_warp_tune.warp, ty, tx, w),
             one_hot_bound(o7, ty, tx, w))
            for ty, tx, w in ((8, 128, 64), (16, 128, 64), (32, 128, 128))],
        8: [(f"warp_slim ({ty},{tx}) w{w}",
             *one_hot(o7, exp_warp_tune2.warp_slim, ty, tx, w),
             one_hot_bound(o7, ty, tx, w))
            for ty, tx, w in ((16, 128, 64), (32, 128, 128))],
        9: [("warp_two_pass", lambda ius, iv: exp_warp2pass.warp_two_pass(
            r9["table"], ius, iv), (r9["iustar"], r9["iv"]),
            (4 * r9["iustar"].numel() + 8 * n_px + 4 * numbered_texels(
                exp_warp2pass.warp_two_pass_reference, r9["table"],
                r9["iustar"], r9["iv"]), 20 * n_px))],
    }
    plains = {
        4: (lambda: exp_onehot_warp.onehot_warp_reference(
            o4["t_hl"], o4["lin"], 64), results[4]["inputs"]["tables"][0],
            o4["lin"]),
        5: (lambda: exp_warp_ablate.ablate_reference(
            o5["t_hl"], o5["lin"], "twload"), results[5]["inputs"]["table"],
            o5["lin"]),
        6: (lambda: exp_warp_kernel.warp_pallas_reference(
            r6["table"], r6["iu"], r6["iv"]), r6["table"], r6["lin"]),
        7: (lambda: exp_warp_tune.warp_reference(
            o7["t_hl"], o7["lin"], 8, 128, 64),
            results[7]["inputs"]["table"], o7["lin"]),
        8: (lambda: exp_warp_tune2.warp_slim_reference(
            o7["t_hl"], o7["lin"], 16, 128, 64),
            results[8]["inputs"]["table"], o7["lin"]),
        9: (lambda: exp_warp2pass.warp_two_pass_reference(
            r9["table"], r9["iustar"], r9["iv"]), r9["table"], r9["lin"]),
    }

    def device_ms(fn, names):
        """(device ms per call of the kernels ``names``, by kernel) under
        the profiler over 50 calls of ``fn``."""
        _, per = profiled(fn, 50)
        per = {n: sum(v for k, v in per.items() if n in k) for n in names}
        return sum(per.values()), per

    # kernel 4's forms on the row 9 driver's M and iv, each bitwise against
    # the plain version, then timed in turns (each form in COL_FORMS' order,
    # then in reverse), warm and cold; launched through the entry point with
    # a form code, so FORM_LAUNCHES does not count them
    def col_form(code, m):
        return lambda iv: exp_warp._call(
            "col_window_launch", iv, tuple(iv.shape), m, m.shape[1], iv,
            None, *iv.shape, exp_warp2pass.WIN2, code)

    for label, kw in inputs.items():
        if "iv9" not in kw or label == "edge set offset views":
            continue
        m = exp_warp2pass.warp_pass1_reference(kw["t9"], kw["iustar"])
        ref = exp_warp2pass.warp_pass2_reference(m, kw["iv9"])
        for f, code in COL_FORMS.items():
            out = col_form(code, m)(kw["iv9"])
            torch.cuda.synchronize()
            if cases.bits_equal_share(out, ref) != 1.0:
                raise RuntimeError(f"kernel 4's {f} form differs from its "
                                   f"plain version on the {label}")
    m9 = exp_warp2pass.warp_pass1_reference(r9["table"], r9["iustar"])
    iv9 = r9["iv"]
    ivs = [(iv9.clone(),) for _ in range(N_COLD)]
    col_turns = {}
    for f in list(COL_FORMS) + list(reversed(COL_FORMS)):
        fn = col_form(COL_FORMS[f], m9)
        warm = device_ms(lambda: fn(iv9), ("col_window",))[0]
        cold = device_ms(rotating(fn, ivs), ("col_window",))[0]
        col_turns.setdefault(f, []).append((warm, cold))
    del ivs
    log("experiments", f"[{smi}] kernel 4 forms in turns, device ms warm/"
        "cold: " + ", ".join(f"{f} " + " ".join(f"{w:.4f}/{c:.4f}"
                                                 for w, c in v)
                             for f, v in col_turns.items()))
    # each pass's own bound: pass 1 reads iustar and T2's distinct texels
    # and writes M; pass 2 reads iv and M's distinct texels and writes out
    pass_bounds = {
        "pass1": bound(4 * r9["iustar"].numel() + 4 * m9.numel()
                       + 4 * numbered_texels(
                           exp_warp2pass.warp_pass1_reference, r9["table"],
                           r9["iustar"]), 10 * m9.numel()),
        "pass2": bound(8 * iv9.numel() + 4 * numbered_texels(
            exp_warp2pass.warp_pass2_reference, m9, iv9), 10 * iv9.numel()),
    }

    rows = []
    for row, vs in variants.items():
        timed = []
        names = EXP_ROWS[row][1]
        for label, call, fields, (nbytes, ops) in vs:
            def kern():
                return call(*fields)

            k_ms = cuda_ms(kern, 200)
            dev_ms, per = device_ms(kern, names)
            copies = [tuple(f.clone() for f in fields) for _ in range(N_COLD)]
            cold_ms, cold_per = device_ms(rotating(call, copies), names)
            del copies
            b_ms, b_by = bound(nbytes, ops)
            timed.append(dict(variant=label, ms=dev_ms or k_ms,
                              ms_source=MS_SOURCE[bool(dev_ms)],
                              wrapper_ms=k_ms, kernel_device_ms=per,
                              ms_cold=cold_ms or None,
                              kernel_device_ms_cold=cold_per, bound_ms=b_ms,
                              bound_by=b_by, bound_bytes=nbytes))
            log("experiments", f"[{smi}] row {row} {label}: kernel "
                + (f"{dev_ms:.4f} ms warm, {cold_ms:.4f} ms cold under the "
                   f"profiler (" + ", ".join(
                       f"{n} {v:.4f}/{cold_per[n]:.4f}"
                       for n, v in per.items()) + ")"
                   if dev_ms else "not measured: the profiler saw no kernel")
                + f", wrapper {k_ms:.4f} ms (CUDA events), bound "
                f"{b_ms * 1e3:.2f} us ({b_by}; {nbytes} bytes)")
        plain, table, lin = plains[row]
        p_ms = cuda_ms(plain, 10)
        flat = torch.where(lin < 0, 0, lin).reshape(-1).long()
        l_ms = cuda_ms(lambda: torch.take(table, flat), 200)
        _, lper = profiled(lambda: torch.take(table, flat), 50)
        if not lper:    # the profiler recorded no device time: once more
            _, lper = profiled(lambda: torch.take(table, flat), 50)
        flats = [(flat.clone(),) for _ in range(N_COLD)]
        _, lper_cold = profiled(
            rotating(lambda f: torch.take(table, f), flats), 50)
        del flats
        lib_ms = sum(lper.values()) or None
        lib_cold = sum(lper_cold.values()) or None
        mismatch = max(results[row]["mismatch"].values())
        head = timed[0]
        rows.append({
            "name": "/".join(row_names[row]),
            "row": row,
            "route": "cuda",
            "source": "ray_tracing_octrees_tpu_torch/trace/csrc/exp_warp.cu",
            "replaces": EXP_ROWS[row][0],
            "launches": sum(launches[row].values()),
            "launches_by_wrapper": launches[row],
            "launches_by_form": forms[row],
            "max_abs_err": max_err[row],
            "match_bar": "bitwise equal (share 1.0)",
            "match_share": min(shares[row].values()),
            "cases": len(shares[row]),
            "match_ok": True,
            "headline": head["variant"],
            "ms": head["ms"],
            "ms_source": head["ms_source"],
            "ms_cold": head["ms_cold"],
            "wrapper_ms": head["wrapper_ms"],
            "kernel_device_ms": head["kernel_device_ms"],
            "plain_ms": p_ms,
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "bound_share_cold": (head["bound_ms"] / head["ms_cold"]
                                 if head["ms_cold"] else None),
            "library_ms": l_ms,
            "library_device_ms": lib_ms,
            "library_device_ms_cold": lib_cold,
            "take_factor": head["ms"] / lib_ms if lib_ms else None,
            "take_factor_cold": (head["ms_cold"] / lib_cold
                                 if lib_cold and head["ms_cold"] else None),
            "library_call": EXP_LIBRARY,
            "library_same_function": mismatch == 0,
            "window_mismatch": mismatch,
            "variants": timed,
            "driver_ms": results[row]["ms"],
            "launches_by_form_on_inputs": {
                k: {f: n for f, n in v.items()
                    if f.split()[0] in FORM_KERNELS.get(row, ())}
                for k, v in input_forms.items()},
        })
        if row == 9:
            per, per_cold = head["kernel_device_ms"], \
                head["kernel_device_ms_cold"]
            rows[-1]["passes"] = {
                p: {"kernel": k, "bound_ms": b_ms, "bound_by": b_by,
                    "ms": per.get(k), "ms_cold": per_cold.get(k),
                    "bound_share_cold": (b_ms / per_cold[k]
                                         if per_cold.get(k) else None)}
                for p, k, (b_ms, b_by) in (
                    ("pass1", "row_window_kernel", pass_bounds["pass1"]),
                    ("pass2", "col_window", pass_bounds["pass2"]))}
            rows[-1]["col_window_forms_in_turns"] = col_turns
            rows[-1]["col_window_forms_best"] = {
                f: {"ms": min(w for w, _ in v), "ms_cold": min(c for _, c in v)}
                for f, v in col_turns.items()}
            log("experiments", f"[{smi}] row 9 passes: " + "; ".join(
                f"{p} {d['ms'] or 0:.4f}/{d['ms_cold'] or 0:.4f} ms, bound "
                f"{d['bound_ms'] * 1e3:.2f} us ({d['bound_by']}), share cold "
                f"{d['bound_share_cold'] or 0:.3f}"
                for p, d in rows[-1]["passes"].items()))
        log("experiments", f"[{smi}] row {row} {head['variant']}: plain "
            f"{p_ms:.4f} ms, torch.take {l_ms:.4f} ms ({lib_ms or 0:.4f} ms "
            f"warm, {lib_cold or 0:.4f} ms cold under the profiler; window "
            f"mismatch {mismatch:.4f}); launches {rows[-1]['launches']}")
    return rows


def run_bench_phase(parity_ref: dict) -> dict:
    """Phase 12: the port's bench at its defaults, as
    ``python -m ray_tracing_octrees_tpu_torch.bench`` runs it, with the
    frame kernels' launch counts set to 0 before it and read after it.
    Checks its one short line and each section of its record; returns a
    summary for the kernels line."""
    import contextlib
    import io
    import math

    from ray_tracing_octrees_tpu_torch import bench
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    kernels = {"warp_frame": wk.warp_frame, "warp_lookup": wk.warp_lookup,
               "warp_lookup_multi": wk.warp_lookup_multi}
    for fn in kernels.values():
        fn.launches = 0
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main([])
    secs = time.perf_counter() - t
    launches = {k: fn.launches for k, fn in kernels.items()}
    lines = buf.getvalue().splitlines()
    if len(lines) != 1 or len(lines[0]) > bench.MAX_LINE:
        raise RuntimeError(f"the bench printed {len(lines)} lines, the "
                           f"first {len(lines[0]) if lines else 0} "
                           f"characters long")
    log("bench", lines[0])
    short = json.loads(lines[0])
    with open(short["record"]) as f:
        rec = json.load(f)
    ens = rec["parity_ensemble"]
    near = rec["exact_radius_2"]
    log("bench", f"{secs:.1f} s; launches {launches}; headline "
        f"{rec['frame_ms']:.3f} ms (windows {rec['frame_ms_windows']}), "
        f"{rec['value']:.1f} Mrays/s, hit fraction {rec['hit_fraction']:.4f}; "
        f"parity {rec['parity_vs_exact']}; exact at the headline pose: "
        f"{rec['exact_tracer_path']} {rec['exact_headline']}, "
        f"{rec['exact_tracer_mrays']:.3f} Mrays/s (tried "
        f"{rec['exact_tried']}); radius "
        f"{near['radius_f']}: {near.get('frame_ms')} ms, "
        f"{near.get('mrays')} Mrays/s ({near['path']}, {near.get('stats')})")
    log("bench", f"ensemble: {ens['n_poses']} poses at {ens['resolution']}, "
        f"median mismatch {ens['median_mismatch']:.5f}, max RMS "
        f"{ens['max_rms_vox']:.4f} voxels, worst {ens['worst_pose']}; refs "
        + ", ".join(f"{r['ref']} {r['mismatches']}" for r in ens["poses"]))
    bad = []
    if min(launches.values()) == 0 or launches["warp_frame"] < 61:
        bad.append(f"launches {launches}")
    if not (math.isfinite(rec["value"]) and rec["value"] > 0
            and 0 < rec["hit_fraction"] < 1):
        bad.append("headline")
    par = rec["parity_vs_exact"]
    if (par["mismatches"] != parity_ref["mismatches"] or not math.isclose(
            par["depth_rms_voxels"], parity_ref["depth_rms_voxels"],
            rel_tol=1e-6)):
        bad.append(f"parity line {par} differs from phase 9's {parity_ref}")
    if not (rec["exact_tracer_path"] == "dda"
            and rec["exact_tracer_mrays"] > 0
            and rec["exact_headline"]["frame_ms"] > 0):
        bad.append("exact section")
    if near["path"] != "fast_exact" or not near["frame_ms"] > 0:
        bad.append(f"radius-{near['radius_f']} exact frame {near}")
    if ens["n_poses"] != 16 or not all(
            math.isfinite(r["mismatch"]) and math.isfinite(r["rms_vox"])
            for r in ens["poses"]):
        bad.append("ensemble")
    if bad:
        raise RuntimeError(f"bench sections failed: {bad}")
    return {"line": short, "seconds": secs, "launches": launches,
            "frame_ms": rec["frame_ms"], "mrays_per_s": rec["value"],
            "parity_vs_exact": par, "exact_tracer_path":
            rec["exact_tracer_path"], "exact_headline": rec["exact_headline"],
            "exact_tracer_mrays": rec["exact_tracer_mrays"],
            "exact_radius_2": near,
            "ensemble": {k: ens[k] for k in ("n_poses", "worst_pose",
                                              "median_mismatch",
                                              "max_rms_vox")}}


def exact_tracer_phases(ctx: dict) -> dict:
    """Phases 13-18: the exact DDA ladder frame, its parity (unseeded at
    the headline pose, seeded at radius 2.0), the sweep-exact frame, the
    unfused fast frame, OctreeRayTracer's routes and card-against-CPU on
    the 32^3 sphere. ``ctx`` holds the scene and helpers of main; returns
    the record's summary, the kernels' launches by path ("launches") and
    their calls on those paths held against their plain versions
    ("held", by kernel and path)."""
    import numpy as np
    import torch

    from ray_tracing_octrees_tpu_torch import bench
    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.core.octree import (
        build_leaf_volume, build_pyramid,
    )
    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        OctreeRayTracer,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import (
        Camera, generate_rays,
    )
    from ray_tracing_octrees_tpu_torch.trace import (
        fast_exact, slab_sweep, sweep_exact,
    )
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk
    from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
        trace_octree, trace_octree_fast,
    )

    dev, smi = ctx["dev"], ctx["smi"]
    vol, pyr, origin, vox = ctx["vol"], ctx["pyr"], ctx["origin"], ctx["vox"]
    light_dir, aspect = ctx["light_dir"], WIDTH / HEIGHT
    kernels = {"warp_frame": wk.warp_frame, "warp_lookup": wk.warp_lookup,
               "warp_lookup_multi": wk.warp_lookup_multi}
    amb32 = float(np.float32(0.1))
    out = {"launches": {}, "held": {"warp_lookup": {}}}

    def zero():
        for fn in kernels.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in kernels.items()}

    def windows_ms(frame, cam):
        wins = []
        for _ in range(3):
            t = time.perf_counter()
            for _ in range(N_EXACT):
                cam.phi += 1e-4
                frame(cam)
            torch.cuda.synchronize()
            wins.append((time.perf_counter() - t) / N_EXACT * 1e3)
        return wins

    # 13. the DDA-ladder frame at the headline pose
    t = time.perf_counter()
    leaf_vol = build_leaf_volume(pyr)
    seed_lay = slab_sweep.SweepLayouts(slab_sweep.dilate_occupancy(
        vol, device=dev))
    torch.cuda.synchronize()
    log("dda", f"leaf volume {tuple(leaf_vol.shape)} and dilated seed "
        f"volume {tuple(seed_lay.volume.shape)} in "
        f"{time.perf_counter() - t:.2f} s")

    def dda(cam, stats=None):
        return bench.dda_ladder_frame(pyr, leaf_vol, seed_lay, origin, vox,
                                      cam, EW, EH, aspect, light_dir, dev,
                                      stats)[0]

    cam = ctx["bench_camera"]()
    d_calls, restore = held_calls([(slab_sweep, "warp_lookup")])
    zero()
    st = {}
    t = time.perf_counter()
    img = dda(cam, st)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    restore()
    out["launches"]["DDA frame (phase 13)"] = read()
    d_held = {k: hold(v, wk.warp_lookup_reference)
              for k, v in d_calls.items() if v}
    require_held("the DDA frame", d_held)
    for k, h in d_held.items():
        out["held"][k]["DDA frame (phase 13)"] = h
    counts = bench.dda_counts(st)
    seeded = bench.dda_ladder_frame(pyr, leaf_vol, seed_lay, origin, vox, cam,
                                    16, 9, aspect, light_dir, dev)[1]
    shadow_steps = next(x["steps"] for x in st["traces"]
                        if x["kind"] == "shadow")
    wins = windows_ms(dda, cam)
    wall, per = profiled(lambda: dda(cam), 2)
    busy = sum(per.values())
    lit, shadowed, background = frame_classes(img, amb32)
    dda_rec = dict(
        frame_ms=min(wins), frame_ms_windows=wins, first_frame_s=first_s,
        mrays_per_s=2 * EW * EH / min(wins) / 1e3, counts=counts,
        seeded=seeded, shadow_steps_max=int(shadow_steps.max()),
        profiled_wall_ms=wall, device_busy_ms=busy if per else None,
        idle_share=max(0.0, 1 - busy / wall) if per else None,
        kernel_kinds=len(per), pixels=dict(lit=lit, shadowed=shadowed,
                                           background=background))
    log("dda", f"[{smi}] {EW}x{EH} at the bench pose, shadows on: "
        f"{min(wins):.3f} ms per frame (best of 3 windows of {N_EXACT}: "
        f"{', '.join(f'{w:.3f}' for w in wins)}), "
        f"{dda_rec['mrays_per_s']:.2f} Mrays/s; first frame {first_s:.2f} s; "
        f"seeds applied {seeded}; per frame {counts} (shadow steps max "
        f"{dda_rec['shadow_steps_max']}); profiled wall {wall:.3f} ms, "
        + (f"device busy {busy:.3f} ms, idle share "
           f"{dda_rec['idle_share']:.3f}, {len(per)} kernel kinds" if per
           else "device time not measured")
        + f"; launches {out['launches']['DDA frame (phase 13)']}; lit {lit}, "
        f"shadowed "
        f"{shadowed}, background {background} px")
    if tuple(img.shape) != (EH, EW, 4) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"bad DDA frame {tuple(img.shape)}")
    if min(lit, shadowed, background) == 0:
        raise RuntimeError("the DDA frame lacks lit, shadowed or background "
                           "pixels")
    if counts["primary_steps_max"] >= 512:
        raise RuntimeError("the DDA frame reached the step bound")

    # 14. its hit mask against the oracle
    pw, ph = 240, 136
    o, d = generate_rays(pw, ph, cam.get_pos(), cam.get_view(), 45.0, aspect,
                         device=dev)
    ref = trace_octree(pyr, o, d, origin, vox)
    live, ts, ext = slab_sweep.sweep_seed(
        seed_lay.volume, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
        aspect, pw, ph, layouts=seed_lay, device=dev)
    res = trace_octree_fast(leaf_vol, o, d, origin, vox, ball_skip=True,
                            t_start=ts if ext else None,
                            live_mask=live if ext else None,
                            const_origin=True)
    idx = torch.nonzero(res["hit"] != ref["hit"]).squeeze(1).cpu().numpy()
    bad = grazing_failures(
        idx, o.cpu().numpy().astype(np.float64),
        d.cpu().numpy().astype(np.float64), res["t"].cpu().numpy(),
        ref["t"].cpu().numpy(), ctx["occ_np"], origin.astype(np.float64), vox)
    both = res["hit"] & ref["hit"]
    t_err = float((res["t"] - ref["t"]).abs()[both].max())
    dda_rec["parity"] = dict(resolution=f"{pw}x{ph}", mismatches=len(idx),
                             not_grazing=len(bad), t_max_abs_err=t_err,
                             oracle_hits=int(ref["hit"].sum()))
    log("dda parity", f"{pw}x{ph}: {len(idx)} hit mismatches against "
        f"trace_octree, {len(bad)} not grazing; t max abs err {t_err:.3g} "
        f"on {int(both.sum())} agreed hits")
    if bad:
        raise RuntimeError(f"DDA mismatches that are not grazing crossings: "
                           f"{bad[:10]}")
    # ... and the seeded route at radius 2.0 x extent, where the slope
    # gate lets sweep_seed's seeds apply: the seed table (the dilated
    # volume's sweep) warped by warp_lookup, held bitwise, and the seeded
    # trace's hit mask against the oracle
    scam = ctx["exact_camera"]()
    o, d = generate_rays(pw, ph, scam.get_pos(), scam.get_view(), 45.0,
                         aspect, device=dev)
    ref = trace_octree(pyr, o, d, origin, vox)
    seed_calls, restore = held_calls([(slab_sweep, "warp_lookup")])
    zero()
    live, ts, ext = slab_sweep.sweep_seed(
        seed_lay.volume, origin, vox, scam.get_pos(), scam.get_view(), 45.0,
        aspect, pw, ph, layouts=seed_lay, device=dev)
    torch.cuda.synchronize()
    restore()
    out["launches"]["DDA seeds (phase 14)"] = read()
    if not ext:
        raise RuntimeError("the seeds do not apply at radius 2.0")
    seed_held = hold(seed_calls.get("warp_lookup", []),
                     wk.warp_lookup_reference)
    res = trace_octree_fast(leaf_vol, o, d, origin, vox, ball_skip=True,
                            t_start=ts, live_mask=live, const_origin=True)
    plain = trace_octree_fast(leaf_vol, o, d, origin, vox, ball_skip=True,
                              const_origin=True)
    idx = torch.nonzero(res["hit"] != ref["hit"]).squeeze(1).cpu().numpy()
    bad = grazing_failures(
        idx, o.cpu().numpy().astype(np.float64),
        d.cpu().numpy().astype(np.float64), res["t"].cpu().numpy(),
        ref["t"].cpu().numpy(), ctx["occ_np"], origin.astype(np.float64), vox)
    both = res["hit"] & ref["hit"]
    dda_rec["seeded_parity"] = dict(
        resolution=f"{pw}x{ph}", radius=EXACT_RADIUS, mismatches=len(idx),
        not_grazing=len(bad),
        t_max_abs_err=float((res["t"] - ref["t"]).abs()[both].max()),
        oracle_hits=int(ref["hit"].sum()), dead_rays=int((~live).sum()),
        seeded_vs_unseeded_hit=int((res["hit"] != plain["hit"]).sum()),
        seeded_vs_unseeded_t=int((res["t"] != plain["t"]).sum()),
        seed_warp_lookup=seed_held)
    log("dda parity", f"seeded, radius {EXACT_RADIUS} x extent, {pw}x{ph}: "
        f"{dda_rec['seeded_parity']}")
    require_held("the DDA seeds", {"warp_lookup": seed_held})
    if bad:
        raise RuntimeError(f"seeded DDA mismatches that are not grazing "
                           f"crossings: {bad[:10]}")
    out["dda"] = dda_rec
    out["held"]["warp_lookup"]["DDA seeds (phase 14)"] = seed_held

    # 15. the sweep-exact frame at radius 2.0
    ecam = ctx["exact_camera"]()
    lay = ctx["layouts"]
    t = time.perf_counter()
    sfld = sweep_exact.build_shadow_field(vol, light_dir, vox, layouts=lay,
                                          device=dev)
    torch.cuda.synchronize()
    field_s = time.perf_counter() - t
    if sfld is None:
        raise RuntimeError("the light is outside the shadow field's envelope")

    def sweep_frame(c):
        got = sweep_exact.render_exact_frame(
            vol, leaf_vol, origin, vox, c.get_pos(), c.get_view(), EW, EH,
            45.0, aspect, light_dir=light_dir, shadows=True,
            shadow_field=sfld, layouts=lay, device=dev)
        if got is None:
            raise RuntimeError("the sweep-exact pose is outside its envelope")
        return got

    look_calls, restore = held_calls([(sweep_exact, "warp_lookup")])
    zero()
    simg, sstats = sweep_frame(ecam)
    torch.cuda.synchronize()
    restore()
    out["launches"]["sweep-exact frame (phase 15)"] = read()
    dead = hold(look_calls["warp_lookup"], wk.warp_lookup_reference)
    out["held"]["warp_lookup"]["sweep-exact dead test (phase 15)"] = dead
    (table, lin), _ = look_calls["warp_lookup"][0]
    dead_share = dead["bitwise_share"]
    swins = windows_ms(lambda c: sweep_frame(c), ecam)
    swall, sper = profiled(lambda: sweep_frame(ecam), 2)
    sbusy = sum(sper.values())
    s_lit, s_sh, s_bg = frame_classes(simg, amb32)
    out["sweep_exact"] = dict(
        frame_ms=min(swins), frame_ms_windows=swins,
        mrays_per_s=2 * EW * EH / min(swins) / 1e3, stats=sstats,
        shadow_field_s=field_s, shadow_field_lattice=(sfld.inter_h,
                                                       sfld.inter_w),
        taps=(sfld.ta, sfld.tb), profiled_wall_ms=swall,
        device_busy_ms=sbusy if sper else None,
        idle_share=max(0.0, 1 - sbusy / swall) if sper else None,
        dead_test=dict(table=list(table.shape), lin=list(lin.shape),
                       **dead),
        pixels=dict(lit=s_lit, shadowed=s_sh, background=s_bg))
    log("sweep exact", f"[{smi}] {EW}x{EH}, radius {EXACT_RADIUS} x extent, "
        f"shadows on: {min(swins):.3f} ms per frame (best of 3 windows of "
        f"{N_EXACT}: {', '.join(f'{w:.3f}' for w in swins)}), "
        f"{out['sweep_exact']['mrays_per_s']:.2f} Mrays/s; stats {sstats}; "
        f"shadow field {sfld.inter_h}x{sfld.inter_w} taps {sfld.ta}x"
        f"{sfld.tb} in {field_s:.2f} s; profiled wall {swall:.3f} ms, "
        + (f"device busy {sbusy:.3f} ms, idle share "
           f"{out['sweep_exact']['idle_share']:.3f}" if sper
           else "device time not measured")
        + f"; launches {out['launches']['sweep-exact frame (phase 15)']}; "
        f"dead test "
        f"warp_lookup on table {tuple(table.shape)}, lin {tuple(lin.shape)}: "
        f"bitwise {dead_share:.6f}; lit {s_lit}, shadowed {s_sh}, "
        f"background {s_bg} px")
    if out["launches"]["sweep-exact frame (phase 15)"]["warp_lookup"] < 1:
        raise RuntimeError("the sweep-exact frame launched no warp_lookup")
    require_held("the sweep-exact dead test", {"warp_lookup": dead})
    if sstats["overflow"] or sstats["unresolved"] or sstats["s_unresolved"]:
        raise RuntimeError(f"the sweep-exact frame left rays: {sstats}")
    if min(s_lit, s_sh, s_bg) == 0 or not bool(torch.isfinite(simg).all()):
        raise RuntimeError("the sweep-exact frame lacks lit, shadowed or "
                           "background pixels")

    # 16. the unfused fast frame: the stage-by-stage route through
    # warp_lookup at the headline pose
    ucam = ctx["bench_camera"]()

    def fast_frame(c, fused):
        return slab_sweep.render_fast_frame(
            vol, lay.shadow, origin, vox, c.get_pos(), c.get_view(), 45.0,
            aspect, WIDTH, HEIGHT, light_dir=light_dir, layouts=lay,
            device=dev, fused=fused)

    u_calls, restore = held_calls([(slab_sweep, "warp_lookup")])
    zero()
    uimg = fast_frame(ucam, False)
    torch.cuda.synchronize()
    restore()
    out["launches"]["unfused fast frame (phase 16)"] = read()
    u_held = hold(u_calls["warp_lookup"], wk.warp_lookup_reference)
    out["held"]["warp_lookup"]["unfused fast frame (phase 16)"] = u_held
    fimg = fast_frame(ucam, True)
    uq = torch.round(uimg.clamp(0.0, 1.0) * 255.0) / 255.0
    u_share = float(((uq - fimg).abs().amax(-1) <= MATCH_TOL).float().mean())
    u_hits = torch.equal(uimg[..., :3].amax(-1) > 0, fimg[..., :3].amax(-1) > 0)
    uwins = windows_ms(lambda c: fast_frame(c, False), ucam)
    out["unfused_fast_frame"] = dict(
        frame_ms=min(uwins), frame_ms_windows=uwins,
        share_within_1_5_255_of_fused=u_share, hit_masks_equal=u_hits,
        warp_lookup=u_held)
    log("unfused frame", f"[{smi}] {WIDTH}x{HEIGHT} at the bench pose, "
        f"shadows on: {min(uwins):.3f} ms per frame (best of 3 windows of "
        f"{N_EXACT}); launches "
        f"{out['launches']['unfused fast frame (phase 16)']}; warp_lookup "
        f"held {u_held}; {u_share:.6f} of pixels within 1.5/255 of the "
        f"fused frame, hit masks equal {u_hits}")
    if out["launches"]["unfused fast frame (phase 16)"]["warp_lookup"] < 1:
        raise RuntimeError("the unfused fast frame launched no warp_lookup")
    require_held("the unfused fast frame", {"warp_lookup": u_held})
    if u_share <= MATCH_SHARE or not u_hits:
        raise RuntimeError("the unfused fast frame disagrees with the fused "
                           "one")

    # 17. OctreeRayTracer.render through every route, each kernel call
    # kept and held bitwise against its plain version on the route's own
    # inputs (the config's light, 1080 rows)
    cfg = EngineConfig()
    rt_cfg = cfg.raytrace
    settings = [
        ("default, headline radius", cfg, ctx["bench_camera"], {}, "dda"),
        ("default, radius 2.0", cfg, ctx["exact_camera"], {}, "sweep_exact"),
        ("use_sweep_exact=False", dataclasses.replace(
            cfg, raytrace=dataclasses.replace(rt_cfg, use_sweep_exact=False)),
         ctx["exact_camera"], {}, "dda"),
        ("use_fast_exact=True", dataclasses.replace(
            cfg, raytrace=dataclasses.replace(rt_cfg, use_fast_exact=True)),
         ctx["exact_camera"], {}, "fast_exact"),
        ("fast=True", cfg, ctx["bench_camera"], dict(fast=True), "fast"),
    ]
    grid = ctx["grid"]
    references = {"warp_frame": wk.warp_frame_reference,
                  "warp_lookup": wk.warp_lookup_reference,
                  "warp_lookup_multi": wk.warp_lookup_multi_reference}
    routes = {}
    tracer_launches = dict.fromkeys(kernels, 0)
    t0 = time.perf_counter()
    for label, c, camera, kw, want in settings:
        tracer = OctreeRayTracer(config=c)
        tracer.set_octree(grid, pyramid=pyr)
        calls, restore = held_calls([
            (slab_sweep, "warp_frame"), (slab_sweep, "warp_lookup"),
            (sweep_exact, "warp_lookup"), (fast_exact, "warp_lookup_multi")])
        zero()
        t = time.perf_counter()
        try:
            rimg = tracer.render(camera(), WIDTH, HEIGHT, aspect,
                                 shadows=True, **kw)
            torch.cuda.synchronize()
        finally:
            restore()
        seconds = time.perf_counter() - t
        launched = read()
        for k, v in launched.items():
            tracer_launches[k] += v
        held = {k: hold(v, references[k]) for k, v in calls.items() if v}
        for k, h in held.items():
            out["held"].setdefault(k, {})[f"OctreeRayTracer {label} "
                                          f"(phase 17)"] = h
        routes[label] = dict(path=tracer.last_path, seconds=seconds,
                             launches=launched, held=held,
                             hit_share=float((rimg[..., :3].amax(-1) > 0)
                                             .float().mean()))
        log("tracer", f"{label}: path {tracer.last_path}, {seconds:.2f} s "
            f"with the scene's set-up, hit share "
            f"{routes[label]['hit_share']:.4f}; launches {launched}; held "
            f"{held}")
        if tracer.last_path != want or tuple(rimg.shape) != (HEIGHT, WIDTH,
                                                             4):
            raise RuntimeError(f"OctreeRayTracer {label}: path "
                               f"{tracer.last_path}, want {want}")
        unkept = [k for k, v in launched.items() if v and k not in held]
        if unkept:
            raise RuntimeError(f"OctreeRayTracer {label}: {unkept} launched "
                               f"outside the kept calls")
        require_held(f"OctreeRayTracer {label}", held)
    out["launches"]["OctreeRayTracer (phase 17)"] = tracer_launches
    log("tracer", f"five renders in {time.perf_counter() - t0:.2f} s; "
        f"launches {tracer_launches}")
    missing = [k for k, v in tracer_launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"OctreeRayTracer's routes launched no {missing}")
    out["tracer"] = routes

    # 18. the card against the CPU on the 32^3 sphere
    small = ctx["small"]
    s_lv = build_leaf_volume(build_pyramid(small.occ))
    s_vol = (small.occ > 0).to(torch.float32)
    pc = Camera(theta=0.9, phi=0.8, radius=2.0)
    sargs = (small.origin.numpy(), float(small.voxel_size))
    ray_args = (128, 72, pc.get_pos(), pc.get_view(), 45.0, 128 / 72)
    o, d = generate_rays(*ray_args, device="cpu")
    o_g, d_g = generate_rays(*ray_args, device=dev)
    rays_eq = dict(origins=torch.equal(o_g.cpu(), o),
                   directions=torch.equal(d_g.cpu(), d),
                   directions_unequal=int((d_g.cpu() != d).sum()))
    log("card vs CPU", f"generate_rays 128x72: origins equal "
        f"{rays_eq['origins']}, directions equal {rays_eq['directions']} "
        f"({rays_eq['directions_unequal']} components differ)")
    cpu = trace_octree_fast(s_lv, o, d, *sargs, ball_skip=True)
    gpu = trace_octree_fast(s_lv.to(dev), o_g, d_g, *sargs, ball_skip=True)
    pargs = (*sargs, pc.get_pos(), pc.get_view(), 128, 72, 45.0, 128 / 72)
    p_cpu = sweep_exact.trace_pixels_sweep_exact(s_vol, s_lv, *pargs,
                                                 device="cpu")
    p_gpu = sweep_exact.trace_pixels_sweep_exact(s_vol.to(dev), s_lv, *pargs,
                                                 device=dev)
    equal = {}
    for name, a, b in (("trace_octree_fast", gpu, cpu),
                       ("sweep-exact primary", p_gpu, p_cpu)):
        keys = ("hit", "t", "point", "normal") if name == "trace_octree_fast" \
            else ("hit", "t")
        equal[name] = {k: torch.equal(a[k].cpu(), b[k]) for k in keys}
        equal[name]["hits"] = int(b["hit"].sum())
        log("card vs CPU", f"{name}, 32^3 sphere 128x72: equal "
            f"{ {k: equal[name][k] for k in keys} } "
            f"({equal[name]['hits']} hits)")
    if not (rays_eq["origins"] and rays_eq["directions"] and all(
            v for e in equal.values() for k, v in e.items() if k != "hits")):
        raise RuntimeError(f"the card disagrees with the CPU: rays "
                           f"{rays_eq}, {equal}")
    # the host's share of every frame's rays: the view rotation (the
    # reference's f32 LU inverse in scalar Python) beside numpy's inverse
    view = np.asarray(pc.get_view(), np.float32)
    host_us = {name: min(timeit.repeat(fn, number=200, repeat=5)) / 200 * 1e6
               for name, fn in (
                   ("view_rotation", lambda: wk.view_rotation(45.0, view)),
                   ("lu_inverse", lambda: wk.lu_inverse(view)),
                   ("np.linalg.inv", lambda: np.linalg.inv(view)))}
    log("card vs CPU", "host time a call (µs, best of 5 x 200): " + ", ".join(
        f"{k} {v:.1f}" for k, v in host_us.items()))
    out["card_vs_cpu"] = dict(equal, generate_rays=rays_eq, host_us=host_us)
    return out


N_VOLUME = 5          # volume frames per timed window (phase 20)
OW, OH = 480, 272     # the volume oracle's frame (phase 21)
ORACLE_BAR = 0.92     # hit-mask agreement, tests/test_raymarch_sweep.py:60
# the oracle's profiled iterations: max_steps 350 + this leaves each ray
# this many steps (the reference takes 350 off at the far plane's
# distance), and the march stops one iteration later
ORACLE_PROFILED = 40
VOLUME_TOL, VOLUME_SHARE = 1e-4, 0.005   # the CPU tests' image bar


def volume_phases(ctx: dict) -> dict:
    """Phases 19-22: the volume renderer on the 256^3 sphere (init and
    precompute, carving, indirect light, the sweep scene), its frame at
    1920x1080 with warp_lookup_multi's calls kept and held, its per-ray
    oracle at 480x272 against the frame's hit mask, and card against CPU
    on the 32^3 sphere. Returns the record's section, with the frame's
    launches ("launches") and held calls ("held") of warp_lookup_multi."""
    import numpy as np
    import torch

    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )
    from ray_tracing_octrees_tpu_torch.ops import precompute, sampling
    from ray_tracing_octrees_tpu_torch.render.camera import Camera
    from ray_tracing_octrees_tpu_torch.trace import raymarch
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk
    from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
        _view_consts, _warp_setup,
    )

    dev, smi, grid = ctx["dev"], ctx["smi"], ctx["grid"]
    aspect = WIDTH / HEIGHT
    rec = {"card": smi}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # 19. init: each texture pass, then the renderer, carving, light
    torch.cuda.reset_peak_memory_stats()
    vol = (grid.occ > 0).to(torch.float32)
    zero = torch.zeros_like(vol)
    init_ms = {}
    _, init_ms["build_mip_chain"] = timed(lambda: sampling.build_mip_chain(
        vol))
    _, init_ms["precompute_volume"] = timed(
        lambda: precompute.precompute_volume(vol, zero))
    _, init_ms["ambient_occlusion"] = timed(
        lambda: precompute.ambient_occlusion(grid.occ))
    _, init_ms["build_skip_distance"] = timed(
        lambda: precompute.build_skip_distance(
            grid.occ, grid.voxel_size, grid.world_min, grid.world_max))
    r, init_ms["renderer_init"] = timed(
        lambda: VolumeRaycastRenderer(device=dev).init(grid))
    _, init_ms["update_indirect_lighting"] = timed(r.update_indirect_lighting)
    r.add_splat(np.array([0.3, 0.25, 0.1], np.float32), radius=4.0)
    _, init_ms["dispatch_radiation_1_splat"] = timed(r.dispatch_radiation)
    cam = ctx["bench_camera"]()
    hit, init_ms["carve_at_screen"] = timed(lambda: r.carve_at_screen(
        cam, WIDTH / 2, HEIGHT / 2, WIDTH, HEIGHT, aspect))
    if not hit:
        raise RuntimeError("carve_at_screen at the frame centre missed")
    _, init_ms["run_precompute"] = timed(r.run_precompute)
    _, init_ms["prepare_volume_scene"] = timed(r.sweep_scene)
    rec["init_ms"] = init_ms
    rec["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    log("volume init", f"[{smi}] 256^3 sphere: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in init_ms.items())
        + f"; peak {rec['init_peak_bytes'] / 2 ** 30:.2f} GiB")

    # 20. the frame at 1920x1080, the bench pose
    torch.cuda.reset_peak_memory_stats()

    def frame(c, w=WIDTH, h=HEIGHT):
        return r.draw_fast(c, w, h, w / h)

    img0, first_ms = timed(lambda: frame(cam))
    wk.warp_lookup_multi.launches = 0
    calls, restore = held_calls([(rs, "warp_lookup_multi")])
    out = frame(cam)
    restore()
    wins = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(N_VOLUME):
            cam.phi += 1e-4
            frame(cam)
        torch.cuda.synchronize()
        wins.append((time.perf_counter() - t) / N_VOLUME * 1e3)
    launches = wk.warp_lookup_multi.launches
    n_frames = 1 + 3 * N_VOLUME
    held = {"warp_lookup_multi": hold(calls["warp_lookup_multi"],
                                      wk.warp_lookup_multi_reference)}
    require_held("the volume frame", held)
    if launches < n_frames:
        raise RuntimeError(f"warp_lookup_multi launched {launches} times in "
                           f"{n_frames} volume frames")
    # the kernel on this path's inputs: 5 planes, one lin a pixel
    (tab, ln), _ = calls["warp_lookup_multi"][0]
    planes, th, tw = tab.shape
    flat = torch.where(ln < 0, 0, (ln >> 10) * tw + (ln & 1023)).long()
    flat_p = flat[None] + torch.arange(planes, device=dev)[:, None, None] \
        * (th * tw)
    _, per = profiled(lambda: wk.warp_lookup_multi(tab, ln), 50)
    k_ms = sum(v for k, v in per.items() if "warp_lookup_kernel" in k) \
        or None
    _, lper = profiled(lambda: torch.take(tab, flat_p), 50)
    n_px = ln.numel()
    l_bound, l_by = bound(n_px * (4 + 4 * planes)
                          + planes * distinct(flat, ln >= 0) * 4, 5 * n_px)
    lookup = dict(
        ms=k_ms, wrapper_ms=cuda_ms(lambda: wk.warp_lookup_multi(tab, ln),
                                    200),
        plain_ms=cuda_ms(lambda: wk.warp_lookup_multi_reference(tab, ln),
                         20),
        library_ms=sum(lper.values()) or None, bound_ms=l_bound,
        bound_by=l_by, bound_share=l_bound / k_ms if k_ms else None,
        planes=planes, table=[th, tw], pixels=n_px,
        miss_share=float((ln < 0).float().mean()))
    log("volume frame", f"[{smi}] warp_lookup_multi on the frame's "
        f"{planes} planes of {th}x{tw}, {n_px} px: kernel {k_ms} ms "
        f"(profiler), wrapper {lookup['wrapper_ms']:.4f}, plain "
        f"{lookup['plain_ms']:.4f}, torch.take {lookup['library_ms']}, "
        f"bound {l_bound * 1e3:.2f} us ({l_by})")
    color, alpha = out["color"], out["alpha"]
    if tuple(color.shape) != (HEIGHT, WIDTH, 4) or not bool(
            torch.isfinite(color).all()):
        raise RuntimeError(f"bad volume frame {tuple(color.shape)}")
    hits = alpha >= 0.1
    n_lit = int((hits & (color[..., :3].amax(-1) > 0)).sum())
    n_bg = int((~hits).sum())
    black = bool((color[..., :3][~hits] == 0).all())
    if n_lit == 0 or n_bg == 0 or not black:
        raise RuntimeError(f"volume frame: {n_lit} lit, {n_bg} background "
                           f"pixels, misses black {black}")
    wall, per = profiled(lambda: frame(cam), 5)
    busy = sum(per.values())
    # the frame's stages, by CUDA events (layouts rebuilt each call)
    scene = r.sweep_scene()
    args = (scene, grid.origin, cam.get_pos(), cam.get_view(), 45.0, aspect)
    det_bf, cats, scal_np, m = rs._volume_frame_inputs(*args)
    scal = torch.as_tensor(scal_np, device=dev)
    ih, iw = m["inter_h"], m["inter_w"]
    sweep = lambda: rs._volume_sweep(det_bf, cats, scal, m["S"], m["A"],
                                     m["B"], ih, iw, m["flip"], m["nf"])
    packed, vals = sweep()
    consts = torch.as_tensor(_view_consts(scal_np), device=dev)

    def gather():
        lin, _, _, _ = _warp_setup(scal, m["axis_world"], ih, iw, WIDTH,
                                   HEIGHT, consts)
        return rs._gather_table(packed, vals, lin, ih, iw, WIDTH, HEIGHT)

    lin, behind, dirs, d_s_n = _warp_setup(scal, m["axis_world"], ih, iw,
                                           WIDTH, HEIGHT, consts)
    w_depth, w_vals = gather()

    def layouts():
        scene.layouts.clear()
        return rs._volume_frame_inputs(*args)

    stage_ms = {
        "layouts": cuda_ms(layouts, 2),
        "sweep": cuda_ms(sweep, 3),
        "ray setup + gather": cuda_ms(gather, 10),
        "shade": cuda_ms(lambda: rs._shade_pixels(
            w_depth, w_vals, behind, dirs, d_s_n, scal, 0.0, WIDTH, HEIGHT),
            10),
    }
    frame_ms = min(wins)
    rec["frame"] = dict(
        resolution=f"{WIDTH}x{HEIGHT}", pose="bench (theta 0.9, phi 0.8, "
        "radius 0.75 x extent)", frame_ms=frame_ms,
        frame_ms_median=sorted(wins)[1], frame_ms_windows=wins,
        first_frame_ms=first_ms,
        mrays_per_s=WIDTH * HEIGHT * 2 / frame_ms / 1e3,
        mrays_primary_per_s=WIDTH * HEIGHT / frame_ms / 1e3,
        table=[ih, iw], sweep_axis=m["axis_world"], flip=m["flip"],
        profiled_wall_ms=wall, device_busy_ms=busy if per else None,
        idle_share=1.0 - busy / wall if per else None, stage_ms=stage_ms,
        lit=n_lit, background=n_bg,
        peak_bytes=torch.cuda.max_memory_allocated(),
        launches={"warp_lookup_multi": launches}, frames=n_frames,
        warp_lookup_multi=lookup)
    log("volume frame", f"[{smi}] draw_fast {WIDTH}x{HEIGHT}: {frame_ms:.3f} "
        f"ms (windows {', '.join(f'{w:.3f}' for w in wins)}; first "
        f"{first_ms:.1f}), {rec['frame']['mrays_per_s']:.1f} Mrays/s at 2 "
        f"rays a pixel; table {ih}x{iw}, axis {m['axis_world']}; idle share "
        f"{rec['frame']['idle_share']}; stages " + ", ".join(
            f"{k} {v:.3f}" for k, v in stage_ms.items())
        + f" ms; {n_lit} lit, {n_bg} background; warp_lookup_multi "
        f"{launches} launches in {n_frames} frames, held {held}; peak "
        f"{rec['frame']['peak_bytes'] / 2 ** 30:.2f} GiB")

    # 21. the per-ray oracle at 480x272, against the frame's hit mask
    cam = ctx["bench_camera"]()
    fast = frame(cam, OW, OH)
    torch.cuda.reset_peak_memory_stats()
    ref, oracle_ms = timed(lambda: r.draw(cam, OW, OH, OW / OH))
    oracle_peak = torch.cuda.max_memory_allocated()
    hit_f = fast["alpha"] >= 0.1
    hit_o = ref["alpha"] >= 0.1
    agree = float((hit_f == hit_o).float().mean())
    steps = ref["steps"].reshape(-1).float()
    # the idle share over the march's first ORACLE_PROFILED iterations
    # (the same ops each iteration; a whole frame's ~10^6 kernel events
    # take minutes to sum)
    iv = np.linalg.inv(cam.get_view())
    ip = np.linalg.inv(cam.get_proj(OW / OH))
    o_wall, o_per = profiled(lambda: raymarch.raymarch_volume(
        r.textures, cam.get_pos(), iv, ip, OW, OH,
        max_steps=350 + ORACLE_PROFILED, device=dev), 1)
    o_busy = sum(o_per.values())
    rec["oracle"] = dict(
        resolution=f"{OW}x{OH}", ms=oracle_ms, iters=ref["iters"],
        steps_p50=float(steps.median()), steps_max=float(steps.max()),
        hit_share=float(hit_o.float().mean()), hit_agreement=agree,
        bar=ORACLE_BAR, profiled_wall_ms=o_wall,
        profiled_iterations=ORACLE_PROFILED,
        device_busy_ms=o_busy if o_per else None,
        idle_share=1.0 - o_busy / o_wall if o_per else None,
        peak_bytes=oracle_peak, octree_skip_t=r.octree_skip_t)
    log("volume oracle", f"[{smi}] draw {OW}x{OH}: {oracle_ms:.1f} ms, "
        f"{ref['iters']} iterations, steps p50 {rec['oracle']['steps_p50']} "
        f"max {rec['oracle']['steps_max']}; hit mask agrees with draw_fast "
        f"on {agree:.4f} (bar {ORACLE_BAR}); idle share "
        f"{rec['oracle']['idle_share']} over its first {ORACLE_PROFILED} "
        f"iterations; peak {oracle_peak / 2 ** 30:.2f} "
        "GiB")
    if not agree > ORACLE_BAR:
        raise RuntimeError(f"the volume oracle's hit mask agrees with the "
                           f"frame on {agree:.4f}, not over {ORACLE_BAR}")

    # 22. the card against the CPU on the 32^3 sphere, 96x96
    small = ctx["small"]
    pc = Camera(theta=0.5, phi=0.8, radius=2.2)
    cpu_r = VolumeRaycastRenderer(device="cpu").init(small)
    gpu_r = VolumeRaycastRenderer(device=dev).init(small)
    sc = cpu_r.sweep_scene()
    det_c, cats_c, scal_c, mc = rs._volume_frame_inputs(
        sc, small.origin, pc.get_pos(), pc.get_view(), 45.0, 1.0)
    targs = (mc["S"], mc["A"], mc["B"], mc["inter_h"], mc["inter_w"],
             mc["flip"], mc["nf"])
    p_c, v_c = rs._volume_sweep(det_c, cats_c, torch.as_tensor(scal_c),
                                *targs)
    p_g, v_g = rs._volume_sweep(det_c.to(dev), [c.to(dev) for c in cats_c],
                                torch.as_tensor(scal_c, device=dev), *targs)
    tables_equal = torch.equal(p_g.cpu(), p_c) and all(
        torch.equal(a.cpu(), b) for a, b in zip(v_g, v_c))
    f_c = cpu_r.draw_fast(pc, 96, 96, 1.0)
    f_g = gpu_r.draw_fast(pc, 96, 96, 1.0)
    diff = (f_g["color"].cpu() - f_c["color"]).abs().amax(-1)
    over = float((diff > VOLUME_TOL).float().mean())
    d_c = cpu_r.draw(pc, 96, 96, 1.0)
    d_g = gpu_r.draw(pc, 96, 96, 1.0)
    d_agree = float(((d_g["alpha"].cpu() >= 0.1) == (d_c["alpha"] >= 0.1))
                    .float().mean())
    rec["card_vs_cpu"] = dict(
        sweep_tables_bitwise=tables_equal, draw_fast_share_over_1e4=over,
        draw_fast_max_abs=float(diff.max()), draw_hit_agreement=d_agree,
        draw_iters=[d_g["iters"], d_c["iters"]])
    log("volume card vs CPU", f"32^3 sphere 96x96: _volume_sweep's packed "
        f"table and 4 channels equal {tables_equal}; draw_fast share over "
        f"1e-4 {over:.5f} (max {float(diff.max()):.3g}); draw hit masks "
        f"agree on {d_agree:.4f}, iterations {d_g['iters']} / {d_c['iters']}")
    if not (tables_equal and over <= VOLUME_SHARE and d_agree >= 0.99):
        raise RuntimeError(f"the volume renderer on the card disagrees with "
                           f"the CPU: {rec['card_vs_cpu']}")
    return dict(rec, launches=launches, held=held, renderer=r)


# The JAX package's counts on the 256^3 sphere (its build_linear_octree,
# count_mc_triangles, count_block_triangles and adaptive_dual_contouring
# with node_id_vol and tree_meta, on the CPU)
SPHERE_COUNTS = dict(nodes=374921, leaves=328056, mc=493816, blocks=399372,
                     adaptive_dc=228288)
# the CPU tests' bars for DC against a reference: vertices, normals
DC_TOL = (2e-6, 2e-4)
# phase 25's non-default QEF and DC toggles (the CPU tests' QEF_ALT and
# DC_ALT, tests/test_torch_dual_contouring.py)
QEF_ALT = dict(regularization=0.05, masspoint_mix=0.5)
DC_ALT = dict(max_size_ratio=4, face_fan_divisions=1)
N_QUERIES = 1 << 16   # seeded find_node queries (phase 23)
# a frustum margin that culls part of the sphere's tree at the bench pose
# (the CPU tests' margin; the config's margins, 50, 150 and 20, keep every
# node of a scene one unit across)
CULL_MARGIN = 0.05
# the host's waits for the card in one call of each extraction pipeline:
# adaptive DC waits for the need-vertex mask, the fan candidates and the
# kept rows, and with its rows on the host for their two copies
HOST_SYNCS = {"adaptive_dc": 3, "adaptive_dc host rows": 5,
              "adaptive_dc culled": 3, "adaptive_dc culled 0.05": 3}


def count_syncs(fn) -> int:
    """The times one call of ``fn`` makes the host wait for the card, as
    PyTorch's sync debug mode reports them (copies to the host, nonzero,
    item, blocking copies from pageable host memory)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def sync_sites(fn) -> dict:
    """The Python lines at which one call of ``fn`` makes the host wait
    for the card ("file:line" -> count), as :func:`count_syncs` finds
    them."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{os.path.basename(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def kernel_counts() -> dict:
    """Every kernel's launch count: the three frame kernels' counters and
    exp_warp.cu's forms summed."""
    from ray_tracing_octrees_tpu_torch.trace import exp_warp
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    return {"warp_frame": wk.warp_frame.launches,
            "warp_lookup": wk.warp_lookup.launches,
            "warp_lookup_multi": wk.warp_lookup_multi.launches,
            "exp_warp": sum(exp_warp.FORM_LAUNCHES.values())}


def extraction_phases(ctx: dict) -> dict:
    """Phases 23-25: the linear octree of the 256^3 sphere (build, node-id
    volume, both lookups), the three extraction pipelines at the bench
    pose unculled and culled (at the config's margin and at CULL_MARGIN,
    which culls part of the tree), with their times, triangles/s, peak
    memory, host syncs and DC's idle share, and card against CPU on the
    32^3 and 64^3 spheres, unculled and at CULL_MARGIN. Extraction is
    plain PyTorch: every kernel's count must stay 0 over phase 24. Returns the record's section, with the tree
    ("tree") for phase 26."""
    import numpy as np
    import torch

    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.core.octree import (
        build_linear_octree, build_node_id_volume, find_node_vol,
    )
    from ray_tracing_octrees_tpu_torch.models.extraction import (
        MarchingCubesRenderer, VoxelBlockRenderer,
    )
    from ray_tracing_octrees_tpu_torch.ops import blocks
    from ray_tracing_octrees_tpu_torch.ops import dual_contouring as dc
    from ray_tracing_octrees_tpu_torch.ops import marching_cubes as mcm
    from ray_tracing_octrees_tpu_torch.render.frustum import visible_node_mask

    dev, smi, grid = ctx["dev"], ctx["smi"], ctx["grid"]
    rec = {"card": smi}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # 23. the linear octree
    torch.cuda.reset_peak_memory_stats()
    tree, build_s = timed(lambda: build_linear_octree(grid.occ, device=dev))
    vol, vol_s = timed(lambda: build_node_id_volume(tree))
    n_leaves = int(tree.is_leaf.sum())
    leaf = tree.is_leaf
    corners = [c[leaf] for c in (tree.x, tree.y, tree.z)]
    corners_equal = torch.equal(find_node_vol(tree, vol, *corners),
                                tree.find_node(*corners))
    S = vol.shape[0]
    q = torch.as_tensor(np.random.default_rng(453).integers(
        -16, S + 16, (3, N_QUERIES)), device=dev)
    by_vol, by_search = find_node_vol(tree, vol, *q), tree.find_node(*q)
    inside = ((q >= 0) & (q < S)).all(0)
    queries_equal = torch.equal(by_vol[inside], by_search[inside]) and bool(
        (by_vol[~inside] == -1).all())
    rec["linear_octree"] = dict(
        nodes=tree.num_nodes, leaves=n_leaves, build_s=build_s,
        node_id_volume_s=vol_s, node_id_volume_shape=list(vol.shape),
        leaf_corners=int(leaf.sum()), leaf_corners_equal=corners_equal,
        queries=N_QUERIES, queries_out_of_cube=int((~inside).sum()),
        queries_equal=queries_equal,
        peak_bytes=torch.cuda.max_memory_allocated())
    log("linear octree", f"[{smi}] 256^3 sphere: {tree.num_nodes} nodes, "
        f"{n_leaves} leaves; build {build_s:.3f} s (numpy on the host, then "
        f"to the card), node-id volume {tuple(vol.shape)} {vol_s:.3f} s; "
        f"find_node_vol = find_node on {int(leaf.sum())} leaf corners "
        f"{corners_equal} and on {N_QUERIES} queries "
        f"({int((~inside).sum())} out of the cube) {queries_equal}; peak "
        f"{rec['linear_octree']['peak_bytes'] / 2 ** 30:.2f} GiB")
    if (tree.num_nodes, n_leaves) != (SPHERE_COUNTS["nodes"],
                                      SPHERE_COUNTS["leaves"]):
        raise RuntimeError(f"linear octree: {tree.num_nodes} nodes, "
                           f"{n_leaves} leaves, not {SPHERE_COUNTS}")
    if not (corners_equal and queries_equal):
        raise RuntimeError("find_node_vol disagrees with find_node")

    # 24. extraction at the bench pose, unculled and culled
    cfg = EngineConfig()
    margin = cfg.extraction_frustum_margin
    cam = ctx["bench_camera"]()
    vp = (cam.get_proj(16 / 9) @ cam.get_view()).astype(np.float32)
    meta = dc.tree_host_meta(tree)
    node_mask = visible_node_mask(tree, grid.origin, grid.voxel_size, vp,
                                  margin)
    tight_mask = visible_node_mask(tree, grid.origin, grid.voxel_size, vp,
                                   CULL_MARGIN)
    tight = cfg.replace(extraction_frustum_margin=CULL_MARGIN)
    mc = MarchingCubesRenderer(cfg, device=dev)
    vb = VoxelBlockRenderer(cfg, device=dev)
    mc_tight = MarchingCubesRenderer(tight, device=dev)
    vb_tight = VoxelBlockRenderer(tight, device=dev)
    g64 = make_sphere_grid(64, device=dev)

    def adaptive(**kw):
        return lambda: dc.adaptive_dual_contouring(
            grid, tree, node_id_vol=vol, tree_meta=meta, device=dev, **kw)

    pipelines = {
        "mc": lambda: mc.render(grid),
        "mc culled": lambda: mc.render(grid, vp),
        "mc culled 0.05": lambda: mc_tight.render(grid, vp),
        "blocks": lambda: vb.render(grid, tree),
        "blocks culled": lambda: vb.render(grid, tree, vp),
        "blocks culled 0.05": lambda: vb_tight.render(grid, tree, vp),
        "adaptive_dc": adaptive(device_out=True),
        "adaptive_dc host rows": adaptive(),
        "adaptive_dc culled": adaptive(device_out=True, node_mask=node_mask),
        "adaptive_dc culled 0.05": adaptive(device_out=True,
                                            node_mask=tight_mask),
        "uniform_dc 64^3": lambda: dc.dual_contour_uniform(
            g64, 65536, 262144, device=dev),
    }
    before = kernel_counts()
    runs, outs = {}, {}
    for name, fn in pipelines.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, first_s = timed(fn)
        peak = torch.cuda.max_memory_allocated() - base
        wins = []
        for _ in range(3):
            _, sec = timed(fn)
            wins.append(sec * 1e3)
        n = int(out[2])
        run = dict(triangles=n, first_ms=first_s * 1e3, ms=min(wins),
                   ms_windows=wins, triangles_per_s=n / (min(wins) / 1e3),
                   peak_bytes=peak, host_syncs=count_syncs(fn))
        if "dc" in name:
            wall, per = profiled(fn, 1)
            busy = sum(per.values())
            run.update(profiled_wall_ms=wall,
                       device_busy_ms=busy if per else None,
                       idle_share=1.0 - busy / wall if per else None)
        runs[name], outs[name] = run, out
        log("extraction", f"[{smi}] {name}: {n} triangles, {min(wins):.2f} ms "
            f"warm (windows {', '.join(f'{w:.2f}' for w in wins)}; first "
            f"{first_s * 1e3:.1f}), {run['triangles_per_s'] / 1e6:.2f} M "
            f"triangles/s, peak {peak / 2 ** 30:.3f} GiB above the "
            f"resident {base / 2 ** 30:.2f}, {run['host_syncs']} host syncs"
            + (f", idle share {run['idle_share']}" if "dc" in name else ""))
    after = kernel_counts()
    launched = {k: after[k] - before[k] for k in after}
    rec["extraction"] = dict(pose="bench (theta 0.9, phi 0.8, radius 0.75 x "
                             "extent), 16:9 projection", margin=margin,
                             visible_nodes=int(node_mask.sum()),
                             cull_margin=CULL_MARGIN,
                             visible_nodes_cull_margin=int(tight_mask.sum()),
                             runs=runs, kernel_launches=launched)
    host, devo = outs["adaptive_dc host rows"], outs["adaptive_dc"]
    same_rows = torch.equal(devo[0].cpu(), host[0]) and torch.equal(
        devo[1].cpu(), host[1])
    for name, want in (("mc", "mc"), ("blocks", "blocks"),
                       ("adaptive_dc", "adaptive_dc"),
                       ("adaptive_dc host rows", "adaptive_dc")):
        if runs[name]["triangles"] != SPHERE_COUNTS[want]:
            raise RuntimeError(f"{name}: {runs[name]['triangles']} triangles, "
                               f"the JAX package gives {SPHERE_COUNTS[want]}")
    for name in ("mc", "blocks", "adaptive_dc"):
        if runs[f"{name} culled"]["triangles"] > runs[name]["triangles"]:
            raise RuntimeError(f"{name}: culling added triangles")
        if not (0 < runs[f"{name} culled 0.05"]["triangles"]
                < runs[name]["triangles"]):
            raise RuntimeError(f"{name}: margin {CULL_MARGIN} culled "
                               f"nothing or everything")
    syncs = {k: v["host_syncs"] for k, v in runs.items()}
    want_syncs = {k: HOST_SYNCS.get(k, 0) for k in runs}
    if syncs != want_syncs:
        raise RuntimeError(f"extraction's host syncs {syncs}, not "
                           f"{want_syncs}")
    if not same_rows:
        raise RuntimeError("adaptive DC's device rows differ from its host "
                           "rows")
    if runs["uniform_dc 64^3"]["triangles"] in (0, 262144):
        raise RuntimeError("uniform DC on the 64^3 sphere: empty or "
                           "truncated")
    for o in outs.values():
        c = int(o[2])
        if not bool(torch.isfinite(o[0][:c]).all() & torch.isfinite(
                o[1][:c]).all()):
            raise RuntimeError("extraction gave non-finite rows")
    if any(launched.values()):
        raise RuntimeError(f"extraction launched kernels: {launched}")
    log("extraction", f"no kernel launched over the {len(pipelines)} "
        f"pipelines' runs: {launched}; device rows = host rows "
        f"{same_rows}; {int(node_mask.sum())} of {tree.num_nodes} nodes "
        f"visible at margin {margin}, {int(tight_mask.sum())} at margin "
        f"{CULL_MARGIN}; host syncs {syncs}")

    # 25. the card against the CPU on the 32^3 and 64^3 spheres
    import dataclasses

    from ray_tracing_octrees_tpu_torch.config import DCConfig, QEFConfig

    cmp = {}
    for dim in (32, 64):
        gc = make_sphere_grid(dim, device="cpu")
        gg = gc.to(dev)
        tc = build_linear_octree(gc.occ, device="cpu")
        tg = build_linear_octree(gg.occ, device=dev)
        vc, vg = build_node_id_volume(tc), build_node_id_volume(tg)
        tree_eq = all(torch.equal(getattr(tg, f.name).cpu(),
                                  getattr(tc, f.name))
                      for f in dataclasses.fields(tc)) and torch.equal(
            vg.cpu(), vc)
        # node masks at a margin that culls part of the tree
        mc_ = visible_node_mask(tc, gc.origin, gc.voxel_size, vp,
                                CULL_MARGIN)
        mg = visible_node_mask(tg, gg.origin, gg.voxel_size, vp,
                               CULL_MARGIN)
        mask_eq = torch.equal(mg.cpu(), mc_)
        n_mc = int(mcm.count_mc_triangles(gc))
        n_bl = int(blocks.count_block_triangles(gc, tc))
        cut = tight.replace(max_triangles=max(n_mc, n_bl))
        culled = {d: (MarchingCubesRenderer(cut, device=d),
                      VoxelBlockRenderer(cut, device=d)) for d in ("cpu", dev)}
        soups = {
            "mc": (mcm.marching_cubes_grid(gc, n_mc, device="cpu"),
                   mcm.marching_cubes_grid(gg, n_mc, device=dev)),
            "blocks": (blocks.extract_block_faces(gc, tc, n_bl, device="cpu"),
                       blocks.extract_block_faces(gg, tg, n_bl, device=dev)),
            "mc culled": (culled["cpu"][0].render(gc, vp),
                          culled[dev][0].render(gg, vp)),
            "blocks culled": (culled["cpu"][1].render(gc, tc, vp),
                              culled[dev][1].render(gg, tg, vp)),
        }
        exact = {k: int(a[2]) == int(b[2]) and all(
            torch.equal(x.cpu(), y) for x, y in zip(b[:2], a[:2]))
            for k, (a, b) in soups.items()}
        dcs = {
            "adaptive_dc": (
                dc.adaptive_dual_contouring(gc, tc, node_id_vol=vc,
                                            device="cpu"),
                dc.adaptive_dual_contouring(gg, tg, node_id_vol=vg,
                                            device=dev)),
            "adaptive_dc culled": (
                dc.adaptive_dual_contouring(gc, tc, node_mask=mc_,
                                            node_id_vol=vc, device="cpu"),
                dc.adaptive_dual_contouring(gg, tg, node_mask=mg,
                                            node_id_vol=vg, device=dev)),
            "uniform_dc": (dc.dual_contour_uniform(gc, 65536, 262144,
                                                   device="cpu"),
                           dc.dual_contour_uniform(gg, 65536, 262144,
                                                   device=dev)),
            # the QEF and DC toggles away from their defaults
            "adaptive_dc configs": tuple(
                dc.adaptive_dual_contouring(g_, t_, node_id_vol=v_,
                                            qef_cfg=QEFConfig(**QEF_ALT),
                                            dc_cfg=DCConfig(**DC_ALT),
                                            device=d)
                for g_, t_, v_, d in ((gc, tc, vc, "cpu"),
                                      (gg, tg, vg, dev))),
        }
        close = {}
        for k, (a, b) in dcs.items():
            c = int(a[2])
            dv = float((b[0][:c].cpu() - a[0][:c]).abs().max()) if c else 0.0
            dn = float((b[1][:c].cpu() - a[1][:c]).abs().max()) if c else 0.0
            close[k] = dict(count_cpu=c, count_card=int(b[2]), max_vertex=dv,
                            max_normal=dn, ok=int(b[2]) == c and dv <= DC_TOL[0]
                            and dn <= DC_TOL[1])
        kept = {k: (int(soups[f"{k} culled"][0][2]), int(soups[k][0][2]))
                for k in ("mc", "blocks")}
        kept["adaptive_dc"] = (close["adaptive_dc culled"]["count_cpu"],
                               close["adaptive_dc"]["count_cpu"])
        cuts = all(0 < a < b for a, b in kept.values()) and 0 < int(
            mc_.sum()) < tc.num_nodes
        cmp[f"{dim}^3"] = dict(tree_bitwise=tree_eq, bitwise=exact,
                               triangles={"mc": n_mc, "blocks": n_bl},
                               dc=close, cull_margin=CULL_MARGIN,
                               node_mask_bitwise=mask_eq,
                               visible_nodes=int(mc_.sum()),
                               culled_vs_unculled_triangles=kept)
        log("extraction card vs CPU", f"{dim}^3 sphere: tree and node-id "
            f"volume equal {tree_eq}; MC ({n_mc}) and blocks ({n_bl}) "
            f"bitwise {exact}; DC {close}; at margin {CULL_MARGIN} "
            f"{int(mc_.sum())} of {tc.num_nodes} nodes visible, node masks "
            f"equal {mask_eq}, triangles (culled, unculled) {kept}")
        if not (tree_eq and mask_eq and cuts and all(exact.values())
                and all(v["ok"] for v in close.values())):
            raise RuntimeError(f"extraction on the card disagrees with the "
                               f"CPU on the {dim}^3 sphere: {cmp[f'{dim}^3']}")
    rec["card_vs_cpu"] = cmp
    return dict(rec, tree=tree)


def linear_tree_phases(ctx: dict) -> dict:
    """Phase 26: the branches the linear octree opens.
    OctreeRayTracer.set_octree(tree=...) and update_frustum at the bench
    pose (visible_count against a recount of visible_node_mask, every
    child index of visible_tree in range or -1), then render at 1920x1080
    (fast=True at the bench pose, the default route at radius 2.0) with
    every kernel call held bitwise; update_frustum at CULL_MARGIN, which
    culls part of the tree, its visible_tree bitwise against the CPU's;
    draw_fast at 1920x1080 after
    VolumeRaycastRenderer.update_frustum_culling(tree=...), its
    warp_lookup_multi counted and held; and the exact working volume at
    CULL_MARGIN bitwise against the CPU's. Returns the record's section,
    with the kernels' launches ("launches") and held calls ("held") by
    path."""
    import numpy as np
    import torch

    from ray_tracing_octrees_tpu_torch.models import volume_raycaster as vr
    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        OctreeRayTracer,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import perspective
    from ray_tracing_octrees_tpu_torch.render.frustum import visible_node_mask
    from ray_tracing_octrees_tpu_torch.trace import (
        fast_exact, slab_sweep, sweep_exact,
    )
    from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
        compact_visible_nodes,
    )
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    dev, smi, grid, tree = ctx["dev"], ctx["smi"], ctx["grid"], ctx["tree"]
    aspect = WIDTH / HEIGHT
    kernels = {"warp_frame": wk.warp_frame, "warp_lookup": wk.warp_lookup,
               "warp_lookup_multi": wk.warp_lookup_multi}
    references = {"warp_frame": wk.warp_frame_reference,
                  "warp_lookup": wk.warp_lookup_reference,
                  "warp_lookup_multi": wk.warp_lookup_multi_reference}
    out = {"launches": {}, "held": {}}

    tracer = OctreeRayTracer(device=dev)
    tracer.set_octree(grid, pyramid=ctx["pyr"], tree=tree)
    cam = ctx["bench_camera"]()
    vp = (cam.get_proj(aspect) @ cam.get_view()).astype(np.float32)
    t = time.perf_counter()
    tracer.update_frustum(vp)
    torch.cuda.synchronize()
    cull_s = time.perf_counter() - t
    margin = tracer.config.raytrace.frustum_margin
    vis = visible_node_mask(tree, grid.origin, grid.voxel_size, vp, margin)
    recount = int(vis[1:].sum()) + 1          # the root is always kept
    ch = tracer.visible_tree.children
    n_vis = tracer.visible_count
    children_ok = bool(((ch == -1) | ((ch >= 0) & (ch < n_vis))).all())
    out["tracer_tree"] = dict(visible_count=n_vis, recount=recount,
                              nodes=tree.num_nodes, margin=margin,
                              children_in_range=children_ok,
                              update_frustum_s=cull_s)
    log("linear tree", f"OctreeRayTracer.update_frustum at the bench pose: "
        f"visible_count {n_vis} of {tree.num_nodes} (recount {recount}, "
        f"margin {margin}), children in range or -1 {children_ok}, "
        f"{cull_s * 1e3:.1f} ms")
    if n_vis != recount or not children_ok:
        raise RuntimeError(f"the compacted node buffer is wrong: "
                           f"{out['tracer_tree']}")
    # at a margin that culls part of the tree: the compaction and its
    # child remap against the same functions on the CPU
    cull_cfg = tracer.config.replace(raytrace=dataclasses.replace(
        tracer.config.raytrace, frustum_margin=CULL_MARGIN))
    culling = OctreeRayTracer(config=cull_cfg, device=dev)
    culling.set_octree(grid, pyramid=ctx["pyr"], tree=tree)
    culling.update_frustum(vp)
    tree_cpu = tree.to("cpu")
    ref_tree, ref_count = compact_visible_nodes(tree_cpu, visible_node_mask(
        tree_cpu, grid.origin.cpu(), grid.voxel_size.cpu(), vp, CULL_MARGIN))
    got = culling.visible_tree
    tree_equal = all(torch.equal(getattr(got, f.name).cpu(),
                                 getattr(ref_tree, f.name))
                     for f in dataclasses.fields(ref_tree))
    ch = got.children
    n_cut = culling.visible_count
    cut_children_ok = bool(((ch == -1) | ((ch >= 0) & (ch < n_cut))).all())
    out["tracer_tree_culled"] = dict(
        margin=CULL_MARGIN, visible_count=n_cut, cpu_count=int(ref_count),
        nodes=tree.num_nodes, visible_tree_bitwise_cpu=tree_equal,
        children_in_range=cut_children_ok)
    log("linear tree", f"update_frustum at margin {CULL_MARGIN}: "
        f"visible_count {n_cut} of {tree.num_nodes} (CPU {int(ref_count)}), "
        f"visible_tree bitwise equal to the CPU's {tree_equal}, children in "
        f"range or -1 {cut_children_ok}")
    if not (tree_equal and cut_children_ok and n_cut == int(ref_count)
            and 0 < n_cut < tree.num_nodes):
        raise RuntimeError(f"the culled node buffer is wrong: "
                           f"{out['tracer_tree_culled']}")
    for label, camera, kw, want in (
            ("fast=True, bench pose", ctx["bench_camera"], dict(fast=True),
             "fast"),
            ("default, radius 2.0", ctx["exact_camera"], {}, "sweep_exact")):
        calls, restore = held_calls([
            (slab_sweep, "warp_frame"), (slab_sweep, "warp_lookup"),
            (sweep_exact, "warp_lookup"), (fast_exact, "warp_lookup_multi")])
        for fn in kernels.values():
            fn.launches = 0
        t = time.perf_counter()
        try:
            img = tracer.render(camera(), WIDTH, HEIGHT, aspect,
                                shadows=True, **kw)
            torch.cuda.synchronize()
        finally:
            restore()
        seconds = time.perf_counter() - t
        launched = {k: fn.launches for k, fn in kernels.items()}
        held = {k: hold(v, references[k]) for k, v in calls.items() if v}
        path = f"OctreeRayTracer with a bound tree, {label} (phase 26)"
        out["launches"][path] = launched
        for k, h in held.items():
            out["held"].setdefault(k, {})[path] = h
        log("linear tree", f"render {label}: path {tracer.last_path}, "
            f"{seconds:.2f} s; launches {launched}; held {held}")
        unkept = [k for k, v in launched.items() if v and k not in held]
        if (tracer.last_path != want or tuple(img.shape) != (HEIGHT, WIDTH, 4)
                or not sum(launched.values()) or unkept):
            raise RuntimeError(f"OctreeRayTracer with a tree, {label}: path "
                               f"{tracer.last_path}, launches {launched}, "
                               f"unkept {unkept}")
        require_held(f"OctreeRayTracer with a tree, {label}", held)

    # the volume renderer's exact working volume, then its frame
    r = ctx["volume_renderer"]
    r.update_frustum_culling(cam, aspect)
    kept_cells = int((r.textures.working > 0).sum())
    t = time.perf_counter()
    r.update_frustum_culling(cam, aspect, tree=tree)
    torch.cuda.synchronize()
    wv_s = time.perf_counter() - t
    kept_tree = int((r.textures.working > 0).sum())
    # the exact working volume at a margin that culls part of the tree,
    # against the CPU's
    wvp = (perspective(r.config.raymarch.frustum_fov_narrow_deg, aspect,
                       0.01, 5000.0) @ cam.get_view()).astype(np.float32)
    wv_card = vr._working_volume_octree(grid.occ, tree, grid.origin,
                                        grid.voxel_size, wvp, CULL_MARGIN)
    wv_cpu = vr._working_volume_octree(grid.occ.cpu(), tree_cpu,
                                       grid.origin.cpu(),
                                       grid.voxel_size.cpu(), wvp,
                                       CULL_MARGIN)
    wv_equal = torch.equal(wv_card.cpu(), wv_cpu)
    kept_cut = int((wv_cpu > 0).sum())
    wk.warp_lookup_multi.launches = 0
    calls, restore = held_calls([(rs, "warp_lookup_multi")])
    t = time.perf_counter()
    try:
        frame = r.draw_fast(cam, WIDTH, HEIGHT, aspect)
        torch.cuda.synchronize()
    finally:
        restore()
    first_ms = (time.perf_counter() - t) * 1e3
    launches = wk.warp_lookup_multi.launches
    held = {"warp_lookup_multi": hold(calls["warp_lookup_multi"],
                                      wk.warp_lookup_multi_reference)}
    path = "volume frame after update_frustum_culling(tree=...) (phase 26)"
    out["launches"][path] = {"warp_lookup_multi": launches}
    out["held"].setdefault("warp_lookup_multi", {})[path] = \
        held["warp_lookup_multi"]
    color = frame["color"]
    hits = frame["alpha"] >= 0.1
    n_lit = int((hits & (color[..., :3].amax(-1) > 0)).sum())
    solid = int((grid.occ > 0).sum())
    out["volume"] = dict(voxels_kept_tree=kept_tree,
                         voxels_kept_8cubed_cells=kept_cells,
                         solid_voxels=solid, cull_margin=CULL_MARGIN,
                         voxels_kept_tree_cull_margin=kept_cut,
                         working_volume_bitwise_cpu=wv_equal,
                         working_volume_octree_s=wv_s,
                         frame_ms_with_scene_rebuild=first_ms,
                         launches=launches, lit=n_lit)
    log("linear tree", f"VolumeRaycastRenderer.update_frustum_culling(tree="
        f"...) at the bench pose: {kept_tree} voxels kept (the 8^3-cell "
        f"working volume keeps {kept_cells} of "
        f"{out['volume']['solid_voxels']}), {wv_s * 1e3:.1f} ms; draw_fast "
        f"{WIDTH}x{HEIGHT} {first_ms:.1f} ms with the sweep scene rebuilt; "
        f"warp_lookup_multi {launches} launches, held {held}; {n_lit} lit; "
        f"at margin {CULL_MARGIN} the exact working volume keeps {kept_cut} "
        f"voxels, bitwise equal to the CPU's {wv_equal}")
    if not (wv_equal and 0 < kept_cut < solid):
        raise RuntimeError(f"the exact working volume at margin "
                           f"{CULL_MARGIN}: {kept_cut} of {solid} voxels "
                           f"kept, equal to the CPU's {wv_equal}")
    if launches < 1 or not bool(torch.isfinite(color).all()) or not n_lit:
        raise RuntimeError(f"the volume frame after the exact culling: "
                           f"{launches} launches, {n_lit} lit pixels")
    require_held("the volume frame after update_frustum_culling(tree=...)",
                 held)
    return out


# The MC mesh frame (the JAX benchmarks' config 4: benchmarks.py:158-256)
MESH_W, MESH_H = 1920, 1088
MESH_DIM = 128        # config 4's scene while sceneCache.bin is absent
MESH_FRAMES = 10      # distinct poses a timed window, as config 4 times
# the JAX package's MC triangle count on the 128^3 sphere (its
# count_mc_triangles on the CPU)
MESH_TRIANGLES = 123352
LBVH_W, LBVH_H = 480, 270
ORACLE_INTER = 256    # the texel trace held against the LBVH oracle
# tests/test_mesh_grid.py:85-96's bars: hit mismatch, t rtol on shared
# hits, share of shared hits within rtol 1e-4, unit-normal tolerance
ORACLE_BARS = dict(mismatch=0.005, t_rtol=2e-3, t_close_share=0.995,
                   unit=1e-4)
# the seeded city's voxel size (m), as the Calgary ingest's
CITY_VOXEL = 5.0


def mesh_phases(ctx: dict) -> dict:
    """Phases 27-30: the MC mesh frame of config 4 on the 128^3 sphere
    (10 distinct poses a window, warp_lookup's calls held) and a window
    on the 256^3 sphere; the LBVH oracle (build over the 128^3 sphere's
    MC triangles, primary and shadow traces at 480x270, the texel trace
    held to tests/test_mesh_grid.py's bars against it); ingest of the
    seeded city (native parse, assembly and voxelizer; the dense
    voxelizer on the card equal to the native grid) and its mesh frame;
    card against CPU on the 32^3 sphere. Returns the record's section,
    with warp_lookup's launches ("launches") and held calls ("held") by
    path."""
    import tempfile

    import numpy as np
    import torch

    from ray_tracing_octrees_tpu_torch.core.grid import (
        building_center, make_sphere_grid, recenter_filled_voxels,
    )
    from ray_tracing_octrees_tpu_torch.ingest import csv_loader
    from ray_tracing_octrees_tpu_torch.ingest.city import write_city_csv
    from ray_tracing_octrees_tpu_torch.ingest import voxelize as ivox
    from ray_tracing_octrees_tpu_torch.native import runtime
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        count_mc_triangles, marching_cubes_grid,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import (
        Camera, generate_rays,
    )
    from ray_tracing_octrees_tpu_torch.trace import lbvh, mesh_grid
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    dev, smi, grid = ctx["dev"], ctx["smi"], ctx["grid"]
    light_dir = tuple(-c for c in TO_LIGHT)
    aspect = MESH_W / MESH_H
    rec = {"card": smi}
    out = {"launches": {}, "held": {"warp_lookup": {}}}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    placed = {}

    def pose_of(g, i):
        """Config 4's i-th pose around ``g`` (its extent and centre read
        from the card once a grid, outside the frames)."""
        if id(g) not in placed:
            placed[id(g)] = (g, float((g.world_max - g.world_min).max()),
                             building_center(g))
        _, extent, center = placed[id(g)]
        cam = Camera(theta=0.9 + 0.013 * i, phi=0.8 - 0.007 * i,
                     radius=0.75 * extent)
        cam.set_target(center)
        return cam

    def mframe(scene, cam, w=MESH_W, h=MESH_H, **kw):
        return mesh_grid.render_mc_mesh_frame(
            scene, cam.get_pos(), cam.get_view(), 45.0, w / h, w, h,
            light_dir=light_dir, device=dev, **kw)

    def held_frame(label, scene, cam):
        """One frame with warp_lookup's count set to 0 before it and its
        calls kept: (image, stats, launches, hold)."""
        wk.warp_lookup.launches = 0
        calls, restore = held_calls([(slab_sweep, "warp_lookup")])
        try:
            img, stats = mframe(scene, cam, with_stats=True)
            torch.cuda.synchronize()
        finally:
            restore()
        n = wk.warp_lookup.launches
        h = {"warp_lookup": hold(calls["warp_lookup"],
                                 wk.warp_lookup_reference)}
        require_held(label, h)
        if n < 1:
            raise RuntimeError(f"{label}: warp_lookup did not launch")
        return img, stats, n, h["warp_lookup"]

    def classes_ok(label, img, need_shadow=True):
        lit, shadowed, bg = frame_classes(img)
        if (tuple(img.shape) != (MESH_H, MESH_W, 4)
                or not bool(torch.isfinite(img).all()) or lit == 0
                or bg == 0 or (need_shadow and shadowed == 0)):
            raise RuntimeError(f"{label}: {tuple(img.shape)}, {lit} lit, "
                               f"{shadowed} shadowed, {bg} background")
        return dict(lit=lit, shadowed=shadowed, background=bg)

    def stage_ms(scene, cam, frames: int = 3):
        """Per-stage ms of the frame by CUDA events (mean of ``frames``)."""
        acc = {}
        for _ in range(frames):
            torch.cuda.synchronize()
            marks = [("start", torch.cuda.Event(enable_timing=True))]
            marks[0][1].record()

            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((name, e))
            setup, scal_np = mesh_grid._frame_setup(
                scene, cam.get_pos(), cam.get_view(), 45.0, aspect,
                light_dir, (1.0, 0.8, 0.6), (0.1, 0.1, 0.1))
            mesh_grid._mesh_frame(scene, scal_np, setup, MESH_W, MESH_H,
                                  1024, 1024, 8, 512, mark=mark)
            torch.cuda.synchronize()
            for (_, a), (name, b) in zip(marks, marks[1:]):
                acc[name] = acc.get(name, 0.0) + a.elapsed_time(b) / frames
        return acc

    # 27. the mesh frame, config 4: the 128^3 sphere at 1920x1088
    g128 = make_sphere_grid(MESH_DIM, device=dev)
    scene, prep_ms = timed(lambda: mesh_grid.prepare_mc_scene(
        g128.occ, g128.origin, g128.voxel_size, to_light=TO_LIGHT,
        device=dev))
    _, first_ms = timed(lambda: mframe(scene, pose_of(g128, 0)))
    img, stats, n_held, h = held_frame("the mesh frame", scene,
                                       pose_of(g128, 1))
    cls = classes_ok("the mesh frame", img)
    hit_frac = float((img[..., :3].amax(-1) > 0).float().mean())
    wk.warp_lookup.launches = 0
    wins = []
    for _ in range(3):
        t = time.perf_counter()
        for i in range(1, MESH_FRAMES + 1):
            mframe(scene, pose_of(g128, i))
        torch.cuda.synchronize()
        wins.append((time.perf_counter() - t) / MESH_FRAMES * 1e3)
    n_win = wk.warp_lookup.launches
    if n_win < 3 * MESH_FRAMES:
        raise RuntimeError(f"warp_lookup launched {n_win} times in "
                           f"{3 * MESH_FRAMES} mesh frames")
    out["launches"]["mesh frame 128^3 (phase 27)"] = {
        "warp_lookup": n_held + n_win}
    out["held"]["warp_lookup"]["mesh frame 128^3 (phase 27)"] = h
    cam2 = pose_of(g128, 2)
    sites = sync_sites(lambda: mframe(scene, cam2))
    syncs = sum(sites.values())
    wall, per = profiled(lambda: mframe(scene, pose_of(g128, 3)), 5)
    busy = sum(per.values())
    stages = stage_ms(scene, pose_of(g128, 4))
    torch.cuda.reset_peak_memory_stats()
    mframe(scene, pose_of(g128, 5))
    peak = torch.cuda.max_memory_allocated()
    ms_min, ms_med = min(wins), float(np.median(wins))
    setup = mesh_grid._scene_sweep_setup(scene, pose_of(g128, 1).get_pos(),
                                         pose_of(g128, 1).get_view(), 45.0,
                                         aspect)
    rec["frame_128"] = dict(
        scene_ms=prep_ms, first_frame_ms=first_ms, ms_windows=wins,
        ms_min=ms_min, ms_median=ms_med,
        mrays_per_s=MESH_W * MESH_H * 2 / (ms_min / 1e3) / 1e6,
        hit_fraction=hit_frac, classes=cls, rounds=stats["rounds"],
        unresolved=stats["unresolved"], hist=stats["hist"],
        overflow=stats["overflow"], host_syncs=syncs, sync_sites=sites,
        host_syncs_counted_by_the_tracer=stats["syncs"],
        profiled_wall_ms=wall, device_busy_ms=busy,
        idle_share=max(0.0, 1.0 - busy / wall) if per else None,
        stage_ms=stages, peak_bytes=peak, sweep_axis=setup[0],
        flip=setup[1], sizes=list(setup[2]), kcells=setup[6],
        case_sw=list(setup[3].shape), launches_held=n_held,
        launches_windows=n_win, held=h)
    log("mesh frame", f"[{smi}] 128^3 sphere, 1920x1088, 1024^2 texels, "
        f"axis {setup[0]} flip {setup[1]} S,A,B {setup[2]} kcells "
        f"{setup[6]}: {ms_min:.3f} ms min, {ms_med:.3f} median of 3 windows "
        f"of {MESH_FRAMES} poses ({rec['frame_128']['mrays_per_s']:.1f} "
        f"Mrays/s at 2 rays a pixel); scene {prep_ms:.1f} ms, first frame "
        f"{first_ms:.1f} ms; hit fraction {hit_frac:.4f}, rounds "
        f"{stats['rounds']}, unresolved {stats['unresolved']}, hist "
        f"{stats['hist']}; host syncs {syncs} a frame ({sites}); idle "
        f"{rec['frame_128']['idle_share']}; peak {peak / 2 ** 30:.2f} GiB; "
        f"stages " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms; warp_lookup {n_held} + {n_win} launches, held "
        f"{h['calls']} calls bitwise")

    # ... and one window on the 256^3 sphere, the scene of the other phases
    scene256, prep256 = timed(lambda: mesh_grid.prepare_mc_scene(
        grid.occ, grid.origin, grid.voxel_size, to_light=TO_LIGHT,
        device=dev))
    _, first256 = timed(lambda: mframe(scene256, pose_of(grid, 0)))
    img256, st256, n256, h256 = held_frame("the 256^3 mesh frame", scene256,
                                           pose_of(grid, 0))
    cls256 = classes_ok("the 256^3 mesh frame", img256)
    wk.warp_lookup.launches = 0
    t = time.perf_counter()
    for i in range(1, MESH_FRAMES + 1):
        mframe(scene256, pose_of(grid, i))
    torch.cuda.synchronize()
    ms256 = (time.perf_counter() - t) / MESH_FRAMES * 1e3
    n256 += wk.warp_lookup.launches
    out["launches"]["mesh frame 256^3 (phase 27)"] = {"warp_lookup": n256}
    out["held"]["warp_lookup"]["mesh frame 256^3 (phase 27)"] = h256
    cam2 = pose_of(grid, 2)
    syncs256 = count_syncs(lambda: mframe(scene256, cam2))
    rec["frame_256"] = dict(
        scene_ms=prep256, first_frame_ms=first256, ms=ms256,
        mrays_per_s=MESH_W * MESH_H * 2 / (ms256 / 1e3) / 1e6,
        hit_fraction=float((img256[..., :3].amax(-1) > 0).float().mean()),
        classes=cls256, rounds=st256["rounds"],
        unresolved=st256["unresolved"], hist=st256["hist"],
        host_syncs=syncs256, launches=n256, held=h256)
    log("mesh frame", f"[{smi}] 256^3 sphere: {ms256:.3f} ms a frame (one "
        f"window of {MESH_FRAMES} poses, "
        f"{rec['frame_256']['mrays_per_s']:.1f} Mrays/s); scene "
        f"{prep256:.1f} ms; rounds {st256['rounds']}, unresolved "
        f"{st256['unresolved']}, syncs {syncs256}; warp_lookup {n256} "
        f"launches, held bitwise")

    # 28. the LBVH oracle over the 128^3 sphere's MC triangles
    total = int(count_mc_triangles(g128))
    verts, _, count = marching_cubes_grid(g128, max_triangles=total,
                                          device=dev)
    n_tris = int(count)
    if n_tris != MESH_TRIANGLES:
        raise RuntimeError(f"MC gave {n_tris} triangles on the 128^3 sphere, "
                           f"the JAX package {MESH_TRIANGLES}")
    tris = verts[:n_tris]
    build_ms = []
    for _ in range(3):
        bvh, ms = timed(lambda: lbvh.build_lbvh(tris, device=dev))
        build_ms.append(ms)
    cam = pose_of(g128, 0)
    o, d = generate_rays(LBVH_W, LBVH_H, cam.get_pos(), cam.get_view(), 45.0,
                         LBVH_W / LBVH_H, device=dev)
    prim, prim_ms = timed(lambda: lbvh.trace_lbvh(bvh, o, d, max_steps=4096))
    l = np.asarray(TO_LIGHT, np.float32)
    l = l / np.linalg.norm(l)
    so = prim["point"] + prim["normal"] * 1e-3
    sd = torch.as_tensor(l, device=dev)[None, :].expand_as(so).contiguous()
    shad, shad_ms = timed(lambda: lbvh.trace_lbvh(bvh, so, sd,
                                                  max_steps=4096))
    ph = prim["hit"]
    lbvh_syncs = count_syncs(lambda: lbvh.trace_lbvh(bvh, o, d,
                                                     max_steps=4096))
    # the texel trace against the oracle on its own rays
    tex = mesh_grid.trace_mc_mesh_texels(
        scene, cam.get_pos(), cam.get_view(), 45.0, aspect, ORACLE_INTER,
        ORACLE_INTER, max_rounds=64, tol_texels=0, device=dev)
    orc, orc_ms = timed(lambda: lbvh.trace_lbvh(bvh, tex["ray_o"],
                                                tex["ray_d"], max_steps=4096))
    o_hit = orc["hit"]
    o_t = orc["t"] * tex["ray_d"].double().norm(dim=-1).float()
    both = tex["hit"] & o_hit
    mismatch = float((tex["hit"] != o_hit).float().mean())
    rel = ((tex["t"] - o_t).abs() / o_t.abs().clamp(min=1e-30))[both]
    close = float((rel <= 1e-4).float().mean())
    unit = float((tex["normal"][both].norm(dim=-1) - 1.0).abs().max())
    bars = dict(mismatch=mismatch, t_rel_max=float(rel.max()),
                t_close_share=close, normal_unit_err=unit,
                unresolved=tex["unresolved"], rounds=tex["rounds"],
                shared_hits=int(both.sum()))
    if not (mismatch < ORACLE_BARS["mismatch"]
            and bars["t_rel_max"] <= ORACLE_BARS["t_rtol"]
            and close > ORACLE_BARS["t_close_share"]
            and unit <= ORACLE_BARS["unit"] and tex["unresolved"] == 0):
        raise RuntimeError(f"the texel trace against the LBVH oracle: {bars}")
    rec["lbvh"] = dict(
        triangles=n_tris, build_ms=build_ms, build_ms_min=min(build_ms),
        primary_ms=prim_ms, primary_steps=prim["steps"],
        primary_syncs=prim["syncs"], primary_syncs_counted=lbvh_syncs,
        primary_compactions=prim["compactions"],
        primary_hit_fraction=float(ph.float().mean()),
        shadow_ms=shad_ms, shadow_steps=shad["steps"],
        shadow_syncs=shad["syncs"],
        shadow_occluded_share_of_hits=float(
            (shad["hit"] & ph).float().sum() / ph.float().sum().clamp(
                min=1)),
        oracle_ms_texels=orc_ms, oracle_steps_texels=orc["steps"],
        texel_vs_oracle=bars, bars=ORACLE_BARS)
    log("lbvh", f"[{smi}] {n_tris} triangles: build {min(build_ms):.1f} ms "
        f"(min of 3: {', '.join(f'{v:.1f}' for v in build_ms)}); primary "
        f"{LBVH_W}x{LBVH_H} {prim_ms:.1f} ms, {prim['steps']} steps, "
        f"{prim['syncs']} syncs ({lbvh_syncs} counted), hit fraction "
        f"{rec['lbvh']['primary_hit_fraction']:.4f}; shadow {shad_ms:.1f} "
        f"ms, {shad['steps']} steps; texels {ORACLE_INTER}^2 against the "
        f"oracle: {bars}")

    # 29. ingest: the seeded city through the native runtime, the dense
    # voxelizer on the card against it, then its mesh frame
    with tempfile.TemporaryDirectory() as tmp:
        vp, fp, city = write_city_csv(tmp)
        _, build_native_ms = timed(runtime._load)
        (verts_c, faces_c), parse_ms = timed(lambda: (
            runtime.parse_csv_file(vp, 8, 8), runtime.parse_csv_file(fp, 4,
                                                                     4)))
        v_np = csv_loader.load_csv_vertices(vp)
        f_np = csv_loader.load_csv_faces(fp)
        if not (np.array_equal(v_np, verts_c)
                and np.array_equal(f_np, faces_c)):
            raise RuntimeError("native CSV parse differs from numpy's")
        (tris_c, kept), asm_ms = timed(
            lambda: runtime.assemble_triangles_native(verts_c, faces_c))
        g_nat, native_ms = timed(lambda: runtime.voxelize_triangles(
            tris_c, CITY_VOXEL, device=dev))
        dense_ms = []
        for _ in range(3):
            g_den, ms = timed(lambda: ivox.voxelize_triangles_dense(
                tris_c, CITY_VOXEL, device=dev))
            dense_ms.append(ms)
        g_e2e, e2e_ms = timed(lambda: ivox.load_csv_into_voxel_grid(
            vp, fp, CITY_VOXEL, use_native=True, device=dev))
    same = (torch.equal(g_nat.occ, g_den.occ)
            and torch.equal(g_nat.origin, g_den.origin)
            and torch.equal(g_nat.voxel_size, g_den.voxel_size)
            and torch.equal(g_e2e.occ, g_nat.occ))
    if not same:
        raise RuntimeError("the dense voxelizer on the card differs from "
                           "the native grid")
    filled = int((g_nat.occ > 0).sum())
    city_grid = recenter_filled_voxels(g_nat)
    scene_c, prep_c = timed(lambda: mesh_grid.prepare_mc_scene(
        city_grid.occ, city_grid.origin, city_grid.voxel_size,
        to_light=TO_LIGHT, device=dev))
    ccam = pose_of(city_grid, 0)
    _, first_c = timed(lambda: mframe(scene_c, ccam))
    img_c, st_c, n_c, h_c = held_frame("the city mesh frame", scene_c, ccam)
    cls_c = classes_ok("the city mesh frame", img_c, need_shadow=False)
    wk.warp_lookup.launches = 0
    _, frame_c = timed(lambda: [mframe(scene_c, pose_of(city_grid, i))
                                for i in range(1, 4)])
    n_c += wk.warp_lookup.launches
    out["launches"]["city mesh frame (phase 29)"] = {"warp_lookup": n_c}
    out["held"]["warp_lookup"]["city mesh frame (phase 29)"] = h_c
    setup_c = mesh_grid._scene_sweep_setup(scene_c, ccam.get_pos(),
                                           ccam.get_view(), 45.0, aspect)
    rec["city"] = dict(
        csv=city, voxel_size=CITY_VOXEL, dims_xyz=list(g_nat.dims_xyz),
        filled=filled, vertices=int(verts_c.shape[0]),
        faces=int(faces_c.shape[0]), triangles=int(tris_c.shape[0]),
        faces_dropped=int((~kept).sum()), native_build_ms=build_native_ms,
        native_build=dict(runtime.BUILD_INFO),
        parse_ms=parse_ms, assembly_ms=asm_ms, native_voxelize_ms=native_ms,
        dense_voxelize_ms=dense_ms, dense_voxelize_ms_min=min(dense_ms),
        load_csv_into_voxel_grid_ms=e2e_ms, dense_equals_native=same,
        scene_ms=prep_c, first_frame_ms=first_c, frame_ms=frame_c / 3,
        hit_fraction=float((img_c[..., :3].amax(-1) > 0).float().mean()),
        classes=cls_c, rounds=st_c["rounds"], unresolved=st_c["unresolved"],
        sweep_axis=setup_c[0], sizes=list(setup_c[2]), kcells=setup_c[6],
        launches=n_c, held=h_c)
    log("ingest", f"[{smi}] city of {city['buildings']} buildings "
        f"({city['vertex_lines']} vertex and {city['face_lines']} face "
        f"lines, bad ones included): native build {build_native_ms:.0f} "
        f"ms ({runtime.BUILD_INFO.get('compiler')}, "
        f"{len(runtime.BUILD_INFO.get('failed', []))} compilers failed "
        f"first), parse {parse_ms:.1f} ms, assembly {asm_ms:.1f} ms "
        f"({int(tris_c.shape[0])} triangles, {int((~kept).sum())} dropped), "
        f"native voxelizer {native_ms:.1f} ms, dense on the card "
        f"{min(dense_ms):.1f} ms (min of 3), equal bitwise; the whole "
        f"load {e2e_ms:.1f} ms; grid {g_nat.dims_xyz} at {CITY_VOXEL} m, "
        f"{filled} filled; its mesh frame: scene {prep_c:.1f} ms, axis "
        f"{setup_c[0]} S,A,B {setup_c[2]} kcells {setup_c[6]}, "
        f"{frame_c / 3:.2f} ms a frame, rounds {st_c['rounds']}, hit "
        f"fraction {rec['city']['hit_fraction']:.4f}; warp_lookup {n_c} "
        f"launches, held bitwise")

    # 30. card against CPU on the 32^3 sphere, one pose with kcells 4
    g_cpu = make_sphere_grid(32, device="cpu")
    s_cpu = mesh_grid.prepare_mc_scene(g_cpu.occ, g_cpu.origin,
                                       g_cpu.voxel_size, to_light=TO_LIGHT,
                                       device="cpu")
    s_dev = mesh_grid.prepare_mc_scene(g_cpu.occ, g_cpu.origin,
                                       g_cpu.voxel_size, to_light=TO_LIGHT,
                                       device=dev)
    vs_cpu = marching_cubes_grid(g_cpu, int(count_mc_triangles(g_cpu)),
                                 device="cpu")
    t_cpu = vs_cpu[0][: int(vs_cpu[2])]
    b_cpu = lbvh.build_lbvh(t_cpu, device="cpu")
    b_dev = lbvh.build_lbvh(t_cpu.to(dev), device=dev)
    eq = lambda a, b: bool(torch.equal(a.cpu(), b.cpu()))
    card = {"build_lbvh": all(eq(getattr(b_cpu, f.name), getattr(b_dev,
                                                                 f.name))
                              for f in dataclasses.fields(lbvh.LBVH))}
    kc_seen = []
    for k, p in enumerate(((0.5, 0.3), (1.4, 0.55), (2.3, 0.8))):
        c = Camera(theta=p[0], phi=p[1], radius=1.4)
        args = (c.get_pos(), c.get_view(), 45.0, 1.0, 128, 128)
        a = mesh_grid.trace_mc_mesh_texels(s_cpu, *args, max_rounds=24,
                                           device="cpu")
        b = mesh_grid.trace_mc_mesh_texels(s_dev, *args, max_rounds=24,
                                           device=dev)
        kc_seen.append(mesh_grid._scene_sweep_setup(s_cpu, c.get_pos(),
                                                    c.get_view(), 45.0,
                                                    1.0)[6])
        card[f"texels pose {k}"] = all(eq(a[f], b[f]) for f in (
            "hit", "case", "tri", "t", "normal", "shadow")) and \
            a["rounds"] == b["rounds"]
        if k == 0:
            ra = lbvh.trace_lbvh(b_cpu, a["ray_o"], a["ray_d"], 4096)
            rb = lbvh.trace_lbvh(b_dev, b["ray_o"], b["ray_d"], 4096)
            card["trace_lbvh"] = all(eq(ra[f], rb[f])
                                     for f in ("hit", "tri", "t"))
            ia = mesh_grid.render_mc_mesh_frame(
                s_cpu, c.get_pos(), c.get_view(), 45.0, 1.0, 128, 128,
                light_dir=light_dir, inter_h=128, inter_w=128,
                device="cpu")
            ib = mesh_grid.render_mc_mesh_frame(
                s_dev, c.get_pos(), c.get_view(), 45.0, 1.0, 128, 128,
                light_dir=light_dir, inter_h=128, inter_w=128, device=dev)
            card["frame"] = eq(ia, ib)
    if 4 not in kc_seen or not all(card.values()):
        raise RuntimeError(f"mesh card vs CPU: {card}, kcells {kc_seen}")
    rec["card_vs_cpu"] = dict(card, kcells=kc_seen)
    log("mesh card vs CPU", f"[{smi}] 32^3 sphere at 128^2 texels, three "
        f"poses (kcells {kc_seen}): {card}")
    out["mesh"] = rec
    return out


# The app shell, the pipelined fast frames, the CLI and the demo (phases
# 31-36). The JAX package's triangle counts of the three extraction
# pipelines at the app's pose (margin 50 keeps every node of the sphere)
APP_TRIANGLES = {"MARCHING_CUBES": SPHERE_COUNTS["mc"],
                 "BLOCKS": SPHERE_COUNTS["blocks"],
                 "DUAL_CONTOURING": SPHERE_COUNTS["adaptive_dc"]}
APP_ORBITS = 14        # frames after the cold one, each after orbit(5, 0)
# the wireframe keeps the first max_lines // 12 leaves in node order
# (render/wireframe.py): 87381 of the sphere's 328056 leaves
WIREFRAME_LINES = 12 * ((1 << 20) // 12)
N_PIPELINED = 20       # poses of the bench's orbit (phi += 1e-4 a frame)
RASTER_CHUNK = 65536   # rasterize_triangles' default chunk
DEMO_FRAMES = ("raytrace_fast.png", "raytrace_exact.png",
               "raytrace_fast_exact.png", "marching_cubes.png", "blocks.png",
               "volume_raycast.png", "volume_raycast_closeup.png")


def png_size(path: str):
    """(width, height) of an 8-bit RGBA PNG whose pixel rows decode with
    zlib to the size its header gives; raises otherwise."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (1 + 4 * w):
        raise RuntimeError(f"{path}: pixel rows do not match {w}x{h}")
    return w, h


def device_busy(fn):
    """(wall ms, device-busy ms, summed kernel ms) of one ``fn()`` under
    torch.profiler: busy is the union of the kernels' intervals, so the
    sum over it is the overlap of concurrent kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy = total = 0.0
    end = None
    for s, e in spans:
        total += e - s
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return wall, busy / 1e3, total / 1e3


def app_phases(ctx: dict) -> dict:
    """Phases 31-36: the application shell at 1920x1080 on the 256^3
    sphere (five modes, the wireframe, a click, the DC cache), the scene
    bootstrap on the seeded city, the pipelined fast frames against the
    per-pose loop, the CLI and the demo, and the rasterizer, wireframe and
    extraction frames on the card against the CPU. Returns the record's
    section, with rows 1-3's launches ("launches") and held calls
    ("held") by path."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from ray_tracing_octrees_tpu_torch.config import EngineConfig
    from ray_tracing_octrees_tpu_torch.core.grid import (
        building_center, make_sphere_grid,
    )
    from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
    from ray_tracing_octrees_tpu_torch.examples import render_demo
    from ray_tracing_octrees_tpu_torch.ingest.city import write_city_csv
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        marching_cubes_grid,
    )
    from ray_tracing_octrees_tpu_torch.parallel import (
        render_fast_frames_pipelined,
    )
    from ray_tracing_octrees_tpu_torch.render import app as app_mod
    from ray_tracing_octrees_tpu_torch.render import raster
    from ray_tracing_octrees_tpu_torch.render.app import (
        Application, RenderMode,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import Camera
    from ray_tracing_octrees_tpu_torch.render.wireframe import (
        octree_wireframe,
    )
    from ray_tracing_octrees_tpu_torch.trace import fast_exact, sweep_exact
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep

    dev, smi, grid = ctx["dev"], ctx["smi"], ctx["grid"]
    W, H = WIDTH, HEIGHT
    rec = {"card": smi}
    out = {"launches": {}, "held": {}}
    targets = [(slab_sweep, "warp_frame"), (slab_sweep, "warp_lookup"),
               (sweep_exact, "warp_lookup"), (fast_exact, "warp_lookup_multi"),
               (rs, "warp_lookup_multi")]

    def counted(label, fn, hold_calls=True):
        """:func:`count_and_hold` of ``fn()`` (no call held unless
        ``hold_calls``), its launches and held calls kept by path."""
        res, launched, held = count_and_hold(
            label, fn, targets if hold_calls else [])
        out["launches"][label] = launched
        for k, h in held.items():
            out["held"].setdefault(k, {})[label] = h
        return res, launched, held

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    # 31. the application: five modes at 1920x1080 on the 256^3 sphere
    tmp = tempfile.mkdtemp(prefix="rto_app_")
    t = time.perf_counter()
    app = Application(device=dev).setup(grid=grid)
    app.tri_cache.directory = os.path.join(tmp, "triangle_cache")
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t
    log("app", f"[{smi}] Application(device={str(dev)!r}).setup on the "
        f"{SPHERE_DIM}^3 sphere: {rec['setup_s']:.2f} s (pyramid, linear "
        f"octree, tracer, volume textures); {app.tree.num_nodes} nodes")
    x = torch.zeros((H, W, 4), dtype=torch.float32, device=dev)
    copies = []
    for _ in range(5):
        _, ms = wall(lambda: x.cpu().numpy())
        copies.append(ms)
    rec["host_copy_ms"] = min(copies)
    del x
    log("app", f"[{smi}] the host copy of a {W}x{H} rgba frame "
        f"({H * W * 16 / 1e6:.1f} MB): {rec['host_copy_ms']:.3f} ms (min "
        f"of 5)")

    def frame_kind(stages, new_mesh, mode):
        if mode.name in APP_TRIANGLES:
            return "extract+raster" if new_mesh else "raster"
        return "render" if stages else "replay"

    modes = {}
    for mode in RenderMode:
        app.mode = mode
        app._cached_frames.clear()
        app._cached_dev.clear()
        app._cached_mesh = None
        torch.cuda.reset_peak_memory_stats()
        sched, times = [], []

        def one():
            calls = {k: s.calls for k, s in app.timer.stats.items()}
            mesh = app._cached_mesh
            res, ms = wall(lambda: app.frame(W, H))
            ran = {k for k, s in app.timer.stats.items()
                   if s.calls > calls.get(k, 0)}
            sched.append(frame_kind(ran, app._cached_mesh is not mesh, mode))
            times.append(ms)
            return res

        first = None

        def run():
            nonlocal first
            first = one()
            for _ in range(APP_ORBITS):
                app.orbit(5.0, 0.0)
                one()

        counted(f"app {mode.name} (phase 31)", run, hold_calls=False)
        launched = out["launches"][f"app {mode.name} (phase 31)"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        color = first["color"]
        if color.shape != (H, W, 4) or not np.isfinite(color).all():
            raise RuntimeError(f"app {mode.name}: bad frame {color.shape}")
        m = dict(schedule=sched, cold_ms=times[0], launches=launched,
                 peak_gib=peak)
        rendered = [ms for s, ms in zip(sched[1:], times[1:])
                    if s != "replay"]
        replayed = [ms for s, ms in zip(sched[1:], times[1:])
                    if s == "replay"]
        m["rendered_ms_min"] = min(rendered, default=None)
        m["rendered_ms_median"] = (statistics.median(rendered) if rendered
                                   else None)
        m["replayed_ms"] = statistics.median(replayed) if replayed else None

        def rendered_frame():
            app.orbit(5.0, 0.0)
            if mode is RenderMode.VOLUME_RAYCAST:
                app._cached_frames.clear()
            return app.frame(W, H)

        if mode is RenderMode.OCTREE_RAYTRACE:
            # the orbit's frames take the DDA over the frustum-culled
            # pyramid, which launches no kernel; the held frame moves to
            # the bench angles at the exact radius, where the tracer
            # takes sweep-exact (its dead test through warp_lookup)
            m["orbit_path"] = app.raytracer.last_path
            app.camera.theta, app.camera.phi = 0.9, 0.8
            app.camera.radius = EXACT_RADIUS * float(
                (grid.world_max - grid.world_min).max())
        # one rendered frame with every kernel call held
        counted(f"app {mode.name} held frame (phase 31)", rendered_frame)
        m["held"] = {k: v.get(f"app {mode.name} held frame (phase 31)")
                     for k, v in out["held"].items()
                     if f"app {mode.name} held frame (phase 31)" in v}
        m["host_syncs"] = count_syncs(rendered_frame)
        fwall, busy, ksum = device_busy(rendered_frame)
        m.update(profiled_wall_ms=fwall, device_busy_ms=busy,
                 idle_share=1.0 - busy / fwall)
        if mode.name in APP_TRIANGLES:
            mesh = app._cached_mesh
            if mesh.count != APP_TRIANGLES[mode.name]:
                raise RuntimeError(f"app {mode.name}: {mesh.count} "
                                   f"triangles, the JAX package's "
                                   f"{APP_TRIANGLES[mode.name]}")
            st = app.timer.stats[{"MARCHING_CUBES": "extract/mc",
                                  "BLOCKS": "extract/blocks",
                                  "DUAL_CONTOURING": "extract/dc"}[
                                      mode.name]]
            m["triangles"] = mesh.count
            m["extract_ms_mean"] = st.mean_ms
            m["extractions"] = st.calls
            # the rasterizer's passes on this mesh by CUDA events
            vp = app._view_proj(W / H)
            colors = torch.full((mesh.count, 3), 0.8, device=dev)
            def passes_ms(chunk):
                """Min over 3 runs of each pass's ms by CUDA events, and
                the peak memory of a run (GiB)."""
                passes = {"depth": [], "winner": [], "shade": []}
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for _ in range(3):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(4)]
                    ev[0].record()
                    r = raster._Raster(mesh.verts_dev,
                                       raster._on_device(vp, dev), W, H,
                                       None, 16)
                    zb, kept = raster.depth_pass(r, chunk)
                    ev[1].record()
                    win = raster.winner_pass(zb, kept)
                    del kept
                    ev[2].record()
                    raster.shade_winners(r, mesh.verts_dev, mesh.normals_dev,
                                         colors, win, zb,
                                         app.camera.get_pos())
                    ev[3].record()
                    torch.cuda.synchronize()
                    for k, a, b in (("depth", 0, 1), ("winner", 1, 2),
                                    ("shade", 2, 3)):
                        passes[k].append(ev[a].elapsed_time(ev[b]))
                return ({k: min(v) for k, v in passes.items()},
                        torch.cuda.max_memory_allocated() / 2**30)

            m["raster_ms"], m["raster_peak_gib"] = passes_ms(RASTER_CHUNK)
            if mode is RenderMode.MARCHING_CUBES:
                # the reference's chunk (the output is the same): its time
                # and memory beside the default's
                m["raster_ms_chunk_16384"], m["raster_peak_gib_16384"] = \
                    passes_ms(16384)
            m["raster_samples_a_pass"] = mesh.count * 256
            m["raster_chunks"] = -(-mesh.count // RASTER_CHUNK)
        if mode is RenderMode.OCTREE_RAYTRACE:
            m["tracer_path"] = app.raytracer.last_path
            if m["tracer_path"] != "sweep_exact":
                raise RuntimeError(f"app OCTREE_RAYTRACE at the exact radius "
                                   f"took {m['tracer_path']}")
        need = {"VOLUME_RAYCAST": "warp_lookup_multi",
                "OCTREE_RAYTRACE": "warp_lookup"}.get(mode.name)
        if need and not m["held"].get(need, {}).get("calls"):
            raise RuntimeError(f"app {mode.name}: {need} did not launch on "
                               f"its rendered frame: {m['held']}")
        if mode.name in APP_TRIANGLES and any(launched.values()):
            raise RuntimeError(f"app {mode.name}: a kernel launched on the "
                               f"extraction path: {launched}")
        modes[mode.name] = m
        log("app", f"[{smi}] {mode.name}: schedule {sched}; cold "
            f"{times[0]:.1f} ms, rendered {m['rendered_ms_min']} / "
            f"{m['rendered_ms_median']} ms (min / median), replayed "
            f"{m['replayed_ms']} ms; syncs a rendered frame "
            f"{m['host_syncs']}; idle {m['idle_share']:.3f} (busy "
            f"{busy:.2f} of {fwall:.2f} ms); peak {peak:.2f} GiB; launches "
            f"{launched}; held {m['held']}"
            + (f"; {m['triangles']} triangles, extraction "
               f"{m['extract_ms_mean']:.2f} ms x{m['extractions']}, raster "
               f"passes {m['raster_ms']} ms, peak {m['raster_peak_gib']:.2f} "
               f"GiB ({m['raster_chunks']} chunks of {RASTER_CHUNK}, "
               f"{m['raster_samples_a_pass']} samples a pass)"
               + (f"; chunk 16384: {m['raster_ms_chunk_16384']} ms, peak "
                  f"{m['raster_peak_gib_16384']:.2f} GiB"
                  if "raster_ms_chunk_16384" in m else "")
               if mode.name in APP_TRIANGLES else "")
            + (f"; tracer path {m['orbit_path']} on the orbit, "
               f"{m['tracer_path']} on the held frame (bench angles, "
               f"radius {EXACT_RADIUS} x extent)"
               if mode is RenderMode.OCTREE_RAYTRACE else ""))
    rec["modes"] = modes

    # 32. the overlay, a click, the DC cache
    app.mode = RenderMode.MARCHING_CUBES
    app._cached_mesh = None
    app.frame(W, H)
    app.handle_key("S")
    (wf_out, wf_ms) = wall(lambda: app.frame(W, H))
    app.handle_key("S")
    n_lines = wf_out["wireframe"]["count"]
    if n_lines != WIREFRAME_LINES:
        raise RuntimeError(f"wireframe: {n_lines} lines, not "
                           f"{WIREFRAME_LINES}")
    _, nowf_ms = wall(lambda: app.frame(W, H))
    vp = app._view_proj(W / H)
    (segs, _), seg_ms = wall(lambda: octree_wireframe(
        app.tree, app._origin, app._voxel, vp, 50.0))
    rec["wireframe"] = dict(lines=n_lines, frame_ms=wf_ms,
                            frame_without_ms=nowf_ms, segments_ms=seg_ms,
                            line_samples=n_lines * 64)
    log("app", f"[{smi}] wireframe (S) in MARCHING_CUBES: {n_lines} lines "
        f"(12 x {n_lines // 12} of {SPHERE_COUNTS['leaves']} leaves), "
        f"frame {wf_ms:.1f} ms against {nowf_ms:.1f} ms without; "
        f"octree_wireframe {seg_ms:.2f} ms; {n_lines * 64} line samples")
    app.mode = RenderMode.VOLUME_RAYCAST
    app._cached_frames.clear()
    before = app.frame(W, H)["color"]
    (hit, click_ms) = wall(lambda: app.click(W / 2, H / 2, W, H))
    app._cached_frames.clear()
    after = app.frame(W, H)["color"]
    changed = int((np.abs(after - before).max(-1) > 0).sum())
    if not hit or changed == 0:
        raise RuntimeError(f"click: hit {hit}, {changed} pixels changed")
    rec["click"] = dict(hit=hit, ms=click_ms, pixels_changed=changed)
    log("app", f"[{smi}] click at the centre in VOLUME_RAYCAST: hit, "
        f"{click_ms:.1f} ms (pick, splat, precompute queued); the next "
        f"rendered frame differs on {changed} pixels")
    app.mode = RenderMode.DUAL_CONTOURING
    calls0 = app.timer.stats["extract/dc"].calls
    app._cached_mesh = None
    (_, dc_ms) = wall(lambda: app.frame(W, H))
    first_count = app._cached_mesh.count
    app._cached_mesh = None
    (_, cached_ms) = wall(lambda: app.frame(W, H))
    calls1 = app.timer.stats["extract/dc"].calls
    if calls1 != calls0 + 1 or app._cached_mesh.count != first_count:
        raise RuntimeError(f"DC cache: {calls1 - calls0} extractions, "
                           f"{app._cached_mesh.count} vs {first_count}")
    rec["dc_cache"] = dict(extract_frame_ms=dc_ms, cached_frame_ms=cached_ms,
                           count=first_count)
    log("app", f"[{smi}] DC at one pose twice: extracted and saved "
        f"{dc_ms:.1f} ms, then loaded from the triangle cache "
        f"{cached_ms:.1f} ms, {first_count} triangles both")
    del app
    torch.cuda.empty_cache()

    # 33. scene bootstrap: the seeded city through load_scene
    city = tempfile.mkdtemp(prefix="rto_city_")
    os.makedirs(os.path.join(city, "DT"))
    write_city_csv(os.path.join(city, "DT"))
    cfg = EngineConfig(cache_filename=os.path.join(city, "sceneCache.bin"))
    (g_csv, csv_ms) = wall(lambda: app_mod.load_scene(
        cfg, search_dirs=(city,), device=dev))
    (g_cache, cache_ms) = wall(lambda: app_mod.load_scene(
        cfg, search_dirs=(city,), device=dev))
    same = (torch.equal(g_csv.occ, g_cache.occ)
            and torch.equal(g_csv.origin, g_cache.origin)
            and torch.equal(g_csv.voxel_size, g_cache.voxel_size))
    if not same:
        raise RuntimeError("load_scene: the cached grid differs from the "
                           "CSV grid")
    rec["bootstrap"] = dict(csv_ms=csv_ms, cache_ms=cache_ms,
                            dims=list(g_csv.occ.shape),
                            filled=int(g_csv.occ.sum()))
    log("app", f"[{smi}] load_scene on the seeded city: CSV route "
        f"{csv_ms:.1f} ms (native parse, voxelizer, cache written), cache "
        f"route {cache_ms:.1f} ms, grids equal {tuple(g_csv.occ.shape)}")

    # 34. pipelined fast frames against the per-pose loop
    vol, shadow, layouts = ctx["vol"], ctx["shadow"], ctx["layouts"]
    origin, vox = ctx["origin"], ctx["vox"]
    light_dir = tuple(-c for c in TO_LIGHT)
    aspect = W / H
    cam = ctx["bench_camera"]()
    poses = []
    for _ in range(N_PIPELINED):
        cam.phi += 1e-4
        poses.append((cam.get_pos(), cam.get_view()))
    kw = dict(light_dir=light_dir, inter_h=1024, inter_w=1024,
              layouts=layouts, device=dev)

    def pipelined():
        return render_fast_frames_pipelined(vol, shadow, origin, vox, poses,
                                            45.0, aspect, W, H, **kw)

    def loop():
        return [slab_sweep.render_fast_frame(
            vol, shadow, origin, vox, p, v, 45.0, aspect, W, H, fused=False,
            **kw) for p, v in poses]

    piped, p_launch, p_held = counted("pipelined fast frames (phase 34)",
                                      pipelined)
    looped, l_launch, l_held = counted("per-pose unfused loop (phase 34)",
                                       loop)
    equal = [torch.equal(a, b) for a, b in zip(piped, looped)]
    if len(piped) != N_PIPELINED or not all(equal):
        raise RuntimeError(f"pipelined frames differ from the loop: "
                           f"{equal}")
    if p_launch["warp_lookup"] < N_PIPELINED:
        raise RuntimeError(f"pipeline: warp_lookup launched {p_launch}")
    del piped, looped
    per = {}
    for name, fn in (("pipelined", pipelined), ("loop", loop),
                     ("pipelined again", pipelined), ("loop again", loop)):
        best = min(wall(fn)[1] for _ in range(3)) / N_PIPELINED
        per[name] = best
    p_wall, p_busy, p_sum = device_busy(pipelined)
    l_wall, l_busy, l_sum = device_busy(loop)
    rec["pipeline"] = dict(
        frames=N_PIPELINED, equal=True, ms_per_frame=per,
        launches=p_launch, held=p_held,
        pipelined_profile=dict(wall_ms=p_wall, busy_ms=p_busy,
                               kernel_sum_ms=p_sum,
                               busy_share=p_busy / p_wall,
                               overlap=p_sum / p_busy),
        loop_profile=dict(wall_ms=l_wall, busy_ms=l_busy, kernel_sum_ms=l_sum,
                          busy_share=l_busy / l_wall,
                          overlap=l_sum / l_busy))
    log("pipeline", f"[{smi}] {N_PIPELINED} poses of the bench orbit at "
        f"{W}x{H}, shadows, 1024^2 table: pipelined equal to the per-pose "
        f"unfused loop bitwise; ms a frame (best of 3 windows, in turns) "
        + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
        + f"; device busy {p_busy / p_wall:.3f} of the pipelined wall "
        f"(kernel overlap {p_sum / p_busy:.3f}x), {l_busy / l_wall:.3f} of "
        f"the loop's ({l_sum / l_busy:.3f}x); warp_lookup held {p_held}")

    # 35. the CLI and the demo
    cli_dir = os.path.join(tmp, "cli")
    (_, cli_ms) = wall(lambda: counted(
        "rto-render VOLUME_RAYCAST (phase 35)",
        lambda: app_mod.main(["--mode", "VOLUME_RAYCAST", "--frames", "2",
                              "--out", cli_dir, "--device", str(dev)])))
    cli_pngs = sorted(os.listdir(cli_dir))
    sizes = {n: png_size(os.path.join(cli_dir, n)) for n in cli_pngs}
    if cli_pngs != ["volume_raycast_000.png", "volume_raycast_001.png"] or \
            set(sizes.values()) != {(960, 540)}:
        raise RuntimeError(f"rto-render wrote {sizes}")
    demo_dir = os.path.join(tmp, "demo")
    (_, demo_ms) = wall(lambda: counted(
        "render_demo (phase 35)", lambda: render_demo.main(demo_dir,
                                                           device=dev)))
    demo = {n: png_size(os.path.join(demo_dir, n)) for n in DEMO_FRAMES}
    if set(demo.values()) != {(960, 540)}:
        raise RuntimeError(f"the demo wrote {demo}")
    demo_launches = out["launches"]["render_demo (phase 35)"]
    # the fast trace launches warp_frame, the fast-exact trace and the
    # volume frames warp_lookup_multi; the exact trace at the demo's
    # radius (0.75 x extent) takes the DDA, unseeded there
    if not (demo_launches["warp_frame"] and
            demo_launches["warp_lookup_multi"]):
        raise RuntimeError(f"the demo did not launch rows 1 and 3: "
                           f"{demo_launches}")
    rec["cli"] = dict(ms=cli_ms, pngs=cli_pngs,
                      launches=out["launches"][
                          "rto-render VOLUME_RAYCAST (phase 35)"])
    rec["demo"] = dict(ms=demo_ms, pngs=list(demo), launches=demo_launches)
    log("cli", f"[{smi}] rto-render --mode VOLUME_RAYCAST --frames 2: "
        f"{cli_ms / 1e3:.2f} s with set-up, {cli_pngs} at 960x540; the "
        f"demo: {demo_ms / 1e3:.2f} s, {len(demo)} PNGs at 960x540; "
        f"launches {rec['cli']['launches']} and {demo_launches}, every "
        f"call held")

    # 36. card against CPU on the 32^3 sphere at 128x128
    res = {}
    devs = {"cpu": torch.device("cpu"), "card": dev}
    small = {d: make_sphere_grid(32, device=v) for d, v in devs.items()}
    scam = Camera(theta=0.6, phi=0.4, radius=1.6)
    svp = (scam.get_proj(1.0) @ scam.get_view()).astype(np.float32)
    ras = {}
    for d, g in small.items():
        v, n, c = marching_cubes_grid(g, max_triangles=40000,
                                      device=devs[d])
        c = int(c)
        cols = torch.full((c, 3), 0.8, device=devs[d])
        img, zb = raster.rasterize_triangles(v[:c], n[:c], cols, svp, 128,
                                             128, cam_pos=scam.get_pos())
        tree = build_linear_octree(g.occ, device=devs[d])
        segs, nl = octree_wireframe(tree, g.origin, g.voxel_size, svp, 50.0)
        lines = raster.rasterize_lines(img, zb, segs[:int(nl)], svp, 128,
                                       128)
        ras[d] = (img.cpu(), zb.cpu(), segs.cpu(), lines.cpu())
    for k, i in (("rasterize_triangles image", 0), ("zbuf", 1),
                 ("octree_wireframe segments", 2), ("rasterize_lines", 3)):
        res[k] = torch.equal(ras["cpu"][i], ras["card"][i])
    frames = {}
    for d, g in small.items():
        a = Application(config=EngineConfig(use_buildings=False,
                                            sphere_dim=32), device=devs[d])
        a.setup(grid=g)
        a.tri_cache.directory = os.path.join(tmp, f"tc_{d}")
        frames[d] = []
        for mode in (RenderMode.MARCHING_CUBES, RenderMode.BLOCKS,
                     RenderMode.DUAL_CONTOURING):
            a.mode = mode
            a._cached_mesh = None
            frames[d].append(a.frame(128, 128))
    for mode, fc, fg in zip(("MC", "blocks", "DC"), frames["cpu"],
                            frames["card"]):
        res[f"app {mode} frame"] = bool(np.array_equal(fc["color"],
                                                       fg["color"]))
        res[f"app {mode} mesh"] = bool(
            np.array_equal(fc["mesh"]["verts"], fg["mesh"]["verts"]))
    rec["card_vs_cpu"] = res
    log("card vs cpu", f"[{smi}] 32^3 sphere at 128x128, card against "
        f"CPU bitwise: {res}")
    if not all(res.values()):
        raise RuntimeError(f"card and CPU differ: {res}")
    return dict(app=rec, **out)


MULTI_RANKS = 4       # phase 38's gloo ranks, all on the one card
MC_CAP = 1 << 20      # rows of phase 37's dense MC (the sphere's 493816 fit)
N_SEGMENTED = 10      # segmented frames per timed window (phases 37-38)


def count_and_hold(label: str, fn, targets):
    """``fn()`` with rows 1-3's launch counts set to 0 before it and read
    after it, every call of them through ``targets`` ((module, name)
    pairs) held bitwise against its plain version: (result, launches,
    held)."""
    import torch

    from ray_tracing_octrees_tpu_torch.trace import warp_kernel as wk

    kernels = {"warp_frame": wk.warp_frame, "warp_lookup": wk.warp_lookup,
               "warp_lookup_multi": wk.warp_lookup_multi}
    for k in kernels.values():
        k.launches = 0
    calls, restore = held_calls(targets)
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        restore()
    launched = {k: f.launches for k, f in kernels.items()}
    held = {k: hold(v, getattr(wk, k + "_reference"))
            for k, v in calls.items() if v}
    require_held(label, held)
    return res, launched, held


def segmented_paths(mesh, mesh_tp, sc: dict) -> dict:
    """The calls phases 37 and 38 make on ``mesh`` (one "sp" axis) and
    ``mesh_tp`` ((dp, tp)): both segmented frames at 1920x1080, counted
    and held, halo MC and trace_segmented at OW x OH, and each frame's ms
    (best of 3 windows of N_SEGMENTED, CUDA events). ``sc`` holds the
    scene: vol, shadow, layouts, origin, vox, pos, view, scene (the
    volume's), occ, mc_cap."""
    from ray_tracing_octrees_tpu_torch.parallel import sharding as sh
    from ray_tracing_octrees_tpu_torch.render.camera import generate_rays
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep

    aspect = WIDTH / HEIGHT
    light_dir = tuple(-c for c in TO_LIGHT)
    n = mesh.shape[0]

    def fast():
        return sh.sweep_frame_segmented(
            mesh, sc["vol"], sc["shadow"], sc["origin"], sc["vox"],
            sc["pos"], sc["view"], 45.0, aspect, WIDTH, HEIGHT,
            light_dir=light_dir, layouts=sc["layouts"])

    def volume():
        return sh.volume_frame_segmented(
            mesh, sc["scene"], sc["origin"], sc["pos"], sc["view"], 45.0,
            aspect, WIDTH, HEIGHT)

    out = {"launches": {}, "held": {}}
    for name, fn, target in (("fast", fast, (slab_sweep, "warp_lookup")),
                             ("volume", volume, (rs, "warp_lookup_multi"))):
        label = f"{name} frame segmented over {n} rank(s)"
        out[name], out["launches"][name], out["held"][name] = \
            count_and_hold(label, fn, [target])
    out["mc"] = sh.marching_cubes_halo(mesh_tp, sc["occ"], sc["origin"],
                                       sc["vox"], sc["mc_cap"])
    o, d = generate_rays(OW, OH, sc["pos"], sc["view"], 45.0, aspect,
                         device=sc["vol"].device)
    out["trace_segmented"] = sh.trace_segmented(mesh_tp, sc["occ"], o, d,
                                                sc["origin"], sc["vox"])
    out["ms"] = {"fast": cuda_ms(fast, N_SEGMENTED),
                 "volume": cuda_ms(volume, N_SEGMENTED // 2)}
    return out


def _multichip_rank(rank: int, world: int, store: str, inp_path: str,
                    out_dir: str, device: str) -> None:
    """One of phase 38's gloo ranks, on the one card: the phase-37 scene
    from ``inp_path``, :func:`segmented_paths` on a ("sp",) mesh and a
    (1, world) mesh; rank 0 saves the results, every rank its launches,
    held calls and ms."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from ray_tracing_octrees_tpu_torch.parallel import make_mesh
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep

    # gloo, not initialize_distributed's NCCL: NCCL takes one rank a card
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("gloo", init_method=store, world_size=world,
                            rank=rank)
    inp = torch.load(inp_path, weights_only=False)
    vol = inp["vol"].to(dev).float()
    shadow = inp["shadow"].to(dev)
    scene = rs.VolumeSweepScene(
        det=inp["det"].to(dev).float(),
        bundles=[[b.to(dev).float() for b in ch] for ch in inp["bundles"]],
        box_min=inp["box_min"], box_max=inp["box_max"],
        voxel_size=inp["voxel_size"], sticky_inter=inp["sticky_inter"])
    sc = dict(vol=vol, shadow=shadow,
              layouts=slab_sweep.SweepLayouts(vol, shadow),
              origin=inp["origin"], vox=inp["vox"], pos=inp["pos"],
              view=inp["view"], scene=scene, occ=inp["occ"].to(dev),
              mc_cap=inp["mc_cap"])
    res = segmented_paths(
        init_device_mesh(dev.type, (world,), mesh_dim_names=("sp",)),
        make_mesh(world, dp=1, tp=world, device=dev), sc)
    if rank == 0:
        cpu = lambda x: {k: v.cpu() for k, v in x.items()} \
            if isinstance(x, dict) else x.cpu()
        torch.save({k: cpu(res[k]) if k != "mc" else
                    tuple(v.cpu() for v in res[k])
                    for k in ("fast", "volume", "mc", "trace_segmented")},
                   os.path.join(out_dir, "outputs.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({k: res[k] for k in ("launches", "held", "ms")}, f)
    dist.barrier()
    dist.destroy_process_group()


def lattice_keys(verts, vs: float):
    """Triangles (rows of 9 coordinates) sorted by their exact vs/2
    lattice keys, as tests/test_parallel.py compares MC multisets:
    (sorted rows, keys)."""
    import numpy as np

    flat = verts.reshape(len(verts), -1)
    q = np.round(flat / (vs / 2)).astype(np.int64)
    order = np.lexsort(q.T)
    return flat[order], q[order]


def multichip_phases(ctx: dict) -> dict:
    """Phases 37-38: the multi-device paths on the one card. 37: a
    world-1 NCCL group; both segmented frames at 1920x1080 bitwise the
    single-device frames with rows 2 and 3 counted and held, halo MC on
    make_mesh(1) equal to dense MC, and the four tracers of
    parallel/sharding.py at OW x OH against trace_octree /
    render_octree_image; ms a frame beside the single-device frames. 38:
    MULTI_RANKS gloo ranks spawned on the same card, their results
    bitwise phase 37's. Returns the record's section, with rows 2 and 3's
    launches ("launches") and held calls ("held") by path."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        render_octree_image,
    )
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        marching_cubes_grid,
    )
    from ray_tracing_octrees_tpu_torch.parallel import (
        initialize_distributed, make_mesh,
    )
    from ray_tracing_octrees_tpu_torch.parallel import sharding as sh
    from ray_tracing_octrees_tpu_torch.render.camera import generate_rays
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep
    from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree

    dev, smi, grid = ctx["dev"], ctx["smi"], ctx["grid"]
    aspect = WIDTH / HEIGHT
    light_dir = tuple(-c for c in TO_LIGHT)
    cam = ctx["bench_camera"]()
    scene = ctx["volume_renderer"].sweep_scene()
    sc = dict(vol=ctx["vol"], shadow=ctx["shadow"], layouts=ctx["layouts"],
              origin=ctx["origin"], vox=ctx["vox"], pos=cam.get_pos(),
              view=cam.get_view(), scene=scene, occ=grid.occ)
    rec = {"card": smi}
    out = {"launches": {}, "held": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multichip_")
    try:
        # 37. one rank on a world-1 NCCL group
        t0 = time.perf_counter()
        if not initialize_distributed(f"file://{tmp}/store37", 1, 0,
                                      device=dev):
            raise RuntimeError("initialize_distributed started no group")
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"backend {dist.get_backend()}, not nccl")
        single = {
            "fast": slab_sweep.render_fast_frame(
                sc["vol"], sc["shadow"], sc["origin"], sc["vox"], sc["pos"],
                sc["view"], 45.0, aspect, WIDTH, HEIGHT, light_dir=light_dir,
                layouts=sc["layouts"], device=dev, fused=False),
            "volume": rs.render_volume_frame(
                scene, sc["origin"], sc["pos"], sc["view"], 45.0, aspect,
                WIDTH, HEIGHT, device=dev)}
        dv, dn, dc = marching_cubes_grid(grid, max_triangles=MC_CAP,
                                         device=dev)
        n_tri = int(dc)
        if not 0 < n_tri < MC_CAP:
            raise RuntimeError(f"dense MC gave {n_tri} of {MC_CAP} rows")
        sc["mc_cap"] = n_tri
        mesh1 = init_device_mesh(dev.type, (1,), mesh_dim_names=("sp",))
        m11 = make_mesh(1, device=dev)
        seg = segmented_paths(mesh1, m11, sc)
        frames_equal = {
            "fast": torch.equal(seg["fast"], single["fast"]),
            "volume": {k: torch.equal(seg["volume"][k], single["volume"][k])
                       for k in ("color", "depth", "normal", "alpha")}}
        if not (frames_equal["fast"] and all(frames_equal["volume"].values())):
            raise RuntimeError(f"segmented frames on one rank differ from "
                               f"the single-device frames: {frames_equal}")
        hv, hn, hc = seg["mc"]
        mc_equal = (hc.tolist() == [n_tri] and
                    torch.equal(hv[:n_tri], dv[:n_tri]) and
                    torch.equal(hn[:n_tri], dn[:n_tri]))
        if not mc_equal:
            raise RuntimeError(f"halo MC on one rank: counts {hc.tolist()} "
                               f"against dense {n_tri}, or rows differ")
        for path, name in (("fast", "warp_lookup"),
                           ("volume", "warp_lookup_multi")):
            label = f"{path} frame segmented, NCCL world 1 (phase 37)"
            if seg["launches"][path][name] < 1:
                raise RuntimeError(f"{label}: {name} not launched")
            out["launches"][label] = seg["launches"][path]
            for k, h in seg["held"][path].items():
                out["held"].setdefault(k, {})[label] = h
        single_ms = {
            "fast": cuda_ms(lambda: slab_sweep.render_fast_frame(
                sc["vol"], sc["shadow"], sc["origin"], sc["vox"], sc["pos"],
                sc["view"], 45.0, aspect, WIDTH, HEIGHT, light_dir=light_dir,
                layouts=sc["layouts"], device=dev, fused=False),
                N_SEGMENTED),
            "volume": cuda_ms(lambda: rs.render_volume_frame(
                scene, sc["origin"], sc["pos"], sc["view"], 45.0, aspect,
                WIDTH, HEIGHT, device=dev), N_SEGMENTED // 2)}

        # the tracers of parallel/sharding.py at OW x OH
        pyr = ctx["pyr"]
        o, d = generate_rays(OW, OH, sc["pos"], sc["view"], 45.0, aspect,
                             device=dev)
        ref = trace_octree(pyr, o, d, sc["origin"], sc["vox"])
        hit = ref["hit"]
        tracers = {}
        for name in ("trace_sharded", "trace_shardmap", "trace_segmented"):
            res = seg["trace_segmented"] if name == "trace_segmented" else \
                getattr(sh, name)(m11, grid.occ, o, d, sc["origin"],
                                  sc["vox"])
            eq = {"hit": torch.equal(res["hit"], hit),
                  "steps": torch.equal(res["steps"], ref["steps"])}
            for k in ("t", "point", "normal"):
                eq[k] = torch.equal(res[k][hit], ref[k][hit])
            tracers[name] = eq
        img_ref = render_octree_image(
            pyr, sc["origin"], sc["vox"], sc["pos"], sc["view"], OW, OH,
            45.0, aspect, light_dir=light_dir, shadows=True, device=dev)
        img = sh.render_image_sharded(m11, grid.occ, o, d, sc["origin"],
                                      sc["vox"], light_dir=light_dir,
                                      shadows=True)
        tracers["render_image_sharded"] = {
            "image": torch.equal(img.reshape(OH, OW, 4), img_ref)}
        if not all(all(v.values()) for v in tracers.values()):
            raise RuntimeError(f"sharded tracers against trace_octree / "
                               f"render_octree_image: {tracers}")
        # what trace_segmented over MULTI_RANKS slabs gives, combined here
        g0 = torch.as_tensor(np.asarray(sc["origin"], np.float32), device=dev)
        vs = torch.as_tensor(np.float32(sc["vox"]), device=dev)
        zl = grid.occ.shape[0] // MULTI_RANKS
        slabs = [trace_octree(build_pyramid(grid.occ[r * zl:(r + 1) * zl]),
                              o, d, sh._slab_origin(g0, vs, r, zl), vs)
                 for r in range(MULTI_RANKS)]
        ts = torch.stack([torch.where(s["hit"], s["t"], sh._BIG)
                          for s in slabs])
        t_min = ts.amin(0)
        won = [s["hit"] & (t == t_min) for s, t in zip(slabs, ts)]
        pick = lambda k: sum(torch.where(w[:, None], s[k], 0.0)
                             for w, s in zip(won, slabs))
        hit4 = t_min < sh._BIG
        combined = dict(hit=hit4, t=torch.where(hit4, t_min, 0.0),
                        point=pick("point"), normal=pick("normal"),
                        steps=sum(s["steps"] for s in slabs))
        both = hit4 & hit
        seg4_vs_single = dict(
            hit_mismatches=int((hit4 != hit).sum()),
            t_unequal=int((combined["t"][both] != ref["t"][both]).sum()),
            max_dt_voxels=float((combined["t"][both] - ref["t"][both]).abs()
                                .max()) / sc["vox"])
        dist.destroy_process_group()
        p37_s = time.perf_counter() - t0
        rec["one_rank_nccl"] = dict(
            frames_equal=frames_equal, mc_triangles=n_tri, mc_equal=mc_equal,
            tracers=tracers, ms=seg["ms"], single_ms=single_ms,
            launches=seg["launches"], held=seg["held"], seconds=p37_s,
            trace_segmented_4_slabs_vs_single=seg4_vs_single)
        log("multichip 1 rank", f"[{smi}] NCCL world 1, {WIDTH}x{HEIGHT} at "
            f"the bench pose: sweep_frame_segmented and "
            f"volume_frame_segmented bitwise the single-device frames; "
            f"ms a frame (best of 3 windows, CUDA events) fast "
            f"{seg['ms']['fast']:.3f} segmented / {single_ms['fast']:.3f} "
            f"single, volume {seg['ms']['volume']:.3f} / "
            f"{single_ms['volume']:.3f}; warp_lookup held "
            f"{seg['held']['fast']}, warp_lookup_multi held "
            f"{seg['held']['volume']}; halo MC = dense MC ({n_tri} "
            f"triangles); {OW}x{OH}: trace_sharded, trace_shardmap, "
            f"trace_segmented and render_image_sharded (shadows) bitwise "
            f"trace_octree / render_octree_image; {MULTI_RANKS} slabs "
            f"min-combined here against the single trace: {seg4_vs_single}; "
            f"{p37_s:.1f} s")

        # 38. MULTI_RANKS gloo ranks on the one card
        t0 = time.perf_counter()
        u8 = lambda x: x.to(torch.uint8).cpu()
        for x in [scene.det] + [b for ch in scene.bundles for b in ch]:
            if not torch.equal(u8(x).float(), x.cpu()):
                raise RuntimeError("a sweep scene volume is not 8-bit")
        inp_path = os.path.join(tmp, "inputs.pt")
        torch.save(dict(
            vol=u8(sc["vol"]), shadow=sc["shadow"].cpu(), occ=grid.occ.cpu(),
            det=u8(scene.det), bundles=[[u8(b) for b in ch]
                                        for ch in scene.bundles],
            box_min=scene.box_min, box_max=scene.box_max,
            voxel_size=scene.voxel_size, sticky_inter=scene.sticky_inter,
            origin=sc["origin"], vox=sc["vox"], pos=sc["pos"],
            view=sc["view"], mc_cap=n_tri), inp_path)
        mp.spawn(_multichip_rank, args=(MULTI_RANKS, f"file://{tmp}/store38",
                                        inp_path, tmp, str(dev)),
                 nprocs=MULTI_RANKS, join=True)
        got = torch.load(os.path.join(tmp, "outputs.pt"), weights_only=False)
        ranks = []
        for r in range(MULTI_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        equal4 = {
            "fast": torch.equal(got["fast"], single["fast"].cpu()),
            "volume": all(torch.equal(got["volume"][k],
                                      single["volume"][k].cpu())
                          for k in ("color", "depth", "normal", "alpha")),
            "trace_segmented": all(
                torch.equal(got["trace_segmented"][k], v.cpu())
                for k, v in combined.items())}
        hv4, hn4, hc4 = (x.numpy() for x in got["mc"])
        cap = hv4.shape[0] // MULTI_RANKS
        parts = np.concatenate([hv4[s * cap:s * cap + hc4[s]]
                                for s in range(MULTI_RANKS)])
        h_rows, h_keys = lattice_keys(parts, sc["vox"])
        d_rows, d_keys = lattice_keys(dv[:n_tri].cpu().numpy(), sc["vox"])
        equal4["mc_counts"] = int(hc4.sum()) == n_tri
        equal4["mc_lattice_keys"] = bool(
            h_keys.shape == d_keys.shape and (h_keys == d_keys).all())
        mc_max_err = float(np.abs(h_rows - d_rows).max()) \
            if equal4["mc_lattice_keys"] else None
        if not all(equal4.values()):
            raise RuntimeError(f"{MULTI_RANKS} gloo ranks against phase 37: "
                               f"{equal4}")
        for path, name in (("fast", "warp_lookup"),
                           ("volume", "warp_lookup_multi")):
            label = (f"{path} frame segmented, {MULTI_RANKS} gloo ranks "
                     f"(phase 38)")
            if any(rk["launches"][path][name] < 1 for rk in ranks):
                raise RuntimeError(f"{label}: a rank did not launch {name}")
            out["launches"][label] = {
                k: sum(rk["launches"][path][k] for rk in ranks)
                for k in ranks[0]["launches"][path]}
            for k in ranks[0]["held"][path]:
                hs = [rk["held"][path][k] for rk in ranks]
                out["held"].setdefault(k, {})[label] = dict(
                    calls=sum(h["calls"] for h in hs),
                    bitwise_share=min(h["bitwise_share"] for h in hs),
                    max_abs_err=max(h["max_abs_err"] for h in hs))
        p38_s = time.perf_counter() - t0
        rec["four_ranks_gloo"] = dict(
            ranks=MULTI_RANKS, equal=equal4, mc_counts=hc4.tolist(),
            mc_max_vertex_err=mc_max_err, ms=ranks[0]["ms"],
            ms_by_rank=[rk["ms"] for rk in ranks],
            launches_by_rank=[rk["launches"] for rk in ranks],
            seconds=p38_s)
        log("multichip 4 ranks", f"[{smi}] {MULTI_RANKS} gloo ranks on the "
            f"one card (collectives through host memory; they share the "
            f"card, so this shows the collectives' cost, not a speed-up): "
            f"both segmented frames at {WIDTH}x{HEIGHT}, halo MC (counts "
            f"{hc4.tolist()}, lattice keys equal, vertices within "
            f"{mc_max_err:.3g}) and trace_segmented at (1, {MULTI_RANKS}) "
            f"bitwise phase 37's; rank 0's ms a frame fast "
            f"{ranks[0]['ms']['fast']:.3f}, volume "
            f"{ranks[0]['ms']['volume']:.3f}; rows 2 and 3 held in every "
            f"rank; {p38_s:.1f} s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(rec, **out)


# the ladder's configs whose calls launch each row kernel (phase 39)
LADDER_KERNELS = {"warp_frame": (5,), "warp_lookup": (2, 4),
                  "warp_lookup_multi": (6,)}


def ladder_phase(ctx: dict) -> dict:
    """Phase 39: the config ladder (benchmarks.config1 ... config6 at the
    JAX ladder's sizes) on the card, each config under
    :func:`count_and_hold`, so every call of rows 1-3 is counted and held
    bitwise against its plain version (the row times carry the hold's
    output copy); every row logged and kept. Without the scene cache config
    3 must print the JAX ladder's skipped line and configs 4-6 run on the
    128^3 sphere; no row may carry an error, config 5's rows are 3840x2160,
    and each row kernel must launch in the configs that call it. Returns
    the record's section with the launches and held calls by path."""
    from ray_tracing_octrees_tpu_torch import benchmarks
    from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as rs
    from ray_tracing_octrees_tpu_torch.trace import slab_sweep

    dev, smi = ctx["dev"], ctx["smi"]
    targets = [(slab_sweep, "warp_frame"), (slab_sweep, "warp_lookup"),
               (rs, "warp_lookup_multi")]
    rec = {"card": smi, "rows": [], "configs": {}}
    out = {"launches": {}, "held": {}}
    t0 = time.perf_counter()
    for i in range(1, 7):
        fn = getattr(benchmarks, f"config{i}")
        label = f"ladder config {i} (phase 39)"
        t = time.perf_counter()
        rows, launched, held = count_and_hold(
            label, lambda fn=fn: fn(device=dev), targets)
        secs = time.perf_counter() - t
        out["launches"][label] = launched
        for k, h in held.items():
            out["held"].setdefault(k, {})[label] = h
        rec["configs"][i] = dict(seconds=secs, launches=launched, held=held)
        rec["rows"] += rows
        for row in rows:
            log("ladder", f"[{smi}] config {i}: {json.dumps(row)}")
        log("ladder", f"config {i}: {secs:.1f} s; row-kernel launches "
            f"{launched}; held {held}")
    rows = rec["rows"]
    if any("error" in r for r in rows):
        raise RuntimeError(f"a ladder row carries an error: {rows}")
    if not benchmarks._scene_path(None):
        if rows[2] != {"config": "calgary_adaptive_dc",
                       "skipped": "scene cache missing"}:
            raise RuntimeError(f"config 3 without a scene cache: {rows[2]}")
        scenes = {r["scene"] for r in rows if "scene" in r}
        if scenes != {"sphere128"}:
            raise RuntimeError(f"configs 4-6 without a scene cache: {scenes}")
    fly = [r for r in rows if r["config"].startswith("calgary_4k_flythrough")]
    if not fly or {r["resolution"] for r in fly} != {"3840x2160"} or \
            fly[0]["config"] != "calgary_4k_flythrough_exterior":
        raise RuntimeError(f"config 5's rows: {fly}")
    for k, configs in LADDER_KERNELS.items():
        for i in configs:
            if rec["configs"][i]["launches"][k] < 1:
                raise RuntimeError(f"ladder config {i} launched no {k}")
    rec["seconds"] = time.perf_counter() - t0
    log("ladder", f"[{smi}] {len(rows)} rows, every row-kernel call held "
        f"bitwise; the phase took {rec['seconds']:.1f} s")
    return dict(rec, **out)


def entry_phases(ctx: dict) -> dict:
    """Phase 40: the entry points of graft_entry.py. entry()'s step on the
    card, its ms (best of 3 windows, CUDA events) and its row-kernel
    launches (none: the pyramid DDA is plain PyTorch), against the same
    step on the CPU: the whole image bitwise (the rays, the DDA's normal
    and the shading are elementwise f32 ops on both).
    Then dryrun_multichip(1) on a world-1 NCCL
    group and dryrun_multichip(MULTI_RANKS) on gloo ranks sharing the
    card (each spawned rank holds its sharded and segmented frames to the
    one-device frames at 1e-5 and reports its launches; every rank must
    launch warp_lookup and warp_lookup_multi). Returns the record's
    section with the launches by path."""
    import torch

    from ray_tracing_octrees_tpu_torch import graft_entry

    dev, smi = ctx["dev"], ctx["smi"]
    rec = {"card": smi}
    out = {"launches": {}, "held": {}}
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    label = "entry step (phase 40)"
    img, launched, _ = count_and_hold(label, lambda: fn(*args), [])
    out["launches"][label] = launched
    step_ms = cuda_ms(lambda: fn(*args), 5)
    fn_c, args_c = graft_entry.entry(device="cpu")
    img_c = fn_c(*args_c)
    hit = img_c[..., :3].amax(-1) > 0
    diff = (img.cpu() - img_c).abs().amax(-1)
    cmp = dict(
        shape=tuple(img.shape),
        equal=torch.equal(img.cpu(), img_c),
        hit_masks_equal=torch.equal(img[..., :3].amax(-1).cpu() > 0, hit),
        hit_pixels=int(hit.sum()),
        pixels_unequal=int((diff > 0).sum()),
        max_abs_err=float(diff.max()))
    if not cmp["equal"]:
        raise RuntimeError(f"entry() step, card against CPU: {cmp}")
    rec["entry"] = dict(cmp, ms=step_ms, launches=launched,
                        device=str(args[1].device))
    log("entry", f"[{smi}] entry() step on {rec['entry']['device']}: "
        f"{cmp['shape']}, {step_ms:.3f} ms (best of 3 windows, CUDA "
        f"events); against the CPU: bitwise {cmp['equal']} "
        f"({cmp['hit_pixels']} hits, {cmp['pixels_unequal']} pixels "
        f"unequal, largest {cmp['max_abs_err']:.3g}); row-kernel launches "
        f"{launched}")
    rec["dryrun"] = {}
    for n in (1, MULTI_RANKS):
        t = time.perf_counter()
        dr = graft_entry.dryrun_multichip(n)
        secs = time.perf_counter() - t
        want = "nccl" if n <= torch.cuda.device_count() else "gloo"
        if dr["backend"] != want or dr["device"] != "cuda":
            raise RuntimeError(f"dryrun_multichip({n}): {dr}")
        for r, counts in enumerate(dr["launches"]):
            if counts["warp_lookup"] < 1 or counts["warp_lookup_multi"] < 1:
                raise RuntimeError(f"dryrun_multichip({n}) rank {r} launched "
                                   f"{counts}")
        summed = {k: sum(c[k] for c in dr["launches"])
                  for k in graft_entry.ROW_KERNELS}
        out["launches"][f"dryrun_multichip({n}), {dr['backend']} (phase "
                        f"40)"] = summed
        rec["dryrun"][n] = dict(dr, seconds=secs)
        log("entry", f"[{smi}] dryrun_multichip({n}): {n} {dr['backend']} "
            f"rank(s) on the card, the sharded and segmented frames within "
            f"1e-5 of the one-device frames in every rank; launches by rank "
            f"{dr['launches']}; {secs:.1f} s")
    rec["seconds"] = time.perf_counter() - t0
    log("entry", f"the phase took {rec['seconds']:.1f} s")
    return dict(rec, **out)


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
        import numpy as np

        from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
        from ray_tracing_octrees_tpu_torch.render.camera import (
            Camera, generate_rays,
        )
        from ray_tracing_octrees_tpu_torch.trace import _build, slab_sweep
        from ray_tracing_octrees_tpu_torch.trace import fast_exact
        from ray_tracing_octrees_tpu_torch.trace import warp_kernel
        from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
            trace_octree,
        )
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
    kernels = ["warp_frame", "warp_lookup", "exp_warp"]
    _build.build(kernels)
    log("build", f"{kernels} in {time.perf_counter() - t:.2f} s wall; "
        + ", ".join(f"{k} {s:.2f} s" for k, s in _build.BUILD_SECONDS.items()))
    ptxas = {}
    for name, text in _build.BUILD_LOG.items():
        ptxas[name] = report = ptxas_report(text)
        for fn, r in report.items():
            log("build", f"{name} ptxas: {fn}: {r['registers']} registers, "
                f"{r['spill_bytes']} bytes spilled, {r['stack_frame_bytes']} "
                f"bytes stack frame")
        spilled = [fn for fn, r in report.items() if r["spill_bytes"]]
        if spilled:
            raise RuntimeError(f"{name}.cu kernels spill: {spilled}")
        stacked = [fn for fn, r in report.items() if r["stack_frame_bytes"]]
        if stacked:
            raise RuntimeError(f"{name}.cu kernels keep a stack frame: "
                               f"{stacked}")

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
        bitwise = equal_share(out, ref)
        share, max_err = rgb_agreement(out, ref)
        hit = float((table >= 0).float().mean())
        checks[name] = (bitwise, share, max_err)
        log("kernels", f"warp_frame {name} pose (axis {axis_world}, flip "
            f"{flip}, table "
            f"{tuple(table.shape)}, hit texels {hit:.4f}): bitwise "
            f"{bitwise:.6f}, within 1.5/255 {share:.6f}, max abs err "
            f"{max_err:.6f}")
    # every instantiation (sweep axis x shadow flag x vox's reciprocal
    # exact or not) in both store forms, on the bench pose's table and
    # scalars: the plain version computes the same function for any axis
    # and flag, and the kernel may divide by the sphere's power-of-two vox
    # (inv_vox 0) as well as multiply by its reciprocal
    inst_checks = {}
    table, kscal, _, _ = tables["bench"]
    frame_lib = _build.load("warp_frame")
    for (w, h), aw, sh, inv in itertools.product(
            FRAME_SIZES, (0, 1, 2), (False, True), (None, 0.0)):
        ks = warp_kernel._check(table, kscal, aw, w, h)
        out = warp_kernel._launch(frame_lib, table, ks, aw, w, h, sh, inv)
        ref = warp_kernel.warp_frame_reference(table, kscal, aw, w, h, sh)
        torch.cuda.synchronize()
        inst_checks[f"{w}x{h} axis {aw} shadow {int(sh)} "
                    f"{'divide' if inv == 0.0 else 'reciprocal'}"] = (
            equal_share(out, ref))
    log("kernels", "warp_frame instantiations on the bench table, bitwise: "
        + ", ".join(f"{k} {v:.6f}" for k, v in inst_checks.items()))
    bad = {k: v for k, v in inst_checks.items() if v != 1.0}
    bad.update({k: b for k, (b, _, _) in checks.items() if b != 1.0})
    if bad:
        raise RuntimeError(f"warp_frame differs from its plain version: "
                           f"bitwise shares {bad}")

    # 6. timing
    frame_ms = min(windows)
    mrays = 2 * WIDTH * HEIGHT / (frame_ms / 1e3) / 1e6
    table, kscal, axis_world, has_sh = tables["bench"]
    warp_ms = cuda_ms(lambda: warp_kernel.warp_frame(
        table, kscal, axis_world, WIDTH, HEIGHT, has_sh), 200)
    _, wper = profiled(lambda: warp_kernel.warp_frame(
        table, kscal, axis_world, WIDTH, HEIGHT, has_sh), 50)
    warp_dev_ms = sum(v for k, v in wper.items() if "warp_frame_kernel" in k)
    vox_ms = time_vox_division(table, kscal, axis_world, has_sh)
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
    # the distinct texels the frame's pixels read, the scalars, the output
    th_, tw_ = table.shape
    *_, inv1, iu1, iv1 = warp_kernel._texels(
        th_, tw_, warp_kernel._check(table, kscal, axis_world, WIDTH, HEIGHT),
        axis_world, WIDTH, HEIGHT, dev)
    texels1 = distinct(iu1.long() * tw_ + iv1, ~inv1)
    bytes_moved = texels1 * 4 + 35 * 4 + WIDTH * HEIGHT * 4
    ops_117 = WARP_OPS_PER_PIXEL * WIDTH * HEIGHT
    # the pixels that run the shading: hits, less shadowed ones when
    # shadows are on; the rest stop after the ray, plane and texel
    val1 = torch.where(inv1, -1.0, table[iu1.long(), iv1.long()])
    shaded = val1 >= 0
    if has_sh:
        shaded &= val1 < 2048
    n_shaded = int(shaded.sum())
    # of those, the ambient-coloured ones stop before the normal's length
    # (a normal facing away from the light; a few lit ones round to the
    # ambient word too, so this counts at most that many)
    ambient = warp_kernel.warp_frame(table, kscal, axis_world, WIDTH, HEIGHT,
                                     has_sh) == warp_kernel.ambient_word(
        warp_kernel._check(table, kscal, axis_world, WIDTH, HEIGHT))
    n_back = int((shaded & ambient).sum())
    class_ops = (WARP_OPS_PER_PIXEL * (n_shaded - n_back)
                 + WARP_OPS_BACK_FACING * n_back
                 + WARP_OPS_EARLY_EXIT * (WIDTH * HEIGHT - n_shaded))
    bound_bytes_ms = bytes_moved / PEAK_BYTES_S * 1e3
    bound_ops_ms = class_ops / PEAK_F32_NOFMA_S * 1e3
    bound_ms, bound_by = bound(bytes_moved, class_ops, PEAK_F32_NOFMA_S)
    # the bound of earlier runs: 117 operations for every pixel at the
    # FMA-counted rate, kept on the log line and in the record to compare
    bound_117_ms = bound(bytes_moved, ops_117)[0]
    log("timing", f"[{smi}] frame {frame_ms:.3f} ms (best of 3 windows of "
        f"{N_FRAMES}: {', '.join(f'{w:.3f}' for w in windows)}), "
        f"{mrays:.1f} Mrays/s (2 rays per pixel); host enqueue "
        f"{', '.join(f'{e:.3f}' for e in enqueue)} ms per frame")
    log("timing", f"[{smi}] warp_frame kernel {warp_ms:.4f} ms (alone "
        + (f"{warp_dev_ms:.4f} ms under the profiler" if warp_dev_ms
           else "not measured") + "), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms * 1e3:.2f} us (bytes "
        f"{bound_bytes_ms * 1e3:.2f} us with {texels1} distinct texels, "
        f"class-weighted f32 ops without FMA {bound_ops_ms * 1e3:.2f} us; "
        f"earlier runs' bound, 117 ops a pixel at the FMA-counted rate: "
        f"{bound_117_ms * 1e3:.2f} us); "
        f"sweep + pack {sweep_ms:.3f} ms; shadow volume {shadow_s:.3f} s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("timing", f"warp_frame pixels: {n_shaded} shaded, of which "
        f"{n_back} ambient-coloured (back-facing, at most), "
        f"{WIDTH * HEIGHT - n_shaded} stop at the texel; class-weighted "
        f"operations {class_ops} ({bound_ops_ms * 1e3:.2f} us at the f32 "
        f"rate without FMA, {class_ops / PEAK_F32_S * 1e6:.2f} us at the "
        f"FMA-counted rate), against {ops_117} at {WARP_OPS_PER_PIXEL} a "
        f"pixel")

    # 7. first hit: sweep_first_hit through the warp_lookup kernel
    wk = warp_kernel
    look_calls, restore = held_calls([(slab_sweep, "warp_lookup")])
    wk.warp_lookup.launches = 0
    wk.warp_lookup_multi.launches = 0
    for k in wk.LOOKUP_FORM_LAUNCHES:
        wk.LOOKUP_FORM_LAUNCHES[k] = 0
    hit, t, _, _ = slab_sweep.sweep_first_hit(
        vol, origin, vox, cam.get_pos(), cam.get_view(), 45.0, aspect, WIDTH,
        HEIGHT, layouts=layouts, device=dev)
    torch.cuda.synchronize()
    restore()
    sfh_launches = {"warp_lookup": wk.warp_lookup.launches,
                    "warp_lookup_multi": wk.warp_lookup_multi.launches}
    sfh_forms = dict(wk.LOOKUP_FORM_LAUNCHES)
    log("first hit", f"sweep_first_hit {WIDTH}x{HEIGHT}, bench pose: hit "
        f"share {float(hit.float().mean()):.4f}; launches {sfh_launches}, "
        f"warp_lookup by form {sfh_forms}")
    if sfh_launches["warp_lookup"] < 1:
        raise RuntimeError("sweep_first_hit did not launch warp_lookup")
    if not bool(torch.isfinite(t).all()):
        raise RuntimeError("sweep_first_hit gave non-finite t")
    sfh_ms = cuda_ms(lambda: slab_sweep.sweep_first_hit(
        vol, origin, vox, cam.get_pos(), cam.get_view(), 45.0, aspect, WIDTH,
        HEIGHT, layouts=layouts, device=dev), 5)

    # 8. exact: render_fast_exact_frame through warp_lookup_multi
    def exact_camera(theta=0.9, phi=0.8):
        c = Camera(theta=theta, phi=phi, radius=EXACT_RADIUS * extent)
        c.set_target(center)
        return c

    def exact_frame(c, mark=None):
        out = fast_exact.render_fast_exact_frame(
            vol, shadow, origin, vox, c.get_pos(), c.get_view(), 45.0, aspect,
            WIDTH, HEIGHT, light_dir=light_dir, with_stats=True,
            layouts=layouts, device=dev, mark=mark)
        if out is None:
            raise RuntimeError("the exact pose is outside the envelope")
        if out[1]["overflow"] != 0 or out[1]["unresolved"] != 0:
            raise RuntimeError(f"exact frame dropped pixels: {out[1]}")
        return out

    ecam = exact_camera()
    multi_calls, restore = held_calls([(fast_exact, "warp_lookup_multi")])
    wk.warp_lookup.launches = 0
    wk.warp_lookup_multi.launches = 0
    eimg, estats = exact_frame(ecam)
    torch.cuda.synchronize()
    restore()
    ewindows = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(N_EXACT):
            ecam.phi += 1e-4
            _, st = exact_frame(ecam)
        torch.cuda.synchronize()
        ewindows.append((time.perf_counter() - t) / N_EXACT * 1e3)
    n_exact = 1 + 3 * N_EXACT
    ex_launches = {"warp_lookup": wk.warp_lookup.launches,
                   "warp_lookup_multi": wk.warp_lookup_multi.launches}
    log("exact", f"{n_exact} frames at {WIDTH}x{HEIGHT}, radius "
        f"{EXACT_RADIUS} x extent; stats {estats}; launches {ex_launches}")
    if ex_launches["warp_lookup_multi"] < n_exact:
        raise RuntimeError(f"warp_lookup_multi launched "
                           f"{ex_launches['warp_lookup_multi']} times in "
                           f"{n_exact} exact frames")
    if tuple(eimg.shape) != (HEIGHT, WIDTH, 4) or not bool(
            torch.isfinite(eimg).all()):
        raise RuntimeError(f"bad exact frame {tuple(eimg.shape)}")
    e_lit, e_shadowed, e_background = frame_classes(eimg)
    log("exact", f"lit {e_lit}, shadowed {e_shadowed}, background "
        f"{e_background} px")
    if min(e_lit, e_shadowed, e_background) == 0:
        raise RuntimeError("the exact frame lacks lit, shadowed or "
                           "background pixels")
    stage_ms = {"cube_sweep": [], "resolve": [], "fallback": []}
    for _ in range(3):
        ecam.phi += 1e-4
        marks = []

        def mark(stage):
            marks.append((stage, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        mark("start")
        exact_frame(ecam, mark)
        torch.cuda.synchronize()
        for (_, a), (stage, b) in zip(marks, marks[1:]):
            stage_ms[stage].append(a.elapsed_time(b))
    stage_ms = {k: min(v) for k, v in stage_ms.items()}
    ewall, eper = profiled(lambda: exact_frame(ecam), 2)
    ebusy = sum(eper.values())
    log("exact", f"profiled: wall {ewall:.3f} ms per frame, device busy "
        + (f"{ebusy:.3f} ms, idle share {max(0.0, 1 - ebusy / ewall):.3f}, "
           f"{len(eper)} kernel kinds" if eper else "not measured"))
    exact_ms = min(ewindows)
    exact_mrays = 2 * WIDTH * HEIGHT / (exact_ms / 1e3) / 1e6
    log("exact", f"[{smi}] {exact_ms:.3f} ms per frame (best of 3 windows "
        f"of {N_EXACT}: {', '.join(f'{w:.3f}' for w in ewindows)}), "
        f"{exact_mrays:.1f} Mrays/s (2 rays per pixel); stages (CUDA "
        f"events, best of 3): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stage_ms.items()))

    # 9. parity against the DDA oracle on the card
    pyr = build_pyramid(grid.occ)
    occ_np = grid.occ.cpu().numpy()
    checks_parity = {}
    for name, (pw, ph, pc) in {"sweep_first_hit": (240, 136, bench_camera()),
                               "fast_exact_first_hit": (480, 270,
                                                        exact_camera())}.items():
        # the headline's aspect, as bench.py's parity line (480 / 270 is
        # the same)
        o, d = generate_rays(pw, ph, pc.get_pos(), pc.get_view(), 45.0,
                             aspect, device=dev)
        ref = trace_octree(pyr, o, d, origin, vox)
        args = (vol, origin, vox, pc.get_pos(), pc.get_view(), 45.0, aspect,
                pw, ph)
        if name == "sweep_first_hit":
            hit, t, _, _ = slab_sweep.sweep_first_hit(
                *args, layouts=layouts, device=dev)
        else:
            (hit, t, _, _), st = fast_exact.fast_exact_first_hit(
                *args, with_stats=True, layouts=layouts, device=dev)
            if st["overflow"] != 0:
                raise RuntimeError(f"fast_exact_first_hit overflow: {st}")
        mism, rms = parity(hit, t, ref, vox)
        n_mism = int((hit != ref["hit"]).sum())
        missed = int((ref["hit"] & ~hit).sum())
        checks_parity[name] = {"hit_mismatch_frac": mism,
                               "depth_rms_voxels": rms,
                               "mismatches": n_mism,
                               "oracle_hits_missed": missed}
        log("parity", f"{name} {pw}x{ph}: hit mismatch {mism:.6f} "
            f"({n_mism} px, {missed} oracle hits missed), depth RMS "
            f"{rms:.6f} voxels; oracle steps max {int(ref['steps'].max())}")
        if name == "fast_exact_first_hit":
            idx = torch.nonzero(hit != ref["hit"]).squeeze(1).cpu().numpy()
            bad = grazing_failures(
                idx, o.cpu().numpy().astype(np.float64),
                d.cpu().numpy().astype(np.float64), t.cpu().numpy(),
                ref["t"].cpu().numpy(), occ_np, origin.astype(np.float64),
                vox)
            if bad:
                raise RuntimeError(f"fast-exact mismatches that are not "
                                   f"grazing crossings: {bad[:10]}")

    # the same small frames on the card and on the CPU
    svol_d = svol.to(dev)
    for name, pc in {"sweep_first_hit": Camera(theta=0.5, phi=0.8,
                                               radius=2.2),
                     "fast_exact_first_hit": Camera(theta=0.9, phi=0.8,
                                                    radius=2.0)}.items():
        fn = (slab_sweep.sweep_first_hit if name == "sweep_first_hit"
              else fast_exact.fast_exact_first_hit)
        args = (small.origin.numpy(), float(small.voxel_size), pc.get_pos(),
                pc.get_view(), 45.0, 128 / 72, 128, 72)
        h_c, t_c = fn(svol, *args, device="cpu")[:2]
        h_g, t_g = (x.cpu() for x in fn(svol_d, *args, device=dev)[:2])
        log("parity", f"{name} 32^3 sphere 128x72, card vs CPU: hit masks "
            f"equal {torch.equal(h_g, h_c)} ({int((h_g != h_c).sum())} px "
            f"differ), t equal {torch.equal(t_g, t_c)} (max abs diff "
            f"{float((t_g - t_c).abs().max()):.3g})")
        if not (torch.equal(h_g, h_c) and torch.equal(t_g, t_c)):
            raise RuntimeError(f"{name} on the card disagrees with the CPU")

    # 10. the lookup kernels against their plain versions, and their times
    lookups = {}
    (table, lin), _ = look_calls["warp_lookup"][0]
    multi_in = {}
    for name, (th_, ph_) in {"flip_true": (0.9, 0.8),
                             "flip_false": (-0.9, 0.8 + 3.14159)}.items():
        if name == "flip_true":
            multi_in[name] = multi_calls["warp_lookup_multi"][0][0]
            continue
        calls, restore = held_calls([(fast_exact, "warp_lookup_multi")])
        exact_frame(exact_camera(th_, ph_))
        restore()
        multi_in[name] = calls["warp_lookup_multi"][0][0]
    # warp_lookup's forms on edge inputs made from the bench lin: each
    # bitwise, each launching the forms lookup_forms chooses
    lookup_forms, lookup_edge_ms = {}, {}
    for label, (ln, want) in lookup_edge_inputs(lin).items():
        before = dict(wk.LOOKUP_FORM_LAUNCHES)
        out = wk.warp_lookup(table, ln)
        ref = wk.warp_lookup_reference(table, ln)
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in wk.LOOKUP_FORM_LAUNCHES.items()
               if v != before[k]}
        share = equal_share(out, ref)
        if got != want or share != 1.0:
            raise RuntimeError(f"warp_lookup on the {label} input: launches "
                               f"by form {got} (want {want}), bitwise {share}")
        lookup_forms[label] = got
        _, per = profiled(lambda: wk.warp_lookup(table, ln), 50)
        lookup_edge_ms[label] = sum(v for k, v in per.items()
                                    if "warp_lookup" in k) or None
        log("lookups", f"warp_lookup {label} ({ln.numel()} px, storage "
            f"offset {ln.storage_offset()}): launches by form {got}, bitwise "
            f"{share:.6f}, device ms warm {lookup_edge_ms[label]}")

    # the kernels of the timed inputs: the bench lin takes the vector form
    kernel_names = {"warp_lookup": ("warp_lookup_vector_kernel",),
                    "warp_lookup_multi": ("warp_lookup_kernel",)}
    for kname, inputs in {"warp_lookup": {"bench": (table, lin)},
                          "warp_lookup_multi": multi_in}.items():
        kern = getattr(wk, kname)
        plain = getattr(wk, kname + "_reference")
        res = {}
        for pname, (tab, ln) in inputs.items():
            out = kern(tab, ln)
            ref = plain(tab, ln)
            torch.cuda.synchronize()
            res[pname] = (equal_share(out, ref),
                          float((out - ref).abs().max()))
            log("lookups", f"{kname} {pname} (table "
                f"{tuple(tab.shape)}, lin {tuple(ln.shape)}, miss share "
                f"{float((ln < 0).float().mean()):.4f}): bitwise "
                f"{res[pname][0]:.6f}, max abs err {res[pname][1]}")
        if any(b != 1.0 for b, _ in res.values()):
            raise RuntimeError(f"{kname} differs from its plain version: {res}")
        tab, ln = next(iter(inputs.values()))
        planes = 1 if tab.ndim == 2 else tab.shape[0]
        th, tw = tab.shape[-2:]
        flat = torch.where(ln < 0, 0, (ln >> 10) * tw + (ln & 1023)).long()
        if planes > 1:
            flat = flat[None] + torch.arange(
                planes, device=dev)[:, None, None] * (th * tw)
        names = kernel_names[kname]

        def dev_ms_of(fn, names=names):
            _, per = profiled(fn, 50)
            return sum(v for k, v in per.items()
                       if any(n in k for n in names))

        k_ms = cuda_ms(lambda: kern(tab, ln), 200)
        dev_ms = dev_ms_of(lambda: kern(tab, ln))
        lins = [(ln.clone(),) for _ in range(N_COLD)]
        cold_ms = dev_ms_of(rotating(lambda x: kern(tab, x), lins))
        p_ms = cuda_ms(lambda: plain(tab, ln), 20)
        l_ms = cuda_ms(lambda: torch.take(tab, flat), 200)
        _, lper = profiled(lambda: torch.take(tab, flat), 50)
        flats = [(flat.clone(),) for _ in range(N_COLD)]
        _, lper_cold = profiled(
            rotating(lambda f: torch.take(tab, f), flats), 50)
        del flats
        lib_ms = sum(lper.values()) or None
        lib_cold = sum(lper_cold.values()) or None
        n_px = ln.numel()
        texels = distinct(flat[0] if planes > 1 else flat, ln >= 0)
        # lin, the output planes and each plane's distinct texels; a
        # shift, a mask, two clamps and an index product per pixel
        l_bound, l_by = bound(n_px * (4 + 4 * planes) + planes * texels * 4,
                              5 * n_px)
        extra = {}
        if kname == "warp_lookup":
            extra = compare_lookup_bodies(tab, ln, lins, dev_ms_of)
        del lins
        lookups[kname] = dict(
            res=res, ms=dev_ms or k_ms, ms_cold=cold_ms or None,
            wrapper_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
            library_device_ms=lib_ms, library_device_ms_cold=lib_cold,
            bound_ms=l_bound, bound_by=l_by,
            bound_share_cold=l_bound / cold_ms if cold_ms else None,
            take_factor=dev_ms / lib_ms if dev_ms and lib_ms else None,
            take_factor_cold=(cold_ms / lib_cold if cold_ms and lib_cold
                              else None), **extra)
        log("lookups", f"[{smi}] {kname} kernel {k_ms:.4f} ms (CUDA "
            f"events over wrapper calls; the kernel alone "
            + (f"{dev_ms:.4f} ms warm, {cold_ms:.4f} ms cold under the "
               f"profiler" if dev_ms else "not measured: the profiler saw "
               "no kernel")
            + f"), plain "
            f"{p_ms:.4f} ms, torch.take {l_ms:.4f} ms (its kernels "
            f"{lib_ms or 0:.4f} ms warm, {lib_cold or 0:.4f} ms cold under "
            f"the profiler), bound "
            f"{l_bound * 1e3:.2f} us ({planes} plane(s), "
            f"{n_px} px, {texels} distinct texels of a {th}x{tw} table)")

    # 11. the warp experiments
    exp_rows = experiments(smi)

    # 12. the bench
    bench_rec = run_bench_phase(checks_parity["sweep_first_hit"])

    # 13-18. the exact tracers
    exact = exact_tracer_phases(dict(
        dev=dev, smi=smi, vol=vol, pyr=pyr, origin=origin, vox=vox,
        light_dir=light_dir, layouts=layouts, grid=grid, occ_np=occ_np,
        small=small, bench_camera=bench_camera, exact_camera=exact_camera))
    # 19-22. the volume renderer
    volume = volume_phases(dict(dev=dev, smi=smi, grid=grid, small=small,
                                bench_camera=bench_camera))
    exact["launches"]["volume frame (phase 20)"] = {
        "warp_lookup_multi": volume.pop("launches")}
    for k, h in volume.pop("held").items():
        exact["held"].setdefault(k, {})["volume frame (phase 20)"] = h
    # 23-25. the linear octree and extraction
    extraction = extraction_phases(dict(dev=dev, smi=smi, grid=grid,
                                        bench_camera=bench_camera))
    # 26. the linear tree's branches
    volume_renderer = volume.pop("renderer")
    branches = linear_tree_phases(dict(
        dev=dev, smi=smi, grid=grid, pyr=pyr, tree=extraction.pop("tree"),
        bench_camera=bench_camera, exact_camera=exact_camera,
        volume_renderer=volume_renderer))
    for path, counts in branches.pop("launches").items():
        exact["launches"][path] = counts
    for k, by in branches.pop("held").items():
        exact["held"].setdefault(k, {}).update(by)
    # 27-30. the mesh frame, the LBVH oracle, ingest, card vs CPU
    mesh = mesh_phases(dict(dev=dev, smi=smi, grid=grid))
    for path, counts in mesh.pop("launches").items():
        exact["launches"][path] = counts
    for k, by in mesh.pop("held").items():
        exact["held"].setdefault(k, {}).update(by)
    # 31-36. the app shell, the pipeline, the CLI and demo, card vs CPU
    app = app_phases(dict(dev=dev, smi=smi, grid=grid, vol=vol,
                          shadow=shadow, layouts=layouts, origin=origin,
                          vox=vox, bench_camera=bench_camera))
    for path, counts in app.pop("launches").items():
        exact["launches"][path] = counts
    for k, by in app.pop("held").items():
        exact["held"].setdefault(k, {}).update(by)

    by_path = {
        "warp_frame": {"fast frame (phase 4)": launches["warp_frame"]},
        "warp_lookup": {"sweep_first_hit (phase 7)":
                        sfh_launches["warp_lookup"]},
        "warp_lookup_multi": {"exact frame (phase 8)":
                              ex_launches["warp_lookup_multi"]},
    }
    for path, counts in exact["launches"].items():
        for k, v in counts.items():
            by_path[k][path] = v
    for k, v in extraction["extraction"]["kernel_launches"].items():
        if k in by_path:
            by_path[k]["extraction pipelines (phase 24)"] = v

    # 37-38. the multi-device paths: one NCCL rank, four gloo ranks
    multichip = multichip_phases(dict(
        dev=dev, smi=smi, grid=grid, vol=vol, shadow=shadow, layouts=layouts,
        origin=origin, vox=vox, pyr=pyr, bench_camera=bench_camera,
        volume_renderer=volume_renderer))
    for path, counts in multichip.pop("launches").items():
        for k, v in counts.items():
            by_path[k][path] = v
    for k, by in multichip.pop("held").items():
        exact["held"].setdefault(k, {}).update(by)

    # 39. the config ladder; 40. the entry points
    ladder = ladder_phase(dict(dev=dev, smi=smi))
    entries = entry_phases(dict(dev=dev, smi=smi))
    for section in (ladder, entries):
        for path, counts in section.pop("launches").items():
            for k, v in counts.items():
                by_path[k][path] = v
        for k, by in section.pop("held").items():
            exact["held"].setdefault(k, {}).update(by)

    # 41. lines
    held = exact["held"]
    record = {"kernels": [{
        "name": "warp_frame",
        "route": "cuda",
        "source": "ray_tracing_octrees_tpu_torch/trace/csrc/warp_frame.cu",
        "replaces": "ray_tracing_octrees_tpu/trace/warp_kernel.py:309",
        "launches": sum(by_path["warp_frame"].values()),
        "launches_by_path": by_path["warp_frame"],
        "launches_per_frame": launches["warp_frame"] / n_main,
        "max_abs_err": max([e for _, _, e in checks.values()]
                           + [h["max_abs_err"] for h in
                              held.get("warp_frame", {}).values()]),
        "bitwise_share": {k: b for k, (b, _, _) in checks.items()},
        "held_on_paths": held.get("warp_frame", {}),
        "bitwise_share_instantiations": inst_checks,
        "match_bar": "bitwise equal (share 1.0)",
        "match_share_within_1.5_255": {k: s for k, (_, s, _)
                                        in checks.items()},
        "match_ok": True,
        "ms": warp_dev_ms or warp_ms,
        "ms_source": MS_SOURCE[bool(warp_dev_ms)],
        "ms_by_vox_division": vox_ms,
        "wrapper_ms": warp_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_share": bound_ms / (warp_dev_ms or warp_ms),
        "bound_rule": "max(bytes at 3.35 TB/s, class-weighted ops at 33.5 "
                      "TFLOP/s: the f32 rate without FMA)",
        "bound_ms_117_per_pixel": bound_117_ms,
        "pixels_shaded": n_shaded,
        "pixels_shaded_ambient": n_back,
        "class_weighted_ops": class_ops,
        "class_weighted_ops_ms": bound_ops_ms,
        "ptxas": kernel_resources(ptxas.get("warp_frame", {}),
                                  "warp_frame_kernel"),
        "library_ms": None,
    }] + [{
        "name": kname,
        "route": "cuda",
        "source": "ray_tracing_octrees_tpu_torch/trace/csrc/warp_lookup.cu",
        "replaces": "ray_tracing_octrees_tpu/trace/warp_kernel.py:"
                    + ("50" if kname == "warp_lookup" else "192"),
        "launches": sum(by_path[kname].values()),
        "launches_by_path": by_path[kname],
        "launches_per_frame": launches_of / n_frames,
        "max_abs_err": max([e for _, e in lk["res"].values()]
                           + [h["max_abs_err"] for h in
                              held.get(kname, {}).values()]),
        "bitwise_share": {k: b for k, (b, _) in lk["res"].items()},
        "held_on_paths": held.get(kname, {}),
        "match_bar": "bitwise equal (share 1.0)",
        "match_share": {k: b for k, (b, _) in lk["res"].items()},
        "match_ok": True,
        "ms": lk["ms"],
        "ms_source": MS_SOURCE[lk["ms"] != lk["wrapper_ms"]],
        "wrapper_ms": lk["wrapper_ms"],
        "plain_ms": lk["plain_ms"],
        "bound_ms": lk["bound_ms"],
        "bound_by": lk["bound_by"],
        "library_ms": lk["library_ms"],
        "library_device_ms": lk["library_device_ms"],
        "library_device_ms_cold": lk["library_device_ms_cold"],
        "ms_cold": lk["ms_cold"],
        "bound_share_cold": lk["bound_share_cold"],
        "take_factor": lk["take_factor"],
        "take_factor_cold": lk["take_factor_cold"],
        "launches_by_form": forms_of,
        "ptxas": {k: v for n in kernel_names[kname] for k, v in
                  kernel_resources(ptxas.get("warp_lookup", {}), n).items()},
        **({"edge_ms_warm": lookup_edge_ms} if kname == "warp_lookup"
           else {}),
        **({"on_volume_frame_inputs": volume["frame"]["warp_lookup_multi"]}
           if kname == "warp_lookup_multi" else {}),
        **{k: lk[k] for k in ("first_port_ms", "first_port_ms_cold",
                              "vector_in_turns_ms", "vector_in_turns_ms_cold")
           if k in lk},
    } for kname, lk, launches_of, n_frames, forms_of in (
        ("warp_lookup", lookups["warp_lookup"],
         sfh_launches["warp_lookup"], 1,
         {"bench": sfh_forms, **lookup_forms}),
        ("warp_lookup_multi", lookups["warp_lookup_multi"],
         ex_launches["warp_lookup_multi"], n_exact, None))] + exp_rows,
        "frame_ms": frame_ms, "mrays_per_s": mrays, "sweep_ms": sweep_ms,
        "sweep_first_hit_ms": sfh_ms, "exact_frame_ms": exact_ms,
        "exact_mrays_per_s": exact_mrays, "exact_stage_ms": stage_ms,
        "exact_stats": estats, "exact_profiled_wall_ms": ewall,
        "exact_device_busy_ms": ebusy if eper else None,
        "parity": checks_parity, "bench": bench_rec,
        "exact_tracers": {k: v for k, v in exact.items()
                          if k not in ("launches", "held")},
        "volume": volume,
        "extraction": dict(extraction, launches_on_extraction_paths=extraction[
            "extraction"]["kernel_launches"]),
        "linear_tree_branches": branches,
        "mesh": mesh["mesh"],
        "app": app["app"],
        "multichip": multichip,
        "ladder": ladder,
        "entry_points": entries,
        "wall_s": time.perf_counter() - T0,
        "card": smi}
    log("lines", f"[{smi}] the whole run took {record['wall_s']:.1f} s")
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
