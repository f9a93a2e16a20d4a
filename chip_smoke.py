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
              the exact section, the 16-pose ensemble)
  13. lines   the kernels JSON line, the nvidia-smi line, and last the
              {"ok": true, "device": {...}} line

Imports nothing of JAX or of the JAX package. Without a CUDA device, or
without the port package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import re
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


def recorded(module, name):
    """Wrap ``module.name`` so each call keeps its arguments; returns
    (calls, restore)."""
    calls = []
    real = getattr(module, name)

    def rec(*args):
        calls.append(args)
        return real(*args)

    setattr(module, name, rec)
    return calls, lambda: setattr(module, name, real)


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
        f"{rec['exact_tracer_path'] or rec['exact_skip_reason']}; radius "
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
    if not (rec["exact_tracer_path"] is None and rec["exact_skip_reason"]
            or rec["exact_tracer_path"] == "fast_exact"
            and rec["exact_tracer_mrays"] > 0):
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
            rec["exact_tracer_path"], "exact_radius_2": near,
            "ensemble": {k: ens[k] for k in ("n_poses", "worst_pose",
                                              "median_mismatch",
                                              "max_rms_vox")}}


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
    look_calls, restore = recorded(slab_sweep, "warp_lookup")
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
    multi_calls, restore = recorded(fast_exact, "warp_lookup_multi")
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
    table, lin = look_calls[0]
    multi_in = {}
    for name, (th_, ph_) in {"flip_true": (0.9, 0.8),
                             "flip_false": (-0.9, 0.8 + 3.14159)}.items():
        if name == "flip_true":
            multi_in[name] = multi_calls[0]
            continue
        calls, restore = recorded(fast_exact, "warp_lookup_multi")
        exact_frame(exact_camera(th_, ph_))
        restore()
        multi_in[name] = calls[0]
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

    # 13. lines
    record = {"kernels": [{
        "name": "warp_frame",
        "route": "cuda",
        "source": "ray_tracing_octrees_tpu_torch/trace/csrc/warp_frame.cu",
        "replaces": "ray_tracing_octrees_tpu/trace/warp_kernel.py:309",
        "launches": launches["warp_frame"],
        "launches_per_frame": launches["warp_frame"] / n_main,
        "max_abs_err": max(e for _, _, e in checks.values()),
        "bitwise_share": {k: b for k, (b, _, _) in checks.items()},
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
        "launches": launches_of,
        "launches_per_frame": launches_of / n_frames,
        "max_abs_err": max(e for _, e in lk["res"].values()),
        "bitwise_share": {k: b for k, (b, _) in lk["res"].items()},
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
        "parity": checks_parity, "bench": bench_rec, "card": smi}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
