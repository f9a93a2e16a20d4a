"""The config ladder of the port: one JSON line per configuration.

Counterpart of the JAX package's ladder (``benchmarks.py`` at the
repository root), with its function names (:func:`_bench`, :func:`_emit`,
:func:`config1` ... :func:`config6`, :func:`main`), its config names and
fields, its poses, resolutions, frame counts and scene fallback:

  1. sphere 64^3 -> octree -> Marching Cubes mesh + triangle count
  2. sphere 128^3 octree raycast (DDA) at 512x512, depth + normal, and the
     slab-sweep first hit of the same depth buffer
  3. Calgary voxelize -> adaptive Dual Contouring with QEF solves
  4. extracted MC mesh -> grid-wavefront mesh frame at 1920x1088, and the
     LBVH oracle at 480x270, primary + shadow
  5. the fast frame's 4K (3840x2160) fly-through, exterior and interior
  6. VOLUME_RAYCAST: the sweep frame at 256^2, 512^2 and 1920x1080, the
     per-ray oracle at 128^2 and 256^2, and the oracle at 512^2 against
     the sweep frame's hit mask

    python -m ray_tracing_octrees_tpu_torch.benchmarks [config-numbers...]

(default: all six). Scenes: :data:`SCENE_CACHE`, looked up in the
repository root by :func:`bench.find_scene`, recentred; where it is
absent config 3 prints the JAX ladder's ``skipped`` line and configs 4-6
take the 128^3 sphere (``scene: "sphere128"``). Each config returns the
rows it printed.

Every config runs on CUDA unless the caller passes ``device="cpu"`` (the
kernels' plain versions; no time it gives is a device time); without
CUDA and without that, :func:`main` and each config raise. Times are the
host clock around calls whose ends wait for the card
(``torch.cuda.synchronize()``): :func:`_bench` is one warm call, then the
mean of ``iters``; configs 4-6 time their own loops as the JAX ladder
does (config 5: every pose warmed, then all frames enqueued and one wait).
The size arguments' defaults are the JAX ladder's; smaller ones serve
the tests. The JAX ladder keeps its sweep layouts in id-keyed caches;
here each config holds its scene's :class:`slab_sweep.SweepLayouts`.

Not carried over, and why:

- ``enable_compile_cache``: the persistent XLA cache exists only for XLA;
  the port builds its kernels with ``nvcc`` at first use;
- the catch-alls: the JAX ``main`` catches each config's error and goes
  on, and so does config 6's 512^2 row; here a failure raises and the
  command exits non-zero, as in the port's bench;
- config 6's 512^2 oracle runs as one band (``band_rows=512``) with
  ``max_steps=800`` and no ``segment_steps``: the JAX ladder's 16 bands
  of 32 rows in segments of 100 steps exist because long dispatches
  killed the remote TPU worker. ``raymarch_volume_banded`` equals the
  whole frame for any band height, and the port's oracle is host-bound
  (a few hundred small ops an iteration), so each band would pay the
  frame's iterations again.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.bench import _sync, find_scene

SCENE_CACHE = "sceneCache.bin"   # the Calgary scene cache (not in the repo)
TO_LIGHT = (0.5, 0.9, 0.4)       # toward the light (configs 4 and 5)
ORACLE_NOTE = ("divergence is the reference's own far-field skip scale "
               "(raycastFS.glsl:506) which the sweep does not reproduce; "
               "skips-off agreement 98.6% at 128^2")


def _bench(fn: Callable, dev: torch.device, iters: int = 3):
    """(the last output, seconds a call): one warm call, then the mean of
    ``iters`` calls, each end waiting for the device."""
    out = fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) / iters


def _emit(**kw) -> dict:
    print(json.dumps(kw), flush=True)
    return kw


def _scene_path(scene_path: Optional[str]) -> str:
    """The scene cache to load: ``scene_path`` when given ("" for none),
    else :data:`SCENE_CACHE` in the repository root, or ""."""
    return find_scene(SCENE_CACHE) if scene_path is None else scene_path


def _scene_grid(dev: torch.device, n: int, scene_path: Optional[str]):
    """(grid, scene name): the recentred Calgary cache where there is one,
    else the n^3 sphere (named "sphere128" at every n, as the rows)."""
    from ray_tracing_octrees_tpu_torch.core.cache import load_voxel_grid
    from ray_tracing_octrees_tpu_torch.core.grid import (
        make_sphere_grid, recenter_filled_voxels,
    )

    path = _scene_path(scene_path)
    if path:
        return recenter_filled_voxels(load_voxel_grid(path, device=dev)), \
            "calgary"
    return make_sphere_grid(n, device=dev), "sphere128"


def _extent_center(g):
    """(largest world extent, filled-box centre) of grid ``g``."""
    from ray_tracing_octrees_tpu_torch.core.grid import building_center

    extent = float((g.world_max - g.world_min).max())
    return extent, np.asarray(building_center(g))


def config1(n: int = 64, device: DeviceLike = None) -> List[dict]:
    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        count_mc_triangles, marching_cubes_grid,
    )

    dev = resolve_device(device)
    g = make_sphere_grid(n, device=dev)
    tree = build_linear_octree(g.occ, device=dev)
    total = int(count_mc_triangles(g))
    out, dt = _bench(
        lambda: marching_cubes_grid(g, max_triangles=total + 16, device=dev),
        dev)
    return [_emit(
        config="sphere64_mc",
        triangles=total,
        octree_nodes=tree.num_nodes,
        extract_ms=round(dt * 1e3, 3),
        tris_per_s=round(total / dt, 1),
    )]


def config2(n: int = 128, res: int = 512,
            device: DeviceLike = None) -> List[dict]:
    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
    from ray_tracing_octrees_tpu_torch.render.camera import (
        Camera, generate_rays,
    )
    from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree
    from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
        SweepLayouts, sweep_first_hit,
    )

    dev = resolve_device(device)
    g = make_sphere_grid(n, device=dev)
    pyr = build_pyramid(g.occ)
    cam = Camera(theta=0.4, phi=0.8, radius=2.0)
    o, d = generate_rays(res, res, cam.get_pos(), cam.get_view(), 45.0, 1.0,
                         device=dev)
    out, dt = _bench(
        lambda: trace_octree(pyr, o, d, g.origin, g.voxel_size), dev)
    hits = int(out["hit"].sum())

    # fast slab-sweep variant of the same depth buffer
    vol = (g.occ > 0).to(torch.float32)
    layouts = SweepLayouts(vol)
    origin = g.origin.cpu().numpy()
    vox = float(g.voxel_size)
    out2, dt2 = _bench(
        lambda: sweep_first_hit(
            vol, origin, vox, cam.get_pos(), cam.get_view(), 45.0, 1.0, res,
            res, layouts=layouts, device=dev),
        dev)
    return [_emit(
        config="sphere128_raycast_512_depth_normal",
        rays=res * res,
        hits=hits,
        frame_ms=round(dt * 1e3, 3),
        mrays_per_s=round(res * res / dt / 1e6, 3),
        sweep_frame_ms=round(dt2 * 1e3, 3),
        sweep_mrays_per_s=round(res * res / dt2 / 1e6, 3),
    )]


def config3(scene_path: Optional[str] = None,
            device: DeviceLike = None) -> List[dict]:
    from ray_tracing_octrees_tpu_torch.core.cache import load_voxel_grid
    from ray_tracing_octrees_tpu_torch.core.grid import recenter_filled_voxels
    from ray_tracing_octrees_tpu_torch.core.octree import (
        build_linear_octree, build_node_id_volume,
    )
    from ray_tracing_octrees_tpu_torch.ops.dual_contouring import (
        adaptive_dual_contouring, tree_host_meta,
    )

    dev = resolve_device(device)
    path = _scene_path(scene_path)
    if not path:
        return [_emit(config="calgary_adaptive_dc",
                      skipped="scene cache missing")]
    g = recenter_filled_voxels(load_voxel_grid(path, device=dev))
    tree = build_linear_octree(g.occ, device=dev)
    # scene preprocessing, as g_octreeMap registered during the octree
    # build (OctreeVoxel.cpp:552-554): one-lookup neighbours and the
    # tree's host metadata for the extractions below
    id_vol = build_node_id_volume(tree)
    _sync(dev)
    meta = tree_host_meta(tree)
    accel = dict(node_id_vol=id_vol, tree_meta=meta, device=dev)
    t0 = time.perf_counter()
    verts, normals, count = adaptive_dual_contouring(g, tree, **accel)
    dt = time.perf_counter() - t0
    # warm pass: the steady-state per-pose extraction
    t0 = time.perf_counter()
    verts2, _, count2 = adaptive_dual_contouring(g, tree, **accel)
    dt_warm = time.perf_counter() - t0
    if int(count2) != int(count):
        raise RuntimeError(f"warm DC count {int(count2)} != {int(count)}")
    # device-resident variant: the triangles stay on the card for the
    # rasterizer
    v_d, n_d, c_d = adaptive_dual_contouring(g, tree, device_out=True,
                                             **accel)
    _sync(dev)
    t0 = time.perf_counter()
    v_d, n_d, c_d = adaptive_dual_contouring(g, tree, device_out=True,
                                             **accel)
    _sync(dev)
    dt_dev = time.perf_counter() - t0
    if int(c_d) != int(count):
        raise RuntimeError(f"device-out DC count {int(c_d)} != {int(count)}")
    return [_emit(
        config="calgary_adaptive_dc_qef",
        triangles=int(count),
        octree_nodes=tree.num_nodes,
        extract_ms=round(dt * 1e3, 1),
        warm_extract_ms=round(dt_warm * 1e3, 1),
        warm_device_out_ms=round(dt_dev * 1e3, 1),
        tris_per_s=round(int(count) / dt_warm, 1),
    )]


def config4(n: int = 128, size: Tuple[int, int] = (1920, 1088),
            frames: int = 10, oracle_size: Tuple[int, int] = (480, 270),
            scene_path: Optional[str] = None,
            device: DeviceLike = None) -> List[dict]:
    from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
        count_mc_triangles, marching_cubes_grid,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import (
        Camera, generate_rays,
    )
    from ray_tracing_octrees_tpu_torch.trace.lbvh import build_lbvh, trace_lbvh
    from ray_tracing_octrees_tpu_torch.trace.mesh_grid import (
        prepare_mc_scene, render_mc_mesh_frame,
    )
    from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _unit

    dev = resolve_device(device)
    g, scene = _scene_grid(dev, n, scene_path)
    total = int(count_mc_triangles(g))
    verts, _, count = marching_cubes_grid(g, max_triangles=total, device=dev)
    tris = verts[:int(count)]
    t0 = time.perf_counter()
    bvh = build_lbvh(tris, device=dev)
    _sync(dev)
    build_ms = (time.perf_counter() - t0) * 1e3
    extent, center = _extent_center(g)

    # Production path: the grid-wavefront MC-mesh tracer (trace/mesh_grid)
    # at full 1080p, a distinct camera pose per timed frame.
    mscene = prepare_mc_scene(g.occ, g.origin, g.voxel_size,
                              to_light=TO_LIGHT, device=dev)
    W, H = size

    def mesh_frame(i):
        cam = Camera(theta=0.9 + 0.013 * i, phi=0.8 - 0.007 * i,
                     radius=0.75 * extent)
        cam.set_target(center)
        return render_mc_mesh_frame(
            mscene, cam.get_pos(), cam.get_view(), 45.0, W / H, W, H,
            light_dir=tuple(-c for c in TO_LIGHT), device=dev)

    mesh_frame(0)
    _sync(dev)
    t0 = time.perf_counter()
    outs = [mesh_frame(1 + i) for i in range(frames)]
    _sync(dev)
    dt = (time.perf_counter() - t0) / frames
    hit_frac = float((outs[0][..., :3].amax(-1) > 0).float().mean())
    rows = [_emit(
        config="mc_mesh_grid_trace",
        scene=scene,
        resolution=f"{W}x{H}",
        triangles=int(count),
        frame_ms=round(dt * 1e3, 1),
        mrays_per_s=round(W * H * 2 / dt / 1e6, 3),
        hit_fraction=round(hit_frac, 4),
    )]

    # The exact general-mesh oracle (escape-link LBVH traversal), scoped
    # as the correctness oracle of the mesh frame, measured small.
    Wq, Hq = oracle_size
    cam = Camera(theta=0.9, phi=0.8, radius=0.75 * extent)
    cam.set_target(center)
    o, d = generate_rays(Wq, Hq, cam.get_pos(), cam.get_view(), 45.0,
                         Wq / Hq, device=dev)
    light = torch.tensor(TO_LIGHT, dtype=torch.float32, device=dev)

    def frame():
        res = trace_lbvh(bvh, o, d, max_steps=4096)
        so = res["point"] + res["normal"] * 1e-3
        sd = _unit(light).expand(so.shape)
        sres = trace_lbvh(bvh, so, sd, max_steps=4096)
        return res, sres

    out, dt = _bench(frame, dev, iters=1)
    rows.append(_emit(
        config="mc_mesh_lbvh_trace_oracle",
        scene=scene,
        resolution=f"{Wq}x{Hq}",
        triangles=int(count),
        lbvh_build_ms=round(build_ms, 1),
        frame_ms=round(dt * 1e3, 1),
        mrays_per_s=round(Wq * Hq * 2 / dt / 1e6, 3),
        hit_fraction=round(float(out[0]["hit"].float().mean()), 4),
    ))
    return rows


def config5(n: int = 128, size: Tuple[int, int] = (3840, 2160),
            reps: int = 4, scene_path: Optional[str] = None,
            device: DeviceLike = None) -> List[dict]:
    from ray_tracing_octrees_tpu_torch.render.camera import Camera
    from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
        SweepLayouts, render_fast_frame, shadow_volume,
    )

    dev = resolve_device(device)
    g, scene = _scene_grid(dev, n, scene_path)
    vol = (g.occ > 0).to(torch.float32)
    light = tuple(-c for c in TO_LIGHT)
    sv = shadow_volume(vol, TO_LIGHT, device=dev)
    layouts = SweepLayouts(vol, sv)
    origin = g.origin.cpu().numpy()
    vox = float(g.voxel_size)
    extent, center = _extent_center(g)
    W, H = size   # 4K fly-through
    wmin = g.world_min.cpu().numpy()
    wmax = g.world_max.cpu().numpy()
    rows = []

    def measure(poses, label):
        # Sustained fly-through: every pose warmed, then all frames
        # enqueued (every frame a distinct pose) and one wait at the end.
        def f(cam):
            return render_fast_frame(
                vol, sv, origin, vox, cam.get_pos(), cam.get_view(), 45.0,
                W / H, W, H, light_dir=light, layouts=layouts, device=dev)

        for cam in poses:
            f(cam)
            _sync(dev)
        t0 = time.perf_counter()
        outs = []
        for _ in range(reps):
            for cam in poses:
                cam.phi += 1e-4
                outs.append(f(cam))
        _sync(dev)
        dt = (time.perf_counter() - t0) / (reps * len(poses))
        rows.append(_emit(
            config=f"calgary_4k_flythrough_{label}",
            scene=scene,
            resolution=f"{W}x{H}",
            frame_ms=round(dt * 1e3, 1),
            fps=round(1.0 / dt, 2),
            mrays_per_s=round(W * H * 2 / dt / 1e6, 1),
        ))

    ext_poses = []
    for i in range(4):
        cam = Camera(theta=0.8 + 0.05 * i, phi=0.5 + 0.4 * i,
                     radius=0.8 * extent)
        cam.set_target(center)
        ext_poses.append(cam)
    measure(ext_poses, "exterior")

    # fly-THROUGH: eyes inside the scene bounds (forward half-volume sweep)
    int_poses = []
    for i in range(2):
        tgt = center + np.array([0.25 * extent, 0.0, 0.0], np.float32)
        cam = Camera(theta=0.04, phi=1.45 + 0.02 * i, radius=0.22 * extent,
                     target=tgt.astype(np.float32))
        pos = cam.get_pos()
        if bool(((pos > wmin) & (pos < wmax)).all()):
            int_poses.append(cam)
    if int_poses:
        measure(int_poses, "interior")
    return rows


def config6(n: int = 128,
            sweep_sizes: Sequence[Tuple[int, int]] = ((256, 256), (512, 512),
                                                      (1920, 1080)),
            sweep_frames: int = 20,
            oracle_sizes: Sequence[Tuple[int, int]] = ((128, 128),
                                                       (256, 256)),
            oracle_frames: int = 2, oracle_res: int = 512,
            scene_path: Optional[str] = None,
            device: DeviceLike = None) -> List[dict]:
    """VOLUME_RAYCAST mode (the reference's busiest shader, raycastFS.glsl):
    the sweep frame, and the per-ray raymarch with mip skipping, shadows,
    AO and TAA jitter as its oracle."""
    from ray_tracing_octrees_tpu_torch.config import DEFAULT_CONFIG
    from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
    from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import Camera
    from ray_tracing_octrees_tpu_torch.trace.raymarch import (
        raymarch_volume_banded,
    )
    from ray_tracing_octrees_tpu_torch.trace.raymarch_sweep import (
        prepare_volume_scene, render_volume_frame,
    )

    dev = resolve_device(device)
    g, scene = _scene_grid(dev, n, scene_path)
    rc = VolumeRaycastRenderer(DEFAULT_CONFIG, device=dev).init(
        g, build_pyramid(g.occ))
    extent, center = _extent_center(g)
    rows = []

    def camera(i):
        cam = Camera(theta=0.9 + 0.01 * i, phi=0.8 - 0.005 * i,
                     radius=0.75 * extent)
        cam.set_target(center)
        return cam

    def timed(draw, W, H, frames):
        """Seconds a frame of ``draw`` at W x H over ``frames`` distinct
        poses, after one warm frame."""
        draw(camera(0), W, H, W / H)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(frames):
            draw(camera(1 + i), W, H, W / H)
        _sync(dev)
        return (time.perf_counter() - t0) / frames

    # The production path is the sweep-space restructuring (draw_fast:
    # trace/raymarch_sweep.py); the per-ray port (draw) stays as the
    # reference-semantics oracle, measured small, for the record.
    for label, draw, sizes, frames in (
            ("volume_raymarch_sweep", rc.draw_fast, sweep_sizes,
             sweep_frames),
            ("volume_raymarch_oracle", rc.draw, oracle_sizes,
             oracle_frames)):
        for W, H in sizes:
            dt = timed(draw, W, H, frames)
            rows.append(_emit(
                config=label,
                scene=scene,
                resolution=f"{W}x{H}",
                frame_ms=round(dt * 1e3, 1),
                fps=round(1.0 / dt, 4),
                mrays_per_s=round(W * H / dt / 1e6, 4),
            ))

    # The oracle at 512^2 in one band, and its hit mask against the sweep
    # frame's. The reference's own distance-scaled skipping
    # (raycastFS.glsl:506, mix(0.001, 12.0, nd^3.5)) saturates at
    # Calgary's world scale and over-skips thin buildings; the sweep
    # renders the unskipped integral.
    W = H = oracle_res
    cam = Camera(theta=0.9, phi=0.8, radius=0.75 * extent)
    cam.set_target(center)
    inv_view = np.linalg.inv(np.asarray(cam.get_view(), np.float64))
    inv_proj = np.linalg.inv(np.asarray(cam.get_proj(1.0), np.float64))
    t0 = time.perf_counter()
    ref = raymarch_volume_banded(
        rc.textures, np.asarray(cam.get_pos(), np.float32),
        inv_view.astype(np.float32), inv_proj.astype(np.float32), W, H,
        band_rows=H, max_steps=800, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    vscene = prepare_volume_scene(rc.textures, float(g.voxel_size),
                                  device=dev)
    out = render_volume_frame(vscene, g.origin.cpu().numpy(), cam.get_pos(),
                              cam.get_view(), 45.0, 1.0, W, H, device=dev)
    hs = out["alpha"] >= 0.1
    hr = ref["alpha"] >= 0.1
    rows.append(_emit(
        config="volume_raymarch_oracle_512",
        scene=scene,
        resolution=f"{W}x{H}",
        frame_s=round(dt, 1),
        sweep_hit_agreement=round(float((hs == hr).float().mean()), 4),
        note=ORACLE_NOTE,
    ))
    return rows


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> List[dict]:
    """Run the configs named in ``argv`` (default: the command line's,
    else all six) in order; returns every row printed. A config's failure
    raises."""
    dev = resolve_device(device)
    args = sys.argv[1:] if argv is None else list(argv)
    picks = [int(a) for a in args] or [1, 2, 3, 4, 5, 6]
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5,
           6: config6}
    rows = []
    for p in picks:
        rows += fns[p](device=dev)
    return rows


if __name__ == "__main__":
    main()
