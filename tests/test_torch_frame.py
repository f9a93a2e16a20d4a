"""The port's slice end to end: the slab-sweep frame against the JAX
reference, the device rule of its entry points, and its independence
from JAX.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ts

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "ray_tracing_octrees_tpu_torch"
TO_LIGHT = (0.5, 0.9, 0.4)
W, H = 256, 64
POSES = {
    "exterior": dict(theta=0.5, phi=0.8, radius=2.2),
    "below": dict(theta=-0.9, phi=4.0, radius=2.0),
    "interior": dict(theta=0.05, phi=3.2, radius=0.05,
                     target=np.array([0.0, 0.0, -0.3], np.float32)),
}


def _camera(name):
    p = dict(POSES[name])
    target = p.pop("target", None)
    cam = Camera(**p)
    if target is not None:
        cam.set_target(target)
    return cam


@pytest.fixture(scope="module")
def scene():
    g = make_sphere_grid(32)
    vol = (np.asarray(g.occ) > 0).astype(np.float32)
    return (g, vol, js.shadow_volume(vol, TO_LIGHT),
            ts.shadow_volume(vol, TO_LIGHT, device="cpu"))


def _agree(a, b):
    """Share of pixels within 1.5/255 on every channel."""
    return float((np.abs(a - b).max(-1) <= 1.5 / 255.0).mean())


@pytest.mark.parametrize("name", list(POSES))
def test_frame_matches_reference(scene, name):
    """The port's render_fast_frame on the CPU against the JAX frame (the
    split XLA path, unquantized colours) and against the JAX fused Pallas
    frame run interpreted, at the bar of tests/test_warp_kernel.py."""
    g, vol, sv_j, sv_t = scene
    cam = _camera(name)
    ld = tuple(-c for c in TO_LIGHT)
    ref = np.asarray(js.render_fast_frame(
        vol, sv_j, g.origin, g.voxel_size, cam.get_pos(), cam.get_view(),
        45.0, W / H, W, H, light_dir=ld, inter_h=256, inter_w=256))
    aw, flip, (S, A, B), eyes, window, crop = js._sweep_geometry(
        vol, g.origin, g.voxel_size, cam.get_pos(), cam.get_view())
    vb = js._layout_volume(vol, aw, flip, S, A, B, crop)
    scal = js._frame_scalars(
        *eyes[:3], eyes[3], *window, 45.0, W / H, float(g.voxel_size), S,
        np.asarray(g.origin, np.float32) + js._AXIS_SELECTORS[aw][0]
        * np.float32(crop * float(g.voxel_size)),
        np.asarray(cam.get_pos(), np.float32), cam.get_view(), ld,
        (1.0, 0.8, 0.6), (0.1, 0.1, 0.1))
    fused = np.asarray(js._frame_fused(
        vb, sv_j, scal, vb.shape[0] // 32, S, A, B, 256, 256, bool(flip), aw,
        W, H, True, warp_cfg=(32, 128, 256), crop_lo=crop, s_keep=S))

    out = ts.render_fast_frame(
        torch.from_numpy(vol), sv_t, np.asarray(g.origin),
        float(g.voxel_size), cam.get_pos(), cam.get_view(), 45.0, W / H, W, H,
        light_dir=ld, inter_h=256, inter_w=256, device="cpu").numpy()
    assert out.shape == (H, W, 4) and out.dtype == np.float32
    refq = np.round(np.clip(ref, 0.0, 1.0) * 255.0) / 255.0
    assert _agree(out, refq) > 0.995
    assert _agree(out, fused) > 0.995
    assert (out[..., :3].max(-1) > 0).any()


def test_frame_has_lit_shadowed_and_background(scene):
    g, vol, _, sv_t = scene
    cam = _camera("exterior")
    kw = dict(light_dir=tuple(-c for c in TO_LIGHT), inter_h=256, inter_w=256,
              device="cpu")
    args = (np.asarray(g.origin), float(g.voxel_size), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H)
    vol_t = torch.from_numpy(vol)
    out = ts.render_fast_frame(vol_t, sv_t, *args, **kw).numpy()
    out_nosh = ts.render_fast_frame(vol_t, None, *args, **kw).numpy()
    mx = out[..., :3].max(-1)
    assert (mx > 0.5).any() and (mx == 0).any()
    amb = np.float32(26) * np.float32(1 / 255)
    shadowed = (out[..., :3] == amb).all(-1)
    assert shadowed.any()
    # same visibility with and without the shadow channel
    assert np.array_equal(mx > 0, out_nosh[..., :3].max(-1) > 0)
    assert (out[..., 3] == 1).all()


@pytest.mark.parametrize("name", list(POSES))
def test_unfused_frame_matches_fused(scene, name):
    """render_fast_frame(fused=False), the stage-by-stage route through
    warp_lookup, against the fused kernel's frame and JAX's unfused frame,
    at the bar of tests/test_warp_kernel.py."""
    g, vol, sv_j, sv_t = scene
    cam = _camera(name)
    ld = tuple(-c for c in TO_LIGHT)
    args = (np.asarray(g.origin), float(g.voxel_size), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H)
    kw = dict(light_dir=ld, inter_h=256, inter_w=256, device="cpu")
    vol_t = torch.from_numpy(vol)
    fused = ts.render_fast_frame(vol_t, sv_t, *args, **kw).numpy()
    split = ts.render_fast_frame(vol_t, sv_t, *args, **kw, fused=False)
    assert split.shape == (H, W, 4) and split.dtype == torch.float32
    split = split.numpy()
    splitq = np.round(np.clip(split, 0.0, 1.0) * 255.0) / 255.0
    assert _agree(splitq, fused) > 0.995
    ref = np.asarray(js.render_fast_frame(
        vol, sv_j, g.origin, g.voxel_size, cam.get_pos(), cam.get_view(),
        45.0, W / H, W, H, light_dir=ld, inter_h=256, inter_w=256,
        fused=False))
    assert _agree(split, ref) > 0.995
    assert np.array_equal(split[..., :3].max(-1) > 0,
                          fused[..., :3].max(-1) > 0)


def test_layouts_reused_across_frames(scene):
    g, vol, _, sv_t = scene
    vol_t = torch.from_numpy(vol)
    lay = ts.SweepLayouts(vol_t, sv_t)
    frames = []
    for phi in (0.8, 0.8001):
        cam = Camera(theta=0.5, phi=phi, radius=2.2)
        frames.append(ts.render_fast_frame(
            vol_t, sv_t, np.asarray(g.origin), float(g.voxel_size),
            cam.get_pos(), cam.get_view(), 45.0, W / H, W, H, layouts=lay,
            device="cpu"))
    assert len(lay._cache) == 2     # one volume + one shadow layout
    fresh = ts.render_fast_frame(
        vol_t, sv_t, np.asarray(g.origin), float(g.voxel_size),
        cam.get_pos(), cam.get_view(), 45.0, W / H, W, H, device="cpu")
    assert torch.equal(frames[1], fresh)


def _entry_points():
    from ray_tracing_octrees_tpu_torch.core import cache, grid
    from ray_tracing_octrees_tpu_torch.render import camera
    from ray_tracing_octrees_tpu_torch import bench, convert
    from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
    from ray_tracing_octrees_tpu_torch.models import octree_raytracer
    from ray_tracing_octrees_tpu_torch.render import frustum
    from ray_tracing_octrees_tpu_torch.models import volume_raycaster
    from ray_tracing_octrees_tpu_torch.trace import fast_exact, sweep_exact

    vol = np.zeros((8, 8, 8), np.float32)
    vol[3:5, 3:5, 3:5] = 1
    cam = camera.Camera(theta=0.4, phi=0.8, radius=2.0)
    return {
        "make_sphere_grid": lambda: grid.make_sphere_grid(8),
        "generate_test_volume": lambda: grid.generate_test_volume(4, 4, 4),
        "VoxelGrid.create": lambda: grid.VoxelGrid.create(vol),
        "grid_from_numpy": lambda: convert.grid_from_numpy(vol, (0, 0, 0), 1),
        "load_voxel_grid": lambda: cache.load_voxel_grid("unused.bin"),
        "generate_rays": lambda: camera.generate_rays(
            4, 4, cam.get_pos(), cam.get_view(), 45.0, 1.0),
        "shadow_volume": lambda: ts.shadow_volume(vol, TO_LIGHT),
        "render_fast_frame": lambda: ts.render_fast_frame(
            vol, None, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(),
            cam.get_view(), 45.0, 1.0, 16, 16),
        "sweep_first_hit": lambda: ts.sweep_first_hit(
            vol, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(), cam.get_view(),
            45.0, 1.0, 16, 16),
        "render_fast_exact_frame": lambda: fast_exact.render_fast_exact_frame(
            vol, None, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(),
            cam.get_view(), 45.0, 1.0, 16, 16),
        "fast_exact_first_hit": lambda: fast_exact.fast_exact_first_hit(
            vol, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(), cam.get_view(),
            45.0, 1.0, 16, 16),
        "pyramid_from_numpy": lambda: convert.pyramid_from_numpy(
            [vol.astype(np.uint8)]),
        "render_octree_image": lambda: octree_raytracer.render_octree_image(
            build_pyramid(torch.from_numpy(vol)), (-0.5, -0.5, -0.5), 1 / 8,
            cam.get_pos(), cam.get_view(), 16, 16, 45.0, 1.0),
        "OctreeRayTracer.set_octree": lambda: octree_raytracer.OctreeRayTracer(
        ).set_octree(grid.make_sphere_grid(8, device="cpu")),
        "render_exact_frame": lambda: sweep_exact.render_exact_frame(
            vol, None, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(),
            cam.get_view(), 16, 16, 45.0, 1.0),
        "trace_pixels_sweep_exact": lambda:
            sweep_exact.trace_pixels_sweep_exact(
                vol, None, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(),
                cam.get_view(), 16, 16, 45.0, 1.0),
        "build_shadow_field": lambda: sweep_exact.build_shadow_field(
            vol, (-1.0, -1.0, -1.0), 1 / 8),
        "dilate_occupancy": lambda: ts.dilate_occupancy(vol),
        "sweep_seed": lambda: ts.sweep_seed(
            vol, (-0.5, -0.5, -0.5), 1 / 8, cam.get_pos(), cam.get_view(),
            45.0, 1.0, 16, 16),
        "build_shadow_seed": lambda: ts.build_shadow_seed(vol, TO_LIGHT),
        "frustum_planes": lambda: frustum.frustum_planes(np.eye(4)),
        "visible_cell_mask": lambda: frustum.visible_cell_mask(
            (8, 8, 8), (0, 0, 0), 1.0, np.eye(4), 0.0),
        "bench.run_bench": lambda: bench.run_bench(
            scene="sphere", width=16, height=16, iters=1, dim=8),
        "bench.main": lambda: bench.main(
            ["--scene", "sphere", "--dim", "8", "--out", "record.json"]),
        "VolumeRaycastRenderer.init": lambda:
            volume_raycaster.VolumeRaycastRenderer().init(
                grid.make_sphere_grid(8, device="cpu")),
        "textures_from_numpy": lambda: convert.textures_from_numpy(
            _volume_arrays()),
        "raymarch_volume": lambda: _volume_entry("raymarch_volume"),
        "raymarch_volume_banded": lambda: _volume_entry(
            "raymarch_volume_banded"),
        "prepare_volume_scene": lambda: _volume_entry("prepare_volume_scene"),
        "render_volume_frame": lambda: _volume_entry("render_volume_frame"),
        **{f"tools.{name}.run": _driver_run(name) for name in (
            "exp_onehot_warp", "exp_warp_ablate", "exp_warp_tune",
            "exp_warp_tune2", "exp_warp_kernel", "exp_warp2pass")},
    }


def _volume_arrays():
    """A tiny renderer's textures as numpy (built on the CPU)."""
    from ray_tracing_octrees_tpu_torch import convert
    from ray_tracing_octrees_tpu_torch.core import grid
    from ray_tracing_octrees_tpu_torch.models import volume_raycaster

    r = volume_raycaster.VolumeRaycastRenderer(device="cpu").init(
        grid.make_sphere_grid(8, device="cpu"))
    return convert.textures_to_numpy(r.textures)


def _volume_entry(name):
    """A volume entry point called with no device argument (its inputs
    built on the CPU first, as a caller would with device="cpu")."""
    from ray_tracing_octrees_tpu_torch import convert
    from ray_tracing_octrees_tpu_torch.render import camera
    from ray_tracing_octrees_tpu_torch.trace import raymarch, raymarch_sweep

    tex = convert.textures_from_numpy(_volume_arrays(), device="cpu")
    cam = camera.Camera(theta=0.4, phi=0.8, radius=2.0)
    inv = (np.linalg.inv(cam.get_view()), np.linalg.inv(cam.get_proj(1.0)))
    if name == "prepare_volume_scene":
        return raymarch_sweep.prepare_volume_scene(tex, 1 / 8)
    if name == "render_volume_frame":
        scene = raymarch_sweep.prepare_volume_scene(tex, 1 / 8, device="cpu")
        return raymarch_sweep.render_volume_frame(
            scene, (-0.5, -0.5, -0.5), cam.get_pos(), cam.get_view(), 45.0,
            1.0, 8, 8)
    return getattr(raymarch, name)(tex, cam.get_pos(), *inv, 8, 8,
                                   max_steps=360)


def _driver_run(name):
    """A warp experiment driver's ``run()`` with no device argument."""
    import importlib

    def call():
        return importlib.import_module(
            f"ray_tracing_octrees_tpu_torch.tools.{name}").run()
    return call


@pytest.mark.parametrize("entry", list(_entry_points()))
def test_entry_points_refuse_cpu_without_asking(monkeypatch, entry, tmp_path):
    """With no CUDA device and no device argument an entry point raises:
    it never carries on on the CPU unless the caller asks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    if entry == "load_voxel_grid":
        from ray_tracing_octrees_tpu_torch.core import cache, grid
        cache.save_voxel_grid("unused.bin", grid.make_sphere_grid(
            8, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[entry]()


def test_port_imports_no_jax():
    code = ("import sys; import ray_tracing_octrees_tpu_torch.trace.slab_sweep, "
            "ray_tracing_octrees_tpu_torch.core.cache, "
            "ray_tracing_octrees_tpu_torch.convert, "
            "ray_tracing_octrees_tpu_torch.trace.fmad_check, "
            "ray_tracing_octrees_tpu_torch.trace.fast_exact, "
            "ray_tracing_octrees_tpu_torch.trace.octree_trace, "
            "ray_tracing_octrees_tpu_torch.tools.cases, "
            "ray_tracing_octrees_tpu_torch.tools.exp_warp2pass, "
            "ray_tracing_octrees_tpu_torch.tools.exp_warp_tune2, "
            "ray_tracing_octrees_tpu_torch.tools.exp_warp_ablate, "
            "ray_tracing_octrees_tpu_torch.bench, "
            "ray_tracing_octrees_tpu_torch.config, "
            "ray_tracing_octrees_tpu_torch.models.octree_raytracer, "
            "ray_tracing_octrees_tpu_torch.render.frustum, "
            "ray_tracing_octrees_tpu_torch.trace.sweep_exact, "
            "ray_tracing_octrees_tpu_torch.trace.mesh_grid, "
            "ray_tracing_octrees_tpu_torch.ops.sampling, "
            "ray_tracing_octrees_tpu_torch.ops.precompute, "
            "ray_tracing_octrees_tpu_torch.ops.carve, "
            "ray_tracing_octrees_tpu_torch.trace.raymarch, "
            "ray_tracing_octrees_tpu_torch.trace.raymarch_sweep, "
            "ray_tracing_octrees_tpu_torch.models.volume_raycaster; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'ray_tracing_octrees_tpu' "
            "or m.startswith('ray_tracing_octrees_tpu.')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_static_scan_no_jax_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 8
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top != "jax", f"{f} imports {mod}"
            assert top != "ray_tracing_octrees_tpu", f"{f} imports {mod}"
        text = f.read_text()
        assert "import jax" not in text, f
        assert "ray_tracing_octrees_tpu." not in text.replace(
            "ray_tracing_octrees_tpu_torch", ""), f
