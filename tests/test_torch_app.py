"""Port vs JAX reference: the application shell (``render/app.py``), the
wireframe (``render/wireframe.py``), PNG output (``render/image.py``),
profiling and logging (``utils/``), the CLI and the demo.

The JAX package's own cases (``tests/test_app.py``) run against the port
on the 16^3 sphere. Then one key, orbit and click sequence runs through
both applications on the 16^3 sphere (shared at module scope): the
schedule (which frames extract, which render, which replay) is equal;
MC and blocks meshes and the wireframe are bitwise JAX's, DC's within
the extraction tests' bars; the extraction frames are held at the
rasterizer's bars, the volume and ray-trace frames at the bars of
``tests/test_torch_raymarch_sweep.py`` and ``tests/test_torch_sweep_exact
.py``. Triangle-cache files cross between the packages, ``load_scene``'s
three branches give JAX's grids on a small seeded city, and ``write_png``
writes JAX's bytes.
"""

import functools
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.config import EngineConfig as JConfig
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.core.octree import build_linear_octree as j_tree
from ray_tracing_octrees_tpu.ingest import voxelize as j_vox
from ray_tracing_octrees_tpu.render import app as japp
from ray_tracing_octrees_tpu.render.camera import Camera as JCamera
from ray_tracing_octrees_tpu.render.image import write_png as j_write_png
from ray_tracing_octrees_tpu.render.wireframe import (
    octree_wireframe as j_wireframe,
)
from ray_tracing_octrees_tpu.utils import profiling as jprof
from ray_tracing_octrees_tpu_torch.config import EngineConfig
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
from ray_tracing_octrees_tpu_torch.ingest.city import write_city_csv
from ray_tracing_octrees_tpu_torch.native import runtime
from ray_tracing_octrees_tpu_torch.render import app as tapp
from ray_tracing_octrees_tpu_torch.render.app import (
    Application, RenderMode, TriangleCache,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.render.image import write_png
from ray_tracing_octrees_tpu_torch.render.wireframe import octree_wireframe
from ray_tracing_octrees_tpu_torch.utils import profiling as tprof
from ray_tracing_octrees_tpu_torch.utils.logging import get_logger

torch.set_num_threads(2)

DIM = 16
W, H = 40, 30
# the 16^3 meshes hold ~2000 triangles: a small extraction capacity keeps
# the CPU run short (the count stays under it, so the meshes are the same)
CAP = 30000
SHADE_TOL, SHADE_SHARE = 1.5 / 255.0, 0.995
DC_TOL = (2e-6, 2e-4)   # vertices, normals (tests/test_torch_dual_contouring)
# One sequence: "f" a frame, "o+" / "o-" an orbit and its undo, "c" a
# click at the image centre, anything else a key. MC extracts, replays
# its mesh, re-extracts on a change; DC writes its cache, reads it back
# at a pose seen before, regenerates on G; the volume frame renders on
# the first frame and every 7th, the ray trace on a change and every 6th.
SEQ = (["f", "f", "o+", "f",
        "R", "f", "o+", "f",
        "R", "f", "f", "o+", "f", "o-", "f", "G", "f",
        "R"] + ["f"] * 6 + ["c", "f", "f", "o+", "f",
        "R", "f", "f", "o+", "f"] + ["f"] * 5 + ["S", "f", "S"])


@pytest.fixture(scope="module")
def port_app():
    a = Application(config=EngineConfig(use_buildings=False, sphere_dim=DIM,
                                        max_triangles=CAP), device="cpu")
    return a.setup(grid=make_sphere_grid(DIM, device="cpu"))


def _run(app, tmp, zbuf_of):
    """Drive ``app`` through SEQ; one record per frame."""
    app.tri_cache.directory = str(tmp)
    recs = []
    for step in SEQ:
        if step in ("o+", "o-"):
            app.orbit(40.0 if step == "o+" else -40.0, 0.0)
            continue
        if step == "c":
            recs.append(("click", app.click(W / 2, H / 2, W, H)))
            continue
        if step != "f":
            app.handle_key(step)
            continue
        calls = {k: s.calls for k, s in app.timer.stats.items()}
        mesh = app._cached_mesh
        out = app.frame(W, H)
        ran = {k for k, s in app.timer.stats.items()
               if s.calls > calls.get(k, 0)}
        recs.append(dict(
            mode=app.mode.name, stages=ran,
            new_mesh=app._cached_mesh is not mesh,
            color=np.asarray(out["color"]),
            mesh=out.get("mesh"), wireframe=out.get("wireframe"),
            depth=out.get("depth"),
            zbuf=zbuf_of(app) if "mesh" in out else None))
    return recs


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """(JAX records, port records) of SEQ, each app on its own cache
    directory."""
    ja = japp.Application(config=JConfig(use_buildings=False,
                                         sphere_dim=DIM, max_triangles=CAP))
    ja.setup(grid=j_sphere(DIM))
    ta = Application(config=EngineConfig(use_buildings=False, sphere_dim=DIM,
                                         max_triangles=CAP), device="cpu")
    ta.setup(grid=make_sphere_grid(DIM, device="cpu"))
    jrec = _run(ja, tmp_path_factory.mktemp("jax_tc"),
                lambda a: np.asarray(a._last_zbuf))
    trec = _run(ta, tmp_path_factory.mktemp("port_tc"),
                lambda a: a._last_zbuf.numpy())
    return jrec, trec


def _frames(recs):
    return [r for r in recs if isinstance(r, dict)]


# -- the JAX package's cases, on the port ----------------------------------

def test_mode_cycle(port_app):
    start = port_app.mode
    names = [start.name]
    for _ in range(5):
        port_app.handle_key("R")
        names.append(port_app.mode.name)
    assert port_app.mode == start
    assert len(set(names)) == 5


def test_extraction_modes_produce_meshes(port_app, tmp_path):
    port_app.mode = RenderMode.MARCHING_CUBES
    out = port_app.frame(32, 32)
    assert out["mesh"]["count"] > 0
    assert out["color"].shape == (32, 32, 4)
    assert isinstance(out["color"], np.ndarray)
    port_app.mode = RenderMode.BLOCKS
    port_app._cached_mesh = None
    out = port_app.frame(32, 32)
    assert out["mesh"]["count"] > 0
    write_png(str(tmp_path / "frame.png"), out["color"])
    assert (tmp_path / "frame.png").stat().st_size > 100


def test_raytrace_mode_schedules_and_caches(port_app):
    port_app.mode = RenderMode.OCTREE_RAYTRACE
    img1 = port_app.frame(24, 24)["color"]
    # no camera change: the next frame replays the cached array itself
    assert port_app.frame(24, 24)["color"] is img1
    # a camera change forces a re-render
    port_app.orbit(40.0, 0.0)
    assert not np.array_equal(port_app.frame(24, 24)["color"], img1)


def test_volume_mode_renders(port_app):
    port_app.mode = RenderMode.VOLUME_RAYCAST
    out = port_app.frame(24, 24)
    assert out["color"].shape == (24, 24, 4)
    assert np.isfinite(out["color"]).all()


def test_wireframe_overlay(port_app):
    port_app.show_octree_wireframe = True
    port_app.mode = RenderMode.MARCHING_CUBES
    try:
        wf = port_app.frame(24, 24)["wireframe"]
    finally:
        port_app.show_octree_wireframe = False
    assert wf["count"] > 0 and wf["count"] % 12 == 0
    assert np.isfinite(wf["segments"][: wf["count"]]).all()


def test_wireframe_counts_match_visible_leaves():
    g = make_sphere_grid(8, device="cpu")
    tree = build_linear_octree(g.occ, device="cpu")
    segs, count = octree_wireframe(tree, g.origin, g.voxel_size, None)
    assert int(count) == 12 * int(tree.is_leaf.sum())


def test_dc_triangle_cache_roundtrip(tmp_path):
    cache = TriangleCache(directory=str(tmp_path / "tc"))
    cam = Camera(theta=0.2, phi=0.3, radius=2.0)
    verts = np.random.default_rng(0).random((10, 3, 3)).astype(np.float32)
    normals = np.random.default_rng(1).random((10, 3)).astype(np.float32)
    cache.save(cam, 1.0, verts, normals, 10)
    v, n, c = cache.load(cam, 1.0)
    assert c == 10
    np.testing.assert_array_equal(v, verts)
    assert cache.load(Camera(theta=0.21, phi=0.3, radius=2.0), 1.0) is None


def test_key_toggles(port_app):
    w0 = port_app.wireframe_fill
    port_app.handle_key("W")
    assert port_app.wireframe_fill != w0
    o0 = port_app.raycaster.enable_octree_skip
    port_app.handle_key("O")
    assert port_app.raycaster.enable_octree_skip != o0
    port_app.handle_key("O")
    port_app.handle_key("C")
    np.testing.assert_allclose(port_app.camera.target,
                               port_app.building_center)


# -- one sequence through both applications ---------------------------------

def test_schedule_matches_jax(sequences):
    """Per frame: the mode, the stages that ran (extraction, ray cast,
    ray trace) and whether the mesh was extracted or loaded anew; and the
    click's result."""
    jrec, trec = sequences
    key = lambda r: ((r["mode"], r["stages"], r["new_mesh"])
                     if isinstance(r, dict) else r)
    assert [key(r) for r in trec] == [key(r) for r in jrec]
    modes = {r["mode"] for r in _frames(trec)}
    assert modes == {m.name for m in RenderMode}
    rendered = [bool(r["stages"]) for r in _frames(trec)
                if r["mode"] == "VOLUME_RAYCAST"]
    assert rendered == [True] + [False] * 5 + [True, False, False]
    assert ("click", True) in trec


def test_sequence_meshes_match_jax(sequences):
    jrec, trec = sequences
    n = 0
    for j, t in zip(_frames(jrec), _frames(trec)):
        if j["mesh"] is None:
            continue
        n += 1
        assert j["mesh"]["count"] == t["mesh"]["count"] > 0
        jv = np.asarray(j["mesh"]["verts"])[: j["mesh"]["count"]]
        jn = np.asarray(j["mesh"]["normals"])[: j["mesh"]["count"]]
        if j["mode"] == "DUAL_CONTOURING":
            np.testing.assert_allclose(t["mesh"]["verts"], jv, rtol=0,
                                       atol=DC_TOL[0])
            np.testing.assert_allclose(t["mesh"]["normals"], jn, rtol=0,
                                       atol=DC_TOL[1])
        else:
            np.testing.assert_array_equal(t["mesh"]["verts"], jv)
            np.testing.assert_array_equal(t["mesh"]["normals"], jn)
    assert n == 10


def test_sequence_extraction_frames_match_jax(sequences):
    """The rasterized frames at the rasterizer's bars. These meshes fit
    one chunk, and JAX's one-chunk program recomputes the screen
    coordinates inside its fused loops and contracts them into
    multiply-adds (unlike its multi-chunk program, which
    ``tests/test_torch_raster.py`` holds bitwise): depth within 1e-5
    here (5.1e-6 measured)."""
    jrec, trec = sequences
    for j, t in zip(_frames(jrec), _frames(trec)):
        if j["mesh"] is None or j["wireframe"] is not None:
            continue
        jc, tc = j["zbuf"] < 2.0, t["zbuf"] < 2.0
        assert (jc == tc).mean() >= 0.999
        both = jc & tc
        np.testing.assert_allclose(t["zbuf"][both], j["zbuf"][both],
                                   rtol=0, atol=1e-5)
        close = np.abs(t["color"] - j["color"]).max(-1) <= SHADE_TOL
        assert close.mean() > SHADE_SHARE
        assert jc.mean() > 0.05


def test_sequence_ray_frames_match_jax(sequences):
    """Volume frames within 1e-4 on all but 0.5% of pixels with equal hit
    masks (depth > 0); ray-trace frames with equal hit masks and within
    1e-4 but for at most 2 pixels."""
    jrec, trec = sequences
    seen = set()
    for j, t in zip(_frames(jrec), _frames(trec)):
        if j["mesh"] is not None or j["wireframe"] is not None:
            continue
        seen.add(j["mode"])
        diff = np.abs(t["color"] - j["color"]).max(-1)
        if j["mode"] == "VOLUME_RAYCAST":
            assert (diff > 1e-4).mean() <= 0.005
            if j["depth"] is not None:
                np.testing.assert_array_equal(t["depth"] > 0,
                                              j["depth"] > 0)
        else:
            np.testing.assert_array_equal(t["color"][..., :3].max(-1) > 0,
                                          j["color"][..., :3].max(-1) > 0)
            assert int((diff > 1e-4).sum()) <= 2
    assert seen == {"VOLUME_RAYCAST", "OCTREE_RAYTRACE"}


def test_sequence_click_changes_the_volume_frame(sequences):
    _, trec = sequences
    vol = [r for r in _frames(trec) if r["mode"] == "VOLUME_RAYCAST"
           and r["stages"]]
    assert not np.array_equal(vol[0]["color"], vol[1]["color"])


def test_sequence_wireframe_matches_jax(sequences):
    jrec, trec = sequences
    pairs = [(j, t) for j, t in zip(_frames(jrec), _frames(trec))
             if j["wireframe"] is not None]
    assert len(pairs) == 1
    (j, t), = pairs
    assert j["wireframe"]["count"] == t["wireframe"]["count"] > 0
    np.testing.assert_array_equal(t["wireframe"]["segments"],
                                  np.asarray(j["wireframe"]["segments"]))
    np.testing.assert_array_equal(t["color"], j["color"])


# -- modules against JAX ------------------------------------------------------

@pytest.mark.parametrize("cull", [None, 50.0, 0.05])
@pytest.mark.parametrize("max_lines", [1 << 20, 600])
def test_wireframe_matches_jax(cull, max_lines):
    """Segments and counts bitwise, the leaf cap (max_lines // 12 leaves
    in node order) included, on a non-dyadic placement."""
    occ = (np.random.default_rng(3).random((9, 11, 7)) < 0.4).astype(
        np.uint8)
    origin = np.array([-3.7, 11.1, 0.9], np.float32)
    vs = np.float32(1.7)
    cam = Camera(theta=0.3, phi=0.5, radius=10.0)
    cam.set_target(np.array([2.0, 20.0, 8.0], np.float32))
    vp = None if cull is None else (cam.get_proj(1.3)
                                    @ cam.get_view()).astype(np.float32)
    margin = 50.0 if cull is None else cull
    js, jc = j_wireframe(j_tree(jnp.asarray(occ)), jnp.asarray(origin),
                         jnp.asarray(vs),
                         None if vp is None else jnp.asarray(vp), margin,
                         max_lines)
    ts, tc = octree_wireframe(build_linear_octree(torch.from_numpy(occ),
                                                  device="cpu"),
                              origin, vs, vp, margin, max_lines)
    assert int(tc) == int(jc) > 0
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if max_lines == 600:
        assert int(tc) == 12 * (600 // 12)


def test_triangle_cache_crosses_packages(tmp_path):
    """A file written by one package loads in the other, under the same
    name (pose_key)."""
    rng = np.random.default_rng(7)
    verts = rng.random((25, 3, 3)).astype(np.float32)
    normals = rng.random((25, 3)).astype(np.float32)
    pose = dict(theta=0.37, phi=1.2, radius=2.5)
    jcam, tcam = JCamera(**pose), Camera(**pose)
    for aspect in (1.0, 16 / 9):
        assert tcam.pose_key(aspect) == jcam.pose_key(aspect)
    jcache = japp.TriangleCache(directory=str(tmp_path / "j"))
    tcache = TriangleCache(directory=str(tmp_path / "t"))
    jcache.save(jcam, 16 / 9, verts, normals, 25)
    tcache.save(tcam, 16 / 9, verts, normals, 25)
    jname = jcache.filename(jcam, 16 / 9)
    tname = tcache.filename(tcam, 16 / 9)
    assert os.path.basename(jname) == os.path.basename(tname)
    with open(jname, "rb") as a, open(tname, "rb") as b:
        assert a.read() == b.read()
    v, n, c = TriangleCache(directory=str(tmp_path / "j")).load(tcam, 16 / 9)
    assert c == 25
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(n, normals)
    v, n, c = japp.TriangleCache(directory=str(tmp_path / "t")).load(
        jcam, 16 / 9)
    np.testing.assert_array_equal(v, verts)


def _same_grid(jg, tg):
    np.testing.assert_array_equal(tg.occ.numpy(), np.asarray(jg.occ))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert float(tg.voxel_size) == float(jg.voxel_size)


def test_load_scene_branches_match_jax(tmp_path, monkeypatch):
    """CSV (written, then cached), cache and sphere, on a 60-building
    seeded city. The JAX package runs its numpy voxelizer here: its
    OpenMP library rounds in f32 and differs from its own numpy form on
    voxel centres that lie on faces' diagonals, and the port follows the
    numpy form."""
    os.makedirs(tmp_path / "DT")
    write_city_csv(str(tmp_path / "DT"), n=60)
    monkeypatch.setattr(j_vox, "load_csv_into_voxel_grid", functools.partial(
        j_vox.load_csv_into_voxel_grid, use_native=False))
    dirs = (str(tmp_path),)
    jcfg = JConfig(cache_filename=str(tmp_path / "j.bin"))
    tcfg = EngineConfig(cache_filename=str(tmp_path / "t.bin"))
    jg = japp.load_scene(jcfg, search_dirs=dirs)
    tg = tapp.load_scene(tcfg, search_dirs=dirs, device="cpu")
    _same_grid(jg, tg)
    assert tg.occ.shape[1] > 50
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "t.bin").read_bytes()
    # the second call loads the cache it wrote
    _same_grid(jg, tapp.load_scene(tcfg, search_dirs=dirs, device="cpu"))
    _same_grid(japp.load_scene(jcfg, search_dirs=dirs),
               tapp.load_scene(tcfg, search_dirs=dirs, device="cpu"))
    # no data: the sphere, whether buildings were asked for or not
    for use in (True, False):
        kw = dict(use_buildings=use, sphere_dim=DIM,
                  cache_filename=str(tmp_path / "none.bin"))
        _same_grid(japp.load_scene(JConfig(**kw),
                                   search_dirs=(str(tmp_path / "DT"),)),
                   tapp.load_scene(EngineConfig(**kw),
                                   search_dirs=(str(tmp_path / "DT"),),
                                   device="cpu"))


def test_load_scene_raises_when_native_cannot_build(tmp_path, monkeypatch):
    """A native library that cannot be built raises; the sphere does not
    stand in for CSV data that is there."""
    os.makedirs(tmp_path / "DT")
    write_city_csv(str(tmp_path / "DT"), n=5)
    monkeypatch.setattr(runtime, "CXX_CANDIDATES",
                        (str(tmp_path / "missing" / "g++"),))
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    cfg = EngineConfig(cache_filename=str(tmp_path / "t.bin"))
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        tapp.load_scene(cfg, search_dirs=(str(tmp_path),), device="cpu")
    assert not (tmp_path / "t.bin").exists()


def test_entry_points_need_a_device_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Application(config=EngineConfig(use_buildings=False,
                                        sphere_dim=8)).setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.load_scene(EngineConfig(use_buildings=False, sphere_dim=8))


def _png_pixels(path):
    """(width, height, RGBA rows) of an 8-bit RGBA PNG, read back with
    zlib."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return w, h, raw


@pytest.mark.parametrize("kind", ["f32 rgba", "f32 rgb", "u8 rgba", "gray",
                                  "tensor"])
def test_write_png_bytes_match_jax(tmp_path, kind):
    rng = np.random.default_rng(9)
    img = rng.uniform(-0.2, 1.2, (13, 17, 4)).astype(np.float32)
    if kind == "f32 rgb":
        img = img[..., :3]
    elif kind == "u8 rgba":
        img = (img.clip(0, 1) * 255).astype(np.uint8)
    elif kind == "gray":
        img = img[..., 0]
    j_write_png(str(tmp_path / "j.png"), img)
    write_png(str(tmp_path / "t.png"), torch.from_numpy(img)
              if kind == "tensor" else img)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()
    w, h, raw = _png_pixels(str(tmp_path / "t.png"))
    assert (w, h) == (17, 13)


def test_cli_writes_pngs(tmp_path):
    out = tmp_path / "frames"
    tapp.main(["--mode", "VOLUME_RAYCAST", "--frames", "2", "--width", "32",
               "--height", "24", "--out", str(out), "--device", "cpu",
               "--set", "use_buildings=false", "--set", f"sphere_dim={DIM}",
               "--set", f"max_triangles={CAP}"])
    names = sorted(os.listdir(out))
    assert names == ["volume_raycast_000.png", "volume_raycast_001.png"]
    for n in names:
        w, h, raw = _png_pixels(str(out / n))
        assert (w, h) == (32, 24) and len(raw) == 24 * (1 + 32 * 4)


def test_demo_writes_its_frames(tmp_path):
    from ray_tracing_octrees_tpu_torch.examples import render_demo

    paths = render_demo.main(str(tmp_path / "demo"), device="cpu",
                             width=48, height=27,
                             config=EngineConfig(use_buildings=False,
                                                 sphere_dim=DIM,
                                                 max_triangles=CAP))
    assert [os.path.basename(p) for p in paths] == list(render_demo.FRAMES)
    for p in paths:
        w, h, _ = _png_pixels(p)
        assert (w, h) == (48, 27)


def test_stage_timer_and_profiler_behave_as_jax(monkeypatch):
    """The same stages give the same counts, items and report lines (the
    clock made equal); the FPS counter reports once a second."""
    reports = []
    for mod in (jprof, tprof):
        clock = iter(np.arange(0.0, 100.0, 0.25))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(
            next(clock)))
        timer = mod.StageTimer()
        for name, items in (("raytrace", 2.0e6), ("extract/mc", 0.0),
                            ("raytrace", 2.0e6)):
            with timer.stage(name, items=items):
                pass
        with timer.stage("sync", sync=torch.zeros(3) if mod is tprof
                         else jnp.zeros(3)):
            pass
        logged = []
        prof = mod.FrameProfiler(log=logged.append)
        fps = [prof.tick("MARCHING_CUBES") for _ in range(8)]
        reports.append((timer.report(), {k: (s.calls, s.items) for k, s in
                                         timer.stats.items()}, fps, logged))
    assert reports[0] == reports[1]
    assert "raytrace: 250.00 ms x2  8.00 M/s" in reports[1][0]
    assert reports[1][3] == ["FPS: 4.0  mode: MARCHING_CUBES"] * 2


def test_logger_level_and_format(monkeypatch, capsys):
    monkeypatch.setenv("RTO_LOG_LEVEL", "warning")
    log = get_logger("rto-test-port-logger")
    assert log.level == 30 and not log.propagate
    log.info("hidden")
    log.warning("shown %d", 3)
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "[WARNING] rto-test-port-logger: shown 3" in err
