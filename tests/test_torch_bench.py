"""Port vs JAX reference: the bench (``ray_tracing_octrees_tpu_torch/bench.py``).

``run_bench`` runs on the CPU at a small size (the 32^3 sphere, a 64 x 36
headline, one iteration a window, the exact frames at 64 x 36, the first
four ensemble poses) and its record is held against the JAX bench: every
key of the JAX record but ``vs_baseline`` (read from the JAX source, whose
``run_bench`` is not called: it points the compile cache at the tracked
``xla_cache/``), the ensemble's poses (the JAX formula, read from the JAX
source), and the parity line and each ensemble row against the JAX
functions on the same grid, poses and aspect, on the CPU. Mismatch counts
must be equal. The depth RMS agrees within ``RMS_TOL`` voxels: the JAX
rays differ from the port's by an ulp (XLA fuses the ray math into FMAs),
which moves t on grazing faces by up to ~2e-4 world units, 0.0064 voxels
of the 32^3 sphere on one ray; an RMS over thousands of agreed hits moves
by far less (at most 2e-6 voxels on these poses).
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.core.grid import building_center as j_center
from ray_tracing_octrees_tpu.core.octree import build_pyramid as j_pyramid
from ray_tracing_octrees_tpu.render.camera import Camera as JCamera
from ray_tracing_octrees_tpu.render.camera import generate_rays as j_rays
from ray_tracing_octrees_tpu.trace.fast_exact import fast_exact_first_hit
from ray_tracing_octrees_tpu.trace.octree_trace import trace_octree as j_trace
from ray_tracing_octrees_tpu.trace.slab_sweep import sweep_first_hit
from ray_tracing_octrees_tpu_torch import bench

torch.set_num_threads(2)

DIM, W, H = 32, 64, 36
N_POSES = 4
RMS_TOL = 1e-4   # voxels; see the module docstring
JAX_BENCH = Path(__file__).resolve().parents[1] / "ray_tracing_octrees_tpu" \
    / "bench.py"


def _jax_run_bench() -> ast.FunctionDef:
    tree = ast.parse(JAX_BENCH.read_text())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "run_bench")


def _jax_record_keys():
    ret = [n for n in ast.walk(_jax_run_bench())
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(ret) == 1
    return {k.value for k in ret[0].value.keys}


def _jax_poses(n: int):
    """The JAX bench's ensemble poses: its ``poses = [...]`` expression,
    evaluated with ``n_poses = n``."""
    expr = next(n.value for n in ast.walk(_jax_run_bench())
                if isinstance(n, ast.Assign)
                and [getattr(t, "id", None) for t in n.targets] == ["poses"])
    code = compile(ast.Expression(expr), str(JAX_BENCH), "eval")
    return eval(code, {}, {"n_poses": n})


@pytest.fixture(scope="module")
def record():
    return bench.run_bench(scene="sphere", width=W, height=H, iters=1,
                           dim=DIM, exact_res=(W, H), n_poses=N_POSES,
                           device="cpu")


@pytest.fixture(scope="module")
def jax_scene():
    g = j_sphere(DIM)
    vol = (jnp.asarray(g.occ) > 0).astype(jnp.float32)
    extent = float(np.max(np.asarray(g.world_max) - np.asarray(g.world_min)))
    return g, vol, extent, np.asarray(j_center(g)), j_pyramid(g.occ)


def _jax_camera(jax_scene, theta, phi, radius_f):
    _, _, extent, center, _ = jax_scene
    cam = JCamera(theta=theta, phi=phi, radius=radius_f * extent)
    cam.set_target(center)
    return cam


def _jax_first_hit(jax_scene, cam, exact_first: bool):
    """(hit, t, reference kind, reference hit, reference t) of the JAX
    functions at the bench's parity size and the headline's aspect."""
    g, vol, _, _, pyr = jax_scene
    pw, ph = bench.PARITY_RES
    args = (vol, g.origin, g.voxel_size, cam.get_pos(), cam.get_view(), 45.0,
            W / H, pw, ph)
    hit, t, _, _ = sweep_first_hit(*args)
    refo = fast_exact_first_hit(*args) if exact_first else None
    if refo is not None:
        return hit, t, "fast_exact", refo[0], refo[1]
    o, d = j_rays(pw, ph, jnp.asarray(cam.get_pos(), jnp.float32),
                  jnp.asarray(cam.get_view(), jnp.float32), 45.0, W / H)
    ref = j_trace(pyr, o, d, g.origin, g.voxel_size)
    return hit, t, "dda", ref["hit"], ref["t"]


def _jax_parity(hit, t, rh, rt, vs):
    hit, t, rh, rt = (torch.as_tensor(np.array(x)) for x in (hit, t, rh, rt))
    return bench.parity_stats(hit, t, rh, rt, vs)


def test_record_has_the_jax_keys(record):
    keys = _jax_record_keys()
    assert "vs_baseline" in keys and "parity_ensemble" in keys
    assert keys - {"vs_baseline"} <= set(record)
    assert "vs_baseline" not in record
    r2 = record["exact_radius_2"]
    assert r2["path"] == "fast_exact" and r2["radius_f"] == 2.0
    assert r2["frame_ms"] > 0 and r2["stats"]["overflow"] == 0
    assert record["exact_tracer_path"] is None
    assert "not ported" in record["exact_skip_reason"]
    assert record["metric"] == f"raytrace_sphere{DIM}_{H}p_primary+shadow"
    assert record["backend"] == "cpu" and record["unit"] == "Mrays/s"
    assert 0 < record["hit_fraction"] < 1
    assert len(record["frame_ms_windows"]) == 3
    json.dumps(record)


def test_main_prints_one_short_line(record, tmp_path, monkeypatch, capsys):
    """One JSON line of at most 400 characters; the side file holds the
    whole record."""
    seen = {}

    def fake_run_bench(**kw):
        seen.update(kw)
        return record

    monkeypatch.setattr(bench, "run_bench", fake_run_bench)
    out = tmp_path / "deep" / "record.json"
    bench.main(["--out", str(out), "--scene", "sphere", "--dim", "32"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and len(lines[0]) <= bench.MAX_LINE
    short = json.loads(lines[0])
    assert set(short) == {"metric", "value", "unit", "frame_ms", "record"}
    assert short["value"] == record["value"]
    assert Path(short["record"]).resolve() == out.resolve()
    assert json.loads(out.read_text()) == json.loads(json.dumps(record))
    assert seen["dim"] == 32 and seen["scene"] == "sphere"


def test_ensemble_poses_are_the_jax_formula(record):
    assert bench.ensemble_poses(16) == _jax_poses(16)
    rows = record["parity_ensemble"]["poses"]
    assert [(r["theta"], r["phi"], r["radius_f"]) for r in rows] == \
        _jax_poses(N_POSES)
    assert {r["ref"] for r in rows} == {"dda", "fast_exact"}


def test_parity_line_matches_jax(record, jax_scene):
    cam = _jax_camera(jax_scene, 0.9, 0.8, 0.75)
    hit, t, _, rh, rt = _jax_first_hit(jax_scene, cam, exact_first=False)
    want = _jax_parity(hit, t, rh, rt, 1.0 / DIM)
    got = record["parity_vs_exact"]
    assert got["mismatches"] == want["mismatches"] > 0
    assert got["hit_mismatch_frac"] == want["hit_mismatch_frac"]
    assert abs(got["depth_rms_voxels"] - want["depth_rms_voxels"]) <= RMS_TOL


@pytest.mark.parametrize("i", range(N_POSES))
def test_ensemble_row_matches_jax(record, jax_scene, i):
    row = record["parity_ensemble"]["poses"][i]
    cam = _jax_camera(jax_scene, *_jax_poses(N_POSES)[i])
    hit, t, kind, rh, rt = _jax_first_hit(jax_scene, cam, exact_first=True)
    want = _jax_parity(hit, t, rh, rt, 1.0 / DIM)
    assert row["ref"] == kind
    assert row["mismatches"] == want["mismatches"]
    assert abs(row["rms_vox"] - (want["depth_rms_voxels"] or 0.0)) <= RMS_TOL


def test_scene_file_runs_recentred(tmp_path):
    """``--scene PATH`` loads the cache file and recentres it, as the JAX
    bench does; the record names the file."""
    from ray_tracing_octrees_tpu_torch.core import cache, grid

    path = tmp_path / "scene16.bin"
    cache.save_voxel_grid(str(path), grid.make_sphere_grid(16, device="cpu"))
    rec = bench.run_bench(scene=str(path), width=32, height=18, iters=1,
                          exact_res=(32, 18), n_poses=1, device="cpu")
    assert rec["scene"] == "scene16.bin"
    assert rec["metric"] == "raytrace_scene16_18p_primary+shadow"
    assert rec["parity_ensemble"]["n_poses"] == 1
    assert 0 < rec["hit_fraction"] < 1
