"""Port vs JAX reference: the config ladder
(``ray_tracing_octrees_tpu_torch/benchmarks.py`` against the repository
root's ``benchmarks.py``), on the CPU at small sizes (the kernels' plain
versions; no time here is a device time).

- Every row carries the JAX ladder's keys for its config name, read from
  the ``_emit`` calls of the root ``benchmarks.py``.
- Config 1 at its defaults: ``triangles`` and ``octree_nodes`` equal to the
  line JAX's ``benchmarks.config1()`` prints (30 952 and 23 561).
- Config 2 on the 32^3 sphere at 64x64: ``hits`` equal to JAX's
  ``trace_octree`` on the same rays.
- Config 3 without a scene cache prints the JAX ladder's ``skipped`` line;
  on a 24^3 sphere written as a scene cache its triangle count is the
  port's adaptive DC count on the recentred grid.
- Configs 4-6 on the 32^3 sphere at small frames: JAX's keys and scene
  name; config 4's ``triangles`` equal JAX's ``count_mc_triangles``.
- A config that raises makes ``main`` raise; without CUDA ``main`` and the
  configs raise unless given ``device="cpu"``.
"""

import ast
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu_torch import benchmarks

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_keys() -> dict:
    """{config name or f-string prefix: the keys of its ``_emit``} in the
    root ``benchmarks.py``, but for the catch-alls' ``error`` rows (not
    carried over)."""
    with open(os.path.join(ROOT, "benchmarks.py")) as f:
        tree = ast.parse(f.read())
    keys = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and
                getattr(node.func, "id", None) == "_emit"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if "error" in kw:
            continue
        name = kw["config"]
        if isinstance(name, ast.JoinedStr):
            name = name.values[0].value       # the literal prefix
        else:
            name = name.value
        keys.setdefault(name, [k.arg for k in node.keywords])
    return keys


JAX_KEYS = _jax_keys()


def _rows(fn, *args, **kw):
    """(what ``fn`` returned, the JSON lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = fn(*args, **kw)
    return rows, [json.loads(line) for line in buf.getvalue().splitlines()]


def _check_keys(rows, printed):
    assert rows == printed
    for row in rows:
        name = row["config"]
        key = name if name in JAX_KEYS else name.rsplit("_", 1)[0] + "_"
        assert list(row) == JAX_KEYS[key], name
        assert "error" not in row


def test_jax_keys_read():
    assert JAX_KEYS["sphere64_mc"] == ["config", "triangles", "octree_nodes",
                                       "extract_ms", "tris_per_s"]
    assert "calgary_4k_flythrough_" in JAX_KEYS
    assert len(JAX_KEYS) == 10


def test_config1_matches_jax_line():
    import importlib

    jb = importlib.import_module("benchmarks")
    _, (jline,) = _rows(jb.config1)
    rows, printed = _rows(benchmarks.config1, device="cpu")
    _check_keys(rows, printed)
    (row,) = rows
    assert list(row) == list(jline)
    assert row["config"] == jline["config"] == "sphere64_mc"
    assert (row["triangles"], row["octree_nodes"]) == \
        (jline["triangles"], jline["octree_nodes"]) == (30952, 23561)


def test_config2_hits_match_jax_trace():
    import jax.numpy as jnp

    from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu.core.octree import build_pyramid
    from ray_tracing_octrees_tpu.trace.octree_trace import trace_octree
    from ray_tracing_octrees_tpu_torch.render.camera import (
        Camera, generate_rays,
    )

    rows, printed = _rows(benchmarks.config2, n=32, res=64, device="cpu")
    _check_keys(rows, printed)
    (row,) = rows
    cam = Camera(theta=0.4, phi=0.8, radius=2.0)
    o, d = generate_rays(64, 64, cam.get_pos(), cam.get_view(), 45.0, 1.0,
                         device="cpu")
    g = make_sphere_grid(32)
    ref = trace_octree(build_pyramid(g.occ), jnp.asarray(o.numpy()),
                       jnp.asarray(d.numpy()), g.origin, g.voxel_size)
    hits = int(np.asarray(ref["hit"]).sum())
    assert row["rays"] == 64 * 64
    assert row["hits"] == hits and 0 < hits < 64 * 64


def test_config3_skips_without_a_scene_cache():
    rows, printed = _rows(benchmarks.config3, scene_path="", device="cpu")
    assert rows == printed == [{"config": "calgary_adaptive_dc",
                                "skipped": "scene cache missing"}]


def test_config3_on_a_scene_cache(tmp_path):
    from ray_tracing_octrees_tpu_torch.core.cache import save_voxel_grid
    from ray_tracing_octrees_tpu_torch.core.grid import (
        make_sphere_grid, recenter_filled_voxels,
    )
    from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
    from ray_tracing_octrees_tpu_torch.ops.dual_contouring import (
        adaptive_dual_contouring,
    )

    g = make_sphere_grid(24, device="cpu")
    path = str(tmp_path / "sceneCache.bin")
    save_voxel_grid(path, g)
    rows, printed = _rows(benchmarks.config3, scene_path=path, device="cpu")
    _check_keys(rows, printed)
    (row,) = rows
    rg = recenter_filled_voxels(g)
    tree = build_linear_octree(rg.occ, device="cpu")
    _, _, count = adaptive_dual_contouring(rg, tree, device="cpu")
    assert row["triangles"] == int(count) > 0
    assert row["octree_nodes"] == tree.num_nodes


def test_configs_4_to_6_small():
    from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu.ops.marching_cubes import count_mc_triangles

    common = dict(n=32, scene_path="", device="cpu")
    rows4, printed = _rows(benchmarks.config4, size=(64, 36), frames=1,
                           oracle_size=(32, 18), **common)
    _check_keys(rows4, printed)
    rows5, printed = _rows(benchmarks.config5, size=(96, 54), reps=1,
                           **common)
    _check_keys(rows5, printed)
    rows6, printed = _rows(benchmarks.config6, sweep_sizes=((32, 32),),
                           sweep_frames=1, oracle_sizes=((16, 16),),
                           oracle_frames=1, oracle_res=32, **common)
    _check_keys(rows6, printed)
    assert [r["config"] for r in rows4 + rows5 + rows6] == [
        "mc_mesh_grid_trace", "mc_mesh_lbvh_trace_oracle",
        "calgary_4k_flythrough_exterior", "calgary_4k_flythrough_interior",
        "volume_raymarch_sweep", "volume_raymarch_oracle",
        "volume_raymarch_oracle_512"]
    assert {r["scene"] for r in rows4 + rows5 + rows6} == {"sphere128"}
    tris = int(count_mc_triangles(make_sphere_grid(32)))
    assert [r["triangles"] for r in rows4] == [tris, tris]
    assert all(0 < r["hit_fraction"] < 1 for r in rows4)
    assert rows6[-1]["sweep_hit_agreement"] > 0.9


def test_main_raises_when_a_config_raises(monkeypatch):
    def broken(device=None):
        raise RuntimeError("config failed")

    monkeypatch.setattr(benchmarks, "config1", broken)
    with pytest.raises(RuntimeError, match="config failed"):
        _rows(benchmarks.main, ["3", "1"], device="cpu")


def test_main_runs_the_picked_configs():
    """main(["1", "3"]) runs configs 1 and 3 in that order (3 skips or
    extracts, as the repository root holds a scene cache or not)."""
    rows, printed = _rows(benchmarks.main, ["1", "3"], device="cpu")
    assert rows == printed and len(rows) == 2
    _check_keys(rows[:1], printed[:1])
    assert rows[0]["config"] == "sphere64_mc"
    assert rows[1]["config"].startswith("calgary_adaptive_dc")


def test_ladder_needs_a_device_named():
    """Without CUDA the ladder raises unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.main(["1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmarks.config3(scene_path="")
