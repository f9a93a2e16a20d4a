"""The port's MC mesh tracer (trace/mesh_grid.py) against the JAX
reference, on the same scene and poses.

Every input of the consume rounds must equal the reference's bit for
bit: the case table, the dot-constant Moller-Trumbore table, the case
and shadow volumes, their sweep layouts (the shadow one against the
reference's ``_shadow_relayout``), the detection hats (against the
reference's function compiled, as its trace runs it), the packed case
volumes and the candidate bit field. The texel trace then runs the same
rounds: rounds, hist and unresolved equal, and hit, case, triangle,
normal, shadow and the rays equal bit for bit (measured here); t within
rtol 1e-5 (up to 4 ulps measured: the reference's ladder rebuilds |rd|
per stage in another fused form). Each JAX trace compiles anew per pose
(its sweep axis, flip and footprint are static), so each runs once per
module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import mesh_grid as jmg
from ray_tracing_octrees_tpu.trace import slab_sweep as jss
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.trace import mesh_grid as tmg

torch.set_num_threads(2)

TO_LIGHT = (0.5, 0.9, 0.4)
RES = 160
# tests/test_mesh_grid.py's cameras; the second has |slope| <= 1 (the
# 2x2 footprint, kcells 4), the others the 3x3 (kcells 9)
POSES = {0: dict(theta=0.5, phi=0.3, radius=1.4),
         1: dict(theta=1.4, phi=0.55, radius=1.4),
         2: dict(theta=2.3, phi=0.8, radius=1.4)}
KCELLS = {0: 9, 1: 4, 2: 9}


@pytest.fixture(scope="module")
def scenes():
    g = make_sphere_grid(32)
    js = jmg.prepare_mc_scene(g.occ, g.origin, g.voxel_size,
                              to_light=TO_LIGHT)
    ts = tmg.prepare_mc_scene(np.asarray(g.occ), np.asarray(g.origin),
                              float(g.voxel_size), to_light=TO_LIGHT,
                              device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def traces(scenes):
    """(JAX, port) texel traces per pose, each computed once."""
    js, ts = scenes
    out = {}

    def get(pose):
        if pose not in out:
            cam = Camera(**POSES[pose])
            args = (cam.get_pos(), cam.get_view(), 45.0, 1.0, RES, RES)
            jr = jax.tree_util.tree_map(np.asarray, jmg.trace_mc_mesh_texels(
                js, *args, max_rounds=24, tol_texels=0))
            tr = tmg.trace_mc_mesh_texels(ts, *args, max_rounds=24,
                                          tol_texels=0, device="cpu")
            out[pose] = (jr, tr)
        return out[pose]
    return get


def _setups(scenes, pose):
    js, ts = scenes
    cam = Camera(**POSES[pose])
    j = jmg._scene_sweep_setup(js, cam.get_pos(), cam.get_view(), 45.0, 1.0,
                               RES, RES)
    t = tmg._scene_sweep_setup(ts, cam.get_pos(), cam.get_view(), 45.0, 1.0)
    return j, t, RES


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def test_case_tables_equal_jax():
    np.testing.assert_array_equal(
        np.asarray(jmg.case_triangle_table()),
        tmg.case_triangle_table(device="cpu").numpy())
    for axis in range(3):
        np.testing.assert_array_equal(_f32(jmg._mt_const_np(axis)),
                                      tmg._mt_const_np(axis))


def test_prepare_mc_scene_equals_jax(scenes):
    js, ts = scenes
    np.testing.assert_array_equal(np.asarray(js.case_vol),
                                  ts.case_vol.numpy())
    np.testing.assert_array_equal(np.asarray(js.shadow_cell),
                                  ts.shadow_cell.numpy())
    np.testing.assert_array_equal(np.asarray(js.origin), ts.origin)
    assert js.voxel_size == ts.voxel_size


def test_mc_scene_convert_round_trip(scenes):
    js, ts = scenes
    back = convert.mc_scene_from_numpy(js, device="cpu")
    np.testing.assert_array_equal(back.case_vol.numpy(), ts.case_vol.numpy())
    np.testing.assert_array_equal(back.shadow_cell.numpy(),
                                  ts.shadow_cell.numpy())
    arrays = convert.mc_scene_to_numpy(ts)
    assert arrays["voxel_size"] == ts.voxel_size
    np.testing.assert_array_equal(arrays["origin"], ts.origin)


@pytest.mark.parametrize("pose", [0, 1, 2])
def test_sweep_inputs_equal_jax(scenes, pose):
    """Set-up, layouts, hats, packed volumes and candidate bits."""
    j, t, res = _setups(scenes, pose)
    (axis, flip, (S, A, B), case_sw, shadow_sw, scal_np, kc) = j
    assert (axis, bool(flip), (S, A, B), kc) == (t[0], t[1], t[2], t[6])
    assert kc == KCELLS[pose]
    np.testing.assert_array_equal(scal_np, t[5])
    np.testing.assert_array_equal(_f32(case_sw), t[3].float().numpy())
    # the shadow layout against the reference's _shadow_relayout
    js, _ = scenes
    ref_sh = jss._shadow_relayout(js.shadow_cell, axis, bool(flip),
                                  case_sw.shape[0], A, B, crop_lo=0,
                                  s_keep=S)
    np.testing.assert_array_equal(_f32(ref_sh), t[4].float().numpy())
    np.testing.assert_array_equal(_f32(shadow_sw), t[4].float().numpy())

    sp = case_sw.shape[0]
    jh = jax.jit(jmg._build_detect_hats, static_argnums=range(1, 8))(
        jnp.asarray(scal_np), sp, S, A, B, res, res, bool(flip))
    th = tmg._build_detect_hats(torch.as_tensor(scal_np), sp, S, A, B, res,
                                res, bool(flip))
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(_f32(a), b.float().numpy())
    np.testing.assert_array_equal(_f32(jmg._detect_volume(case_sw)),
                                  tmg._detect_volume(t[3]).float().numpy())
    np.testing.assert_array_equal(np.asarray(jmg._build_packed_cases(
        case_sw)), tmg._build_packed_cases(t[3]).numpy())
    np.testing.assert_array_equal(
        np.asarray(jmg._build_packed_cases4(case_sw)).astype(np.int64),
        tmg._build_packed_cases4(t[3]).numpy().astype(np.int64) & 0xFFFFFFFF)
    jb = jmg._sweep_candidates(jmg._detect_volume(case_sw), jh, sp // 32, S,
                               A, B, res, res, bool(flip))
    tb = tmg._sweep_candidates(tmg._detect_volume(t[3]), th, res, res)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    assert tb.any()


@pytest.mark.parametrize("pose", [0, 1, 2])
def test_texel_trace_equals_jax(traces, pose):
    jr, tr = traces(pose)
    assert int(jr["overflow"]) == 0
    assert tr["overflow"] == 0 and tr["blocked"] == 0
    assert tr["rounds"] == int(jr["rounds"])
    assert tr["unresolved"] == int(jr["unresolved"]) == 0
    assert tr["hist"] == [int(v) for v in jr["hist"]]
    assert tr["syncs"] == tr["rounds"] + 1
    for f in ("hit", "case", "tri", "normal", "shadow", "ray_o", "ray_d"):
        np.testing.assert_array_equal(tr[f].numpy(), jr[f], err_msg=f)
    both = jr["hit"]
    assert both.mean() > 0.1
    np.testing.assert_allclose(tr["t"].numpy()[both], jr["t"][both],
                               rtol=1e-5)
    np.testing.assert_allclose(tr["point"].numpy(), jr["point"], rtol=0,
                               atol=1e-5)


def test_texel_trace_round_cap_equals_jax(scenes):
    """A round cap and a tolerance that stop the rounds early: the same
    rounds, unresolved count and hits."""
    js, ts = scenes
    cam = Camera(**POSES[0])
    args = (cam.get_pos(), cam.get_view(), 45.0, 1.0, RES, RES)
    jr = jmg.trace_mc_mesh_texels(js, *args, max_rounds=3, tol_texels=100)
    tr = tmg.trace_mc_mesh_texels(ts, *args, max_rounds=3, tol_texels=100,
                                  device="cpu")
    assert tr["rounds"] == int(jr["rounds"]) == 3
    assert tr["unresolved"] == int(jr["unresolved"]) > 100
    np.testing.assert_array_equal(tr["hit"].numpy(), np.asarray(jr["hit"]))
    np.testing.assert_array_equal(tr["case"].numpy(), np.asarray(jr["case"]))
