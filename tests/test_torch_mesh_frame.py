"""The port's MC mesh frame against the JAX reference, and the
reference's own mesh-tracer tests (``tests/test_mesh_grid.py``) against
the port's exact LBVH oracle on the same rays.

``render_mc_mesh_frame`` must meet the shaded-frame bar of
``tests/test_warp_kernel.py`` (within 1.5/255 on more than 99.5 % of
pixels) with rounds and unresolved equal; measured here it is equal bit
for bit, which the test holds. On the CPU the frame's lookup runs
``warp_lookup``'s plain version; the card's kernel is held against it
in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import mesh_grid as jmg
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.ops import mc_tables
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
    count_mc_triangles, marching_cubes_grid,
)
from ray_tracing_octrees_tpu_torch.trace import lbvh, mesh_grid as tmg

torch.set_num_threads(2)

TO_LIGHT = (0.5, 0.9, 0.4)
LIGHT = tuple(-c for c in TO_LIGHT)


@pytest.mark.parametrize("pose", ["exterior", "interior"])
def test_frame_equals_jax(pose):
    """tests/test_mesh_grid.py's frame pose, and a camera inside the
    grid (the sweep cropped to the forward half-volume)."""
    g = j_sphere(32)
    js = jmg.prepare_mc_scene(g.occ, g.origin, g.voxel_size,
                              to_light=TO_LIGHT)
    ts = tmg.prepare_mc_scene(np.asarray(g.occ), np.asarray(g.origin),
                              float(g.voxel_size), to_light=TO_LIGHT,
                              device="cpu")
    if pose == "exterior":
        cam = Camera(theta=0.7, phi=0.5, radius=1.3)
    else:
        cam = Camera(theta=0.05, phi=3.2, radius=0.05)
        cam.set_target(np.array([0.0, 0.0, -0.3], np.float32))
        assert tmg._scene_sweep_setup(ts, cam.get_pos(), cam.get_view(),
                                      45.0, 1.0)[2][0] < 31
    args = (cam.get_pos(), cam.get_view(), 45.0, 1.0, 128, 128)
    kw = dict(light_dir=LIGHT, inter_h=160, inter_w=160, max_rounds=16,
              tol_texels=0, with_stats=True)
    ji, jst = jmg.render_mc_mesh_frame(js, *args, **kw)
    ti, tst = tmg.render_mc_mesh_frame(ts, *args, device="cpu", **kw)
    ji, ti = np.asarray(ji), ti.numpy()
    assert tst["rounds"] == int(jst["rounds"])
    assert tst["unresolved"] == int(jst["unresolved"])
    d = np.abs(ti - ji).max(-1)
    assert (d <= 1.5 / 255).mean() > 0.995
    np.testing.assert_array_equal(ti, ji)
    hit = (ji[..., :3].max(-1) > 0).mean()
    # from inside the grid the inner shell fills the view
    assert 0.05 < hit < 0.9 if pose == "exterior" else hit > 0.5


# --- the reference's own tests against the port's LBVH oracle -----------

@pytest.fixture(scope="module")
def sphere_scene():
    grid = make_sphere_grid(48, device="cpu")
    verts, _, count = marching_cubes_grid(
        grid, max_triangles=int(count_mc_triangles(grid)), device="cpu")
    tris = verts[: int(count)]
    scene = tmg.prepare_mc_scene(grid.occ, grid.origin, grid.voxel_size,
                                 to_light=TO_LIGHT, device="cpu")
    return grid, tris, scene


def _extent(grid):
    return float((grid.world_max - grid.world_min).max())


def test_case_table_matches_mc_vertices(sphere_scene):
    """Case-table triangles == marching_cubes_grid's (as multisets)."""
    grid, tris, scene = sphere_scene
    table = tmg.case_triangle_table(device="cpu").numpy().reshape(256, 5, 3,
                                                                  3)
    case = scene.case_vol.numpy().astype(np.int32)
    origin = grid.origin.numpy()
    vs = float(grid.voxel_size)
    rebuilt = []
    for cz, cy, cx in zip(*np.nonzero(case)):
        c = case[cz, cy, cx]
        for ti in range(int(mc_tables.TRI_COUNTS[c])):
            cell = np.array([cx, cy, cz], np.float32)[None, :]
            rebuilt.append(origin[None, :] + (cell + table[c, ti]) * vs)
    rebuilt = np.asarray(rebuilt, np.float32)
    tris = tris.numpy()
    assert rebuilt.shape == tris.shape
    key = lambda a: np.sort(
        a.reshape(len(a), -1) @ np.arange(1, 10, dtype=np.float64), axis=0)
    np.testing.assert_allclose(key(rebuilt), key(tris), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("pose", [0, 1, 2])
def test_texel_trace_matches_lbvh_oracle(sphere_scene, pose):
    grid, tris, scene = sphere_scene
    bvh = lbvh.build_lbvh(tris, device="cpu")
    cam = Camera(theta=0.5 + 0.9 * pose, phi=0.3 + 0.25 * pose,
                 radius=1.4 * _extent(grid))
    res = tmg.trace_mc_mesh_texels(
        scene, cam.get_pos(), cam.get_view(), fov_deg=45.0, aspect=1.0,
        inter_h=160, inter_w=160, max_rounds=24, tol_texels=0, device="cpu")
    oracle = lbvh.trace_lbvh(bvh, res["ray_o"], res["ray_d"], max_steps=4096)
    hit = res["hit"].numpy()
    o_hit = oracle["hit"].numpy()
    o_t = oracle["t"].numpy() * np.linalg.norm(res["ray_d"].numpy(), axis=-1)
    assert (hit != o_hit).mean() < 0.005
    both = hit & o_hit
    t = res["t"].numpy()
    np.testing.assert_allclose(t[both], o_t[both], rtol=2e-3)
    assert np.isclose(t[both], o_t[both], rtol=1e-4).mean() > 0.995
    nrm = res["normal"].numpy()[both]
    assert np.allclose(np.linalg.norm(nrm, axis=-1), 1.0, atol=1e-4)
    assert res["unresolved"] == 0


def test_kcells4_packed_window_matches_3x3(sphere_scene):
    """The 2x2 byte-packed single lookup == the 3x3 packed-triple path at
    a |slope| <= 1 pose: hits, t, case and triangle agree."""
    grid, _, scene = sphere_scene
    cam = Camera(theta=0.15, phi=0.1, radius=2.5 * _extent(grid))
    setup = tmg._scene_sweep_setup(scene, cam.get_pos(), cam.get_view(),
                                   45.0, 1.0)
    axis, flip, (S, A, B), case_sw, shadow_sw, scal_np, kc = setup
    assert kc == 4
    outs = {k: tmg._trace_texels(case_sw, shadow_sw, torch.as_tensor(scal_np),
                                 S, A, B, 96, 96, flip, axis, 24, 0,
                                 kcells=k) for k in (4, 9)}
    np.testing.assert_array_equal(outs[4]["hit"].numpy(),
                                  outs[9]["hit"].numpy())
    both = outs[4]["hit"].numpy()
    np.testing.assert_allclose(outs[4]["t"].numpy()[both],
                               outs[9]["t"].numpy()[both], rtol=1e-5)
    same = ((outs[4]["case"] == outs[9]["case"])
            & (outs[4]["tri"] == outs[9]["tri"])).numpy()[both]
    assert same.mean() > 0.999


def test_frame_renders_and_shades(sphere_scene):
    grid, _, scene = sphere_scene
    cam = Camera(theta=0.7, phi=0.5, radius=1.3 * _extent(grid))
    img, stats = tmg.render_mc_mesh_frame(
        scene, cam.get_pos(), cam.get_view(), 45.0, 1.0, 128, 128,
        light_dir=LIGHT, inter_h=160, inter_w=160, max_rounds=16,
        tol_texels=0, with_stats=True, device="cpu")
    img = img.numpy()
    assert img.shape == (128, 128, 4)
    hit_frac = (img[..., :3].max(axis=-1) > 0).mean()
    assert 0.05 < hit_frac < 0.9
    assert np.isfinite(img).all()
    lit = img[..., 0][img[..., 0] > 0]
    assert lit.std() > 0.02
    assert stats["rounds"] >= 1
    assert stats["overflow"] == 0 and stats["syncs"] == stats["rounds"] + 1


def test_shadow_channel_darkens_occluded_side(sphere_scene):
    grid, _, scene = sphere_scene
    cam = Camera(theta=0.7, phi=0.15, radius=1.5 * _extent(grid))
    res = tmg.trace_mc_mesh_texels(
        scene, cam.get_pos(), cam.get_view(), fov_deg=45.0, aspect=1.0,
        inter_h=128, inter_w=128, max_rounds=16, tol_texels=0, device="cpu")
    sh = res["shadow"].numpy()[res["hit"].numpy()]
    assert (sh > 0.5).any()
    assert (sh < 0.5).any()


def test_frame_refuses_a_scene_on_another_device(sphere_scene):
    _, _, scene = sphere_scene
    cam = Camera(theta=0.7, phi=0.5, radius=1.3)
    with pytest.raises(ValueError, match="scene is on"):
        tmg.render_mc_mesh_frame(scene, cam.get_pos(), cam.get_view(), 45.0,
                                 1.0, 16, 16, device="meta")
