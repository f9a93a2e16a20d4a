"""Port vs JAX reference: voxel grid, scene cache and camera.

The same numpy inputs go through ``ray_tracing_octrees_tpu`` (JAX, on the
CPU) and ``ray_tracing_octrees_tpu_torch`` (PyTorch, ``device="cpu"``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core import cache as jcache
from ray_tracing_octrees_tpu.core import grid as jgrid
from ray_tracing_octrees_tpu.render import camera as jcamera
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core import cache as tcache
from ray_tracing_octrees_tpu_torch.core import grid as tgrid
from ray_tracing_octrees_tpu_torch.render import camera as tcamera

torch.set_num_threads(2)


@pytest.mark.parametrize("dim", [32, 48])
def test_sphere_grid_bitwise(dim):
    j = jgrid.make_sphere_grid(dim)
    t = tgrid.make_sphere_grid(dim, device="cpu")
    assert t.occ.dtype == torch.uint8 and t.occ.shape == (dim, dim, dim)
    assert np.array_equal(np.asarray(j.occ), t.occ.numpy())
    assert np.array_equal(np.asarray(j.origin), t.origin.numpy())
    assert np.float32(j.voxel_size) == np.float32(t.voxel_size.numpy())


@pytest.mark.parametrize("dims", [(20, 24, 28), (33, 17, 9)])
def test_test_volume_bitwise(dims):
    j = np.asarray(jgrid.generate_test_volume(*dims))
    t = tgrid.generate_test_volume(*dims, device="cpu").numpy()
    assert t.dtype == np.float32 and t.shape == dims[::-1]
    assert np.array_equal(j, t)


def _random_scene(seed):
    rng = np.random.default_rng(seed)
    occ = np.zeros((12, 10, 14), np.uint8)
    occ[3:9, 2:7, 4:12] = rng.random((6, 5, 8)) < 0.4
    origin = rng.normal(size=3).astype(np.float32)
    return occ, origin, np.float32(0.37)


@pytest.mark.parametrize("seed", [0, 1])
def test_recenter_and_building_center(seed):
    occ, origin, vs = _random_scene(seed)
    j = jgrid.VoxelGrid.create(jnp.asarray(occ), origin=origin, voxel_size=vs)
    t = convert.grid_from_numpy(occ, origin, vs, device="cpu")
    assert np.array_equal(jgrid.building_center(j), tgrid.building_center(t))
    jr = jgrid.recenter_filled_voxels(j)
    tr = tgrid.recenter_filled_voxels(t)
    assert np.array_equal(np.asarray(jr.origin), tr.origin.numpy())
    jlo, jhi, jany = jgrid.filled_world_bounds(j)
    tlo, thi, tany = tgrid.filled_world_bounds(t)
    assert jany == tany
    assert np.array_equal(jlo, tlo) and np.array_equal(jhi, thi)


def test_empty_grid_unchanged():
    occ = np.zeros((4, 5, 6), np.uint8)
    t = convert.grid_from_numpy(occ, (1.0, 2.0, 3.0), 0.5, device="cpu")
    assert tgrid.recenter_filled_voxels(t) is t
    assert np.array_equal(tgrid.building_center(t), np.zeros(3, np.float32))


def test_convert_round_trip():
    occ, origin, vs = _random_scene(3)
    t = convert.grid_from_numpy(occ, origin, vs, device="cpu")
    o2, or2, vs2 = convert.grid_to_numpy(t)
    assert np.array_equal(o2, occ) and np.array_equal(or2, origin)
    assert vs2 == vs
    assert t.dims_xyz == (14, 10, 12)
    assert np.allclose(t.world_max.numpy(), origin + np.array([14, 10, 12]) * vs)


def test_cache_jax_writes_port_reads(tmp_path):
    occ, origin, vs = _random_scene(4)
    f = tmp_path / "scene.bin"
    jcache.save_voxel_grid(str(f), jgrid.VoxelGrid.create(
        jnp.asarray(occ), origin=origin, voxel_size=vs))
    t = tcache.load_voxel_grid(str(f), device="cpu")
    assert np.array_equal(t.occ.numpy(), occ)
    assert np.array_equal(t.origin.numpy(), origin)
    assert np.float32(t.voxel_size.numpy()) == vs


def test_cache_port_writes_jax_reads(tmp_path):
    occ, origin, vs = _random_scene(5)
    fj, ft = tmp_path / "j.bin", tmp_path / "t.bin"
    jcache.save_voxel_grid(str(fj), jgrid.VoxelGrid.create(
        jnp.asarray(occ), origin=origin, voxel_size=vs))
    tcache.save_voxel_grid(str(ft), convert.grid_from_numpy(
        occ, origin, vs, device="cpu"))
    assert fj.read_bytes() == ft.read_bytes()
    j = jcache.load_voxel_grid(str(ft))
    assert np.array_equal(np.asarray(j.occ), occ)
    assert np.array_equal(np.asarray(j.origin), origin)


@pytest.mark.parametrize("start,num", [(0, 3), (4, 5), (11, 1)])
def test_cache_partial_load(tmp_path, start, num):
    occ, origin, vs = _random_scene(6)
    f = tmp_path / "scene.bin"
    jcache.save_voxel_grid(str(f), jgrid.VoxelGrid.create(
        jnp.asarray(occ), origin=origin, voxel_size=vs))
    j = jcache.load_voxel_grid_partial(str(f), start, num)
    t = tcache.load_voxel_grid_partial(str(f), start, num, device="cpu")
    assert np.array_equal(t.occ.numpy(), occ[start:start + num])
    assert np.array_equal(np.asarray(j.occ), t.occ.numpy())
    assert np.array_equal(np.asarray(j.origin), t.origin.numpy())


def test_cache_partial_load_out_of_range(tmp_path):
    occ, origin, vs = _random_scene(7)
    f = tmp_path / "scene.bin"
    tcache.save_voxel_grid(str(f), convert.grid_from_numpy(
        occ, origin, vs, device="cpu"))
    with pytest.raises(ValueError):
        tcache.load_voxel_grid_partial(str(f), 10, 5, device="cpu")


POSES = [(0.4, 0.8, 2.0), (-0.9, 4.0, 3.5), (1.2, 2.5, 0.7)]


@pytest.mark.parametrize("pose", POSES)
def test_camera_matrices(pose):
    target = np.array([0.1, -0.2, 0.3], np.float32)
    j = jcamera.Camera(theta=pose[0], phi=pose[1], radius=pose[2])
    j.set_target(target)
    t = tcamera.Camera(theta=pose[0], phi=pose[1], radius=pose[2])
    t.set_target(target)
    assert np.array_equal(j.get_pos(), t.get_pos())
    assert np.array_equal(j.get_view(), t.get_view())
    assert np.array_equal(j.get_proj(16 / 9), t.get_proj(16 / 9))
    assert np.array_equal(j.get_look_dir(), t.get_look_dir())
    for cam in (j, t):
        cam.increment_theta(5.0)
        cam.increment_phi(-3.0)
        cam.increment_r(0.25)
        cam.pan(2.0, -1.0)
    assert np.array_equal(j.get_view(), t.get_view())
    assert j.pose_key(1.5) == t.pose_key(1.5)


@pytest.mark.parametrize("pose", POSES)
def test_generate_rays(pose):
    cam = tcamera.Camera(theta=pose[0], phi=pose[1], radius=pose[2])
    W, H, aspect = 40, 24, 40 / 24
    jo, jd = jcamera.generate_rays(
        W, H, jnp.asarray(cam.get_pos()), jnp.asarray(cam.get_view()), 45.0,
        aspect)
    to, td = tcamera.generate_rays(W, H, cam.get_pos(), cam.get_view(), 45.0,
                                   aspect, device="cpu")
    assert td.shape == (W * H, 3) and to.shape == (W * H, 3)
    # f32 inverse and products in another order: 1e-6 absolute on unit
    # vectors is a few ulps
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
