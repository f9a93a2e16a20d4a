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


def _ray_one_pixel(px, py, W, H, aspect, tan_half, rot):
    """generate_rays' ray for pixel (px, py) alone, in numpy f32 scalars:
    every op one IEEE f32 op (roots and multiply-adds through f64, each
    rounded once)."""
    f = np.float32
    root = lambda v: f(np.sqrt(np.float64(v)))
    fma = lambda a, b, c: f(np.float64(a) * np.float64(b) + np.float64(c))
    nx = (f(f(f(px) + f(0.5)) / f(W)) * f(2.0) - f(1.0)) * f(aspect) * tan_half
    ny = (f(1.0) - f(f(py) + f(0.5)) / f(H) * f(2.0)) * tan_half
    n1 = root(fma(ny, ny, nx * nx) + f(1.0))
    dv = (nx / n1, ny / n1, f(-1.0) / n1)
    dw = [fma(dv[2], rot[c, 2], fma(dv[1], rot[c, 1], dv[0] * rot[c, 0]))
          for c in range(3)]
    n2 = root(fma(dw[2], dw[2], fma(dw[1], dw[1], dw[0] * dw[0])))
    return np.array([c / n2 for c in dw], np.float32)


@pytest.mark.parametrize("pose", POSES)
def test_generate_rays_one_pixel_at_a_time(pose):
    """A pixel's ray does not depend on the batch it is computed in: the
    frame's rays equal each pixel's computed alone in numpy f32 scalars,
    bit for bit, under one thread or several. Every op is elementwise f32
    with the view constants from the host, so the card gives these bits
    too. The rotation is the reference's f32 inverse, bit for bit."""
    cam = tcamera.Camera(theta=pose[0], phi=pose[1], radius=pose[2])
    W, H, aspect = 40, 24, 40 / 24
    _, td = tcamera.generate_rays(W, H, cam.get_pos(), cam.get_view(), 45.0,
                                  aspect, device="cpu")
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        _, td1 = tcamera.generate_rays(W, H, cam.get_pos(), cam.get_view(),
                                       45.0, aspect, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(td, td1)
    tan_half, rot = tcamera.view_rotation(45.0, cam.get_view())
    np.testing.assert_array_equal(
        rot, np.asarray(jnp.linalg.inv(jnp.asarray(cam.get_view())))[:3, :3])
    pix = np.random.default_rng(7).choice(W * H, 96, replace=False)
    want = np.stack([_ray_one_pixel(i % W, i // W, W, H, aspect, tan_half,
                                    rot) for i in pix])
    np.testing.assert_array_equal(td.numpy()[pix], want)


def test_lu_inverse_is_jax_inverse():
    """warp_kernel.lu_inverse on 400 seeded views (any elevation, azimuth,
    radius, some with a moved target): the rotation block bitwise the
    JAX package's f32 jnp.linalg.inv on the CPU, where numpy's f32
    inverse differs in the last bit on some entries."""
    from ray_tracing_octrees_tpu_torch.trace.warp_kernel import lu_inverse

    rng = np.random.default_rng(11)
    numpy_off = 0
    for i in range(400):
        cam = tcamera.Camera(theta=rng.uniform(-1.57, 1.57),
                             phi=rng.uniform(-7.0, 7.0),
                             radius=rng.uniform(0.01, 100.0))
        if i % 2:
            cam.set_target(rng.normal(size=3) * rng.uniform(0.0, 50.0))
        view = cam.get_view()
        want = np.asarray(jnp.linalg.inv(jnp.asarray(view)))[:3, :3]
        np.testing.assert_array_equal(lu_inverse(view)[:3, :3], want)
        numpy_off += int((np.linalg.inv(view)[:3, :3] != want).sum())
    assert numpy_off > 0
