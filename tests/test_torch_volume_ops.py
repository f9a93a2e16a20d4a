"""Port vs JAX reference: the volume ops (``ops/sampling.py``,
``ops/precompute.py``, ``ops/carve.py``) and ``VoxelGrid.sample_safe``.

Inputs are made from a seed with numpy and given to both packages on the
CPU. Tolerances, with the largest difference measured on this suite's
inputs:
- ``sample_trilinear``, ``sample_nearest``: 1e-6 (measured 0: bitwise);
- ``sample_lod``, ``sample_lod_nearest_level``: 1e-6 (measured 1.2e-7:
  XLA fuses the lerp between levels into a multiply-add);
- ``build_mip_chain``: 1e-7 a level (measured 6.0e-8);
- ``sobel_gradient``: 1e-5 (measured 0); ``precompute_volume``: 1e-5
  (measured 3.0e-8, on the edge factor);
- ``ambient_occlusion``, ``build_skip_distance``: bitwise;
- ``indirect_lighting`` at radius 3: 1e-5 relative to the largest value
  (measured 8.9e-8);
- ``splat_radiation``: 1e-6 (measured 3.0e-8);
- ``pick_voxel``: equal ``hit``, ``pos`` within 1e-5 (measured equal).
The last ten tests mirror ``tests/test_volume_raycast.py``'s op-level
cases on the port alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.ops import carve as jc
from ray_tracing_octrees_tpu.ops import precompute as jp
from ray_tracing_octrees_tpu.ops import sampling as js
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid, make_sphere_grid
from ray_tracing_octrees_tpu_torch.ops import carve as tc
from ray_tracing_octrees_tpu_torch.ops import precompute as tp
from ray_tracing_octrees_tpu_torch.ops import sampling as ts

torch.set_num_threads(2)

SEED = 453


def _t(a):
    return torch.tensor(np.array(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def sphere():
    """The 32^3 sphere's occupancy, density and a seeded splat's
    radiation (made by the JAX splat, so both sides read the same)."""
    g = j_sphere(32)
    occ = np.asarray(g.occ)
    rng = np.random.default_rng(SEED)
    center = rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    rad = np.asarray(jc.splat_radiation(
        jnp.zeros(occ.shape, jnp.float32), jnp.asarray(center),
        jnp.float32(3.0), g.world_min, g.world_max))
    return g, occ, (occ > 0).astype(np.float32), rad


@pytest.mark.parametrize("channels", [0, 3])
def test_sample_trilinear_matches_jax(channels):
    rng = np.random.default_rng(SEED + channels)
    shape = (12, 10, 9) + ((channels,) if channels else ())
    vol = rng.random(shape, dtype=np.float32)
    uvw = rng.uniform(-0.2, 1.2, (700, 3)).astype(np.float32)
    want = np.asarray(js.sample_trilinear(jnp.asarray(vol), jnp.asarray(uvw)))
    got = ts.sample_trilinear(_t(vol), _t(uvw)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(js.sample_nearest(jnp.asarray(vol), jnp.asarray(uvw)))
    got = ts.sample_nearest(_t(vol), _t(uvw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_build_mip_chain_and_sample_lod_match_jax():
    rng = np.random.default_rng(SEED)
    vol = rng.random((12, 10, 9), dtype=np.float32)
    mj = js.build_mip_chain(jnp.asarray(vol))
    mt = ts.build_mip_chain(_t(vol))
    assert [tuple(m.shape) for m in mt] == [m.shape for m in mj]
    for a, b in zip(mj, mt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)
    uvw = rng.uniform(-0.1, 1.1, (700, 3)).astype(np.float32)
    lod = rng.uniform(-1.0, len(mj) + 1.0, 700).astype(np.float32)
    for jf, tf in ((js.sample_lod, ts.sample_lod),
                   (js.sample_lod_nearest_level,
                    ts.sample_lod_nearest_level)):
        want = np.asarray(jf(mj, jnp.asarray(uvw), jnp.asarray(lod)))
        got = tf(mt, _t(uvw), _t(lod)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sobel_and_precompute_match_jax(sphere):
    _, _, vol, rad = sphere
    grad_j = np.asarray(jp.sobel_gradient(jnp.asarray(vol), jnp.asarray(rad)))
    grad_t = tp.sobel_gradient(_t(vol), _t(rad)).numpy()
    np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=1e-5)
    want = jp.precompute_volume(jnp.asarray(vol), jnp.asarray(rad))
    got = tp.precompute_volume(_t(vol), _t(rad))
    for name, a, b in zip(("grad_mag", "normal", "edge"), want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert (rad > 0.05).sum() > 10       # the splat carves something


def test_ambient_occlusion_and_skip_distance_bitwise(sphere):
    g, occ, _, _ = sphere
    np.testing.assert_array_equal(
        tp.ambient_occlusion(_t(occ)).numpy(),
        np.asarray(jp.ambient_occlusion(jnp.asarray(occ))))
    box = np.zeros((24, 20, 18), np.uint8)
    box[4:9, 2:11, 3:15] = 1
    for o, vs, lo, hi in ((occ, g.voxel_size, g.world_min, g.world_max),
                          (box, 0.5, (-1.0, 0.0, 2.0), (8.0, 10.0, 14.0))):
        want = np.asarray(jp.build_skip_distance(jnp.asarray(o), vs, lo, hi))
        got = tp.build_skip_distance(_t(o), _np(vs), _np(lo), _np(hi))
        np.testing.assert_array_equal(got.numpy(), want)


def test_indirect_lighting_matches_jax(sphere):
    _, _, vol, rad = sphere
    _, normal, _ = jp.precompute_volume(jnp.asarray(vol), jnp.asarray(rad))
    normal = np.asarray(normal)
    args = ((0.5, 0.9, 0.4), (1.0, 0.98, 0.9), 0.2)
    want = np.asarray(jp.indirect_lighting(
        jnp.asarray(vol), jnp.asarray(normal), jnp.asarray(rad), *args,
        radius=3))
    got = tp.indirect_lighting(_t(vol), _t(normal), _t(rad), *args,
                               radius=3).numpy()
    assert want.max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())


def test_splat_radiation_matches_jax(sphere):
    g, occ, _, rad = sphere
    rng = np.random.default_rng(SEED + 1)
    for _ in range(3):
        pos = rng.uniform(-0.45, 0.45, 3).astype(np.float32)
        r = float(rng.uniform(0.5, 8.0))    # past the clamp at 6 too
        want = np.asarray(jc.splat_radiation(
            jnp.asarray(rad), jnp.asarray(pos), jnp.float32(r), g.world_min,
            g.world_max))
        got = tc.splat_radiation(_t(rad), pos, r, _np(g.world_min),
                                 _np(g.world_max)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ray", [
    ((2.0, 0.1, 0.05), (-1.0, 0.0, 0.0)),
    ((0.3, 2.0, 0.2), (-0.1, -1.0, -0.05)),
    ((1.1, 0.9, -1.3), (-0.55, -0.4, 0.7)),
    ((2.0, 5.0, 0.0), (-1.0, 0.0, 0.0)),          # misses the box
])
def test_pick_voxel_matches_jax(sphere, ray):
    g = sphere[0]
    o = np.asarray(ray[0], np.float32)
    d = np.asarray(ray[1], np.float32)
    d = d / np.linalg.norm(d)
    hit_j, pos_j = jc.pick_voxel(g, o, d, g.world_min, g.world_max)
    tg = make_sphere_grid(32, device="cpu")
    hit_t, pos_t = tc.pick_voxel(tg, o, d, tg.world_min, tg.world_max)
    assert bool(hit_t) == bool(hit_j)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-5)


def test_sample_safe_matches_jax(sphere):
    g, occ, _, _ = sphere
    rng = np.random.default_rng(SEED)
    x, y, z = (rng.integers(-3, 36, 500) for _ in range(3))
    tg = make_sphere_grid(32, device="cpu")
    np.testing.assert_array_equal(tg.sample_safe(x, y, z).numpy(),
                                  np.asarray(g.sample_safe(x, y, z)))


# -- mirrors of tests/test_volume_raycast.py's op-level cases ------------

def small_box_grid(dim=16, lo=5, hi=11):
    occ = np.zeros((dim, dim, dim), np.uint8)
    occ[lo:hi, lo:hi, lo:hi] = 1
    return VoxelGrid.create(occ, origin=(-0.5, -0.5, -0.5),
                            voxel_size=1.0 / dim, device="cpu")


def test_trilinear_sampling_basics():
    vol = torch.arange(8, dtype=torch.float32).reshape(2, 2, 2)
    at = lambda u: float(ts.sample_trilinear(vol, torch.tensor([u, u, u])))
    assert np.isclose(at(0.25), 0.0)          # texel (0,0,0)'s centre
    assert np.isclose(at(0.5), np.arange(8).mean())
    assert np.isclose(at(2.0), 7.0)           # clamp to edge


def test_mip_chain():
    mips = ts.build_mip_chain(torch.ones((8, 8, 8)))
    assert [tuple(m.shape) for m in mips] == [(8, 8, 8), (4, 4, 4),
                                              (2, 2, 2), (1, 1, 1)]
    for m in mips:
        np.testing.assert_allclose(m.numpy(), 1.0)


def test_sobel_gradient_points_outward():
    vol = (small_box_grid().occ > 0).float()
    grad = tp.sobel_gradient(vol, torch.zeros_like(vol)).numpy()
    assert grad[8, 8, 11][0] > 0     # just outside the +x face
    assert grad[8, 8, 4][0] < 0      # just outside the -x face
    np.testing.assert_allclose(grad[8, 8, 8], 0.0, atol=1e-6)


def test_precompute_edge_factor_peaks_at_surface():
    vol = (small_box_grid().occ > 0).float()
    _, normal, edge = tp.precompute_volume(vol, torch.zeros_like(vol))
    edge = edge.numpy()
    assert np.isclose(np.linalg.norm(normal.numpy()[8, 8, 11]), 1.0,
                      atol=1e-5)
    assert edge[8, 8, 10] > edge[8, 8, 1] - 1e-6
    assert edge.max() > 0.2


def test_ambient_occlusion_range_and_border():
    ao = tp.ambient_occlusion(small_box_grid().occ).numpy()
    assert ao.min() >= 0.0 and ao.max() <= 0.7 + 1e-6
    assert ao[0].max() == 0.0 and ao[-1].max() == 0.0
    assert np.isclose(ao[8, 8, 8], 0.7, atol=1e-6)


def test_indirect_lighting_receivers_only():
    occ = np.zeros((9, 9, 9), np.float32)
    occ[4, 4, 4] = 1
    vol = _t(occ)
    rad = torch.zeros_like(vol)
    _, normal, _ = tp.precompute_volume(vol, rad)
    np.testing.assert_allclose(normal.numpy()[4, 4, 4], [0, 1, 0],
                               atol=1e-6)
    ind = tp.indirect_lighting(vol, normal, rad, (0.5, 0.9, 0.4),
                               (1.0, 1.0, 1.0), 1.0, radius=3).numpy()
    assert ind[4, 4, 4].max() == 0.0
    assert ind[4, 3, 4].max() > 0.0
    assert ind[4, 5, 4].max() == 0.0
    assert (ind >= 0).all()


def test_bspline_kernel_shape():
    xs = np.linspace(-2, 2, 101)
    v = tc.bspline_1d(torch.tensor(xs, dtype=torch.float32)).numpy()
    assert np.isclose(v[50], 2.0 / 3.0)
    assert (v[np.abs(xs) > 1.6] == 0).all()
    assert v.max() <= 2.0 / 3.0 + 1e-6


def test_splat_accumulates_and_clamps():
    g = small_box_grid()
    rad = torch.zeros((16, 16, 16))
    center = np.zeros(3, np.float32)
    r1 = tc.splat_radiation(rad, center, 2.0, g.world_min, g.world_max)
    assert float(r1.max()) > 0.1
    assert r1[8, 8, 8] == r1.max()
    r2 = tc.splat_radiation(r1, center, 2.0, g.world_min, g.world_max)
    assert np.isclose(float(r2[8, 8, 8]), 2 * float(r1[8, 8, 8]), rtol=1e-5)


def test_pick_voxel_hits_box_face():
    g = small_box_grid()
    hit, pos = tc.pick_voxel(g, np.array([2.0, 0.0, 0.0], np.float32),
                             np.array([-1.0, 0.0, 0.0], np.float32),
                             g.world_min, g.world_max)
    assert bool(hit)
    assert abs(float(pos[0]) - (11 / 16 - 0.5)) < 0.1
    hit2, _ = tc.pick_voxel(g, np.array([2.0, 5.0, 0.0], np.float32),
                            np.array([-1.0, 0.0, 0.0], np.float32),
                            g.world_min, g.world_max)
    assert not bool(hit2)


def test_skip_distance_texture():
    g = small_box_grid()
    skip = tp.build_skip_distance(g.occ, g.voxel_size, g.world_min,
                                  g.world_max).numpy()
    assert skip.shape == (16, 16, 16)
    assert skip.min() >= 0.0 and skip.max() > 0.0
