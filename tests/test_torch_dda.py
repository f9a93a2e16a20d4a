"""Port vs JAX reference: the exact DDA tracer and its model.

Mirrors tests/test_octree_trace.py for the port's ``build_leaf_volume``,
``trace_octree_fast``, the seeds of ``slab_sweep`` (``dilate_occupancy``,
``sweep_seed``, ``light_blocked_volume``), ``cull_pyramid``, the frustum
helpers and ``models/octree_raytracer.py``. Integer work (leaf volume,
dilations, culled pyramids, seed masks) is bitwise against JAX.
``trace_octree_fast(ball_skip=False)`` is bitwise against the port's own
``trace_octree`` in every output, and against JAX's ``trace_octree_fast``
on JAX's own rays in hit, t and steps (point and normal within 1e-5: XLA
fuses ``o + d * t`` into an FMA on the CPU, the port does not). Images
hold the JAX test's bars against the port's plain ``render_octree_image``
and, against JAX's image, equal hit masks with colours within 1e-4: the
port's rays differ from JAX's by an ulp (the same fusion), which moves a
leaf normal by up to ~1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.config import EngineConfig as JEngineConfig
from ray_tracing_octrees_tpu.core.grid import VoxelGrid as JVoxelGrid
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.core import octree as jo
from ray_tracing_octrees_tpu.models import octree_raytracer as jm
from ray_tracing_octrees_tpu.render import frustum as jf
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.render.camera import generate_rays as j_rays
from ray_tracing_octrees_tpu.trace import octree_trace as jt
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu_torch.config import EngineConfig
from ray_tracing_octrees_tpu_torch.core import octree as to
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.models import octree_raytracer as tm
from ray_tracing_octrees_tpu_torch.render import frustum as tf
from ray_tracing_octrees_tpu_torch.trace import octree_trace as tt
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ts

torch.set_num_threads(2)

KEYS = ("hit", "t", "point", "normal", "steps")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _random_occ(seed, dims, p):
    return (np.random.default_rng(seed).random(dims) < p).astype(np.uint8)


def _random_rays(seed, n, origin, dims, vs, spread=1.4, pad=0.3):
    rng = np.random.default_rng(seed)
    o = (origin[None, :] + rng.random((n, 3)) * np.array(
        [dims[2], dims[1], dims[0]]) * vs * spread - pad).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _camera_rays(cam, w, h):
    o, d = j_rays(w, h, jnp.asarray(cam.get_pos(), jnp.float32),
                  jnp.asarray(cam.get_view(), jnp.float32), 45.0, w / h)
    return np.asarray(o), np.asarray(d)


@pytest.fixture(scope="module")
def sphere():
    jg = j_sphere(32)
    occ = np.asarray(jg.occ)
    pyr = to.build_pyramid(torch.from_numpy(occ))
    return dict(jg=jg, occ=occ, pyr=pyr, lv=to.build_leaf_volume(pyr),
                jlv=jo.build_leaf_volume(jo.build_pyramid(jg.occ)),
                origin=np.asarray(jg.origin), vs=float(jg.voxel_size))


# ---------------------------------------------------------------------------
# leaf volume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims, p, cap", [((8, 8, 8), 0.2, 7),
                                          ((6, 9, 5), 0.2, 7),
                                          ((24, 32, 40), 0.05, 7),
                                          ((20, 20, 20), 0.02, 3)])
def test_leaf_volume_bitwise(dims, p, cap):
    occ = _random_occ(1, dims, p)
    ref = jo.build_leaf_volume(jo.build_pyramid(jnp.asarray(occ)),
                               skip_radius_cap=cap)
    got = to.build_leaf_volume(to.build_pyramid(torch.from_numpy(occ)),
                               skip_radius_cap=cap)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_leaf_volume_sphere_and_skip_radius(sphere):
    assert np.array_equal(sphere["lv"].numpy(), np.asarray(sphere["jlv"]))
    code = torch.arange(8)
    assert np.array_equal(to.decode_skip_radius(code).numpy(), np.asarray(
        jo.decode_skip_radius(jnp.arange(8))))


# ---------------------------------------------------------------------------
# trace_octree_fast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(8, 8, 8), (6, 9, 5), (16, 16, 16)])
def test_fast_trace_bitwise(dims):
    """ball_skip=False: every output equals the port's trace_octree, with
    and without the ladder arguments; hit, t and steps equal JAX's."""
    occ = _random_occ(2, dims, 0.12)
    origin = np.array((-1.0, -0.5, -0.25), np.float32)
    vs = 0.21
    o, d = _random_rays(3, 256, origin, dims, vs)
    pyr = to.build_pyramid(torch.from_numpy(occ))
    lv = to.build_leaf_volume(pyr)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    ref = tt.trace_octree(pyr, ot, dt, origin, vs)
    assert ref["hit"].any()
    for kw in ({}, dict(ladder=((4, 128), (6, 32))), dict(
            ladder=((0, 256), (4, 64), (8, 16)), safety_cap=8)):
        got = tt.trace_octree_fast(lv, ot, dt, origin, vs, **kw)
        for k in KEYS:
            assert torch.equal(got[k], ref[k]), (kw, k)
    jres = jt.trace_octree_fast(
        jo.build_leaf_volume(jo.build_pyramid(jnp.asarray(occ))),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(origin), jnp.float32(vs))
    for k in ("hit", "t", "steps"):
        assert np.array_equal(got[k].numpy(), np.asarray(jres[k])), k
    for k in ("point", "normal"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jres[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("max_steps", [1, 3, 9])
def test_fast_trace_step_bound_is_exact(max_steps):
    """Every ray stops once the largest step count reaches max_steps, as
    the reference's lockstep loop does, across the port's compactions."""
    dims = (16, 16, 16)
    occ = _random_occ(4, dims, 0.05)
    origin = np.array((-0.4, -0.6, -0.2), np.float32)
    o, d = _random_rays(5, 512, origin, dims, 0.17, 1.5, 0.4)
    lv = to.build_leaf_volume(to.build_pyramid(torch.from_numpy(occ)))
    got = tt.trace_octree_fast(lv, torch.from_numpy(o), torch.from_numpy(d),
                               origin, 0.17, max_steps=max_steps,
                               ladder=((0, 256), (2, 64)))
    ref = jt.trace_octree_fast(
        jo.build_leaf_volume(jo.build_pyramid(jnp.asarray(occ))),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(origin),
        jnp.float32(0.17), max_steps=max_steps)
    assert int(got["steps"].max()) == max_steps
    for k in ("hit", "t", "steps"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k


def test_fast_trace_ball_skip_on_sphere(sphere):
    """ball_skip=True: the oracle's hits and t (within 1e-5) in fewer
    steps; hit, t and steps equal JAX's ball-skip trace on its rays."""
    o, d = _camera_rays(Camera(theta=0.4, phi=0.8, radius=2.2), 48, 48)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    args = (sphere["origin"], sphere["vs"])
    ref = tt.trace_octree(sphere["pyr"], ot, dt, *args)
    got = tt.trace_octree_fast(sphere["lv"], ot, dt, *args, ball_skip=True)
    assert torch.equal(got["hit"], ref["hit"])
    np.testing.assert_allclose(got["t"].numpy(), ref["t"].numpy(), atol=1e-5)
    assert int(got["steps"].sum()) < int(ref["steps"].sum())
    jres = jt.trace_octree_fast(sphere["jlv"], jnp.asarray(o),
                                jnp.asarray(d), sphere["jg"].origin,
                                sphere["jg"].voxel_size, ball_skip=True)
    for k in ("hit", "t", "steps"):
        assert np.array_equal(got[k].numpy(), np.asarray(jres[k])), k
    # the pinhole bundle's shared origin changes no bit
    const = tt.trace_octree_fast(sphere["lv"], ot, dt, *args, ball_skip=True,
                                 const_origin=True)
    for k in KEYS:
        assert torch.equal(const[k], got[k]), k


@pytest.mark.parametrize("ball", [False, True])
def test_ladder_arguments_change_nothing(ball):
    occ = _random_occ(6, (16, 16, 16), 0.08)
    origin = np.array((-0.4, -0.6, -0.2), np.float32)
    o, d = _random_rays(7, 512, origin, (16, 16, 16), 0.17, 1.5, 0.4)
    lv = to.build_leaf_volume(to.build_pyramid(torch.from_numpy(occ)))
    args = (lv, torch.from_numpy(o), torch.from_numpy(d), origin, 0.17)
    ref = tt.trace_octree_fast(*args, ball_skip=ball)
    for ladder in (((4, 128), (6, 32)), ((2, 8),), ((1, 1), (1, 1)),
                   ((0, 256), (4, 64), (8, 16))):
        got = tt.trace_octree_fast(*args, ball_skip=ball, ladder=ladder,
                                   safety_cap=16)
        for k in KEYS:
            assert torch.equal(got[k], ref[k]), (ladder, k)
    assert ref["compactions"] >= 1 and ref["syncs"] > ref["compactions"]


# ---------------------------------------------------------------------------
# seeds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sparse():
    occ = _random_occ(8, (24, 24, 24), 0.03)
    origin = np.array((-0.5, -0.5, -0.5), np.float32)
    vs = 1 / 24
    lv = to.build_leaf_volume(to.build_pyramid(torch.from_numpy(occ)))
    vol = occ.astype(np.float32)
    return dict(occ=occ, origin=origin, vs=vs, lv=lv,
                dil=ts.dilate_occupancy(vol, 3, device="cpu"),
                jdil=js.dilate_occupancy(jnp.asarray(vol), 3))


def test_dilate_occupancy_bitwise(sparse):
    assert sparse["dil"].dtype == torch.bfloat16
    assert np.array_equal(sparse["dil"].float().numpy(),
                          np.asarray(sparse["jdil"].astype(jnp.float32)))


@pytest.mark.parametrize("pose", [(0.3, 0.7), (0.9, 0.8), (-0.4, 0.2),
                                  (0.05, 1.3)])
def test_seeded_trace_matches_plain(sparse, pose):
    """Sparse isolated voxels, the adversarial case of the resampled
    sweep: the seeds equal JAX's (live masks bitwise; t_seed within
    1e-5, the rays' ulp), are conservative, and the seeded trace equals
    the plain one."""
    cam = Camera(theta=pose[0], phi=pose[1], radius=2.2)
    W = H = 64
    live, t_seed, ext = ts.sweep_seed(
        sparse["dil"], sparse["origin"], sparse["vs"], cam.get_pos(),
        cam.get_view(), 45.0, 1.0, W, H, device="cpu")
    jlive, jt_seed, jext = js.sweep_seed(
        sparse["jdil"], jnp.asarray(sparse["origin"]),
        jnp.float32(sparse["vs"]), jnp.asarray(cam.get_pos(), jnp.float32),
        jnp.asarray(cam.get_view(), jnp.float32), 45.0, 1.0, W, H)
    assert ext and jext
    assert np.array_equal(live.numpy(), np.asarray(jlive))
    np.testing.assert_allclose(t_seed.numpy(), np.asarray(jt_seed), rtol=0,
                               atol=1e-5)
    o, d = _camera_rays(cam, W, H)
    args = (sparse["lv"], torch.from_numpy(o), torch.from_numpy(d),
            sparse["origin"], sparse["vs"])
    ref = tt.trace_octree_fast(*args, ball_skip=True)
    res = tt.trace_octree_fast(*args, ball_skip=True, t_start=t_seed,
                               live_mask=live, const_origin=True)
    rhit = ref["hit"]
    assert bool(live[rhit].all()), "a true hit was marked dead"
    assert bool((t_seed[rhit] <= ref["t"][rhit] + 1e-5).all())
    for k in ("hit", "t", "normal"):
        assert torch.equal(res[k], ref[k]), k


def test_shadow_prune_volume_conservative():
    """light_blocked_volume equals JAX's; a False flag proves the shadow
    ray misses; the pruned frame equals the unpruned one."""
    rng = np.random.default_rng(9)
    occ = np.zeros((48, 48, 48), np.uint8)
    occ[6:10, 6:30, 6:30] = rng.random((4, 24, 24)) < 0.3
    origin = np.array((-0.5, -0.5, -0.5), np.float32)
    vs = 1 / 48
    pyr = to.build_pyramid(torch.from_numpy(occ))
    lv = to.build_leaf_volume(pyr)
    to_light = (0.5, 0.9, 0.4)
    dil = ts.dilate_occupancy(occ.astype(np.float32), device="cpu")
    blk = ts.light_blocked_volume(dil, to_light, doublings=7)
    jblk = js.light_blocked_volume(
        js.dilate_occupancy(jnp.asarray(occ, jnp.float32)), to_light,
        doublings=7)
    assert np.array_equal(blk.numpy(), np.asarray(jblk))
    free = np.argwhere(~blk.numpy())
    assert len(free) > 0
    sel = free[:: max(1, len(free) // 512)]
    origin_p = origin - ts.SEED_DILATION * vs
    centers = (origin_p[None, :] + (sel[:, ::-1] + 0.5) * vs).astype(
        np.float32)
    l = np.asarray(to_light, np.float64)
    d = np.broadcast_to(l / np.linalg.norm(l), centers.shape).astype(
        np.float32)
    res = tt.trace_octree_fast(lv, torch.from_numpy(centers),
                               torch.from_numpy(d.copy()), origin, vs)
    assert not res["hit"].any(), "a flag=False voxel can be occluded"
    cam = Camera(theta=0.5, phi=0.8, radius=2.3)
    args = (pyr, origin, vs, cam.get_pos(), cam.get_view(), 64, 64, 45.0, 1.0)
    kw = dict(shadows=True, leaf_vol=lv, light_dir=tuple(-c for c in to_light),
              device="cpu")
    a = tm.render_octree_image(*args, **kw)
    b = tm.render_octree_image(*args, **kw, shadow_live_vol=blk)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _hits(img):
    return _np(img)[..., :3].max(-1) > 0


def test_model_exact_render_equals_plain_image(sphere):
    """OctreeRayTracer.render(fast=False): the DDA routing equals the plain
    pyramid render_octree_image (hit masks, colours within 1e-6), the
    default sweep-exact routing differs on at most 3 pixels by more than
    1e-4; both against JAX: equal hit masks and colours within 1e-4."""
    g = make_sphere_grid(32, device="cpu")
    cam = Camera(theta=0.3, phi=0.7, radius=2.0)
    ref = tm.render_octree_image(
        to.build_pyramid(g.occ), g.origin, g.voxel_size, cam.get_pos(),
        cam.get_view(), 64, 64, 45.0, 1.0, shadows=True, device="cpu")
    jg = sphere["jg"]
    jref = np.asarray(jm.render_octree_image(
        jo.build_pyramid(jg.occ), jg.origin, jg.voxel_size,
        jnp.asarray(cam.get_pos(), jnp.float32),
        jnp.asarray(cam.get_view(), jnp.float32), 64, 64, jnp.float32(45.0),
        jnp.float32(1.0), shadows=True))
    cfg = EngineConfig()
    cfg_dda = dataclasses.replace(cfg, raytrace=dataclasses.replace(
        cfg.raytrace, use_sweep_exact=False))
    tracer = tm.OctreeRayTracer(config=cfg_dda, device="cpu")
    tracer.set_octree(g)
    img = tracer.render(cam, 64, 64, aspect=1.0, shadows=True)
    assert tracer.last_path == "dda"
    assert np.array_equal(_hits(img), _hits(ref))
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=1e-6)
    jcfg = JEngineConfig()
    jtracer = jm.OctreeRayTracer(config=dataclasses.replace(
        jcfg, raytrace=dataclasses.replace(jcfg.raytrace,
                                           use_sweep_exact=False)))
    jtracer.set_octree(jg)
    jimg = np.asarray(jtracer.render(cam, 64, 64, aspect=1.0, shadows=True))
    assert np.array_equal(_hits(img), _hits(jimg))
    assert np.array_equal(_hits(ref), _hits(jref))
    np.testing.assert_allclose(img.numpy(), jimg, atol=1e-4)

    tracer2 = tm.OctreeRayTracer(config=cfg, device="cpu")
    tracer2.set_octree(g)
    img2 = tracer2.render(cam, 64, 64, aspect=1.0, shadows=True)
    assert tracer2.last_path == "sweep_exact"
    diff = (img2 - ref).abs().amax(-1)
    assert int((diff > 1e-4).sum()) <= 3
    jdiff = np.abs(img2.numpy() - jref).max(-1)
    assert int((jdiff > 1e-4).sum()) <= 3


def test_interior_backward_cone_falls_back_to_exact(sphere):
    """An interior eye whose cone crosses the sweep plane routes
    render(fast=True) to the exact tracers (the half-volume sweep would
    read misses there)."""
    g = make_sphere_grid(32, device="cpu")
    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fov_deg=100.0))
    rt = tm.OctreeRayTracer(config=cfg, device="cpu")
    rt.set_octree(g)
    cam = Camera(theta=0.62, phi=0.62, radius=0.01)
    assert tm._frustum_crosses_sweep_plane(cam.get_view(), 100.0, 1.0)
    assert jm._frustum_crosses_sweep_plane(cam.get_view(), 100.0, 1.0)
    img_fast = rt.render(cam, 32, 32, 1.0, shadows=False, fast=True)
    assert rt.last_path == "dda"
    img_exact = rt.render(cam, 32, 32, 1.0, shadows=False, fast=False)
    np.testing.assert_allclose(img_fast.numpy(), img_exact.numpy(), atol=1e-6)
    assert bool((img_fast[..., :3].amax(-1) > 0).all())
    cam2 = Camera(theta=0.0, phi=0.0, radius=0.01)
    assert not tm._frustum_crosses_sweep_plane(cam2.get_view(), 30.0, 1.0)
    assert tm._eye_inside_volume(g.origin.numpy(), 1 / 32, (32, 32, 32),
                                 cam.get_pos())


def test_render_image_bands_identical(sphere):
    cam = Camera(theta=0.3, phi=0.7, radius=2.0)
    args = (sphere["pyr"], sphere["origin"], sphere["vs"], cam.get_pos(),
            cam.get_view(), 48, 36, 45.0, 48 / 36)
    kw = dict(shadows=True, leaf_vol=sphere["lv"], ball_skip=True,
              device="cpu")
    a = tm.render_octree_image(*args, **kw)
    b = tm.render_octree_image(*args, **kw, bands=5)
    assert torch.equal(a, b)


def test_set_octree_refuses_a_linear_tree():
    rt = tm.OctreeRayTracer(device="cpu")
    g = make_sphere_grid(8, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        rt.set_octree(g, tree=object())


# ---------------------------------------------------------------------------
# frustum culling
# ---------------------------------------------------------------------------

def test_cull_pyramid_and_frustum_equal_jax():
    occ = _random_occ(10, (20, 24, 28), 0.3)
    origin = np.array((-0.5, -0.4, -0.6), np.float32)
    vs = 1 / 24
    cam = Camera(theta=0.4, phi=1.1, radius=0.9)
    cam.set_target(np.array([0.3, 0.1, 0.2], np.float32))
    vp = cam.get_proj(1.3) @ cam.get_view()
    planes = tf.frustum_planes(vp, device="cpu")
    assert np.array_equal(planes.numpy(), np.asarray(jf.frustum_planes(vp)))
    boxes = (np.random.default_rng(11).random((64, 2, 3)) - 0.5) * 4.0
    lo, hi = np.minimum(boxes[:, 0], boxes[:, 1]), np.maximum(boxes[:, 0],
                                                              boxes[:, 1])
    got = tf.test_aabb(planes, lo, hi, 0.05)
    assert np.array_equal(got.numpy(), np.asarray(jf.test_aabb(
        jnp.asarray(planes.numpy()), lo, hi, 0.05)))
    assert set(np.unique(got.numpy())) == {-1, 0, 1}
    m = tf.visible_cell_mask(occ.shape, origin, vs, vp, 0.02, device="cpu")
    jmask = np.asarray(jf.visible_cell_mask(occ.shape, origin, vs, vp, 0.02))
    assert np.array_equal(m.numpy(), jmask) and 0 < jmask.mean() < 1
    culled = tt.cull_pyramid(to.build_pyramid(torch.from_numpy(occ)), origin,
                             vs, vp, 0.02)
    jculled = jt.cull_pyramid(jo.build_pyramid(jnp.asarray(occ)),
                              jnp.asarray(origin), jnp.float32(vs), vp, 0.02)
    assert (jculled.code_levels[0] > 0).sum() < occ.sum()
    for a, b in zip(culled.code_levels, jculled.code_levels):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the tracer keeps the culled pyramid at its config's margin, and its
    # culled frame is JAX's culled frame
    cfg = EngineConfig()
    cfg = dataclasses.replace(cfg, raytrace=dataclasses.replace(
        cfg.raytrace, frustum_margin=0.02, use_sweep_exact=False))
    rt = tm.OctreeRayTracer(config=cfg, device="cpu")
    rt.set_octree(VoxelGrid.create(occ, origin, vs, device="cpu"))
    rt.update_frustum(vp)
    assert all(torch.equal(a, b) for a, b in zip(rt.culled_pyramid.code_levels,
                                                 culled.code_levels))
    jcfg = JEngineConfig()
    jrt = jm.OctreeRayTracer(config=dataclasses.replace(
        jcfg, raytrace=dataclasses.replace(jcfg.raytrace, frustum_margin=0.02,
                                           use_sweep_exact=False)))
    jrt.set_octree(JVoxelGrid.create(occ, origin=tuple(origin), voxel_size=vs))
    jrt.update_frustum(vp)
    img = rt.render(cam, 48, 36, 48 / 36, use_culling=True)
    jimg = np.asarray(jrt.render(cam, 48, 36, 48 / 36, use_culling=True))
    assert np.array_equal(_hits(img), _hits(jimg))
    np.testing.assert_allclose(img.numpy(), jimg, atol=1e-4)
