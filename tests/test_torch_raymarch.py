"""Port vs JAX reference: the per-ray volume oracle (``trace/raymarch.py``)
and the renderer (``models/volume_raycaster.py``).

Both packages march the same textures (the JAX renderer's, carried over
by ``convert.textures_from_numpy``) on the CPU, at the JAX tests' pose:
the 32^3 sphere, 96 x 96, ``Camera(theta=0.5, phi=0.8, radius=2.2)``,
the camera inverted in float64.

Bars, with what this suite measured:
- hit masks (alpha >= 0.1) agree on >= 99.5% of pixels (measured 100%);
- on pixels where both hit, colour within 2/255 on >= 99% of them
  (measured 100%, largest difference 0.0037);
- both loops run the same iterations (measured 451 and 451);
- ``steps`` equal on >= 95% of rays (measured 95.88%) and within 5 of
  JAX's on >= 99% (measured 99.88%; the largest difference is 175).
  The march is the reference's program, but the step sizes of ~300
  steps through empty space round differently: XLA's CPU compile fuses
  products into multiply-adds and its ``sin`` rounds otherwise than
  PyTorch's, and a threshold that an ulp flips moves every later step
  (the port fuses only where ``fract`` amplifies the last bit: the noise
  hashes and the rays);
- ``_working_volume``: bitwise;
- ``update_octree_skip``'s ``octree_skip_t``: within 1e-5 (measured
  3.6e-8).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.models import volume_raycaster as jvr
from ray_tracing_octrees_tpu.trace import raymarch as jrm
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid, make_sphere_grid
from ray_tracing_octrees_tpu_torch.models import volume_raycaster as tvr
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import raymarch as trm

torch.set_num_threads(2)

W = H = 96
POSE = dict(theta=0.5, phi=0.8, radius=2.2)


def _inverses(cam, aspect):
    """inv(view), inv(proj) in float64, rounded to f32."""
    return (np.linalg.inv(np.asarray(cam.get_view(), np.float64))
            .astype(np.float32),
            np.linalg.inv(np.asarray(cam.get_proj(aspect), np.float64))
            .astype(np.float32))


@pytest.fixture(scope="module")
def scene():
    g = j_sphere(32)
    jr = jvr.VolumeRaycastRenderer().init(g)
    return g, jr, convert.textures_from_numpy(jr.textures, device="cpu")


@pytest.fixture(scope="module")
def oracle_pair(scene):
    _, jr, tex = scene
    cam = Camera(**POSE)
    iv, ip = _inverses(cam, W / H)
    ref = jrm.raymarch_volume(jr.textures, jnp.asarray(cam.get_pos()),
                              jnp.asarray(iv), jnp.asarray(ip), W, H,
                              max_steps=800)
    out = trm.raymarch_volume(tex, cam.get_pos(), iv, ip, W, H,
                              max_steps=800, device="cpu")
    return out, {k: np.asarray(v) for k, v in ref.items()}


def test_raymarch_volume_matches_jax(oracle_pair):
    out, ref = oracle_pair
    hit_t = out["alpha"].numpy() >= 0.1
    hit_j = ref["alpha"] >= 0.1
    assert (hit_t == hit_j).mean() >= 0.995
    assert 0.1 < hit_j.mean() < 0.5
    both = hit_t & hit_j
    diff = np.abs(out["color"].numpy() - ref["color"])[..., :3].max(-1)
    assert (diff[both] <= 2 / 255).mean() >= 0.99
    assert out["iters"] == int(ref["iters"])
    steps_t, steps_j = out["steps"].numpy(), ref["steps"]
    assert (steps_t == steps_j).mean() >= 0.95
    assert (np.abs(steps_t - steps_j) <= 5).mean() >= 0.99
    assert np.isfinite(out["color"].numpy()).all()
    for k in ("depth", "t_near", "t_far"):
        assert out[k].shape == ref[k].shape


def test_banded_equals_monolithic(scene):
    """raymarch_volume_banded over 32-row bands equals the whole frame bit
    for bit (mirrors tests/test_raymarch_sweep.py:182-205)."""
    _, _, tex = scene
    cam = Camera(**POSE)
    iv, ip = _inverses(cam, W / H)
    args = (tex, cam.get_pos(), iv, ip, W, H)
    a = trm.raymarch_volume(*args, max_steps=400, device="cpu")
    b = trm.raymarch_volume_banded(*args, band_rows=32, max_steps=400,
                                   device="cpu")
    for k in ("color", "depth", "normal", "alpha", "t_final", "steps"):
        assert torch.equal(a[k], b[k]), k
    assert b["iters"] <= a["iters"]


def test_full_frame_renders():
    r = tvr.VolumeRaycastRenderer(device="cpu").init(
        make_sphere_grid(32, device="cpu"))
    out = r.draw(Camera(theta=0.4, phi=0.8, radius=2.0), 48, 48, 1.0)
    img = out["color"].numpy()
    assert img.shape == (48, 48, 4) and np.isfinite(img).all()
    assert img[24, 24, :3].max() > 0.01
    assert img[0, 0, :3].max() < 0.02
    d = out["depth"].numpy()
    assert np.isfinite(d).all() and (d >= 0).all()
    assert float(out["alpha"][24, 24]) > 0.9


def _small_box_grid(dim=16, lo=5, hi=11):
    occ = np.zeros((dim, dim, dim), np.uint8)
    occ[lo:hi, lo:hi, lo:hi] = 1
    return VoxelGrid.create(occ, origin=(-0.5, -0.5, -0.5),
                            voxel_size=1.0 / dim, device="cpu")


def test_carving_changes_render():
    r = tvr.VolumeRaycastRenderer(device="cpu").init(_small_box_grid())
    cam = Camera(theta=0.0, phi=0.0, radius=2.0)
    img0 = r.draw(cam, 32, 32, 1.0)["color"]
    r.add_splat(np.array([0.0, 0.0, 11 / 16 - 0.5], np.float32), radius=3.0)
    r.dispatch_radiation()
    assert r.precompute_needed
    img1 = r.draw(cam, 32, 32, 1.0)["color"]
    assert not r.precompute_needed
    assert not torch.allclose(img0, img1)


def test_frustum_culling_blanks_out_of_view():
    r = tvr.VolumeRaycastRenderer(device="cpu").init(_small_box_grid())
    r.use_frustum_culling = True
    tex0 = r.textures
    r.update_frustum_culling(Camera(theta=0.0, phi=0.0, radius=2.0), 1.0)
    assert r.textures is not tex0        # a change makes new textures
    assert float(r.textures.working.max()) == 1.0


@pytest.mark.parametrize("pose", [dict(theta=0.0, phi=0.0, radius=2.0),
                                  dict(theta=0.5, phi=0.8, radius=0.9),
                                  dict(theta=-0.3, phi=2.6, radius=0.6)])
def test_working_volume_matches_jax(scene, pose):
    g = scene[0]
    cam = Camera(**pose)
    proj = jvr.perspective(42.0, 1.3, 0.01, 5000.0)
    vp = (proj @ cam.get_view()).astype(np.float32)
    want = np.asarray(jvr._working_volume(g.occ, g.origin, g.voxel_size,
                                          jnp.asarray(vp), jnp.float32(20.0)))
    got = tvr._working_volume(torch.tensor(np.asarray(g.occ)),
                              np.asarray(g.origin), np.asarray(g.voxel_size),
                              vp, 20.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() <= (np.asarray(g.occ) > 0).sum()


def test_update_octree_skip_matches_jax(scene):
    g, jr, _ = scene
    jr = dataclasses.replace(jr)
    r = tvr.VolumeRaycastRenderer(device="cpu").init(
        make_sphere_grid(32, device="cpu"))
    for pose in (POSE, dict(theta=0.3, phi=2.0, radius=1.4)):
        cam = Camera(**pose)
        jr.update_octree_skip(cam, 1.0)
        r.update_octree_skip(cam, 1.0)
        assert jr.octree_skip_t > 0.0
        assert abs(r.octree_skip_t - jr.octree_skip_t) <= 1e-5


@pytest.mark.parametrize("radius", [2.0, 0.6])
def test_octree_exact_working_volume_matches_oracle(radius):
    """The port's _working_volume_octree keeps the voxels under visible
    SOLID leaves (markVisibleNodesOnly + updateWorkingVolumeWithVisibility),
    checked against a per-node numpy box fill (the JAX test's oracle), at
    the JAX test's pose (everything visible) and nearer (part culled)."""
    from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
    from ray_tracing_octrees_tpu_torch.render.frustum import visible_node_mask

    g = make_sphere_grid(32, device="cpu")
    tree = build_linear_octree(g.occ, device="cpu")
    cam = Camera(theta=0.5, phi=0.8, radius=radius)
    vp = (cam.get_proj(1.0) @ cam.get_view()).astype(np.float32)
    out = tvr._working_volume_octree(g.occ, tree, g.origin, g.voxel_size,
                                     vp, 0.05).numpy()
    vis = visible_node_mask(tree, g.origin, g.voxel_size, vp, 0.05)
    keep = (vis & tree.is_leaf & tree.is_solid).numpy()
    x, y, z, sz = (t.numpy() for t in (tree.x, tree.y, tree.z, tree.size))
    occ = g.occ.numpy()
    ref_mask = np.zeros(occ.shape, bool)
    for i in np.nonzero(keep)[0]:
        ref_mask[z[i]:z[i] + sz[i], y[i]:y[i] + sz[i], x[i]:x[i] + sz[i]] = True
    np.testing.assert_array_equal(
        out, np.where(ref_mask, (occ > 0).astype(np.float32), 0.0))
    assert 0 < out.sum() <= (occ > 0).sum()
    assert (out.sum() < (occ > 0).sum()) == (radius < 1)


@pytest.mark.parametrize("pose", [dict(theta=0.5, phi=0.8, radius=2.0),
                                  dict(theta=0.5, phi=0.8, radius=0.6),
                                  dict(theta=-0.3, phi=2.6, radius=0.4)])
def test_working_volume_octree_matches_jax(scene, pose):
    """_working_volume_octree bitwise against JAX's, and
    update_frustum_culling(tree=...) on both renderers (margin 20: every
    node of the 32^3 sphere stays, so the pose's own test is the margin
    0.05 one)."""
    from ray_tracing_octrees_tpu.core.octree import build_linear_octree as jb

    g, jr, _ = scene
    jtree = jb(g.occ)
    ttree = convert.linear_octree_from_numpy(jtree, device="cpu")
    cam = Camera(**pose)
    vp = (cam.get_proj(1.0) @ cam.get_view()).astype(np.float32)
    occ = torch.tensor(np.asarray(g.occ))
    want = np.asarray(jvr._working_volume_octree(
        g.occ, jtree, g.origin, g.voxel_size, jnp.asarray(vp),
        jnp.float32(0.05)))
    got = tvr._working_volume_octree(occ, ttree, np.asarray(g.origin),
                                     np.asarray(g.voxel_size), vp, 0.05)
    np.testing.assert_array_equal(got.numpy(), want)
    jr = dataclasses.replace(jr)
    jr.update_frustum_culling(cam, 1.3, tree=jtree)
    r = tvr.VolumeRaycastRenderer(device="cpu").init(
        make_sphere_grid(32, device="cpu"))
    r.update_frustum_culling(cam, 1.3, tree=ttree)
    np.testing.assert_array_equal(r.textures.working.numpy(),
                                  np.asarray(jr.textures.working))


def test_textures_round_trip(scene):
    _, jr, tex = scene
    arrays = convert.textures_to_numpy(tex)
    assert len(arrays["vol_mips"]) == len(jr.textures.vol_mips)
    for f in dataclasses.fields(trm.VolumeTextures):
        a, b = arrays[f.name], getattr(jr.textures, f.name)
        pairs = zip(a, b) if f.name == "vol_mips" else [(a, b)]
        for x, y in pairs:
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f.name)
    back = convert.textures_from_numpy(arrays, device="cpu")
    assert torch.equal(back.grad_dir, tex.grad_dir)
