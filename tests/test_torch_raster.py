"""Port vs JAX reference: the filled-triangle rasterizer and the line
overlay (``render/raster.py``).

The JAX package's own cases (``tests/test_raster.py``) run against the
port, then the two packages meet on the same inputs: the 48^3 sphere's
MC mesh at 200x200 with 24x24 samples (the JAX fixture) at three poses.
Coverage and the z-buffer are bitwise equal (the port rounds the
projection, the edge functions and the barycentric depth as XLA's CPU
compile does); colours are bitwise on all but a few pixels (XLA's
``power`` is not correctly rounded, the port's x^32 is) and held at the
shaded-frame bar of ``tests/test_warp_kernel.py`` besides. Ties go to
the highest triangle index, as XLA's ordered scatter leaves them, and the
image does not depend on ``chunk``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.ops.marching_cubes import (
    marching_cubes_grid as j_mc,
)
from ray_tracing_octrees_tpu.render import raster as jr
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
    marching_cubes_grid,
)
from ray_tracing_octrees_tpu_torch.render import raster as tr
from ray_tracing_octrees_tpu_torch.render.camera import Camera

torch.set_num_threads(2)

W = H = 200
SAMPLES = 24
BASE = (0.8, 0.8, 0.85)
# (theta, phi, radius in extents): the JAX fixture's pose, one from the
# other side and one close up
POSES = [(0.6, 0.4, 1.6), (1.1, 2.0, 1.3), (-0.4, 4.0, 0.9)]
SHADE_TOL, SHADE_SHARE = 1.5 / 255.0, 0.995


@pytest.fixture(scope="module")
def mesh():
    """The 48^3 sphere's MC triangles (the port's, which equal JAX's)."""
    grid = make_sphere_grid(48, device="cpu")
    verts, normals, count = marching_cubes_grid(grid, max_triangles=40000,
                                                device="cpu")
    count = int(count)
    jv, jn, jc = j_mc(j_sphere(48), max_triangles=40000)
    assert int(jc) == count
    np.testing.assert_array_equal(np.asarray(jv)[:count],
                                  verts[:count].numpy())
    extent = float((grid.world_max - grid.world_min).max())
    return (verts[:count].contiguous(), normals[:count].contiguous(),
            extent)


def _camera(pose, extent):
    theta, phi, r = pose
    return Camera(theta=theta, phi=phi, radius=r * extent)


def _vp(cam):
    return (cam.get_proj(1.0) @ cam.get_view()).astype(np.float32)


@pytest.fixture(scope="module")
def renders(mesh):
    """Per pose: (JAX image, JAX zbuf, port image, port zbuf, vp)."""
    tris, nrm, extent = mesh
    colors = torch.tensor(BASE).expand(tris.shape[0], 3).contiguous()
    out = []
    for pose in POSES:
        cam = _camera(pose, extent)
        vp = _vp(cam)
        ji, jz = jr.rasterize_triangles(
            jnp.asarray(tris.numpy()), jnp.asarray(nrm.numpy()),
            jnp.asarray(colors.numpy()), jnp.asarray(vp), W, H,
            cam_pos=jnp.asarray(cam.get_pos()), samples=SAMPLES)
        ti, tz = tr.rasterize_triangles(tris, nrm, colors, vp, W, H,
                                        cam_pos=cam.get_pos(),
                                        samples=SAMPLES)
        out.append((np.asarray(ji), np.asarray(jz), ti.numpy(), tz.numpy(),
                    vp))
    return out


@pytest.fixture(scope="module")
def sphere_render(renders, mesh):
    """The JAX fixture's render, from the port."""
    _, _, img, zbuf, vp = renders[0]
    return img, zbuf, vp, mesh[2]


# -- the JAX package's cases, on the port --------------------------------------

def test_filled_silhouette_no_holes(sphere_render):
    """The outer shell projects to a filled disc: interior rows of the
    silhouette are contiguous (filled triangles, not vertex splats)."""
    img, zbuf, vp, extent = sphere_render
    covered = img[..., :3].max(axis=-1) > 0
    frac = covered.mean()
    assert 0.1 < frac < 0.6, frac
    ys, xs = np.nonzero(covered)
    cy = int(ys.mean())
    for y in range(cy - 10, cy + 11, 5):
        x_idx = np.nonzero(covered[y])[0]
        assert x_idx.size > 0
        assert np.diff(x_idx).max() == 1, f"row {y} has interior holes"


def test_depth_buffer_front_surface(sphere_render):
    """Depth at the silhouette centre is nearer than at the rim."""
    img, zbuf, vp, extent = sphere_render
    covered = img[..., :3].max(axis=-1) > 0
    ys, xs = np.nonzero(covered)
    cy, cx = int(ys.mean()), int(xs.mean())
    center_z = zbuf[cy, cx]
    assert center_z < 1.0
    rim_y = ys.min() + 2
    rim_x = int(xs[ys <= rim_y].mean())
    assert center_z < zbuf[rim_y, rim_x]


def test_phong_terms_match_reference_formula():
    """phong_shade == test.frag:7-29 evaluated by hand."""
    out = tr.phong_shade(torch.tensor([[1.0, 2.0, 3.0]]),
                         torch.tensor([[0.0, 0.0, 1.0]]),
                         torch.tensor([[0.5, 1.0, 0.25]])).numpy()[0]
    light = np.array([100.0, 100.0, 100.0]) - np.array([1.0, 2.0, 3.0])
    ldir = light / np.linalg.norm(light)
    diff = max(ldir[2], 0.0)
    view = -np.array([1.0, 2.0, 3.0])
    view = view / np.linalg.norm(view)
    refl = 2 * ldir[2] * np.array([0.0, 0.0, 1.0]) - ldir
    spec = 0.5 * max(float(view @ refl), 0.0) ** 32
    expect = (0.3 + diff + spec) * np.array([0.5, 1.0, 0.25])
    np.testing.assert_allclose(out, expect, rtol=1e-5)


def test_shading_varies_across_surface(sphere_render):
    img = sphere_render[0]
    lit = img[..., 0][img[..., 0] > 0]
    assert lit.std() > 0.05   # Lambert gradient, not flat fill


def test_wireframe_overlay_depth_tested(sphere_render):
    img, zbuf, vp, extent = sphere_render
    half = 0.5 * extent
    front = [[-half, 0.0, 2.0 * half], [half, 0.0, 2.0 * half]]
    behind = [[-half, 0.1, -3.0 * half], [half, 0.1, -3.0 * half]]
    segs = torch.tensor([front, behind], dtype=torch.float32)
    out = tr.rasterize_lines(torch.from_numpy(img), torch.from_numpy(zbuf),
                             segs, vp, W, H, color=(1.0, 0.0, 0.0)).numpy()
    red = (out[..., 0] == 1.0) & (out[..., 1] == 0.0)
    assert red.any(), "front segment must draw"
    covered = img[..., :3].max(axis=-1) > 0
    cy = int(np.nonzero(covered)[0].mean())
    band = red[cy - 2: cy + 3]
    assert not (band & covered[cy - 2: cy + 3]).all(), \
        "hidden segment should be occluded"


# -- the port against JAX -----------------------------------------------------

def test_phong_shade_matches_jax():
    """Within rtol 1e-6 on all but 0.5% of values and 1e-5 on all: the
    sums round as XLA's do (the specular dot is bitwise JAX's), and the
    rest is XLA's own ``power``, which is not correctly rounded (the
    port's x^32 is), amplified where the specular term dominates."""
    rng = np.random.default_rng(14)
    pos = rng.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    nrm = rng.normal(size=(4096, 3)).astype(np.float32)
    col = rng.uniform(0.0, 1.0, (4096, 3)).astype(np.float32)
    ref = np.asarray(jr.phong_shade(jnp.asarray(pos), jnp.asarray(nrm),
                                    jnp.asarray(col)))
    got = tr.phong_shade(torch.from_numpy(pos), torch.from_numpy(nrm),
                         torch.from_numpy(col)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    within = np.abs(got - ref) <= 1e-7 + 1e-6 * np.abs(ref)
    assert within.mean() > 0.995


@pytest.mark.parametrize("k", range(len(POSES)))
def test_rasterize_triangles_matches_jax(renders, k):
    """Coverage and the z-buffer bitwise; colours at the shaded-frame bar
    and bitwise on all but one pixel in a thousand."""
    ji, jz, ti, tz, _ = renders[k]
    assert ti.shape == (H, W, 4) and tz.shape == (H, W)
    np.testing.assert_array_equal(jz < 2.0, tz < 2.0)
    np.testing.assert_array_equal(jz, tz)
    close = np.abs(ji - ti).max(-1) <= SHADE_TOL
    assert close.mean() > SHADE_SHARE
    assert (ji == ti).all(-1).mean() >= 0.999
    assert (ti[..., 3] == 1.0).all()
    assert ((jz < 2.0).mean() > 0.05)


def test_rasterize_is_chunk_independent(mesh):
    tris, nrm, extent = mesh
    cam = _camera(POSES[2], extent)
    colors = torch.rand(tris.shape[0], 3,
                        generator=torch.Generator().manual_seed(5))
    kw = dict(cam_pos=cam.get_pos(), samples=SAMPLES)
    a = tr.rasterize_triangles(tris, nrm, colors, _vp(cam), W, H, **kw)
    assert tris.shape[0] > 16384
    for chunk in (16384, 1000):
        b = tr.rasterize_triangles(tris, nrm, colors, _vp(cam), W, H,
                                   chunk=chunk, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_coplanar_tie_goes_to_highest_index():
    """Two copies of each triangle (same depth everywhere): the later
    copy's colour wins, as in the reference's ordered scatter."""
    cam = Camera(theta=0.3, phi=0.5, radius=3.0)
    vp = _vp(cam)
    tri = np.array([[[-0.8, -0.6, 0.0], [0.9, -0.5, 0.1], [0.0, 0.8, -0.2]],
                    [[-0.5, -0.7, -0.3], [0.6, 0.4, 0.3], [-0.7, 0.5, 0.2]]],
                   np.float32)
    tris = np.concatenate([tri, tri])
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
    colors = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]],
                      np.float32)
    ji, jz = jr.rasterize_triangles(jnp.asarray(tris), jnp.asarray(nrm),
                                    jnp.asarray(colors), jnp.asarray(vp),
                                    64, 48, samples=64)
    ti, tz = tr.rasterize_triangles(torch.from_numpy(tris),
                                    torch.from_numpy(nrm),
                                    torch.from_numpy(colors), vp, 64, 48,
                                    samples=64, chunk=3)
    ji, jz, ti, tz = np.asarray(ji), np.asarray(jz), ti.numpy(), tz.numpy()
    covered = tz < 2.0
    np.testing.assert_array_equal(jz < 2.0, covered)
    assert covered.mean() > 0.1
    # this one-chunk program fuses otherwise than the multi-chunk one:
    # depth within an ulp here
    np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-6)
    for img in (ji, ti):
        # only the second copies (blue, yellow) show: a red or green
        # channel never stands alone
        rgb = img[covered][:, :3]
        assert not ((rgb[:, 1] == 0) & (rgb[:, 2] == 0)).any()
        assert not ((rgb[:, 0] == 0) & (rgb[:, 2] == 0)).any()
    # and the same copy wins every pixel in both packages
    np.testing.assert_array_equal(ji[..., 2] > 0, ti[..., 2] > 0)
    assert (np.abs(ji - ti).max(-1) <= SHADE_TOL).all()


def test_valid_mask_matches_jax(mesh):
    tris, nrm, extent = mesh
    cam = _camera(POSES[0], extent)
    vp = _vp(cam)
    valid = np.random.default_rng(2).random(tris.shape[0]) < 0.7
    colors = np.broadcast_to(np.float32(BASE), (tris.shape[0], 3)).copy()
    ji, jz = jr.rasterize_triangles(
        jnp.asarray(tris.numpy()), jnp.asarray(nrm.numpy()),
        jnp.asarray(colors), jnp.asarray(vp), 96, 72, valid=jnp.asarray(valid),
        samples=SAMPLES)
    ti, tz = tr.rasterize_triangles(tris, nrm, torch.from_numpy(colors), vp,
                                    96, 72, valid=torch.from_numpy(valid),
                                    samples=SAMPLES)
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())
    assert (np.abs(np.asarray(ji) - ti.numpy()).max(-1)
            <= SHADE_TOL).mean() > SHADE_SHARE


@pytest.mark.parametrize("samples", [2, 7, 64, 100])
def test_line_samples_equal_linspace(samples):
    np.testing.assert_array_equal(
        tr.line_samples(samples),
        np.asarray(jnp.linspace(0.0, 1.0, samples)))


@pytest.mark.parametrize("k", range(len(POSES)))
def test_rasterize_lines_matches_jax(renders, mesh, k):
    """Given JAX's image and z-buffer, the overlay is bitwise JAX's."""
    ji, jz, _, _, vp = renders[k]
    extent = mesh[2]
    rng = np.random.default_rng(40 + k)
    segs = rng.uniform(-0.7, 0.7, (3000, 2, 3)).astype(np.float32) * extent
    valid = rng.random(3000) < 0.9
    ref = np.asarray(jr.rasterize_lines(
        jnp.asarray(ji), jnp.asarray(jz), jnp.asarray(segs), jnp.asarray(vp),
        W, H, color=(1.0, 0.5, 0.0), valid=jnp.asarray(valid)))
    got = tr.rasterize_lines(torch.from_numpy(ji), torch.from_numpy(jz),
                             torch.from_numpy(segs), vp, W, H,
                             color=(1.0, 0.5, 0.0),
                             valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != ji).any()
