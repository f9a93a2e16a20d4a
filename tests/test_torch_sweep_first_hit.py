"""Port vs JAX reference: the slab sweep's first-hit trace.

``sweep_first_hit`` on the CPU (the packed table through the plain
version of the ``warp_lookup`` kernel) against the JAX function on the
32^3 sphere, whose CPU path is the ``jnp.take`` gather: hit equal, t
within rtol 1e-5. The table is bitwise equal on both sides; a pixel's
table index rounds the same f32 ray math, up to the ray's rotation (an
f32 inverse and product on each side).
"""

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ts
from ray_tracing_octrees_tpu_torch.trace import warp_kernel as tw

torch.set_num_threads(2)

W, H, INTER = 96, 64, 256
# exterior (the sweep runs from the low end), flipped (from the high
# end), interior (the slabs behind the eye cropped out)
POSES = {
    "exterior": dict(theta=-0.9, phi=4.0, radius=2.0),
    "flipped": dict(theta=0.4, phi=0.8, radius=2.0),
    "interior": dict(theta=0.05, phi=3.2, radius=0.05,
                     target=np.array([0.0, 0.0, -0.3], np.float32)),
}


@pytest.fixture(scope="module")
def scene():
    g = make_sphere_grid(32)
    return g, (np.asarray(g.occ) > 0).astype(np.float32)


def _camera(name):
    p = dict(POSES[name])
    target = p.pop("target", None)
    cam = Camera(**p)
    if target is not None:
        cam.set_target(target)
    return cam


@pytest.mark.parametrize("name", list(POSES))
def test_first_hit_matches_reference(scene, name):
    g, vol = scene
    cam = _camera(name)
    args = (np.asarray(g.origin), float(g.voxel_size), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H, INTER, INTER)
    flip, crop = js._sweep_geometry(vol, g.origin, g.voxel_size,
                                    cam.get_pos(), cam.get_view())[1::4]
    assert {"exterior": (False, 0), "flipped": (True, 0)}.get(
        name, (flip, crop)) == (flip, crop)
    assert name != "interior" or crop > 0
    h_j, t_j, p_j, d_j = (np.asarray(x) for x in js.sweep_first_hit(vol, *args))
    before = tw.warp_lookup.launches
    h_t, t_t, p_t, d_t = (x.numpy() for x in ts.sweep_first_hit(
        torch.from_numpy(vol), *args, device="cpu"))
    assert tw.warp_lookup.launches == before     # the CPU runs the plain version
    assert h_t.shape == (W * H,) and t_t.shape == (W * H,)
    assert h_j.mean() > 0.05
    assert np.array_equal(h_t, h_j)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-5, atol=0)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-5)


def test_first_hit_reuses_layouts(scene):
    g, vol = scene
    vol_t = torch.from_numpy(vol)
    lay = ts.SweepLayouts(vol_t)
    cam = _camera("flipped")
    args = (np.asarray(g.origin), float(g.voxel_size), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H, INTER, INTER)
    a = ts.sweep_first_hit(vol_t, *args, layouts=lay, device="cpu")
    b = ts.sweep_first_hit(vol_t, *args, device="cpu")
    assert len(lay._cache) == 1
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="another volume"):
        ts.sweep_first_hit(vol_t.clone(), *args, layouts=lay, device="cpu")
