"""Port vs JAX reference: slab-sweep geometry, shadow volume, packed table.

The packed sweep table (``k + 0.5`` [+2048] / ``-1`` per texel) must be
bitwise equal: both sides round the same bf16 products once after f32
accumulation. The shadow volume is bitwise equal too: its hat products
have at most two nonzero terms per output, exact in f32 in any order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ts

torch.set_num_threads(2)

TO_LIGHT = (0.5, 0.9, 0.4)

# exterior (the sweep runs from the low end), flipped (from the high
# end), interior looking down the axis (whole forward half), interior
# looking up it (the slabs behind the eye cropped out)
POSES = {
    "exterior": dict(theta=-0.9, phi=4.0, radius=2.0),
    "flipped": dict(theta=0.4, phi=0.8, radius=2.0),
    "interior": dict(theta=0.05, phi=0.1, radius=0.05,
                     target=np.array([0.0, 0.0, 0.3], np.float32)),
    "interior_cropped": dict(theta=0.05, phi=3.2, radius=0.05,
                             target=np.array([0.0, 0.0, -0.3], np.float32)),
}


@pytest.fixture(scope="module")
def scene():
    g = make_sphere_grid(32)
    vol = (np.asarray(g.occ) > 0).astype(np.float32)
    sv_j = np.asarray(js.shadow_volume(vol, TO_LIGHT))
    sv_t = ts.shadow_volume(vol, TO_LIGHT, device="cpu")
    return g, vol, sv_j, sv_t


def test_shadow_volume_sphere_bitwise(scene):
    _, _, sv_j, sv_t = scene
    assert sv_t.dtype == torch.float32 and sv_t.shape == sv_j.shape
    assert np.array_equal(sv_j, sv_t.numpy())
    assert 0.01 < (sv_j > 0.5).mean() < 0.9


@pytest.mark.parametrize("light", [(0.0, 1.0, 0.0), (1.0, 0.0, 0.0),
                                   (1.0, 1.0, 0.0), (-0.3, 0.2, -0.9)])
def test_shadow_volume_directional_bitwise(light):
    occ = np.zeros((16, 16, 16), np.float32)
    occ[8, 8, 8] = 1.0
    occ[3:6, 10:12, 2:9] = 1.0
    sv_j = np.asarray(js.shadow_volume(occ, light))
    sv_t = ts.shadow_volume(occ, light, device="cpu").numpy()
    assert np.array_equal(sv_j, sv_t)


def _camera(name):
    p = dict(POSES[name])
    target = p.pop("target", None)
    cam = Camera(**p)
    if target is not None:
        cam.set_target(target)
    return cam


@pytest.mark.parametrize("name", list(POSES))
def test_sweep_geometry_equal(scene, name):
    g, vol, _, _ = scene
    cam = _camera(name)
    j = js._sweep_geometry(vol, g.origin, g.voxel_size, cam.get_pos(),
                           cam.get_view())
    t = ts._sweep_geometry(vol.shape, np.asarray(g.origin),
                           float(g.voxel_size), cam.get_pos(), cam.get_view())
    assert j == t
    assert js._auto_inter(j[4]) == ts._auto_inter(t[4])


def test_poses_cover_every_sweep_case(scene):
    g, vol, _, _ = scene
    cases = {}
    for name in POSES:
        cam = _camera(name)
        geo = ts._sweep_geometry(vol.shape, np.asarray(g.origin),
                                 float(g.voxel_size), cam.get_pos(),
                                 cam.get_view())
        cases[name] = (geo[1], geo[5])
    assert cases["exterior"] == (False, 0)
    assert cases["flipped"] == (True, 0)
    assert cases["interior"][1] == 0 and cases["interior_cropped"][1] > 0


def _tables(scene, name, with_shadow, inter=256):
    g, vol, sv_j, sv_t = scene
    cam = _camera(name)
    aw, flip, (S, A, B), eyes, window, crop = js._sweep_geometry(
        vol, g.origin, g.voxel_size, cam.get_pos(), cam.get_view())
    scal = js._frame_scalars_np(
        *eyes[:3], eyes[3], *window, 45.0, 1.0, float(g.voxel_size), S,
        np.asarray(g.origin, np.float32), cam.get_pos(), cam.get_view())
    vb = js._layout_volume(vol, aw, flip, S, A, B, crop)
    shv = js._relayout_sweep(jnp.asarray(sv_j), aw, flip, vb.shape[0], A, B,
                             crop, S) if with_shadow else None
    pj = np.asarray(js._sweep_all(vb, jnp.asarray(scal), vb.shape[0] // 32,
                                  S, A, B, inter, inter, bool(flip),
                                  shadow_sw=shv))
    lay = ts.SweepLayouts(torch.from_numpy(vol),
                          sv_t if with_shadow else None)
    vbt = lay.get("volume", aw, flip, S, crop)
    assert np.array_equal(np.asarray(vb.astype(jnp.float32)),
                          vbt.float().numpy())
    shvt = lay.get("shadow", aw, flip, S, crop) if with_shadow else None
    if with_shadow:
        assert np.array_equal(np.asarray(shv.astype(jnp.float32)),
                              shvt.float().numpy())
    pt = ts._sweep_all(vbt, torch.from_numpy(scal), S, A, B, inter, inter,
                       bool(flip), shadow_sw=shvt)
    return pj, pt


@pytest.mark.parametrize("with_shadow", [False, True])
@pytest.mark.parametrize("name", list(POSES))
def test_packed_table_bitwise(scene, name, with_shadow):
    pj, pt = _tables(scene, name, with_shadow)
    assert pt.shape == (256, 256) and pt.dtype == torch.float32
    assert np.array_equal(pj, pt.numpy().reshape(-1))
    assert (pj >= 0).any() and (pj < 0).any()
    assert ((pj >= 2048).any()) == with_shadow


def test_frame_table_matches_sweep(scene):
    """_frame_table (the frame's host set-up + sweep) gives the table the
    reference's own set-up gives, and the kernel scalars of the frame."""
    g, vol, sv_j, sv_t = scene
    cam = _camera("flipped")
    pj, _ = _tables(scene, "flipped", True)
    vol_t = torch.from_numpy(vol)
    table, kscal, aw, has_sh = ts._frame_table(
        vol_t, sv_t, np.asarray(g.origin), float(g.voxel_size),
        cam.get_pos(), cam.get_view(), 45.0, 1.0, inter_h=256, inter_w=256,
        layouts=ts.SweepLayouts(vol_t, sv_t), device="cpu")
    assert has_sh and kscal.shape == (35,)
    assert np.array_equal(table.numpy().reshape(-1), pj)


def test_layouts_must_match_volume(scene):
    g, vol, _, sv_t = scene
    cam = _camera("exterior")
    lay = ts.SweepLayouts(torch.from_numpy(vol), sv_t)
    with pytest.raises(ValueError):
        ts.render_fast_frame(torch.from_numpy(vol), sv_t, np.asarray(g.origin),
                             float(g.voxel_size), cam.get_pos(),
                             cam.get_view(), 45.0, 1.0, 32, 32, layouts=lay,
                             device="cpu")


@pytest.mark.parametrize("name", ["exterior", "flipped", "interior"])
def test_split_path_matches_reference(scene, name):
    """_warp_setup -> gather -> _finish_shade, stage by stage against the
    reference's split path. lin is compared exactly except where the two
    f32 ray products round across a texel edge. Colours agree within 1e-4
    (0.03 of an 8-bit step): the norms and dot products sum in another
    order, and the normal's division by a small |p - centre| magnifies
    those ulps."""
    g, vol, _, _ = scene
    cam = _camera(name)
    W, H, ih = 96, 64, 256
    aw, flip, (S, A, B), eyes, window, crop = js._sweep_geometry(
        vol, g.origin, g.voxel_size, cam.get_pos(), cam.get_view())
    scal = js._frame_scalars_np(
        *eyes[:3], eyes[3], *window, 45.0, W / H, float(g.voxel_size), S,
        np.asarray(g.origin, np.float32), cam.get_pos(), cam.get_view(),
        tuple(-c for c in TO_LIGHT), (1.0, 0.8, 0.6), (0.1, 0.1, 0.1))
    pj, pt = _tables(scene, name, True)
    lin_j, beh_j, dirs_j, dsn_j = (np.array(x) for x in js._warp_setup(
        jnp.asarray(scal), aw, ih, ih, W, H))
    sc = torch.from_numpy(scal)
    lin_t, beh_t, dirs_t, dsn_t = ts._warp_setup(sc, aw, ih, ih, W, H)
    assert (lin_t.numpy() == lin_j).mean() > 0.995
    assert np.array_equal(beh_t.numpy(), beh_j)
    np.testing.assert_allclose(dirs_t.numpy(), dirs_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dsn_t.numpy(), dsn_j, rtol=0, atol=1e-6)

    # shade both from the same looked-up values
    w_val = np.where(lin_j < 0, -1.0, pj[np.maximum(lin_j, 0)]).astype(
        np.float32)
    img_j = np.asarray(js._finish_shade(
        jnp.asarray(w_val), jnp.asarray(beh_j), jnp.asarray(dirs_j),
        jnp.asarray(dsn_j), jnp.asarray(scal), W, H, True))
    img_t = ts._finish_shade(
        torch.from_numpy(w_val), torch.from_numpy(beh_j),
        torch.from_numpy(dirs_j), torch.from_numpy(dsn_j), sc, W, H,
        True).numpy()
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=1e-4)
