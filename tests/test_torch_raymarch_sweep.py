"""Port vs JAX reference: the sweep-space volume frame
(``trace/raymarch_sweep.py``), and the port's sweep against its own
per-ray oracle at the bars of ``tests/test_raymarch_sweep.py``.

Against JAX, on the 32^3 sphere on the CPU, the same inputs on both sides:
- ``_volume_sweep``'s packed first-hit table and its four packed field
  channels are bitwise equal at three poses (sweep axes x, z and y; the
  x and y sweeps flipped), and ``_volume_sweep_core`` with a nonzero
  ``o_base`` is too; so are ``prepare_volume_scene``'s detection volume
  and field bundles, after a splat and ``update_indirect_lighting``;
- ``render_volume_frame``'s image is within 1e-4 of JAX's on all but
  0.5% of pixels (46 of 9216; measured 0, 1 and 1 at the three poses:
  JAX's rays differ by an ulp where XLA fuses their products, which moves
  ``lin`` one texel on a few pixels);
- ``shadow_fraction_volume`` is within 1e-6 (measured 0);
- the 512 x 128 frame: hit masks equal and the image within 1e-4 on all
  but 0.5% of pixels (measured 0 pixels over).
The mirrors of the JAX file's coverage, colour, close-up, misses-black,
shadow-fraction and larger-frame cases hold the port's sweep against the
port's oracle (``raymarch.raymarch_volume``) at the JAX bars.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.models import volume_raycaster as jvr
from ray_tracing_octrees_tpu.trace import raymarch as jrm
from ray_tracing_octrees_tpu.trace import raymarch_sweep as jrs
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.models import volume_raycaster as tvr
from ray_tracing_octrees_tpu_torch.render.camera import Camera, generate_rays
from ray_tracing_octrees_tpu_torch.trace import raymarch as trm
from ray_tracing_octrees_tpu_torch.trace import raymarch_sweep as trs

torch.set_num_threads(2)

# (theta, phi, radius): sweep axis x flipped, z unflipped, y flipped
POSES = [(0.5, 0.8, 2.2), (-0.4, 2.5, 1.6), (1.2, 4.0, 2.0)]
IMAGE_TOL = 1e-4
IMAGE_SHARE = 0.005


@pytest.fixture(scope="module")
def scenes():
    """(JAX grid, JAX renderer, JAX sweep scene, port renderer on the
    JAX textures, port sweep scene)."""
    g = j_sphere(32)
    jr = jvr.VolumeRaycastRenderer().init(g)
    js = jrs.prepare_volume_scene(jr.textures, float(g.voxel_size))
    tr = tvr.VolumeRaycastRenderer(device="cpu").init(
        make_sphere_grid(32, device="cpu"))
    tr.textures = convert.textures_from_numpy(jr.textures, device="cpu")
    ts = trs.prepare_volume_scene(tr.textures, float(g.voxel_size),
                                  device="cpu")
    return g, jr, js, tr, ts


def _jax_tables(js, origin, cam, aspect=1.0):
    det_bf, cats, scal, m = jrs._volume_frame_inputs(
        js, origin, cam.get_pos(), cam.get_view(), 45.0, aspect)
    packed, vals = jrs._volume_sweep(
        det_bf, tuple(cats), jnp.asarray(scal), det_bf.shape[0] // 32,
        m["S"], m["A"], m["B"], m["inter_h"], m["inter_w"], m["flip"],
        m["nf"])
    return np.asarray(packed), [np.asarray(v) for v in vals], scal, m


def _port_tables(ts, origin, cam, aspect=1.0):
    det_bf, cats, scal, m = trs._volume_frame_inputs(
        ts, origin, cam.get_pos(), cam.get_view(), 45.0, aspect)
    packed, vals = trs._volume_sweep(
        det_bf, cats, torch.as_tensor(scal), m["S"], m["A"], m["B"],
        m["inter_h"], m["inter_w"], m["flip"], m["nf"])
    return packed.numpy(), [v.numpy() for v in vals], scal, m


@pytest.mark.parametrize("pose", POSES)
def test_volume_sweep_tables_bitwise(scenes, pose):
    g, _, js, _, ts = scenes
    cam = Camera(*pose)
    pj, vj, sj, mj = _jax_tables(js, np.asarray(g.origin), cam)
    pt, vt, st, mt = _port_tables(ts, np.asarray(g.origin), cam)
    assert {k: mj[k] for k in mt} == mt
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(pt, pj)
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a, b)
    assert 0.05 < (pj >= 0).mean() < 0.5
    # ao/grad_mag/edge, the normal and the shadow carry values at hits (the
    # indirect light is 0 before update_indirect_lighting)
    assert all((vj[j][pj >= 0] > 0).any() for j in (0, 1, 3))


@pytest.mark.parametrize("pose", POSES)
def test_render_volume_frame_matches_jax(scenes, pose):
    g, _, js, _, ts = scenes
    cam = Camera(*pose)
    args = (cam.get_pos(), cam.get_view(), 45.0, 1.0, 96, 96)
    want = jrs.render_volume_frame(js, g.origin, *args)
    got = trs.render_volume_frame(ts, np.asarray(g.origin), *args,
                                  device="cpu")
    np.testing.assert_array_equal(got["alpha"].numpy() >= 0.1,
                                  np.asarray(want["alpha"]) >= 0.1)
    diff = np.abs(got["color"].numpy() - np.asarray(want["color"])).max(-1)
    assert (diff > IMAGE_TOL).mean() <= IMAGE_SHARE
    assert np.isfinite(got["color"].numpy()).all()


def test_shadow_fraction_volume_matches_jax(scenes):
    g, jr, _, _, _ = scenes
    den = np.asarray(jr.textures.vol_mips[0])
    rad = np.zeros_like(den)
    rad[10:20, 12:22, 5:15] = 0.7      # carved blockers drop out
    slab = np.zeros((32, 16, 16), np.float32)
    slab[20:24] = 1.0
    for d, r, light, rng_w, vs in (
            (den, rad, jrm.MAIN_LIGHT_DIR, 5.0, float(g.voxel_size)),
            (slab, np.zeros_like(slab), (0.0, 0.0, 1.0), 5.0, 1.0),
            (den, rad, (-0.3, 0.2, -0.9), 0.4, float(g.voxel_size))):
        want = np.asarray(jrs.shadow_fraction_volume(
            jnp.asarray(d), jnp.asarray(r), light, rng_w, vs))
        got = trs.shadow_fraction_volume(torch.tensor(d), torch.tensor(r),
                                         light, rng_w, vs).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert want.max() > 0.5


def test_volume_sweep_core_o_base_matches_jax(scenes):
    """The sweep's rows numbered from a global offset (a slab segment of
    a larger sweep, as the multi-device frame cuts it): equal first rows
    and field values."""
    g, _, js, _, ts = scenes
    cam = Camera(*POSES[0])
    det_bf, cats, scal, m = jrs._volume_frame_inputs(
        js, np.asarray(g.origin), cam.get_pos(), cam.get_view(), 45.0, 1.0)
    core = jax.jit(jrs._volume_sweep_core, static_argnums=tuple(range(3, 11)))
    fj, vj = core(det_bf, tuple(cats), jnp.asarray(scal), 1, m["S"], m["A"],
                  m["B"], m["inter_h"], m["inter_w"], m["flip"], m["nf"],
                  jnp.float32(64.0))
    det_t, cats_t, scal_t, mt = trs._volume_frame_inputs(
        ts, np.asarray(g.origin), cam.get_pos(), cam.get_view(), 45.0, 1.0)
    ft, vt = trs._volume_sweep_core(
        det_t, cats_t, torch.as_tensor(scal_t), mt["S"], mt["A"], mt["B"],
        mt["inter_h"], mt["inter_w"], mt["flip"], mt["nf"], o_base=64.0)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ft.numpy() < 64 + m["S"]).any()


def test_prepare_after_carving_and_indirect_light(scenes):
    """The port's scene state after a splat, the precompute it triggers
    and the indirect light, carried to JAX by convert.textures_to_numpy:
    both packages bind the same sweep scene."""
    g = scenes[0]
    r = tvr.VolumeRaycastRenderer(device="cpu").init(
        make_sphere_grid(32, device="cpu"))
    r.add_splat(np.array([0.05, 0.3, 0.2], np.float32), radius=4.0)
    r.dispatch_radiation()
    r.run_precompute()
    r.update_indirect_lighting()
    arrays = convert.textures_to_numpy(r.textures)
    assert arrays["indirect"].max() > 0 and arrays["radiation"].max() > 0
    jtex = jrm.VolumeTextures(**{
        k: [jnp.asarray(m) for m in v] if k == "vol_mips" else jnp.asarray(v)
        for k, v in arrays.items()})
    js = jrs.prepare_volume_scene(jtex, float(g.voxel_size))
    ts = r.sweep_scene()
    np.testing.assert_array_equal(ts.det.numpy(), np.asarray(js.det))
    for cj, ct in zip(js.bundles, ts.bundles):
        for a, b in zip(cj, ct):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # and the sweep's tables of that state, the indirect channel included
    cam = Camera(*POSES[0])
    pj, vj, _, _ = _jax_tables(js, np.asarray(g.origin), cam)
    pt, vt, _, _ = _port_tables(ts, np.asarray(g.origin), cam)
    np.testing.assert_array_equal(pt, pj)
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a, b)
    assert (vj[2][pj >= 0] > 0).any()
    # the renderer rebuilds its scene after a texture change, not before
    assert r.sweep_scene() is ts
    r.update_indirect_lighting(strength=0.5)
    assert r.sweep_scene() is not ts


def test_volume_sweep_512_matches_jax_sweep(scenes):
    """The 512-wide frame: the port's sweep against JAX's sweep (not a
    second 512-wide oracle)."""
    g, _, js, _, ts = scenes
    W, H = 512, 128
    cam = Camera(theta=0.5, phi=0.8, radius=2.2)
    args = (cam.get_pos(), cam.get_view(), 45.0, W / H, W, H)
    want = jrs.render_volume_frame(js, g.origin, *args)
    got = trs.render_volume_frame(ts, np.asarray(g.origin), *args,
                                  device="cpu")
    hit_j = np.asarray(want["alpha"]) >= 0.1
    hit_t = got["alpha"].numpy() >= 0.1
    assert (hit_t == hit_j).mean() > 0.92
    np.testing.assert_array_equal(hit_t, hit_j)
    diff = np.abs(got["color"].numpy() - np.asarray(want["color"])).max(-1)
    assert (diff > IMAGE_TOL).mean() <= IMAGE_SHARE


def test_explicit_table_width_over_1024_raises(scenes):
    g, _, _, _, ts = scenes
    cam = Camera(*POSES[0])
    with pytest.raises(ValueError, match="1024"):
        trs.render_volume_frame(ts, np.asarray(g.origin), cam.get_pos(),
                                cam.get_view(), 45.0, 1.0, 32, 32,
                                inter_h=256, inter_w=2048, device="cpu")


# -- mirrors of tests/test_raymarch_sweep.py: the port's sweep against the
# -- port's oracle, at the JAX bars

def _frame_pair(scenes, W, H, theta=0.5, phi=0.8, radius=2.2):
    g, _, _, tr, ts = scenes
    cam = Camera(theta=theta, phi=phi, radius=radius)
    out = trs.render_volume_frame(ts, np.asarray(g.origin), cam.get_pos(),
                                  cam.get_view(), 45.0, W / H, W, H,
                                  device="cpu")
    iv = np.linalg.inv(np.asarray(cam.get_view(), np.float64))
    ip = np.linalg.inv(np.asarray(cam.get_proj(W / H), np.float64))
    ref = trm.raymarch_volume(tr.textures, cam.get_pos(), iv, ip, W, H,
                              max_steps=800, device="cpu")
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() if torch.is_tensor(v) else v
             for k, v in ref.items()})


@pytest.fixture(scope="module")
def pair96(scenes):
    return _frame_pair(scenes, 96, 96)


def test_volume_sweep_matches_oracle_coverage(scenes, pair96):
    out, ref = pair96
    hit_s = out["alpha"] >= 0.1
    hit_r = ref["alpha"] >= 0.1
    assert (hit_s == hit_r).mean() > 0.92
    cam = Camera(theta=0.5, phi=0.8, radius=2.2)
    _, dirs = generate_rays(96, 96, cam.get_pos(), cam.get_view(), 45.0, 1.0,
                            device="cpu")
    dirs = dirs.numpy().astype(np.float64).reshape(96, 96, 3)
    o = np.asarray(cam.get_pos(), np.float64)
    b = (dirs * o).sum(-1)
    disc = b * b - ((o * o).sum() - 0.4 * 0.4)
    t_sph = -b - np.sqrt(np.maximum(disc, 0.0))
    vs = 1.0 / 32
    interior = (disc > (3.0 * vs) ** 2) & hit_s
    dd = np.abs(out["depth"][interior] - t_sph[interior])
    assert interior.sum() > 200
    assert np.quantile(dd, 0.9) < 2.5 * vs


def test_volume_sweep_color_close_on_hits(pair96):
    out, ref = pair96
    both = (out["alpha"] >= 0.1) & (ref["alpha"] >= 0.1)
    assert both.any()
    cs, cr = out["color"][..., :3][both], ref["color"][..., :3][both]
    assert np.abs(cs - cr).mean() < 0.08
    assert np.abs(cs - cr).max() < 0.5
    ls, lr = cs.mean(-1), cr.mean(-1)
    if lr.std() > 0.05:
        assert np.corrcoef(ls, lr)[0, 1] > 0.7
    else:
        assert abs(ls.mean() - lr.mean()) < 0.05


def test_volume_sweep_closeup_statistical_parity(scenes):
    out, ref = _frame_pair(scenes, 160, 160, theta=0.35, phi=1.9,
                           radius=1.0)
    hit_s = out["alpha"] >= 0.1
    hit_r = ref["alpha"] >= 0.1
    assert hit_r.mean() > 0.35
    assert (hit_s != hit_r).mean() < 0.08
    both = hit_s & hit_r
    cs, cr = out["color"][..., :3][both], ref["color"][..., :3][both]
    assert np.abs(cs - cr).mean() < 0.08
    assert cs.std() > 0.02


def test_volume_sweep_misses_are_black(scenes):
    g, _, _, _, ts = scenes
    cam = Camera(theta=0.5, phi=0.8, radius=2.2)
    out = trs.render_volume_frame(ts, np.asarray(g.origin), cam.get_pos(),
                                  cam.get_view(), 45.0, 1.0, 64, 64,
                                  device="cpu")
    alpha, col = out["alpha"].numpy(), out["color"].numpy()
    assert (col[alpha < 0.1][..., :3] == 0).all()
    assert (alpha >= 0.1).any()


def test_shadow_fraction_volume_semantics():
    den = np.zeros((32, 16, 16), np.float32)
    den[20:24] = 1.0
    frac = trs.shadow_fraction_volume(torch.tensor(den),
                                      torch.zeros((32, 16, 16)),
                                      (0.0, 0.0, 1.0), 5.0, 1.0).numpy()
    assert frac.shape == den.shape
    assert frac[18, 8, 8] > 0.5
    assert frac[5, 8, 8] < 0.05
    assert frac[28, 8, 8] < 0.05


def test_volume_sweep_larger_frame(scenes):
    g, _, _, _, ts = scenes
    cam = Camera(theta=0.4, phi=0.6, radius=2.5)
    out = trs.render_volume_frame(ts, np.asarray(g.origin), cam.get_pos(),
                                  cam.get_view(), 45.0, 256 / 144, 256, 144,
                                  device="cpu")
    assert tuple(out["color"].shape) == (144, 256, 4)
    assert bool(torch.isfinite(out["color"]).all())


def test_draw_fast_matches_render_volume_frame():
    """draw_fast is render_volume_frame on the renderer's sweep scene; it
    keeps the scene while the textures are unchanged."""
    r = tvr.VolumeRaycastRenderer(device="cpu").init(
        make_sphere_grid(32, device="cpu"))
    cam = Camera(theta=0.5, phi=0.8, radius=2.2)
    a = r.draw_fast(cam, 64, 48, 64 / 48)
    scene = r._sweep_scene
    b = trs.render_volume_frame(scene, r.grid.origin.numpy(), cam.get_pos(),
                                cam.get_view(), 45.0, 64 / 48, 64, 48,
                                device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    r.draw_fast(cam, 64, 48, 64 / 48)
    assert r._sweep_scene is scene
