"""Port vs JAX reference: the exact fast frame (trace/fast_exact.py).

Mirrors tests/test_fast_exact.py on the same scenes and poses. Integer
work is held bitwise against JAX: the widened hats, ``exact_tap_words``
(3-tap and wide), and the ``_cube_sweep`` planes and candidate words.
``fast_exact_first_hit`` is held against the JAX function on the same
rays (any hit difference must be a grazing crossing, at most 3 a frame;
t within 1e-4 on agreed hits) and against the port's own DDA oracle under the JAX
test's bars (never miss an oracle hit; t within 2e-3). The frame's image
agrees with JAX's within 1.5/255 on more than 99.5 % of pixels, and
``stats["overflow"]`` is 0 everywhere.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import fast_exact as jfe
from ray_tracing_octrees_tpu.trace import mesh_grid as jmg
from ray_tracing_octrees_tpu.trace import sweep_exact as jse
from ray_tracing_octrees_tpu.trace import slab_sweep as jss
from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
from ray_tracing_octrees_tpu_torch.render.camera import generate_rays
from ray_tracing_octrees_tpu_torch.trace import fast_exact as tfe
from ray_tracing_octrees_tpu_torch.trace import mesh_grid as tmg
from ray_tracing_octrees_tpu_torch.trace import sweep_exact as tse
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as tss
from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree

torch.set_num_threads(2)

ORIGIN = np.array([-20.0, -16.0, -12.0], np.float32)
VS = 1.0
W, H = 96, 72
LIGHT = (-0.5, -0.9, -0.4)


def _random_occ():
    rng = np.random.default_rng(0)
    return (rng.random((24, 32, 40)) < 0.08).astype(np.uint8)


def _dense_occ():
    """Solid-ish blocks: consecutive-candidate runs and the cube's
    first-slab ordering."""
    rng = np.random.default_rng(3)
    occ = np.zeros((24, 32, 40), np.uint8)
    for _ in range(12):
        z, y, x = rng.integers(0, 16, 3)
        dz, dy, dx = rng.integers(2, 8, 3)
        occ[z:z + dz, y:y + dy, x:x + dx] = 1
    return occ


def _wide_occ():
    """The long-x scene whose high orbit needs 5 a-taps."""
    rng = np.random.default_rng(7)
    occ = np.zeros((16, 40, 160), np.uint8)
    occ[2:14, 4:36, 8:152] = (rng.random((12, 32, 144)) < 0.05)
    return occ


OCCS = {"scene": _random_occ, "dense_scene": _dense_occ, "wide": _wide_occ}
WIDE_POSE = (0.3, 1.2, 100.0)
POSES = [("scene", (0.7, 0.5, 120.0)), ("scene", (1.1, 1.0, 70.0)),
         ("scene", (2.4, 0.3, 100.0)), ("dense_scene", (0.7, 0.5, 120.0)),
         ("dense_scene", (1.9, 1.2, 80.0)), ("wide", WIDE_POSE)]


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, make in OCCS.items():
        occ = make()
        vol = (occ > 0).astype(np.float32)
        out[name] = (occ, vol, torch.from_numpy(vol),
                     build_pyramid(torch.from_numpy(occ)))
    return out


def _cam(theta, phi, radius):
    cam = Camera(theta=theta, phi=phi, radius=radius)
    cam.target = np.zeros(3, np.float32)
    return cam


def _assert_grazing(mism_idx, o, d, t_a, t_b, occ):
    """Every mismatched ray crosses a solid voxel only at a grazing corner
    (an interval under 2e-3 long), which the nudged DDA may skip."""
    o64 = np.asarray(o, np.float64)
    d64 = np.asarray(d, np.float64)
    dz, dy, dx = occ.shape
    for i in mism_idx:
        found = False
        t_hi = float(max(t_a[i], t_b[i]))
        for t in np.arange(0.0, t_hi + 1.0, 2.5e-4):
            v = np.floor((o64[i] + d64[i] * t - ORIGIN) / VS).astype(int)
            if (v < 0).any() or v[2] >= dz or v[1] >= dy or v[0] >= dx:
                continue
            if occ[v[2], v[1], v[0]]:
                lo = ORIGIN + v
                t0 = (lo - o64[i]) / d64[i]
                t1 = (lo + 1.0 - o64[i]) / d64[i]
                width = np.maximum(t0, t1).min() - np.minimum(t0, t1).max()
                assert width < 2e-3, f"ray {i}: mismatch not grazing ({width})"
                found = True
                break
        assert found, f"ray {i}: mismatch with no solid crossing"


def _configs(vol, vol_t, cam):
    ok_j, cfg_j = jse.sweep_exact_setup(vol, ORIGIN, VS, cam.get_pos(),
                                        cam.get_view(), 1024, 3.5)
    ok_t, cfg_t = tfe.fast_exact_setup(vol_t, ORIGIN, VS, cam.get_pos(),
                                       cam.get_view(), device="cpu")
    assert ok_j and ok_t
    return cfg_j, cfg_t


@pytest.mark.parametrize("name,pose", [POSES[0], ("wide", WIDE_POSE)])
def test_setup_hats_and_tap_words_bitwise(scenes, name, pose):
    """The host gate's configuration equals JAX's; the widened hats and
    the tap words of every chunk are bitwise equal (3-tap and wide)."""
    occ, vol, vol_t, _ = scenes[name]
    cfg_j, cfg_t = _configs(vol, vol_t, _cam(*pose))
    for k in ("axis_world", "flip", "S", "A", "B", "IH", "IW", "ta", "tb"):
        assert cfg_t[k] == cfg_j[k], k
    assert (cfg_t["ta"], cfg_t["tb"]) == ((5, 3) if name == "wide" else (3, 3))
    assert np.array_equal(cfg_t["scal_np"], cfg_j["scal_np"])
    assert np.array_equal(cfg_t["nb9"].numpy(), np.asarray(cfg_j["nb9"]))
    args = (cfg_j["occ_sw"].shape[0], cfg_j["S"], cfg_j["A"], cfg_j["B"],
            cfg_j["IH"], cfg_j["IW"], cfg_j["flip"], cfg_j["ta"], cfg_j["tb"])
    hats_j = [np.asarray(h, np.float32) for h in
              jse._widened_perspective_hats(cfg_j["scal_np"], *args)]
    hats_t = tse._widened_perspective_hats(
        torch.from_numpy(cfg_t["scal_np"]), *args)
    for hj, ht in zip(hats_j, hats_t):
        assert np.array_equal(ht.float().numpy(), hj)
    wide = cfg_t["ta"] > 3 or cfg_t["tb"] > 3
    occ_sw = cfg_t["occ_sw"]
    assert np.array_equal(occ_sw.float().numpy(),
                          np.asarray(cfg_j["occ_sw"], np.float32))
    for lo in range(0, occ_sw.shape[0], 32):
        sl = slice(lo, lo + 32)
        det_j = np.asarray(jmg.exact_tap_words(
            cfg_j["occ_sw"][sl], jnp.asarray(hats_j[0][sl], jnp.bfloat16),
            jnp.asarray(hats_j[1][sl], jnp.bfloat16), wide))
        det_t = tmg.exact_tap_words(occ_sw[sl], hats_t[0][sl], hats_t[1][sl],
                                    wide)
        assert det_t.dtype == torch.float32
        assert np.array_equal(det_t.numpy(), det_j)
    assert det_j.max() > (256 if wide else 64)   # past bf16's exact range


@pytest.mark.parametrize("name,pose,shadow", [
    (*POSES[0], True), (*POSES[0], False), (*POSES[4], True),
    ("wide", WIDE_POSE, False)])
def test_cube_sweep_planes_and_words_bitwise(scenes, name, pose, shadow):
    occ, vol, vol_t, _ = scenes[name]
    cfg_j, cfg_t = _configs(vol, vol_t, _cam(*pose))
    S, A, B = cfg_j["S"], cfg_j["A"], cfg_j["B"]
    IH, IW, flip = cfg_j["IH"], cfg_j["IW"], cfg_j["flip"]
    aw, ta, tb = cfg_j["axis_world"], cfg_j["ta"], cfg_j["tb"]
    sp = cfg_j["occ_sw"].shape[0]
    scal = cfg_j["scal_np"].copy()
    scal[8], scal[9] = 45.0, W / H
    sh_j = jss.shadow_volume(vol, tuple(-c for c in LIGHT)) if shadow else None
    shv_j = jss._relayout_sweep(sh_j, aw, flip, sp, A, B, 0, S) if shadow \
        else cfg_j["occ_sw"][:1]
    planes_j, words_j = jfe._cube_sweep(
        cfg_j["occ_sw"], shv_j, jnp.asarray(scal), sp // 32, S, A, B, IH, IW,
        flip, ta, tb, shadow)
    shv_t = None
    if shadow:
        sh_t = tss.shadow_volume(vol, tuple(-c for c in LIGHT), device="cpu")
        shv_t = tss._layout_volume(sh_t, aw, flip, S)
        assert np.array_equal(shv_t.float().numpy(),
                              np.asarray(shv_j, np.float32))
    planes_t, words_t = tfe._cube_sweep(
        cfg_t["occ_sw"], shv_t, torch.from_numpy(scal), S, A, B, IH, IW,
        flip, ta, tb)
    assert planes_t.shape == (3, IH, IW) and words_t.shape == (IH * IW,
                                                               sp // 32)
    assert np.array_equal(planes_t.reshape(3, -1).numpy(),
                          np.asarray(planes_j))
    assert np.array_equal(words_t.numpy(), np.asarray(words_j))
    p0 = planes_t[0].numpy()
    assert (p0 >= 0).any() and (p0 < 0).any()
    assert shadow == bool((p0 >= 2048).any())


_jax_rays = jax.jit(jse._rays_sab_from_xy, static_argnums=(3, 4, 5))


def _rays_as_jax(xf, yf, scal, consts, axis_world, width, height):
    """The port's ``_rays_sab_from_xy`` replaced by JAX's, jitted as in its
    frame: XLA contracts the ray math into FMAs there, so the packages'
    rays differ by an ulp, which moves t by up to ~2e-4 on rays nearly
    parallel to a voxel face — a difference of ray generation, not of the
    frame."""
    out = _jax_rays(jnp.asarray(xf.numpy()), jnp.asarray(yf.numpy()),
                    jnp.asarray(scal.numpy()), axis_world, width, height)
    return tuple(torch.from_numpy(np.array(c)) for c in out)


@pytest.fixture(scope="module")
def first_hits(scenes):
    """Per pose: the JAX frame; the port's frame on JAX's rays; the port's
    own frame with its stats; the port's DDA oracle on the port's rays."""
    out = {}
    for name, pose in POSES:
        occ, vol, vol_t, pyr = scenes[name]
        cam = _cam(*pose)
        args = (ORIGIN, VS, cam.get_pos(), cam.get_view(), 45.0, W / H, W, H)
        ref = jfe.fast_exact_first_hit(vol, *args)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tse, "_rays_sab_from_xy", _rays_as_jax)
            same_rays = tfe.fast_exact_first_hit(vol_t, *args, device="cpu")
        got, stats = tfe.fast_exact_first_hit(vol_t, *args, with_stats=True,
                                              device="cpu")
        o, d = generate_rays(W, H, cam.get_pos(), cam.get_view(), 45.0,
                             W / H, device="cpu")
        oracle = trace_octree(pyr, o, d, ORIGIN, VS)
        out[(name, pose)] = (ref, same_rays, got, stats, o.numpy(), d.numpy(),
                             oracle)
    return out


@pytest.mark.parametrize("name,pose", POSES)
def test_first_hit_matches_reference(scenes, first_hits, name, pose):
    """On the same rays: hit differences only at grazing crossings (at
    most 3), t within 1e-4. The port's own rays are within 1e-6 of JAX's,
    and its stats report no overflow."""
    ref, same_rays, got, stats, _, _, _ = first_hits[(name, pose)]
    occ = scenes[name][0]
    h_j, t_j, _, d_j = (np.asarray(x) for x in ref)
    h_t, t_t, p_t, d_t = (x.numpy() for x in same_rays)
    assert h_j.any()
    mism = np.nonzero(h_t != h_j)[0]
    assert len(mism) <= 3, f"{len(mism)} mismatches"
    o = np.broadcast_to(_cam(*pose).get_pos(), d_t.shape)
    _assert_grazing(mism, o, d_t, t_t, t_j, occ)
    both = h_t & h_j
    np.testing.assert_allclose(t_t[both], t_j[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_t, o + d_t * t_t[:, None], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), d_j, rtol=0, atol=1e-6)
    assert stats["overflow"] == 0 and stats["unresolved"] == 0
    assert stats["suspicious"] > 0 and stats["rounds"] > 0


@pytest.mark.parametrize("name,pose", POSES)
def test_first_hit_matches_dda_oracle(scenes, first_hits, name, pose):
    _, _, got, _, o, d, oracle = first_hits[(name, pose)]
    occ = scenes[name][0]
    h1, t1 = got[0].numpy(), got[1].numpy()
    h2, t2 = oracle["hit"].numpy(), oracle["t"].numpy()
    mism = np.nonzero(h1 != h2)[0]
    assert len(mism) <= 3, f"{len(mism)} mismatches"
    assert not (h2 & ~h1).any(), "fast-exact must never miss an oracle hit"
    _assert_grazing(mism, o, d, t1, t2, occ)
    both = h1 & h2
    np.testing.assert_allclose(t1[both], t2[both], rtol=0, atol=2e-3)


def test_frame_image_matches_reference(scenes):
    occ, vol, vol_t, pyr = scenes["scene"]
    to_light = tuple(-c for c in LIGHT)
    cam = _cam(0.7, 0.5, 120.0)
    ref = np.asarray(jfe.render_fast_exact_frame(
        vol, jss.shadow_volume(vol, to_light), ORIGIN, VS, cam.get_pos(),
        cam.get_view(), 45.0, W / H, W, H, light_dir=LIGHT))
    sh_t = tss.shadow_volume(vol_t, to_light, device="cpu")
    lay = tss.SweepLayouts(vol_t, sh_t)
    img, stats = tfe.render_fast_exact_frame(
        vol_t, sh_t, ORIGIN, VS, cam.get_pos(), cam.get_view(), 45.0, W / H,
        W, H, light_dir=LIGHT, with_stats=True, layouts=lay, device="cpu")
    img = img.numpy()
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert stats["overflow"] == 0 and stats["unresolved"] == 0
    close = np.abs(img - ref).max(-1) <= 1.5 / 255.0
    assert close.mean() > 0.995
    rgb = img[..., :3]
    amb = np.float32(26) * np.float32(1 / 255)
    assert (rgb.max(-1) > 0.5).any() and (rgb == amb).all(-1).any()
    # the image's hit mask is the oracle's (lit or ambient pixels are hits)
    o, d = generate_rays(W, H, cam.get_pos(), cam.get_view(), 45.0, W / H,
                         device="cpu")
    h_img = (rgb.max(-1) > 0).reshape(-1)
    assert (h_img != trace_octree(pyr, o, d, ORIGIN, VS)["hit"].numpy()).sum() <= 3
    # layouts kept: the sweep volume, its neighbourhood and the shadow
    assert len(lay._cache) == 3
    again = tfe.render_fast_exact_frame(
        vol_t, sh_t, ORIGIN, VS, cam.get_pos(), cam.get_view(), 45.0, W / H,
        W, H, light_dir=LIGHT, layouts=lay, device="cpu")
    assert np.array_equal(again.numpy(), img) and len(lay._cache) == 3


def test_interior_pose_returns_none(scenes):
    occ, vol, vol_t, _ = scenes["scene"]
    cam = _cam(0.7, 0.5, 5.0)     # inside the volume
    args = (ORIGIN, VS, cam.get_pos(), cam.get_view(), 45.0, W / H, W, H)
    assert jfe.fast_exact_first_hit(vol, *args) is None
    assert tfe.fast_exact_first_hit(vol_t, *args, device="cpu") is None
    assert tfe.render_fast_exact_frame(vol_t, None, *args,
                                       device="cpu") is None


def test_consume_ladder_compaction_is_exact(scenes):
    """The port's fallback compacts to the unresolved rows every round and
    has no stage width, so it drops no row: on every pixel of a frame
    (consumed from slab 0) it resolves them all, with the state of plain
    rounds over the full, uncompacted rows."""
    occ, vol, vol_t, _ = scenes["dense_scene"]
    cam = _cam(1.9, 1.2, 80.0)
    _, cfg = tfe.fast_exact_setup(vol_t, ORIGIN, VS, cam.get_pos(),
                                  cam.get_view(), device="cpu")
    scal_np = cfg["scal_np"].copy()
    scal_np[8], scal_np[9] = 45.0, W / H
    scal = torch.from_numpy(scal_np)
    consts = torch.from_numpy(tss._view_consts(scal_np))
    S, A, B, flip = cfg["S"], cfg["A"], cfg["B"], cfg["flip"]
    _, words = tfe._cube_sweep(cfg["occ_sw"], None, scal, S, A, B, cfg["IH"],
                               cfg["IW"], flip, cfg["ta"], cfg["tb"])
    rd3 = tuple(c / scal[10] for c in tse._pixel_rays_sab(
        scal, consts, cfg["axis_world"], W, H))
    ok, ti, tj = tse._texel_map(rd3, scal, flip, cfg["IH"], cfg["IW"])
    pix = torch.nonzero(ok).squeeze(1)
    bits = words[(ti * cfg["IW"] + tj).long()][pix]
    rd3 = tuple(c[pix] for c in rd3)
    ro3 = tuple(scal[c].expand(pix.shape[0]) for c in range(3))
    args = (cfg["nb9"], S, A, B, flip)
    st, rounds = tse._consume_ladder(bits, torch.zeros_like(pix, dtype=
                                     torch.int32), ro3, rd3, *args, 1000,
                                     cfg["ta"], cfg["tb"])
    assert bool(st["resolved"].all()) and st["hit"].any() and rounds > 3
    full = tse._consume_state(pix.shape[0], "cpu")
    for _ in range(rounds):
        full = tse._consume_round(full, bits, ro3, rd3, *args, cfg["ta"],
                                  cfg["tb"])
    for k in full:
        assert torch.equal(st[k], full[k]), k
