"""Port vs JAX reference: the sweep-exact tracer (trace/sweep_exact.py).

Mirrors tests/test_sweep_exact.py on its scene and poses, with the port's
own DDA oracle and ``render_octree_image``: every hit-mask mismatch is a
grazing crossing the nudged oracle skips (at most 3, never an oracle hit
missed), t within 2e-3 and normals within 1e-3 on agreed hits, the frame
within 1e-4 of the DDA image but for at most 2 pixels. Against JAX: the
shadow field's candidate words bitwise, equal hit masks, t within 2e-4
(the rays differ by an ulp: XLA fuses the ray math into FMAs on the CPU;
t is ~100 here) and the frame within 1e-4 but for at most 2 pixels. The
dead test runs through ``warp_kernel.warp_lookup``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core import octree as jo
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import sweep_exact as jse
from ray_tracing_octrees_tpu_torch.core import octree as to
from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
    render_octree_image,
)
from ray_tracing_octrees_tpu_torch.render.camera import generate_rays
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as tss
from ray_tracing_octrees_tpu_torch.trace import sweep_exact as tse
from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree
from tests.test_sweep_exact import _assert_mismatches_are_grazing

torch.set_num_threads(2)

ORIGIN = np.array([-20.0, -16.0, -12.0], np.float32)
VS = 1.0
W, H = 96, 72
LIGHT = (-0.5, -0.9, -0.4)


@pytest.fixture(scope="module")
def scene():
    occ = (np.random.default_rng(0).random((24, 32, 40)) < 0.08).astype(
        np.uint8)
    vol = torch.from_numpy(occ.astype(np.float32))
    pyr = to.build_pyramid(torch.from_numpy(occ))
    jvol = jnp.asarray(occ, jnp.float32)
    return dict(occ=occ, vol=vol, pyr=pyr, lv=to.build_leaf_volume(pyr),
                lay=tss.SweepLayouts(vol), jvol=jvol,
                jlv=jo.build_leaf_volume(jo.build_pyramid(jnp.asarray(occ))))


def _cam(theta, phi, radius):
    cam = Camera(theta=theta, phi=phi, radius=radius)
    cam.target = np.zeros(3, np.float32)
    return cam


def _args(cam):
    return (ORIGIN, VS, cam.get_pos(), cam.get_view(), W, H, 45.0, W / H)


@pytest.mark.parametrize("pose", [(0.7, 0.5, 120.0), (1.1, 1.0, 70.0)])
def test_primary_matches_dda_oracle_and_jax(scene, pose):
    cam = _cam(*pose)
    res = tse.trace_pixels_sweep_exact(scene["vol"], scene["lv"],
                                       *_args(cam), layouts=scene["lay"],
                                       device="cpu")
    assert res is not None, "exterior pose must be supported"
    o, d = generate_rays(W, H, cam.get_pos(), cam.get_view(), 45.0, W / H,
                         device="cpu")
    ref = trace_octree(scene["pyr"], o, d, ORIGIN, VS)
    h1, h2 = res["hit"].numpy(), ref["hit"].numpy()
    assert res["overflow"] == 0 and res["unresolved"] == 0
    mism = np.nonzero(h1 != h2)[0]
    assert len(mism) <= 3
    assert not (h2 & ~h1).any(), "sweep must never miss an oracle hit"
    _assert_mismatches_are_grazing(mism, o.numpy(), d.numpy(), res, ref,
                                   scene["occ"])
    both = h1 & h2
    np.testing.assert_allclose(res["t"].numpy()[both], ref["t"].numpy()[both],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(res["normal"].numpy()[both],
                               ref["normal"].numpy()[both], rtol=0, atol=1e-3)
    jres = jse.trace_pixels_sweep_exact(scene["jvol"], scene["jlv"],
                                        *_args(cam))
    assert np.array_equal(h1, np.asarray(jres["hit"]))
    np.testing.assert_allclose(res["t"].numpy(), np.asarray(jres["t"]),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(res["point"].numpy(), np.asarray(jres["point"]),
                               rtol=0, atol=2e-4)


def test_frame_matches_render_octree_image_and_jax(scene, monkeypatch):
    calls = []
    real = tse.warp_lookup

    def lookup(table, lin):
        calls.append((tuple(table.shape), tuple(lin.shape), lin.dtype))
        return real(table, lin)

    monkeypatch.setattr(tse, "warp_lookup", lookup)
    sf = tse.build_shadow_field(scene["vol"], LIGHT, VS,
                                layouts=scene["lay"], device="cpu")
    jsf = jse.build_shadow_field(scene["jvol"], LIGHT, VS)
    assert sf is not None and jsf is not None
    assert (sf.inter_h, sf.inter_w, sf.ta, sf.tb, sf.axis_l, sf.flip_l) == (
        jsf.inter_h, jsf.inter_w, jsf.ta, jsf.tb, jsf.axis_l, jsf.flip_l)
    assert np.array_equal(sf.bits.numpy(), np.asarray(jsf.bits))
    assert np.array_equal(sf.nb9.numpy(), np.asarray(jsf.nb9))
    cam = _cam(0.7, 0.5, 120.0)
    img, stats = tse.render_exact_frame(
        scene["vol"], scene["lv"], *_args(cam), light_dir=LIGHT,
        shadows=True, shadow_field=sf, layouts=scene["lay"], device="cpu")
    assert len(calls) == 1 and calls[0][1] == (H, W)
    assert calls[0][2] == torch.int32
    assert stats["s_unresolved"] == 0 and stats["s_overflow"] == 0
    assert stats["unresolved"] == 0 and stats["rounds"] > 0
    ref = render_octree_image(
        scene["pyr"], ORIGIN, VS, cam.get_pos(), cam.get_view(), W, H, 45.0,
        W / H, light_dir=LIGHT, shadows=True, leaf_vol=scene["lv"],
        device="cpu")
    diff = (img - ref).abs().amax(-1)
    assert int((diff > 1e-4).sum()) <= 2
    jimg, _ = jse.render_exact_frame(
        scene["jvol"], scene["jlv"], *_args(cam), light_dir=LIGHT,
        shadows=True, shadow_field=jsf)
    jdiff = np.abs(img.numpy() - np.asarray(jimg)).max(-1)
    assert int((jdiff > 1e-4).sum()) <= 2
    # shadows off: the same visibility, no shadowed pixel
    img0, st0 = tse.render_exact_frame(
        scene["vol"], scene["lv"], *_args(cam), light_dir=LIGHT,
        shadows=False, layouts=scene["lay"], device="cpu")
    assert torch.equal(img0[..., :3].amax(-1) > 0, img[..., :3].amax(-1) > 0)
    assert st0["s_rounds"] == 0


def test_coarse_lattice_stays_exact(scene):
    """The superset invariant does not depend on the lattice: a coarse
    detection lattice gives the same per-pixel hits."""
    cam = _cam(0.2, 2.2, 90.0)
    fine = tse.trace_pixels_sweep_exact(scene["vol"], scene["lv"],
                                        *_args(cam), layouts=scene["lay"],
                                        device="cpu")
    ok, cfg = tse.sweep_exact_setup(scene["vol"], ORIGIN, VS, cam.get_pos(),
                                    cam.get_view(), max_inter=128,
                                    layouts=scene["lay"], device="cpu")
    ok_f, cfg_f = tse.sweep_exact_setup(scene["vol"], ORIGIN, VS,
                                        cam.get_pos(), cam.get_view(),
                                        layouts=scene["lay"], device="cpu")
    assert ok and ok_f and cfg["IH"] * cfg["IW"] < cfg_f["IH"] * cfg_f["IW"]
    coarse = tse._trace_pixels(cfg, tse._frame_scal(cfg, 45.0, W / H),
                               scene["lv"], W, H)
    assert coarse["unresolved"] == 0
    assert torch.equal(coarse["hit"], fine["hit"])
    both = coarse["hit"].numpy()
    np.testing.assert_allclose(coarse["t"].numpy()[both],
                               fine["t"].numpy()[both], rtol=0, atol=1e-4)


def test_shadow_occlusion_matches_dda(scene):
    """Exact shadow occlusion equals tracing the shadow rays with the DDA
    oracle from the same offset origins."""
    sf = tse.build_shadow_field(scene["vol"], LIGHT, VS,
                                layouts=scene["lay"], device="cpu")
    cam = _cam(1.1, 1.0, 70.0)
    res = tse.trace_pixels_sweep_exact(scene["vol"], scene["lv"],
                                       *_args(cam), layouts=scene["lay"],
                                       device="cpu")
    hit = res["hit"]
    l = np.asarray(LIGHT, np.float64)
    l = torch.from_numpy((l / np.linalg.norm(l)).astype(np.float32))
    shadow_o = res["point"] + res["normal"] * (VS * 2.0)
    ref = trace_octree(scene["pyr"], shadow_o, (-l)[None, :].expand(
        shadow_o.shape), ORIGIN, VS)
    occl_ref = ref["hit"] & hit
    o_vox = (shadow_o - torch.from_numpy(ORIGIN)[None, :]) / VS
    occl, rounds, unres, _ = tse._shadow_occluded(
        sf, tuple(o_vox[:, c] for c in range(3)), hit)
    assert unres == 0 and rounds > 0 and occl_ref.any()
    mism = torch.nonzero(occl != occl_ref).squeeze(1)
    assert len(mism) <= 3
    assert not (occl_ref & ~occl).any()


def test_wider_taps_equivalent(scene):
    """A wider tap window than needed (5 x 3 or 3 x 5 detection weights,
    the 15-bit neighbourhood pack, shifted consume slots) gives the same
    exact per-pixel answers."""
    cam = _cam(0.7, 0.5, 120.0)
    ok, cfg = tse.sweep_exact_setup(scene["vol"], ORIGIN, VS, cam.get_pos(),
                                    cam.get_view(), layouts=scene["lay"],
                                    device="cpu")
    assert ok and cfg["ta"] == 3 and cfg["tb"] == 3
    scal = tse._frame_scal(cfg, 45.0, W / H)

    def run(ta, tb):
        nb = tse._nb9_for(scene["lay"], cfg["axis_world"], cfg["flip"],
                          cfg["S"], ta, tb)
        return tse._trace_pixels(dict(cfg, ta=ta, tb=tb, nb9=nb), scal,
                                 scene["lv"], W, H)

    r3 = run(3, 3)
    for ta, tb in ((5, 3), (3, 5)):
        r = run(ta, tb)
        assert torch.equal(r["hit"], r3["hit"]), (ta, tb)
        assert torch.equal(r["t"], r3["t"]), (ta, tb)


def test_outside_envelope_returns_none(scene):
    cam = _cam(0.7, 0.5, 5.0)      # inside the volume
    assert tse.trace_pixels_sweep_exact(scene["vol"], scene["lv"],
                                        *_args(cam), device="cpu") is None
    assert tse.render_exact_frame(scene["vol"], scene["lv"], *_args(cam),
                                  device="cpu") is None
    assert jse.render_exact_frame(scene["jvol"], scene["jlv"],
                                  *_args(cam)) is None
