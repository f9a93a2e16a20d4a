"""Port vs JAX reference: the orthographic shadow seed and the DDA
tracer's bundle options.

Mirrors tests/test_shadow_seed.py. ``build_shadow_seed``'s candidate
words and ``query_shadow_seed``'s live masks are bitwise against JAX
(t_start within 1e-6); the seed is conservative (live=False proves a
miss, t_start never passes the hit), and the seeded, bundled frame is
image-identical to the plain one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.render.camera import generate_rays as j_rays
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu_torch.core import octree as to
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.models import octree_raytracer as tm
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ts
from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree_fast

torch.set_num_threads(2)

LIGHTS = [(0.5, 0.9, 0.4), (-0.3, 0.2, 0.9), (1.0, 0.1, -0.2)]
ORIGIN = np.array([-0.5, -0.4, -0.3], np.float32)
VS = 0.11


def _scene(seed, dims):
    occ = (np.random.default_rng(seed).random(dims) < 0.08).astype(np.uint8)
    lv = to.build_leaf_volume(to.build_pyramid(torch.from_numpy(occ)))
    vol = occ.astype(np.float32)
    return (occ, lv, ts.dilate_occupancy(vol, device="cpu"),
            js.dilate_occupancy(jnp.asarray(vol)))


def _origins(seed, occ, n, pad):
    lo = ORIGIN - pad
    hi = ORIGIN + np.asarray(occ.shape)[::-1] * VS + pad
    rng = np.random.default_rng(seed)
    return (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)


def _dirs(light, n):
    l = np.asarray(light, np.float64)
    return np.broadcast_to((l / np.linalg.norm(l)).astype(np.float32),
                           (n, 3)).copy()


@pytest.mark.parametrize("light", LIGHTS)
def test_shadow_seed_conservative_random(light):
    occ, lv, dil, jdil = _scene(1, (12, 14, 10))
    seed = ts.build_shadow_seed(dil, light, device="cpu")
    jseed = js.build_shadow_seed(jdil, light)
    assert (seed.OA, seed.OB, seed.S, seed.pa_lo, seed.pb_lo) == (
        jseed.OA, jseed.OB, jseed.S, jseed.pa_lo, jseed.pb_lo)
    assert np.array_equal(seed.bits2d.numpy(), np.asarray(jseed.bits2d))
    n = 512
    o = _origins(2, occ, n, 0.3)
    res = trace_octree_fast(lv, torch.from_numpy(o),
                            torch.from_numpy(_dirs(light, n)), ORIGIN, VS)
    live, t0 = ts.query_shadow_seed(seed, torch.from_numpy(o), ORIGIN, VS)
    jlive, jt0 = js.query_shadow_seed(jseed, jnp.asarray(o),
                                      jnp.asarray(ORIGIN), jnp.float32(VS))
    assert np.array_equal(live.numpy(), np.asarray(jlive))
    np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=0,
                               atol=1e-6)
    hit = res["hit"]
    assert hit.any() and not (hit & ~live).any(), "a hitting ray was killed"
    assert not (hit & live & (t0 > res["t"] + 1e-5)).any()


@pytest.mark.parametrize("light", LIGHTS[:2])
def test_shadow_seeded_trace_matches_plain(light):
    """Seed + t_start change no output of the exact shadow trace."""
    occ, lv, dil, _ = _scene(3, (10, 16, 12))
    seed = ts.build_shadow_seed(dil, light, device="cpu")
    n = 256
    o = torch.from_numpy(_origins(4, occ, n, 0.0))
    d = torch.from_numpy(_dirs(light, n))
    plain = trace_octree_fast(lv, o, d, ORIGIN, VS)
    live, t0 = ts.query_shadow_seed(seed, o, ORIGIN, VS)
    seeded = trace_octree_fast(
        lv, o, d, ORIGIN, VS, ball_skip=True, const_dir=True, t_start=t0,
        live_mask=live, ladder=((0, n // 2), (4, n // 4)), safety_cap=n // 4)
    assert torch.equal(plain["hit"], seeded["hit"])
    ph = plain["hit"]
    assert torch.equal(plain["t"][ph], seeded["t"][ph])


def test_const_bundle_ladder_bit_matches():
    """const_origin / const_dir / the ladder arguments change no bit."""
    g = make_sphere_grid(32, device="cpu")
    lv = to.build_leaf_volume(to.build_pyramid(g.occ))
    cam = Camera(theta=0.4, phi=0.8, radius=2.2)
    o, d = j_rays(64, 48, jnp.asarray(cam.get_pos(), jnp.float32),
                  jnp.asarray(cam.get_view(), jnp.float32), 45.0, 64 / 48)
    o, d = torch.from_numpy(np.asarray(o)), torch.from_numpy(np.asarray(d))
    n = 64 * 48
    args = (lv, o, d, g.origin, g.voxel_size)
    base = trace_octree_fast(*args, ball_skip=True)
    lad = ((0, n // 2), (2, n // 8), (6, n // 32))
    for kw in (dict(ladder=lad, const_origin=True),
               dict(ladder=lad, const_origin=True, safety_cap=n // 8),
               dict(ladder=((0, 64), (2, 32)), const_origin=True,
                    safety_cap=n // 4),
               dict(ladder=((0, 64), (2, 32)), const_origin=True)):
        out = trace_octree_fast(*args, ball_skip=True, **kw)
        for k in ("hit", "t", "point", "normal"):
            assert torch.equal(base[k], out[k]), (k, kw)


def test_frame_shadow_seed_image_identical():
    """render_octree_image with shadow_seed equals the plain shadowed
    frame, bit for bit."""
    g = make_sphere_grid(32, device="cpu")
    pyr = to.build_pyramid(g.occ)
    lv = to.build_leaf_volume(pyr)
    dil = ts.dilate_occupancy(g.occ, device="cpu")
    light = (-0.5, -0.9, -0.4)
    seed = ts.build_shadow_seed(dil, tuple(-c for c in light), device="cpu")
    cam = Camera(theta=0.3, phi=0.7, radius=2.0)
    W, H = 64, 48
    args = (pyr, g.origin, g.voxel_size, cam.get_pos(), cam.get_view(), W, H,
            45.0, W / H)
    kw = dict(shadows=True, leaf_vol=lv, ball_skip=True, light_dir=light,
              device="cpu")
    a = tm.render_octree_image(*args, **kw)
    st = {}
    b = tm.render_octree_image(*args, **kw, shadow_seed=seed, stats=st)
    assert torch.equal(a, b)
    assert [t["kind"] for t in st["traces"]] == ["primary", "shadow"]
