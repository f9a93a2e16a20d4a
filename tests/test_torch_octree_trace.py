"""Port vs JAX reference: the occupancy pyramid and the exact DDA oracle.

``build_pyramid`` is integer work, so its codes must be bitwise equal.
``trace_octree`` runs the same f32 ops on both sides from the same
pyramid (handed across with ``convert.pyramid_from_numpy``): hit and steps
bitwise, t within rtol 1e-5 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.core.octree import build_pyramid as j_build
from ray_tracing_octrees_tpu.render.camera import Camera, generate_rays
from ray_tracing_octrees_tpu.trace.octree_trace import trace_octree as j_trace
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core.octree import (
    build_pyramid, padded_cube_size,
)
from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree

torch.set_num_threads(2)

W, H = 64, 48


def _random_scene():
    """The 24x32x40 random scene of tests/test_fast_exact.py."""
    rng = np.random.default_rng(0)
    occ = (rng.random((24, 32, 40)) < 0.08).astype(np.uint8)
    return occ, np.array([-20.0, -16.0, -12.0], np.float32), 1.0


def _sphere_scene():
    g = make_sphere_grid(32)
    return (np.asarray(g.occ).astype(np.uint8),
            np.asarray(g.origin, np.float32), float(g.voxel_size))


SCENES = {"random": _random_scene, "sphere32": _sphere_scene}
# (scene, theta, phi, radius in units of the scene's largest extent)
POSES = [("random", 0.7, 0.5, 3.0), ("random", 2.4, 0.3, 2.5),
         ("random", 0.3, 0.2, 0.1),
         ("sphere32", 0.9, 0.8, 0.75), ("sphere32", -0.9, 3.9, 2.0),
         ("sphere32", 0.05, 0.1, 0.05)]


@pytest.mark.parametrize("name", list(SCENES))
def test_build_pyramid_codes_bitwise(name):
    occ, _, _ = SCENES[name]()
    ref = j_build(jnp.asarray(occ))
    got = build_pyramid(torch.from_numpy(occ))
    assert got.num_levels == ref.num_levels
    assert got.root_size == ref.root_size
    for a, b in zip(ref.code_levels, got.code_levels):
        assert b.dtype == torch.uint8
        assert np.array_equal(np.asarray(a), b.numpy())


def test_build_pyramid_odd_dims_and_cell_code():
    occ = np.zeros((3, 5, 6), np.uint8)
    occ[:2, :4, :4] = 1
    occ[2, 4, 5] = 1
    ref = j_build(jnp.asarray(occ))
    got = build_pyramid(torch.from_numpy(occ))
    assert padded_cube_size(6, 5, 3) == 8 == got.root_size
    for a, b in zip(ref.code_levels, got.code_levels):
        assert np.array_equal(np.asarray(a), b.numpy())
    cx = np.array([-1, 0, 1, 2, 3], np.int32)
    for k in range(got.num_levels):
        assert np.array_equal(
            np.asarray(ref.cell_code(k, jnp.asarray(cx), jnp.asarray(cx),
                                     jnp.asarray(cx))),
            got.cell_code(k, *(torch.from_numpy(cx),) * 3).numpy())


@pytest.mark.parametrize("name", list(SCENES))
def test_pyramid_levels_and_cell_state_bitwise(name):
    """``any_levels``, ``all_levels`` and ``cell_state`` equal JAX's at
    every level, on seeded cells in and out of each level's array."""
    occ, _, _ = SCENES[name]()
    ref = j_build(jnp.asarray(occ))
    got = build_pyramid(torch.from_numpy(occ))
    for levels in ("any_levels", "all_levels"):
        want, have = getattr(ref, levels), getattr(got, levels)
        assert len(have) == len(want)
        for a, b in zip(want, have):
            assert b.dtype == torch.bool
            assert np.array_equal(np.asarray(a), b.numpy()), levels
    rng = np.random.default_rng(1)
    for k in range(got.num_levels):
        dz, dy, dx = got.level_dims_zyx(k)
        c = rng.integers(-2, max(dx, dy, dz) + 2, (3, 500)).astype(np.int32)
        want = ref.cell_state(k, *(jnp.asarray(v) for v in c))
        have = got.cell_state(k, *(torch.from_numpy(v) for v in c))
        for a, b in zip(want, have):
            assert np.array_equal(np.asarray(a), b.numpy()), k


def test_pyramid_numpy_round_trip():
    occ, _, _ = _random_scene()
    ref = j_build(jnp.asarray(occ))
    pyr = convert.pyramid_from_numpy(
        [np.asarray(c) for c in ref.code_levels], device="cpu")
    back = convert.pyramid_to_numpy(pyr)
    assert all(np.array_equal(np.asarray(a), b)
               for a, b in zip(ref.code_levels, back))
    assert all(b.dtype == np.uint8 for b in back)


def _rays(occ, origin, vs, theta, phi, radius):
    ext = max(occ.shape) * vs
    cam = Camera(theta=theta, phi=phi, radius=radius * ext)
    cam.target = origin + 0.5 * vs * np.array(occ.shape[::-1], np.float32)
    o, d = generate_rays(W, H, jnp.asarray(cam.get_pos(), jnp.float32),
                         jnp.asarray(cam.get_view(), jnp.float32), 45.0,
                         W / H)
    return np.asarray(o), np.asarray(d)


@pytest.mark.parametrize("pose", POSES, ids=lambda p: f"{p[0]}-{p[1]}-{p[3]}")
def test_trace_octree_matches_reference(pose):
    name, theta, phi, radius = pose
    occ, origin, vs = SCENES[name]()
    o, d = _rays(occ, origin, vs, theta, phi, radius)
    jp = j_build(jnp.asarray(occ))
    ref = j_trace(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(origin),
                  jnp.float32(vs))
    pyr = convert.pyramid_from_numpy([np.asarray(c) for c in jp.code_levels],
                                     device="cpu")
    got = trace_octree(pyr, torch.from_numpy(o), torch.from_numpy(d),
                       origin, vs)
    hit = np.asarray(ref["hit"])
    assert hit.any()
    assert np.array_equal(got["hit"].numpy(), hit)
    assert np.array_equal(got["steps"].numpy(), np.asarray(ref["steps"]))
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["point"].numpy(), np.asarray(ref["point"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["normal"].numpy(),
                               np.asarray(ref["normal"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("max_steps", [1, 3, 9, 17])
def test_trace_octree_step_bound_is_exact(max_steps):
    """The port tests for live rays every few steps; the step bound must
    still stop it exactly where the reference's per-step test does."""
    occ, origin, vs = _random_scene()
    o, d = _rays(occ, origin, vs, 0.7, 0.5, 3.0)
    jp = j_build(jnp.asarray(occ))
    ref = j_trace(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(origin),
                  jnp.float32(vs), max_steps=max_steps)
    got = trace_octree(build_pyramid(torch.from_numpy(occ)),
                       torch.from_numpy(o), torch.from_numpy(d), origin, vs,
                       max_steps=max_steps)
    assert int(got["steps"].max()) == int(np.asarray(ref["steps"]).max())
    assert np.array_equal(got["steps"].numpy(), np.asarray(ref["steps"]))
    assert np.array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
