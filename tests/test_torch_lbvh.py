"""The port's Morton codes and LBVH against the JAX reference.

The same numpy inputs go through ``ray_tracing_octrees_tpu.core.morton``
/ ``trace.lbvh`` and their counterparts in
``ray_tracing_octrees_tpu_torch``: the codes and every array of the tree
must be equal bit for bit, and a trace of the same rays through the
same tree equal in hit, triangle, t and normal (the port rounds the
centroid, the cross products and the dots as the reference's compiled
form does). The reference's own tests (``tests/test_lbvh.py``) then run
against the port with their own bars.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core import morton as jm
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.ops.marching_cubes import (
    count_mc_triangles, marching_cubes_grid,
)
from ray_tracing_octrees_tpu.trace import lbvh as jl
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core import morton as tm
from ray_tracing_octrees_tpu_torch.trace import lbvh as tl

torch.set_num_threads(2)

FIELDS = ("tri_verts", "tri_index", "left", "right", "parent", "escape",
          "aabb_min", "aabb_max")


def random_tris(rng, k, scale=1.0):
    base = (rng.random((k, 1, 3)) - 0.5) * 2 * scale
    offs = (rng.random((k, 3, 3)) - 0.5) * 0.3 * scale
    return (base + offs).astype(np.float32)


def sphere_tris(dim):
    g = make_sphere_grid(dim)
    verts, _, count = marching_cubes_grid(
        g, max_triangles=int(count_mc_triangles(g)))
    return np.asarray(verts)[: int(count)]


def rays(rng, n, spread=6.0, aim=1.5):
    origins = (rng.random((n, 3)).astype(np.float32) - 0.5) * spread
    targets = (rng.random((n, 3)).astype(np.float32) - 0.5) * aim
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


def test_morton_codes_equal_jax():
    rng = np.random.default_rng(3)
    x, y, z = rng.integers(0, 1024, (3, 4096))
    a = np.asarray(jm.morton_encode_10(*map(jnp.asarray, (x, y, z))))
    b = tm.morton_encode_10(*map(torch.as_tensor, (x, y, z)))
    np.testing.assert_array_equal(a.astype(np.int64), b.numpy())
    for ja, ta in zip(jm.morton_decode_10(jnp.asarray(a)),
                      tm.morton_decode_10(b)):
        np.testing.assert_array_equal(np.asarray(ja).astype(np.int64),
                                      ta.numpy())
    pts = (rng.random((4096, 3)) * 7 - 3).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    for jq, tq in zip(jm.quantize_to_morton_grid(jnp.asarray(pts), lo, hi),
                      tm.quantize_to_morton_grid(torch.as_tensor(pts),
                                                 torch.as_tensor(lo),
                                                 torch.as_tensor(hi))):
        np.testing.assert_array_equal(np.asarray(jq).astype(np.int64),
                                      tq.numpy())


def test_morton_21_equals_jax():
    import jax

    rng = np.random.default_rng(4)
    x, y, z = rng.integers(0, 1 << 21, (3, 2048))
    with jax.enable_x64(True):
        a = np.asarray(jm.morton_encode_21(*map(jnp.asarray, (x, y, z))))
    b = tm.morton_encode_21(*map(torch.as_tensor, (x, y, z)))
    np.testing.assert_array_equal(a.astype(np.int64), b.numpy())


@pytest.fixture(scope="module")
def meshes():
    rng = np.random.default_rng(7)
    return {"random37": random_tris(rng, 37), "random200": random_tris(
        rng, 200), "sphere24": sphere_tris(24)}


@pytest.mark.parametrize("mesh", ["random37", "random200", "sphere24"])
def test_build_lbvh_equals_jax(meshes, mesh):
    tris = meshes[mesh]
    jb = jl.build_lbvh(jnp.asarray(tris))
    tb = tl.build_lbvh(tris, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                      getattr(tb, f).numpy(), err_msg=f)


@pytest.mark.parametrize("mesh", ["random200", "sphere24"])
def test_trace_lbvh_equals_jax(meshes, mesh):
    """The same rays through the same tree: hit, triangle, t and normal
    bit for bit (the hit point's x and y may differ by an ulp: the
    reference's compiled form fuses two of its three columns)."""
    rng = np.random.default_rng(11)
    tris = meshes[mesh]
    o, d = rays(rng, 1500)
    jr = jl.trace_lbvh(jl.build_lbvh(jnp.asarray(tris)), jnp.asarray(o),
                       jnp.asarray(d), max_steps=4096)
    tr = tl.trace_lbvh(tl.build_lbvh(tris, device="cpu"), torch.as_tensor(o),
                       torch.as_tensor(d), max_steps=4096)
    for f in ("hit", "tri", "t", "normal"):
        np.testing.assert_array_equal(np.asarray(jr[f]), tr[f].numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(tr["point"].numpy(), np.asarray(jr["point"]),
                               rtol=0, atol=1e-6)
    assert tr["syncs"] >= 1 and tr["steps"] >= 1


def test_trace_lbvh_stops_at_max_steps_as_jax(meshes):
    """A step bound below what the rays need: the same partial result."""
    rng = np.random.default_rng(12)
    tris = meshes["random200"]
    o, d = rays(rng, 300)
    jr = jl.trace_lbvh(jl.build_lbvh(jnp.asarray(tris)), jnp.asarray(o),
                       jnp.asarray(d), max_steps=13)
    tr = tl.trace_lbvh(tl.build_lbvh(tris, device="cpu"), torch.as_tensor(o),
                       torch.as_tensor(d), max_steps=13)
    assert tr["steps"] == 13
    for f in ("hit", "tri", "t"):
        np.testing.assert_array_equal(np.asarray(jr[f]), tr[f].numpy())


def test_lbvh_convert_round_trip(meshes):
    """The JAX tree carried across traces as the port's own."""
    rng = np.random.default_rng(13)
    tris = meshes["random200"]
    jb = jl.build_lbvh(jnp.asarray(tris))
    tb = convert.lbvh_from_numpy(jb, device="cpu")
    back = convert.lbvh_to_numpy(tb)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jb, f)))
    o, d = rays(rng, 200)
    a = tl.trace_lbvh(tb, torch.as_tensor(o), torch.as_tensor(d))
    b = tl.trace_lbvh(tl.build_lbvh(tris, device="cpu"), torch.as_tensor(o),
                      torch.as_tensor(d))
    np.testing.assert_array_equal(a["t"].numpy(), b["t"].numpy())


# --- the reference's own tests (tests/test_lbvh.py) against the port ------

def brute_force(origins, dirs, tris):
    hit = np.zeros(len(origins), bool)
    t_best = np.full(len(origins), np.inf)
    idx = np.full(len(origins), -1)
    for k in range(len(tris)):
        v0, v1, v2 = tris[k].astype(np.float64)
        e1, e2 = v1 - v0, v2 - v0
        pvec = np.cross(dirs, e2)
        det = (e1 * pvec).sum(-1)
        ok = np.abs(det) > 1e-7
        inv = np.where(ok, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = origins - v0
        u = (tvec * pvec).sum(-1) * inv
        qvec = np.cross(tvec, e1)
        v = (dirs * qvec).sum(-1) * inv
        t = (e2 * qvec).sum(-1) * inv
        h = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-7)
        better = h & (t < t_best)
        t_best = np.where(better, t, t_best)
        hit |= better
        idx = np.where(better, k, idx)
    return hit, t_best, idx


def test_bvh_structure_invariants(rng):
    n = 37
    bvh = tl.build_lbvh(random_tris(rng, n), device="cpu")
    left = bvh.left.numpy()[: n - 1]
    right = bvh.right.numpy()[: n - 1]
    parent = bvh.parent.numpy()
    children = np.concatenate([left, right])
    assert len(set(children.tolist())) == 2 * n - 2
    assert 0 not in children
    for p in range(n - 1):
        assert parent[left[p]] == p and parent[right[p]] == p
    amin, amax = bvh.aabb_min.numpy(), bvh.aabb_max.numpy()
    for p in range(n - 1):
        for c in (left[p], right[p]):
            assert (amin[p] <= amin[c] + 1e-6).all()
            assert (amax[p] >= amax[c] - 1e-6).all()
    tv = bvh.tri_verts.numpy().reshape(-1, 3)
    np.testing.assert_allclose(amin[0], tv.min(0), atol=1e-6)
    np.testing.assert_allclose(amax[0], tv.max(0), atol=1e-6)


@pytest.mark.parametrize("k", [2, 9, 64, 200])
def test_trace_matches_brute_force(rng, k):
    tris = random_tris(rng, k)
    bvh = tl.build_lbvh(tris, device="cpu")
    origins, dirs = rays(rng, 128)
    res = tl.trace_lbvh(bvh, torch.as_tensor(origins), torch.as_tensor(dirs))
    ref_hit, ref_t, ref_idx = brute_force(origins, dirs, tris)
    got_hit = res["hit"].numpy()
    np.testing.assert_array_equal(got_hit, ref_hit)
    np.testing.assert_allclose(res["t"].numpy()[ref_hit], ref_t[ref_hit],
                               rtol=1e-4, atol=1e-5)
    tie_free = ref_hit & (res["tri"].numpy() == ref_idx)
    assert tie_free.sum() >= ref_hit.sum() - 2


def test_trace_mc_sphere_mesh():
    """MC mesh -> LBVH -> primary + shadow rays (BASELINE configs[3])."""
    from ray_tracing_octrees_tpu_torch.core.grid import (
        make_sphere_grid as t_sphere,
    )
    from ray_tracing_octrees_tpu_torch.ops import marching_cubes as tmc

    g = t_sphere(16, device="cpu")
    total = int(tmc.count_mc_triangles(g))
    verts, _, count = tmc.marching_cubes_grid(g, max_triangles=total,
                                              device="cpu")
    bvh = tl.build_lbvh(verts[: int(count)], device="cpu")
    n = 32
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    origins = np.stack([2 * np.cos(ang), np.zeros(n), 2 * np.sin(ang)],
                       -1).astype(np.float32)
    dirs = (-origins / np.linalg.norm(origins, axis=1, keepdims=True)
            ).astype(np.float32)
    res = tl.trace_lbvh(bvh, torch.as_tensor(origins), torch.as_tensor(dirs))
    assert res["hit"].all()
    np.testing.assert_allclose(res["t"].numpy(), 1.6, atol=4.5 / 16)
    light = np.array([0.0, 0.0, -10.0], np.float32)
    p = res["point"].numpy()
    sd = light[None, :] - p
    sd = sd / np.linalg.norm(sd, axis=1, keepdims=True)
    so = p + res["normal"].numpy() * 1e-3
    sres = tl.trace_lbvh(bvh, torch.as_tensor(so), torch.as_tensor(sd))
    assert sres["hit"].float().mean() > 0.4


def test_moller_trumbore_basics():
    t = lambda *v: torch.tensor(v, dtype=torch.float32)
    v0, v1, v2 = t(0.0, 0, 0), t(1.0, 0, 0), t(0.0, 1, 0)
    hit, tt, _, _ = tl.moller_trumbore(t(0.2, 0.2, 1.0), t(0.0, 0, -1.0),
                                       v0, v1, v2)
    assert bool(hit) and np.isclose(float(tt), 1.0)
    hit2, *_ = tl.moller_trumbore(t(2.0, 2.0, 1.0), t(0.0, 0, -1.0), v0, v1,
                                  v2)
    assert not bool(hit2)
