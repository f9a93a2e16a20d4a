"""Port vs JAX reference: the QEF solve (``ops/qef.py``) and dual
contouring (``ops/dual_contouring.py``), uniform and adaptive.

Inputs are made from a seed with numpy and given to both packages on the
CPU; the adaptive cases give both packages the same tree (the JAX tree
carried over by ``convert.linear_octree_from_numpy``), which isolates DC
from the build. The JAX functions run compiled (``jax.jit``, as its
extraction does), so both sides fuse the same products into multiply-adds.

Bars, with what this suite measured:
- hermite data (``edge_hermite``, ``gather_cell_hermite``) and
  ``cell_contains_surface``: bitwise (measured bitwise);
- ``qef_accumulate``: AtA, Atb and the masspoint within 2e-6 relative
  (measured 9.5e-7 absolute on values up to 8: the sums over the K
  hermite points run in another order than XLA's; the counts equal);
- ``qef_solve``, ``generate_dual_vertex``: within 2e-6 (measured 5.4e-7
  and 2.8e-7);
- DC, uniform and adaptive: equal triangle counts on every scene, the
  triangles in JAX's order, vertices within 2e-6 (measured 4.8e-7 on
  coordinates up to 5, 1 ulp of the QEF's sums) and normals within 2e-4
  (measured 6.3e-5, on slivers, where a vertex's last bit turns the
  face).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import VoxelGrid as JGrid
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.core.octree import (
    build_linear_octree as j_tree, build_node_id_volume as j_idvol,
)
from ray_tracing_octrees_tpu.ops import dual_contouring as jd
from ray_tracing_octrees_tpu.ops import qef as jq
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.core.octree import (
    build_linear_octree, build_node_id_volume,
)
from ray_tracing_octrees_tpu_torch.ops import dual_contouring as td
from ray_tracing_octrees_tpu_torch.ops import qef as tq

torch.set_num_threads(2)

SEED = 453
V_TOL = 2e-6      # vertices (measured 4.8e-7)
N_TOL = 2e-4      # normals (measured 6.3e-5)
QEF_TOL = 2e-6    # QEF outputs (measured up to 9.5e-7)


def _t(a):
    return torch.tensor(np.array(a))


def _assert_dc_close(j_out, t_out):
    """Equal counts, JAX's order, vertices and normals within the bars;
    returns the largest differences."""
    jv, jn, jc = j_out
    tv, tn, tc = t_out
    c = int(jc)
    assert int(tc) == c
    jv, jn = np.asarray(jv)[:c], np.asarray(jn)[:c]
    tv, tn = tv[:c].numpy(), tn[:c].numpy()
    dv = float(np.abs(tv - jv).max()) if c else 0.0
    dn = float(np.abs(tn - jn).max()) if c else 0.0
    assert dv <= V_TOL, dv
    assert dn <= N_TOL, dn
    return dv, dn


# ---------------------------------------------------------------------------
# QEF
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hermite_sets():
    """Seeded hermite sets, C cells of K points: random ones, empty ones,
    single points, axis-aligned normals (the snapping path) and
    near-singular ones (every normal in one plane or equal)."""
    rng = np.random.default_rng(SEED)
    C, K = 600, 24
    pts = rng.standard_normal((C, K, 3)).astype(np.float32)
    nrm = rng.standard_normal((C, K, 3)).astype(np.float32)
    mask = rng.random((C, K)) < 0.3
    mask[:50] = False                                # empty
    mask[50:100] = False
    mask[50:100, 3] = True                           # a single point
    nrm[100:250] = np.round(nrm[100:250])            # axis-aligned-ish
    nrm[100:250, :, 0] += 0.05
    nrm[250:350, :, 2] = 0.0                         # normals in a plane
    nrm[350:400] = nrm[350:400, :1]                  # all one normal
    center = rng.standard_normal((C, 3)).astype(np.float32)
    size = (rng.random(C) * 2 + 0.1).astype(np.float32)
    return pts, nrm, mask, center, size


def test_qef_accumulate_close(hermite_sets):
    pts, nrm, mask, _, _ = hermite_sets
    jo = jax.jit(jq.qef_accumulate)(pts, nrm, mask)
    to = tq.qef_accumulate(_t(pts), _t(nrm), _t(mask))
    for a, b in zip(jo[:3], to[:3]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=QEF_TOL,
                                   atol=QEF_TOL)
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))


def test_qef_solve_and_dual_vertex_close(hermite_sets):
    pts, nrm, mask, center, size = hermite_sets
    ata, atb, mp, cnt = (np.asarray(a) for a in jq.qef_accumulate(
        pts, nrm, mask))
    want = np.asarray(jax.jit(jq.qef_solve)(ata, atb, mp, cnt, center, size))
    got = tq.qef_solve(_t(ata), _t(atb), _t(mp), _t(cnt), _t(center),
                       _t(size)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=QEF_TOL)
    want = np.asarray(jax.jit(jq.generate_dual_vertex)(pts, nrm, mask,
                                                       center, size))
    got = tq.generate_dual_vertex(_t(pts), _t(nrm), _t(mask), _t(center),
                                  _t(size)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=QEF_TOL)
    # cells with no hermite data return their centre, exactly
    np.testing.assert_array_equal(got[:50], center[:50])


def test_inverse_3x3_is_the_adjugate():
    m = np.random.default_rng(SEED).standard_normal((200, 3, 3)).astype(
        np.float32)
    m[:20] = np.outer([1, 2, 3], [1, 1, 1]).astype(np.float32)    # singular
    inv, det = tq._inverse_3x3(_t(m))
    jinv, jdet = jax.jit(jq._inverse_3x3)(m)
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    np.testing.assert_array_equal(inv.numpy()[20:], np.asarray(jinv)[20:])
    assert (det[:20] == 0).all() and not torch.isfinite(inv[:20]).any()


# ---------------------------------------------------------------------------
# hermite data and surface classification
# ---------------------------------------------------------------------------

def _scene(dims, p, origin, vs, seed=SEED):
    occ = (np.random.default_rng(seed).random(dims) < p).astype(np.uint8)
    return (occ, JGrid.create(occ, origin=origin, voxel_size=vs),
            VoxelGrid.create(occ, origin=origin, voxel_size=vs, device="cpu"))


def test_hermite_data_bitwise():
    _, jg, tg = _scene((7, 6, 8), 0.5, (-1.0, 0.5, 2.0), 0.37)
    q = np.random.default_rng(SEED).integers(-1, 9, (3, 300)).astype(np.int32)
    for axis in range(3):
        want = jax.jit(lambda x, y, z, a=axis: jd.edge_hermite(
            jg, x, y, z, a))(*q)
        got = td.edge_hermite(tg, *(_t(c) for c in q), axis)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    c = np.random.default_rng(SEED + 1).integers(0, 6, (3, 40)).astype(
        np.int32)
    for size, stride in ((1, 1), (2, 1), (4, 1), (8, 2)):
        want = jax.jit(lambda x, y, z, s=size, st=stride:
                       jd.gather_cell_hermite(jg, x, y, z, s, st))(*c)
        got = td.gather_cell_hermite(tg, *(_t(v) for v in c), size, stride)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_cell_contains_surface_bitwise():
    _, jg, tg = _scene((8, 8, 8), 0.3, (0.0, 0.0, 0.0), 1.0)
    coords = np.random.default_rng(SEED).integers(-2, 9, (3, 60)).astype(
        np.int32)
    for size in (1, 2, 4, 8):
        want = np.asarray(jd.cell_contains_surface(jg, *coords, size))
        got = td.cell_contains_surface(tg, *(_t(c) for c in coords), size)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# uniform DC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(4, 4, 4), (6, 5, 7)])
def test_uniform_dc_close(dims):
    _, jg, tg = _scene(dims, 0.4, (0.0, 0.0, 0.0), 1.0)
    _assert_dc_close(jd.dual_contour_uniform(jg, max_cells=512,
                                             max_triangles=4000),
                     td.dual_contour_uniform(tg, 512, 4000, device="cpu"))


def test_uniform_dc_sphere_and_capacity():
    jg, tg = j_sphere(16), make_sphere_grid(16, device="cpu")
    out = td.dual_contour_uniform(tg, 4096, 20000, device="cpu")
    _assert_dc_close(jd.dual_contour_uniform(jg, max_cells=4096,
                                             max_triangles=20000), out)
    assert int(out[2]) > 100
    # capacities that truncate the active cells and the triangles
    _assert_dc_close(jd.dual_contour_uniform(jg, max_cells=700,
                                             max_triangles=900),
                     td.dual_contour_uniform(tg, 700, 900, device="cpu"))


# ---------------------------------------------------------------------------
# adaptive DC
# ---------------------------------------------------------------------------

RANDOM_SCENES = {"8x8x8": ((8, 8, 8), (1.0, -1.0, 3.0), 0.25),
                 "6x9x5": ((6, 9, 5), (1.0, -1.0, 3.0), 0.25)}


# (scene, case) pairs: fans on and off and a node mask on one scene, fans
# on the other (each JAX variant compiles its own programs: ~12 s for the
# first on a scene, 0.2-3 s for the others)
ADAPTIVE_CASES = [("8x8x8", "fans"), ("8x8x8", "no_fans"),
                  ("8x8x8", "masked"), ("6x9x5", "fans")]


@pytest.fixture(scope="module")
def adaptive_jax():
    """The JAX package's adaptive extractions, once per module (its
    compile dominates): ADAPTIVE_CASES, and the 64^3 sphere through the
    node-id volume."""
    out = {}
    for i, (name, (dims, origin, vs)) in enumerate(RANDOM_SCENES.items()):
        occ, jg, _ = _scene(dims, 0.35, origin, vs, seed=SEED + i)
        tree = j_tree(occ)
        mask = np.random.default_rng(SEED + i).random(tree.num_nodes) < 0.7
        kws = {"fans": {}, "no_fans": dict(with_boundary_fans=False),
               "masked": dict(node_mask=jnp.asarray(mask))}
        out[name] = dict(occ=occ, tree=tree, mask=mask, **{
            case: jd.adaptive_dual_contouring(jg, tree, **kws[case])
            for n, case in ADAPTIVE_CASES if n == name})
    jg = j_sphere(64)
    tree = j_tree(jg.occ)
    out["sphere64"] = dict(tree=tree, fans=jd.adaptive_dual_contouring(
        jg, tree, node_id_vol=j_idvol(tree), tree_meta=jd.tree_host_meta(tree)))
    return out


@pytest.mark.parametrize("name,case", ADAPTIVE_CASES)
def test_adaptive_dc_close(adaptive_jax, name, case):
    ref = adaptive_jax[name]
    dims, origin, vs = RANDOM_SCENES[name]
    tg = VoxelGrid.create(ref["occ"], origin=origin, voxel_size=vs,
                          device="cpu")
    tree = convert.linear_octree_from_numpy(ref["tree"], device="cpu")
    kw = {"fans": {}, "no_fans": dict(with_boundary_fans=False),
          "masked": dict(node_mask=torch.tensor(ref["mask"]))}[case]
    out = td.adaptive_dual_contouring(tg, tree, device="cpu", **kw)
    _assert_dc_close(ref[case], out)
    assert out[2] > 0
    # the node-id volume's lookups give the same triangles
    again = td.adaptive_dual_contouring(
        tg, tree, node_id_vol=build_node_id_volume(tree), device="cpu", **kw)
    assert again[2] == out[2]
    assert torch.equal(again[0], out[0]) and torch.equal(again[1], out[1])


def test_adaptive_dc_sphere64(adaptive_jax):
    """The 64^3 sphere (14 319 triangles): the port's own build and both
    lookups, the host metadata, and the device-out rows."""
    ref = adaptive_jax["sphere64"]
    tg = make_sphere_grid(64, device="cpu")
    tree = build_linear_octree(tg.occ, device="cpu")
    plain = td.adaptive_dual_contouring(tg, tree, device="cpu")
    _assert_dc_close(ref["fans"], plain)
    assert plain[2] == int(ref["fans"][2]) == 14319
    vol = build_node_id_volume(tree)
    fast = td.adaptive_dual_contouring(
        tg, tree, node_id_vol=vol, tree_meta=td.tree_host_meta(tree),
        device="cpu", device_out=True)
    assert fast[2] == plain[2]
    assert torch.equal(fast[0], plain[0]) and torch.equal(fast[1], plain[1])
    n = fast[1]
    np.testing.assert_allclose(torch.linalg.vector_norm(n, dim=-1).numpy(),
                               1.0, atol=1e-4)
