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

from ray_tracing_octrees_tpu import config as jconfig
from ray_tracing_octrees_tpu.core.grid import VoxelGrid as JGrid
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.core.octree import (
    build_linear_octree as j_tree, build_node_id_volume as j_idvol,
)
from ray_tracing_octrees_tpu.ops import dual_contouring as jd
from ray_tracing_octrees_tpu.ops import qef as jq
from ray_tracing_octrees_tpu_torch import config as tconfig
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
# non-default toggles, the same values in each package's config classes
QEF_ALT = dict(regularization=0.05, masspoint_mix=0.5)
DC_ALT = dict(max_size_ratio=4, face_fan_divisions=1)
# uniform DC's unit cells with data all take the snapping path at the
# default threshold; a stricter one sends some through the QEF
QEF_UNIFORM = dict(QEF_ALT, snap_normal_threshold=0.95)


def _cfgs(pkg, qef=None, dc=None):
    """(QEFConfig, DCConfig) of ``pkg`` (``jconfig`` or ``tconfig``)."""
    return pkg.QEFConfig(**(qef or {})), pkg.DCConfig(**(dc or {}))


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


def _rank1_sets(nrm, mask):
    """bool[C]: the sets with data whose masked normals are all parallel
    (AtA of rank 1, invertible only through the regularization)."""
    n = nrm.astype(np.float64)
    first = np.take_along_axis(n, mask.argmax(-1)[:, None, None], 1)
    parallel = np.abs(np.cross(n, first)).max(-1) == 0
    return np.where(mask, parallel, True).all(-1) & mask.any(-1)


def _rank1_gain(cfg):
    """How far ``cfg`` moves a rank-1 set's vertex against a one-ulp change
    of its sums, relative to the defaults. Along the one normal the
    adjugate's cofactors cancel from s^2 down to regularization^2, so the
    solve's gain is 1 / regularization^2; relaxation, (1 - masspoint_mix)
    and (1 - constrained_masspoint_mix) scale what it moves."""
    def gain(c):
        return (c.relaxation * (1.0 - c.masspoint_mix)
                * (1.0 - c.constrained_masspoint_mix) / c.regularization ** 2)
    return gain(cfg) / gain(tconfig.QEFConfig())


@pytest.mark.parametrize("knobs", [
    QEF_ALT, dict(regularization=0.1),
    dict(relaxation=0.4, constrained_masspoint_mix=0.3),
    dict(min_points_for_solve=5, snap_normal_threshold=0.95,
         plane_alignment_threshold=0.5, bounds_inset_factor=0.01)],
    ids=["reg-mix", "reg", "relax-cmix", "thresholds"])
def test_qef_config_close(hermite_sets, knobs):
    """``cfg`` of qef_solve and generate_dual_vertex against JAX's with
    the same non-default knobs; each set moves the output. qef_solve on
    JAX's own sums, and generate_dual_vertex, at QEF_TOL. The rank-1 sets
    (their normals all parallel) sum in another order than XLA's, and the
    solve carries that ulp by :func:`_rank1_gain`; they take
    generate_dual_vertex at QEF_TOL times that gain where it is above 1.
    Measured on their 100: 1.03e-6 at the defaults; 9.42e-6 at
    regularization 0.1 (gain 9, 9.3e-6 predicted), 3.94e-5 at 0.05 (36,
    3.7e-5) and 2.46e-5 with masspoint_mix 0.5 too (22.5, 2.3e-5)."""
    pts, nrm, mask, center, size = hermite_sets
    jcfg, _ = _cfgs(jconfig, knobs)
    tcfg, _ = _cfgs(tconfig, knobs)
    ata, atb, mp, cnt = (np.asarray(a) for a in jq.qef_accumulate(
        pts, nrm, mask))
    want = np.asarray(jax.jit(lambda *a: jq.qef_solve(*a, cfg=jcfg))(
        ata, atb, mp, cnt, center, size))
    args = (_t(ata), _t(atb), _t(mp), _t(cnt), _t(center), _t(size))
    got = tq.qef_solve(*args, cfg=tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=QEF_TOL)
    want = np.asarray(jax.jit(lambda *a: jq.generate_dual_vertex(
        *a, cfg=jcfg))(pts, nrm, mask, center, size))
    got_v = tq.generate_dual_vertex(_t(pts), _t(nrm), _t(mask), _t(center),
                                    _t(size), tcfg)
    rank1 = _rank1_sets(nrm, mask)
    assert rank1.sum() == 100            # the single points and 350-399
    np.testing.assert_allclose(got_v.numpy()[~rank1], want[~rank1], rtol=0,
                               atol=QEF_TOL)
    np.testing.assert_allclose(
        got_v.numpy()[rank1], want[rank1], rtol=0,
        atol=QEF_TOL * max(1.0, _rank1_gain(tcfg)))
    plain = tq.generate_dual_vertex(_t(pts), _t(nrm), _t(mask), _t(center),
                                    _t(size))
    assert not torch.equal(got_v, plain)


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


@pytest.mark.parametrize("dims", [(4, 4, 4), (6, 5, 7)])
def test_uniform_dc_qef_config_close(dims):
    """dual_contour_uniform's ``qef_cfg`` against JAX's, non-default: the
    same count, the bars above, and other vertices than the default's."""
    _, jg, tg = _scene(dims, 0.4, (0.0, 0.0, 0.0), 1.0)
    jcfg, _ = _cfgs(jconfig, QEF_UNIFORM)
    tcfg, _ = _cfgs(tconfig, QEF_UNIFORM)
    out = td.dual_contour_uniform(tg, 512, 4000, qef_cfg=tcfg, device="cpu")
    # JAX's jit marks only the capacities static, so a config (not an
    # array) passes through its unjitted body, compiled with it static
    j_uniform = jax.jit(jd.dual_contour_uniform.__wrapped__, static_argnames=(
        "max_cells", "max_triangles", "qef_cfg"))
    _assert_dc_close(j_uniform(jg, max_cells=512, max_triangles=4000,
                               qef_cfg=jcfg), out)
    plain = td.dual_contour_uniform(tg, 512, 4000, device="cpu")
    assert not torch.equal(out[0], plain[0])


# ---------------------------------------------------------------------------
# adaptive DC
# ---------------------------------------------------------------------------

RANDOM_SCENES = {"8x8x8": ((8, 8, 8), (1.0, -1.0, 3.0), 0.25),
                 "6x9x5": ((6, 9, 5), (1.0, -1.0, 3.0), 0.25)}


# (scene, case) pairs: fans on and off and a node mask on one scene, fans
# on the other, and the non-default QEF and DC toggles on both (each JAX
# variant compiles its own programs: ~12 s for the first on a scene, 0.2-3
# s for the others)
ADAPTIVE_CASES = [("8x8x8", "fans"), ("8x8x8", "no_fans"),
                  ("8x8x8", "masked"), ("6x9x5", "fans"),
                  ("8x8x8", "configs"), ("6x9x5", "configs")]


def _adaptive_kw(pkg, case, mask):
    """Keyword arguments of adaptive_dual_contouring for ``case``."""
    if case == "configs":
        qef, dc = _cfgs(pkg, QEF_ALT, DC_ALT)
        return dict(qef_cfg=qef, dc_cfg=dc)
    return {"fans": {}, "no_fans": dict(with_boundary_fans=False),
            "masked": dict(node_mask=mask)}[case]


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
        out[name] = dict(occ=occ, tree=tree, mask=mask, **{
            case: jd.adaptive_dual_contouring(
                jg, tree, **_adaptive_kw(jconfig, case, jnp.asarray(mask)))
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
    kw = _adaptive_kw(tconfig, case, torch.tensor(ref["mask"]))
    out = td.adaptive_dual_contouring(tg, tree, device="cpu", **kw)
    _assert_dc_close(ref[case], out)
    assert out[2] > 0
    if case == "configs":
        # the toggles change the mesh
        plain = td.adaptive_dual_contouring(tg, tree, device="cpu")
        assert plain[2] != out[2] or not torch.equal(plain[0], out[0])
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
