"""Port vs JAX reference: Marching Cubes (``ops/marching_cubes.py``,
``ops/mc_tables.py``), voxel blocks (``ops/blocks.py``), the stream
compaction (``ops/compaction.py``) and the two renderers of
``models/extraction.py``.

Inputs are made from a seed with numpy and given to both packages on the
CPU. Every comparison is bitwise, triangles in the JAX package's order
(measured bitwise on every case): on the +-1 field every MC vertex is an
exact midpoint and every block corner exact; on non-dyadic placements
and on the seeded scalar field of ``marching_cubes_volume`` the port
rounds the products the JAX package's compiled form fuses as one
multiply-add (``raymarch._fma``), and equals it there too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import VoxelGrid as JGrid
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.core.octree import build_linear_octree as j_tree
from ray_tracing_octrees_tpu.models import extraction as jx
from ray_tracing_octrees_tpu.ops import blocks as jb
from ray_tracing_octrees_tpu.ops import compaction as jcomp
from ray_tracing_octrees_tpu.ops import marching_cubes as jm
from ray_tracing_octrees_tpu.ops import mc_tables as jt
from ray_tracing_octrees_tpu.render.camera import Camera as JCamera
from ray_tracing_octrees_tpu.render.frustum import visible_cell_mask as j_vcm
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.core.octree import build_linear_octree
from ray_tracing_octrees_tpu_torch.models import extraction as tx
from ray_tracing_octrees_tpu_torch.ops import blocks as tb
from ray_tracing_octrees_tpu_torch.ops import compaction as tcomp
from ray_tracing_octrees_tpu_torch.ops import marching_cubes as tm
from ray_tracing_octrees_tpu_torch.ops import mc_tables as tt
from ray_tracing_octrees_tpu_torch.render.camera import Camera

torch.set_num_threads(2)

SEED = 453
# (dims zyx, origin, voxel size): the JAX tests' placements and a
# non-dyadic one
SCENES = [((4, 4, 4), (0.0, 0.0, 0.0), 1.0),
          ((6, 5, 7), (-1.0, 2.0, 0.5), 0.25),
          ((8, 8, 8), (-2.0, 1.0, 4.0), 0.5),
          ((9, 11, 7), (-3.7, 11.1, 0.9), 1.7)]


def _occ(dims, p, seed=SEED):
    return (np.random.default_rng(seed).random(dims) < p).astype(np.uint8)


def _grids(occ, origin, vs):
    return (JGrid.create(occ, origin=origin, voxel_size=vs),
            VoxelGrid.create(occ, origin=origin, voxel_size=vs, device="cpu"))


def _assert_soup_equal(j_out, t_out):
    jv, jn, jc = j_out
    tv, tn, tc = t_out
    assert int(tc) == int(jc)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_tables_are_the_reference_package_tables():
    for name in ("TRI_TABLE", "TRI_COUNTS", "EDGE_CORNERS", "CORNER_OFFSETS",
                 "EDGE_TABLE", "TRI_EDGES"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert tt.MAX_TRIS_PER_CELL == jt.MAX_TRIS_PER_CELL == 5


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: "x".join(map(str, s[0])))
def test_marching_cubes_grid_bitwise(scene):
    dims, origin, vs = scene
    jg, tg = _grids(_occ(dims, 0.4), origin, vs)
    _assert_soup_equal(jm.marching_cubes_grid(jg, 3000),
                       tm.marching_cubes_grid(tg, 3000, device="cpu"))
    assert int(tm.count_mc_triangles(tg)) == int(jm.count_mc_triangles(jg))


def test_marching_cubes_sphere_mask_and_truncation_bitwise():
    """The 32^3 sphere whole, with a seeded cell mask, and truncated to
    half its triangles (rows past the cap dropped, count == cap)."""
    jg, tg = j_sphere(32), make_sphere_grid(32, device="cpu")
    total = int(jm.count_mc_triangles(jg))
    assert int(tm.count_mc_triangles(tg)) == total > 1000
    _assert_soup_equal(jm.marching_cubes_grid(jg, total + 16),
                       tm.marching_cubes_grid(tg, total + 16, device="cpu"))
    mask = np.random.default_rng(SEED).random((31, 31, 31)) < 0.5
    _assert_soup_equal(
        jm.marching_cubes_grid(jg, total, cell_mask=jnp.asarray(mask)),
        tm.marching_cubes_grid(tg, total, cell_mask=torch.tensor(mask),
                               device="cpu"))
    cut = tm.marching_cubes_grid(tg, total // 2, device="cpu")
    assert int(cut[2]) == total // 2
    _assert_soup_equal(jm.marching_cubes_grid(jg, total // 2), cut)


def test_marching_cubes_volume_bitwise():
    """A seeded scalar field with true interpolation, and the JAX test's
    smooth SDF sphere."""
    rng = np.random.default_rng(SEED)
    field = rng.standard_normal((10, 12, 9)).astype(np.float32)
    args = ((0.1, 0.2, 0.3), 0.37, 0.1, 4000)
    _assert_soup_equal(jm.marching_cubes_volume(field, *args),
                       tm.marching_cubes_volume(field, *args, device="cpu"))
    idx = np.arange(24, dtype=np.float32)
    zz, yy, xx = np.meshgrid(idx, idx, idx, indexing="ij")
    sdf = np.sqrt((xx - 11.5) ** 2 + (yy - 11.5) ** 2 + (zz - 11.5) ** 2) - 7
    out = tm.marching_cubes_volume(sdf, (0, 0, 0), 1.0, 0.0, 20000,
                                   device="cpu")
    _assert_soup_equal(jm.marching_cubes_volume(sdf, (0, 0, 0), 1.0, 0.0,
                                                20000), out)
    assert int(out[2]) > 100


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: "x".join(map(str, s[0])))
def test_block_faces_bitwise(scene):
    dims, origin, vs = scene
    occ = _occ(dims, 0.45)
    jg, tg = _grids(occ, origin, vs)
    jtree = j_tree(occ)
    ttree = build_linear_octree(occ, device="cpu")
    _assert_soup_equal(jb.extract_block_faces(jg, jtree, 3000),
                       tb.extract_block_faces(tg, ttree, 3000, device="cpu"))
    mask = np.random.default_rng(SEED).random(jtree.num_nodes) < 0.5
    _assert_soup_equal(
        jb.extract_block_faces(jg, jtree, 3000, node_mask=jnp.asarray(mask)),
        tb.extract_block_faces(tg, ttree, 3000, node_mask=torch.tensor(mask),
                               device="cpu"))
    assert int(tb.count_block_triangles(tg, ttree)) == \
        int(jb.count_block_triangles(jg, jtree))


def test_blocks_sphere_bitwise_and_truncated():
    jg, tg = j_sphere(32), make_sphere_grid(32, device="cpu")
    jtree = j_tree(jg.occ)
    ttree = convert.linear_octree_from_numpy(jtree, device="cpu")
    total = int(jb.count_block_triangles(jg, jtree))
    assert int(tb.count_block_triangles(tg, ttree)) == total > 1000
    _assert_soup_equal(jb.extract_block_faces(jg, jtree, total),
                       tb.extract_block_faces(tg, ttree, total, device="cpu"))
    _assert_soup_equal(jb.extract_block_faces(jg, jtree, 101),
                       tb.extract_block_faces(tg, ttree, 101, device="cpu"))


def _bench_like_vp(radius):
    """A 16:9 view-projection at the bench angles around the origin."""
    out = []
    for cls in (JCamera, Camera):
        cam = cls(theta=0.9, phi=0.8, radius=radius)
        out.append((cam.get_proj(16 / 9) @ cam.get_view()).astype(np.float32))
    np.testing.assert_array_equal(out[0], out[1])
    return out[1]


@pytest.mark.parametrize("margin", [50.0, 0.05])
def test_renderers_bitwise(margin):
    """MarchingCubesRenderer and VoxelBlockRenderer, unculled and culled
    at a view-projection (the config's margin 50, and a margin that culls
    the 32^3 sphere's cells and nodes)."""
    from ray_tracing_octrees_tpu.config import EngineConfig as JCfg
    from ray_tracing_octrees_tpu_torch.config import EngineConfig as TCfg

    jg, tg = j_sphere(32), make_sphere_grid(32, device="cpu")
    jtree = j_tree(jg.occ)
    ttree = build_linear_octree(tg.occ, device="cpu")
    vp = _bench_like_vp(0.6)
    jcfg = JCfg().replace(extraction_frustum_margin=margin,
                          max_triangles=20000)
    tcfg = TCfg().replace(extraction_frustum_margin=margin,
                          max_triangles=20000)
    jmc, tmc = jx.MarchingCubesRenderer(jcfg), \
        tx.MarchingCubesRenderer(tcfg, device="cpu")
    jvb, tvb = jx.VoxelBlockRenderer(jcfg), \
        tx.VoxelBlockRenderer(tcfg, device="cpu")
    full_mc = tmc.render(tg)
    _assert_soup_equal(jmc.render(jg), full_mc)
    culled_mc = tmc.render(tg, vp)
    _assert_soup_equal(jmc.render(jg, jnp.asarray(vp)), culled_mc)
    full_b = tvb.render(tg, ttree)
    _assert_soup_equal(jvb.render(jg, jtree), full_b)
    culled_b = tvb.render(tg, ttree, vp)
    _assert_soup_equal(jvb.render(jg, jtree, jnp.asarray(vp)), culled_b)
    assert int(tmc.count(tg)) == int(full_mc[2])
    assert int(tvb.count(tg, ttree)) == int(full_b[2])
    if margin < 1:
        assert int(culled_mc[2]) < int(full_mc[2])
        assert int(culled_b[2]) < int(full_b[2])
    cells = j_vcm(jg.occ.shape, jg.origin, jg.voxel_size, jnp.asarray(vp),
                  margin)
    assert int(culled_mc[2]) == int(jm.marching_cubes_grid(
        jg, 20000, cell_mask=cells)[2])


def test_compaction_bitwise():
    mask = np.random.default_rng(SEED).random((7, 9)) < 0.3
    data = np.arange(7 * 9 * 2, dtype=np.float32).reshape(7, 9, 2)
    for cap in (5, 63, 80):
        ji, jc = jcomp.compact_indices(jnp.asarray(mask), cap)
        ti, tc = tcomp.compact_indices(torch.tensor(mask), cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert int(tc) == int(jc)
        jr, jrc = jcomp.compact_rows(jnp.asarray(data), jnp.asarray(mask), cap)
        tr, trc = tcomp.compact_rows(torch.tensor(data), torch.tensor(mask),
                                     cap)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert int(trc) == int(jrc)
