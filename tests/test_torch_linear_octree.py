"""Port vs JAX reference: the linear octree (``core/octree.py``'s BFS half),
the grid's world helpers, the frustum's node functions and
``compact_visible_nodes``.

Inputs are made from a seed with numpy and given to both packages on the
CPU. Everything here is bitwise (measured bitwise on every case):
integer node arrays, corner-key lookups, the node-id volume, the
visibility masks and the compacted node buffer. ``grid_to_world`` and
``voxel_center`` round as one multiply-add, as the JAX package's
compiled extraction does, so they are held against the JAX helpers under
``jax.jit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tracing_octrees_tpu.core import octree as jo
from ray_tracing_octrees_tpu.core.grid import VoxelGrid as JGrid
from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.render import frustum as jf
from ray_tracing_octrees_tpu.render.camera import Camera as JCamera
from ray_tracing_octrees_tpu.trace import octree_trace as jtr
from ray_tracing_octrees_tpu_torch import convert
from ray_tracing_octrees_tpu_torch.core import octree as to
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.render import frustum as tf
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import octree_trace as ttr

torch.set_num_threads(2)

SEED = 453
# the JAX tests' dims and odd ones
DIMS = [(4, 4, 4), (8, 8, 8), (5, 7, 3), (16, 9, 12), (6, 5, 7), (13, 9, 17)]
FIELDS = [f.name for f in dataclasses.fields(to.LinearOctree)]


def _occ(dims, p=0.3, seed=SEED):
    return (np.random.default_rng(seed).random(dims) < p).astype(np.uint8)


def _assert_trees_equal(jtree, ttree):
    for name in FIELDS:
        a = np.asarray(getattr(jtree, name))
        b = getattr(ttree, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.fixture(scope="module")
def trees():
    """Both packages' trees at every dim in DIMS, by dims."""
    out = {}
    for i, dims in enumerate(DIMS):
        occ = _occ(dims, seed=SEED + i)
        out[dims] = (occ, jo.build_linear_octree(occ),
                     to.build_linear_octree(occ, device="cpu"))
    return out


@pytest.mark.parametrize("dims", DIMS)
def test_build_linear_octree_bitwise(trees, dims):
    _, jtree, ttree = trees[dims]
    _assert_trees_equal(jtree, ttree)
    assert ttree.num_nodes == jtree.num_nodes


def test_build_linear_octree_sphere_and_tensor_input():
    """The 32^3 sphere from a tensor, on the device asked for (the CPU
    here; with no device named the build goes to CUDA)."""
    g = make_sphere_grid(32, device="cpu")
    ttree = to.build_linear_octree(g.occ, device="cpu")
    assert ttree.device == torch.device("cpu")
    _assert_trees_equal(jo.build_linear_octree(j_sphere(32).occ), ttree)


@pytest.mark.parametrize("dims", [(8, 8, 8), (13, 9, 17)])
def test_find_node_and_neighbors_bitwise(trees, dims):
    _, jtree, ttree = trees[dims]
    q = np.random.default_rng(SEED).integers(-3, 20, (2000, 3))
    a = np.asarray(jtree.find_node(q[:, 0], q[:, 1], q[:, 2]))
    b = ttree.find_node(*(torch.tensor(q[:, i]) for i in range(3)))
    np.testing.assert_array_equal(b.numpy(), a)
    assert (a >= 0).any() and (a < 0).any()
    ids = np.arange(jtree.num_nodes)
    np.testing.assert_array_equal(to.get_neighbors(ttree, ids).numpy(),
                                  np.asarray(jo.get_neighbors(jtree, ids)))


@pytest.mark.parametrize("dims", [(5, 7, 3), (16, 9, 12)])
def test_node_id_volume_and_find_node_vol_bitwise(trees, dims):
    _, jtree, ttree = trees[dims]
    jvol = jo.build_node_id_volume(jtree)
    tvol = to.build_node_id_volume(ttree)
    np.testing.assert_array_equal(tvol.numpy(), np.asarray(jvol))
    q = np.random.default_rng(SEED + 1).integers(-4, 20, (3000, 3))
    a = np.asarray(jo.find_node_vol(jtree, jvol, q[:, 0], q[:, 1], q[:, 2]))
    b = to.find_node_vol(ttree, tvol, q[:, 0], q[:, 1], q[:, 2]).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dims", [(5, 7, 3), (16, 9, 12)])
@pytest.mark.parametrize("scale", ["root", "double", "odd"])
def test_node_id_volume_root_size_bitwise(trees, dims, scale):
    """``build_node_id_volume(tree, root_size=S)`` against JAX's: the
    root's own size (the default's volume), twice it, and a size that is
    not a power of two (floor(log2(S)) doubling steps)."""
    _, jtree, ttree = trees[dims]
    root = int(ttree.size[0])
    S = {"root": root, "double": 2 * root, "odd": root + 3}[scale]
    jvol = np.asarray(jo.build_node_id_volume(jtree, root_size=S))
    tvol = to.build_node_id_volume(ttree, root_size=S)
    assert tvol.dtype == torch.int32
    np.testing.assert_array_equal(tvol.numpy(), jvol)
    if scale != "double":
        assert torch.equal(tvol, to.build_node_id_volume(ttree))


def test_find_node_vol_equals_find_node_on_sphere():
    """On every leaf corner of the 32^3 sphere and on seeded queries,
    some out of the cube: the lookup volume equals the binary search
    inside the cube and gives -1 outside it."""
    ttree = to.build_linear_octree(make_sphere_grid(32, device="cpu").occ,
                                   device="cpu")
    vol = to.build_node_id_volume(ttree)
    np.testing.assert_array_equal(
        vol.numpy(), np.asarray(jo.build_node_id_volume(
            jo.build_linear_octree(j_sphere(32).occ))))
    leaf = ttree.is_leaf
    xs, ys, zs = ttree.x[leaf], ttree.y[leaf], ttree.z[leaf]
    assert torch.equal(to.find_node_vol(ttree, vol, xs, ys, zs),
                       ttree.find_node(xs, ys, zs))
    q = torch.tensor(np.random.default_rng(SEED).integers(-8, 40, (4096, 3)))
    got = to.find_node_vol(ttree, vol, q[:, 0], q[:, 1], q[:, 2])
    inside = ((q >= 0) & (q < 32)).all(1)
    assert torch.equal(got[inside], ttree.find_node(*q[inside].T))
    assert (got[~inside] == -1).all() and (~inside).any()


def test_leaf_grid_arrays_bitwise(trees):
    for dims in ((6, 5, 7), (13, 9, 17)):
        _, jtree, ttree = trees[dims]
        dxyz = dims[::-1]
        for a, b in zip(jo.leaf_grid_arrays(jtree, dxyz),
                        to.leaf_grid_arrays(ttree, dxyz)):
            np.testing.assert_array_equal(b, a)


def test_pack_key_bitwise():
    q = np.random.default_rng(SEED).integers(0, 1024, (500, 3))
    np.testing.assert_array_equal(
        to.pack_key(*(torch.tensor(q[:, i]) for i in range(3))).numpy(),
        np.asarray(jo.pack_key(q[:, 0], q[:, 1], q[:, 2])))


def test_grid_world_helpers():
    """grid_to_world / voxel_center (one multiply-add, as the JAX
    package's compiled form), scalar_field_safe, at_xyz, num_voxels."""
    occ = _occ((5, 6, 7), 0.5)
    origin, vs = (0.3, -1.7, 2.9), 0.37
    jg = JGrid.create(occ, origin=origin, voxel_size=vs)
    tg = VoxelGrid.create(occ, origin=origin, voxel_size=vs, device="cpu")
    q = np.random.default_rng(SEED).integers(-2, 9, (3, 400)).astype(np.int32)
    tq = [torch.tensor(c) for c in q]
    for name in ("grid_to_world", "voxel_center"):
        want = jax.jit(lambda x, y, z, n=name: getattr(jg, n)(x, y, z))(*q)
        np.testing.assert_array_equal(getattr(tg, name)(*tq).numpy(),
                                      np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(tg.scalar_field_safe(*tq).numpy(),
                                  np.asarray(jg.scalar_field_safe(*q)))
    ok = ((q >= 0) & (q < np.array([[7], [6], [5]]))).all(0)
    np.testing.assert_array_equal(
        tg.at_xyz(*(c[ok].long() for c in tq)).numpy(),
        np.asarray(jg.at_xyz(*(c[ok] for c in q))))
    assert tg.num_voxels == jg.num_voxels == 210


def _pose_vp(theta, phi, radius, target, aspect=1.3):
    jc, tc = JCamera(theta=theta, phi=phi, radius=radius), \
        Camera(theta=theta, phi=phi, radius=radius)
    jc.set_target(np.asarray(target, np.float32))
    tc.set_target(np.asarray(target, np.float32))
    return (jc.get_proj(aspect) @ jc.get_view()).astype(np.float32), \
        (tc.get_proj(aspect) @ tc.get_view()).astype(np.float32)


POSES = [(0.4, 1.1, 0.5, (0.3, 0.1, 0.2)), (2.0, 0.6, 0.7, (-0.2, 0.0, 0.1))]


@pytest.mark.parametrize("pose", POSES)
def test_visible_node_mask_and_compaction_bitwise(pose):
    """classify_nodes, visible_node_mask and compact_visible_nodes at a
    seeded pose that culls part of the 32^3 sphere's tree."""
    jtree = jo.build_linear_octree(j_sphere(32).occ)
    ttree = convert.linear_octree_from_numpy(jtree, device="cpu")
    origin = np.array((-0.5, -0.5, -0.5), np.float32)
    vs = np.float32(1 / 32)
    jvp, tvp = _pose_vp(*pose)
    np.testing.assert_array_equal(tvp, jvp)
    margin = 0.05
    cls_j = np.asarray(jf.classify_nodes(jtree, jnp.asarray(origin), vs,
                                         jvp, margin))
    cls_t = tf.classify_nodes(ttree, origin, vs, tvp, margin).numpy()
    np.testing.assert_array_equal(cls_t, cls_j)
    assert set(np.unique(cls_t)) == {-1, 0, 1}
    vis_j = jf.visible_node_mask(jtree, jnp.asarray(origin), vs, jvp, margin)
    vis_t = tf.visible_node_mask(ttree, origin, vs, tvp, margin)
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    jt2, jcount = jtr.compact_visible_nodes(jtree, vis_j)
    tt2, tcount = ttr.compact_visible_nodes(ttree, vis_t)
    assert int(tcount) == int(jcount) < ttree.num_nodes
    _assert_trees_equal(jt2, tt2)


def test_convert_round_trip(trees):
    _, jtree, ttree = trees[(16, 9, 12)]
    arrays = convert.linear_octree_to_numpy(ttree)
    assert set(arrays) == set(FIELDS)
    back = convert.linear_octree_from_numpy(arrays, device="cpu")
    _assert_trees_equal(jtree, back)
    _assert_trees_equal(jtree, convert.linear_octree_from_numpy(
        jtree, device="cpu"))
