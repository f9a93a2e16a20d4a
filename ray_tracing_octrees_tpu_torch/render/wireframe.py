"""Octree wireframe debug geometry (the 'S'-key overlay).

Counterpart of ``ray_tracing_octrees_tpu/render/wireframe.py``, the array
port of ``generateOctreeWireframe`` (main.cpp:443-493): every octree
*leaf* whose AABB survives the frustum test (margin 50) emits its 12 box
edges as line segments; internal nodes only gate traversal. With the
linear octree this is one mask and a compaction, on the tree's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import upload
from ray_tracing_octrees_tpu_torch.core.octree import LinearOctree
from ray_tracing_octrees_tpu_torch.ops.compaction import compact_indices
from ray_tracing_octrees_tpu_torch.render.frustum import visible_node_mask
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma

# Cube corner order of getCubeCorners (main.cpp:424-441) and the 12-edge
# table (main.cpp:473-477).
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float32,
)
_EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int32,
)


def octree_wireframe(tree: LinearOctree, grid_origin, voxel_size,
                     view_proj=None, margin: float = 50.0,
                     max_lines: int = 1 << 20):
    """Line segments f32[max_lines, 2, 3] (zero past the count) and the
    line count (an int32 0-d tensor), on the tree's device.

    Only the first ``max_lines // 12`` visible leaves in node order are
    drawn, as the reference's array port caps them. A box corner is
    ``origin + index * voxel_size`` rounded once (a multiply-add), then
    plus the corner offset times the leaf's width."""
    dev = tree.device
    f32 = torch.float32
    origin, vs = (x.to(device=dev, dtype=f32) if torch.is_tensor(x) else
                  upload(np.asarray(x, np.float32), dev)
                  for x in (grid_origin, voxel_size))
    active = tree.is_leaf
    if view_proj is not None:
        active = active & visible_node_mask(tree, origin, vs,
                                            np.asarray(view_proj, np.float32),
                                            margin)
    idx, count = compact_indices(active, max(max_lines // 12, 1))
    idx = idx.long()
    xyz = torch.stack([tree.x[idx], tree.y[idx], tree.z[idx]], -1).to(f32)
    base = _fma(xyz, vs, origin[None, :])
    w = tree.size[idx].to(f32)[:, None] * vs
    corners = base[:, None, :] + upload(_CORNERS, dev)[None] * w[:, None, :]
    segs = corners[:, upload(_EDGES.astype(np.int64), dev)]  # [N, 12, 2, 3]
    segs = segs.reshape(-1, 2, 3)
    n_lines = count * 12
    valid = torch.arange(segs.shape[0], device=dev) < n_lines
    return torch.where(valid[:, None, None], segs, 0.0), n_lines
