"""View-frustum plane extraction and AABB classification.

Counterpart of ``ray_tracing_octrees_tpu/render/frustum.py`` (the array
port of ``Frustum``, Frustum.cpp:5-93): Gribb-Hartmann planes from the
combined view-projection matrix and the p/n-vertex AABB test returning
-1 (outside), 0 (intersecting) or 1 (inside), with the reference's
inflate margin. ``classify_nodes`` and ``visible_node_mask`` need the
linear octree, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device


def frustum_planes(view_proj, device: DeviceLike = None) -> torch.Tensor:
    """Six normalized planes f32[6, 4] (L, R, B, T, N, F) from row-major VP.

    The reference indexes glm column-major (viewProj[c][r]); with
    row-major M this is rows: left = row3 + row0, right = row3 - row0, ...
    """
    m = torch.as_tensor(np.asarray(view_proj, np.float32),
                        device=resolve_device(device))
    r0, r1, r2, r3 = m[0], m[1], m[2], m[3]
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r3 + r2,
                          r3 - r2], dim=0)
    norm = torch.linalg.norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.clamp(norm, min=1e-30)


def test_aabb(planes: torch.Tensor, box_min, box_max,
              margin: float = 0.0) -> torch.Tensor:
    """Classify AABBs: 1 inside, 0 intersecting, -1 outside (int32), over
    the leading box dims, as Frustum::testAABB (Frustum.cpp:52-93) with
    its expansion margin."""
    f32 = torch.float32
    box_min = torch.as_tensor(box_min, dtype=f32, device=planes.device) - margin
    box_max = torch.as_tensor(box_max, dtype=f32, device=planes.device) + margin
    n_xyz = planes[:, :3]
    d = planes[:, 3]
    pos = n_xyz > 0
    # p-vertex: furthest along the normal; n-vertex: nearest
    p = torch.where(pos, box_max[..., None, :], box_min[..., None, :])
    n = torch.where(pos, box_min[..., None, :], box_max[..., None, :])
    p_dist = (p * n_xyz).sum(-1) + d
    n_dist = (n * n_xyz).sum(-1) + d
    outside = (p_dist < 0).any(-1)
    intersecting = (n_dist < 0).any(-1)
    return torch.where(outside, -1, torch.where(intersecting, 0, 1)).to(
        torch.int32)


def visible_cell_mask(dims_zyx, grid_origin, voxel_size, view_proj, margin,
                      device: DeviceLike = None) -> torch.Tensor:
    """Per-MC-cell visibility bool[Z-1, Y-1, X-1]: cell (x, y, z) spans
    world [origin + p * vs, origin + (p + 1) * vs]; conservative against
    the reference's leaf-level culling (never drops a visible cell)."""
    f32 = torch.float32
    dz, dy, dx = dims_zyx
    planes = frustum_planes(view_proj, device)
    dev = planes.device
    origin = torch.as_tensor(np.asarray(grid_origin, np.float32), device=dev)
    vs = float(voxel_size)
    xs = origin[0] + torch.arange(dx - 1, dtype=f32, device=dev) * vs
    ys = origin[1] + torch.arange(dy - 1, dtype=f32, device=dev) * vs
    zs = origin[2] + torch.arange(dz - 1, dtype=f32, device=dev) * vs
    zg, yg, xg = torch.meshgrid(zs, ys, xs, indexing="ij")
    lo = torch.stack([xg, yg, zg], dim=-1)
    return test_aabb(planes, lo, lo + vs, margin) >= 0
