"""Batched quadric-error-function dual-vertex solves.

Counterpart of ``ray_tracing_octrees_tpu/ops/qef.py``: ``QEFSolver`` and
``generateDualVertex`` (AdaptiveDualContouringRenderer.cpp:46-161,
1146-1234), vectorized: a regularized 3x3 normal-equation solve with
relaxation and masspoint mixing, after the "architectural snapping" path
that projects the cell centre onto the dominant axis plane when the mean
hermite normal is nearly axis-aligned. Everything works on fixed-size
per-cell hermite arrays (positions, normals, valid mask), so one call
solves every cell of a batch.

The 3x3 contractions are written as sums of products (no matrix
product, so no TF32 and no library summation order), and the inverse is
the adjugate, not ``torch.linalg.inv``: its determinant and its
``|inv| > 1e6`` test decide the fallback. Where the reference's compiled
form fuses a product into a multiply-add ahead of a threshold, the port
fuses it too (``_fma``).
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch.config import QEFConfig
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import norm3
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma

_DEFAULT = QEFConfig()     # the reference's constants
f32 = torch.float32


def _c(x: float) -> float:
    """A config constant rounded to f32, as the reference's weakly typed
    Python constants meet its f32 arrays."""
    return float(np.float32(x))


def _normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return v / torch.clamp(norm3(v, keepdim=True), min=eps)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim of size 3 of a * b, as the reference's
    compiled reduction rounds it (a0 b0, then two multiply-adds)."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1],
                                           a[..., 0] * b[..., 0]))


def qef_accumulate(points: torch.Tensor, normals: torch.Tensor,
                   mask: torch.Tensor):
    """(AtA f32[..., 3, 3], Atb f32[..., 3], masspoint f32[..., 3], count
    int64[...]) of masked hermite sets: points / normals f32[..., K, 3],
    mask bool[..., K]. Normals are normalized per point
    (QEFSolver::addPoint, AdaptiveDualContouringRenderer.cpp:49-75);
    d = -dot(n, p)."""
    m = mask[..., None].to(f32)
    n = _normalize(normals) * m
    p = points * m
    ata = (n[..., :, :, None] * n[..., :, None, :]).sum(-3)
    d = -_dot3(n, points)                    # n is already masked
    atb = (n * d[..., None]).sum(-2)
    count = mask.sum(-1)
    masspoint = p.sum(-2) / torch.clamp(count[..., None].to(f32), min=1.0)
    return ata, atb, masspoint, count


def _inverse_3x3(m: torch.Tensor):
    """Adjugate inverse and determinant (glm::inverse semantics)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    two = lambda p, q, r, s: _fma(p, q, -(r * s))     # p q - r s, fused
    co00 = two(e, i, f, h)
    co01 = -two(d, i, f, g)
    co02 = two(d, h, e, g)
    det = _fma(c, co02, _fma(a, co00, b * co01))
    adj = torch.stack([
        torch.stack([co00, -two(b, i, c, h), two(b, f, c, e)], -1),
        torch.stack([co01, two(a, i, c, g), -two(a, f, c, d)], -1),
        torch.stack([co02, -two(a, h, b, g), two(a, e, b, d)], -1),
    ], -2)
    return adj / det[..., None, None], det


def qef_solve(ata, atb, masspoint, count, cell_center, cell_size,
              cfg: QEFConfig = _DEFAULT) -> torch.Tensor:
    """QEFSolver::solve (AdaptiveDualContouringRenderer.cpp:84-148),
    vectorized over the leading dims: the dual position f32[..., 3].
    ``cfg``'s float knobs meet the f32 arrays rounded to f32 (``_c``)."""
    eye = torch.eye(3, dtype=f32, device=ata.device)
    inv, det = _inverse_3x3(ata + eye * _c(cfg.regularization))
    bad_inv = ((det.abs() < 1e-10) | inv.isnan().any(-1).any(-1)
               | inv.isinf().any(-1).any(-1)
               | (inv.abs() > 1e6).any(-1).any(-1))
    solution = _dot3(inv, atb[..., None, :])
    solution = _fma(solution - masspoint, _c(cfg.relaxation), masspoint)
    nan_sol = solution.isnan().any(-1)
    diff = solution - masspoint
    dist_sq = _dot3(diff, diff)
    ok = (~bad_inv & ~nan_sol & (dist_sq < cell_size * cell_size)
          & (count >= cfg.min_points_for_solve))
    mix = cfg.masspoint_mix
    mixed = _fma(solution, _c(1.0 - mix), masspoint * _c(mix))
    # numPoints == 0 -> cellCenter
    fallback = torch.where((count > 0)[..., None], masspoint, cell_center)
    return torch.where(ok[..., None], mixed, fallback)


def generate_dual_vertex(points, normals, mask, cell_center, cell_size,
                         cfg: QEFConfig = _DEFAULT) -> torch.Tensor:
    """generateDualVertex (AdaptiveDualContouringRenderer.cpp:1146-1234).

    points / normals f32[..., K, 3], mask bool[..., K], cell_center
    f32[..., 3], cell_size f32[...]. Cells with no hermite data return
    their centre.
    """
    ata, atb, masspoint, count = qef_accumulate(points, normals, mask)
    has_data = count > 0
    half = (cell_size * 0.5)[..., None]
    inset = (cell_size * _c(cfg.bounds_inset_factor))[..., None]
    min_b = cell_center - half + inset
    max_b = cell_center + half - inset

    # --- architectural snapping -------------------------------------------
    m = mask[..., None].to(f32)
    avg_n = (normals * m).sum(-2)            # unnormalized sum, as the reference
    avg_len = norm3(avg_n)
    avg_unit = avg_n / torch.clamp(avg_len[..., None], min=1e-30)
    abs_n = avg_unit.abs()
    max_comp = abs_n.amax(-1)
    # axis priority x, y, z on exact ties (the if/else chain at :1197-1206)
    is_x = abs_n[..., 0] == max_comp
    is_y = ~is_x & (abs_n[..., 1] == max_comp)
    axis_idx = torch.where(is_x, 0, torch.where(is_y, 1, 2))
    sign = torch.sign(torch.gather(avg_unit, -1, axis_idx[..., None])[..., 0])
    sign = torch.where(sign == 0, 1.0, sign)
    onehot = axis_idx[..., None] == torch.arange(3, device=axis_idx.device)
    snapped = onehot.to(f32) * sign[..., None]

    # plane points: hermite points whose unit normal aligns with the axis
    align = _dot3(_normalize(normals), snapped[..., None, :])
    plane_mask = mask & (align > cfg.plane_alignment_threshold)
    plane_count = plane_mask.sum(-1)
    plane_point = (points * plane_mask[..., None]).sum(-2) / torch.clamp(
        plane_count[..., None].to(f32), min=1.0)
    d = -_dot3(snapped, plane_point)
    t = -(_dot3(snapped, cell_center) + d)
    projected = _fma(t[..., None], snapped, cell_center)
    projected = torch.minimum(torch.maximum(projected, min_b), max_b)
    snap_ok = (has_data & (avg_len > 1e-4)
               & (max_comp > cfg.snap_normal_threshold) & (plane_count > 0))

    # --- constrained QEF ----------------------------------------------------
    qef_center = 0.5 * (min_b + max_b)
    qef_size = (max_b - min_b)[..., 0]
    sol = qef_solve(ata, atb, masspoint, count, qef_center, qef_size, cfg)
    sol = torch.minimum(torch.maximum(sol, min_b), max_b)
    cmix = cfg.constrained_masspoint_mix
    qef_result = _fma(sol, _c(1.0 - cmix), masspoint * _c(cmix))
    out = torch.where(snap_ok[..., None], projected, qef_result)
    return torch.where(has_data[..., None], out, cell_center)
