"""LBVH construction and wavefront ray-triangle tracing.

Counterpart of ``ray_tracing_octrees_tpu/trace/lbvh.py``, the exact
general-mesh tracer and the oracle of the Marching-Cubes mesh tracer
(:mod:`.mesh_grid`). Build: quantize triangle centroids to a 30-bit
Morton lattice over the scene AABB and sort them (stably, as the
reference's argsort); Karras 2012 internal-node ranges and splits from
common-prefix lengths (ties broken by index) give the left, right and
parent pointers; a bottom-up AABB refit and top-down escape links run a
fixed number of parent sweeps, the reference's count, so a tree deeper
than the count comes out as the reference's does. Trace: a stackless
escape-link traversal with slab AABB tests and Moller-Trumbore, over a
wavefront of rays.

Rounding follows the reference's compiled form where it decides a bit:
the centroid is the sum of the three vertices times the f32 reciprocal
of 3 (XLA rewrites the mean's division so), and the cross and dot
products of Moller-Trumbore and of the normal are multiply-adds
(``ops/marching_cubes.cross3`` and :func:`_dot3`). The reference's
``while_loop`` tests for a live ray every step; here the test, a host
sync, runs every ``_CHECK_EVERY`` steps and compacts to the live rays.
A ray whose node has reached -1 never changes, so the output is the
same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.core.morton import (
    morton_encode_10, quantize_to_morton_grid,
)
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import (
    cross3, unit_normals,
)
from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
    _degenerate_axes, _safe_inv, _slab,
)
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _cdiv

_BIG = 1e30
# live-ray check period of trace_lbvh: one host sync a check
_CHECK_EVERY = 8

i32, i64, f32 = torch.int32, torch.int64, torch.float32


@dataclasses.dataclass(frozen=True)
class LBVH:
    """Flat LBVH arrays. N leaves (sorted triangles), N-1 internal nodes.

    Node ids: internal nodes are [0, N-2] (root = 0), leaves are
    [N-1, 2N-2] (leaf i holds sorted triangle i - (N-1)).
    """

    tri_verts: torch.Tensor     # f32[N, 3, 3] in sorted leaf order
    tri_index: torch.Tensor     # int32[N] original triangle ids
    left: torch.Tensor          # int32[2N-1]; -1 for leaves
    right: torch.Tensor         # int32[2N-1]
    parent: torch.Tensor        # int32[2N-1]; -1 at root
    escape: torch.Tensor        # int32[2N-1]; next node when skipping; -1 ends
    aabb_min: torch.Tensor      # f32[2N-1, 3]
    aabb_max: torch.Tensor      # f32[2N-1, 3]

    @property
    def num_tris(self) -> int:
        return self.tri_verts.shape[0]


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the low 32 bits of non-negative int64 ``x``."""
    n = torch.full(x.shape, 32, dtype=i64, device=x.device)
    cur = x
    for s in (16, 8, 4, 2, 1):
        has = (cur >> s) != 0
        n = torch.where(has, n - s, n)
        cur = torch.where(has, cur >> s, cur)
    return n - (cur != 0).to(i64)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the last dim of size 3 as the reference's compiled
    reduction rounds it: a0 b0, then two multiply-adds."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return _fma(a2, b2, _fma(a1, b1, a0 * b0))


def centroids(tri_verts: torch.Tensor) -> torch.Tensor:
    """The reference's ``tri_verts.mean(axis=1)`` as its compiled form
    rounds it: (v0 + v1) + v2 times the f32 reciprocal of 3."""
    return _cdiv(tri_verts[:, 0] + tri_verts[:, 1] + tri_verts[:, 2], 3.0)


def build_lbvh(tri_verts, device: DeviceLike = None) -> LBVH:
    """LBVH over a triangle soup f32[N, 3, 3] (N >= 2), on ``device``."""
    dev = resolve_device(device)
    tv = (tri_verts if torch.is_tensor(tri_verts) else torch.from_numpy(
        np.array(tri_verts, np.float32))).to(device=dev, dtype=f32)
    n = tv.shape[0]
    flat = tv.reshape(-1, 3)
    lo, hi = flat.amin(0), flat.amax(0)
    codes = morton_encode_10(*quantize_to_morton_grid(centroids(tv), lo, hi))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    tri_sorted = tv[order]

    def delta(i, j):
        """Common-prefix length; -1 out of range; index tiebreak (Karras)."""
        ok = (j >= 0) & (j < n)
        jc = j.clamp(0, n - 1)
        x = codes[i] ^ codes[jc]
        d = torch.where(x == 0, _clz32(i ^ jc) + 32, _clz32(x))
        return torch.where(ok, d, -1)

    # Karras internal nodes, vectorized over i in [0, n-2]
    i = torch.arange(n - 1, dtype=i64, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(i, i - d)
    n_rounds = max(2, int(np.ceil(np.log2(n))) + 2)

    # exponential upper bound for the range length
    l_max = torch.full((n - 1,), 2, dtype=i64, device=dev)
    for _ in range(n_rounds):
        l_max = torch.where(delta(i, i + l_max * d) > delta_min, l_max * 2,
                            l_max)
    # binary search of the exact length
    l = torch.zeros(n - 1, dtype=i64, device=dev)
    t = l_max // 2
    for _ in range(n_rounds + 1):
        go = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = torch.where(go, l + t, l)
        t = t // 2
    j = i + l * d

    # split position: highest differing bit within [i, j]
    delta_node = delta(i, j)
    s = torch.zeros(n - 1, dtype=i64, device=dev)
    t = (l + 1) // 2
    for _ in range(n_rounds + 1):
        go = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = torch.where(go, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp(d, max=0)

    leaf_base = n - 1
    left = torch.where(torch.minimum(i, j) == gamma, leaf_base + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1,
                        leaf_base + gamma + 1, gamma + 1)

    total = 2 * n - 1
    left_full = torch.full((total,), -1, dtype=i64, device=dev)
    left_full[: n - 1] = left
    right_full = torch.full((total,), -1, dtype=i64, device=dev)
    right_full[: n - 1] = right
    # each node is the child of one parent: the scatters write distinct
    # indices, so they are deterministic
    parent = torch.full((total,), -1, dtype=i64, device=dev)
    parent.index_copy_(0, left, i)
    parent.index_copy_(0, right, i)

    # AABBs: leaves, then a fixed number of refit sweeps
    amin = torch.full((total, 3), _BIG, dtype=f32, device=dev)
    amax = torch.full((total, 3), -_BIG, dtype=f32, device=dev)
    amin[leaf_base:] = tri_sorted.amin(1)
    amax[leaf_base:] = tri_sorted.amax(1)
    depth = max(2, int(np.ceil(np.log2(max(n, 2)))) * 2 + 8)
    for _ in range(depth):
        new_min = torch.minimum(amin[left], amin[right])
        new_max = torch.maximum(amax[left], amax[right])
        amin[: n - 1] = new_min
        amax[: n - 1] = new_max

    # escape links: escape(left) = right, escape(right) = escape(parent)
    escape = torch.full((total,), -1, dtype=i64, device=dev)
    escape.index_copy_(0, left, right)
    par_c = parent.clamp(0, total - 1)
    is_right = (parent >= 0) & (right_full[par_c]
                                == torch.arange(total, device=dev))
    for _ in range(depth):
        escape = torch.where(is_right, escape[par_c], escape)

    return LBVH(tri_verts=tri_sorted, tri_index=order.to(i32),
                left=left_full.to(i32), right=right_full.to(i32),
                parent=parent.to(i32), escape=escape.to(i32),
                aabb_min=amin, aabb_max=amax)


def moller_trumbore(ro, rd, v0, v1, v2, eps: float = 1e-7):
    """Ray-triangle intersection over the last dim: (hit, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross3(rd, e2)
    det = _dot3(e1, pvec)
    ok = det.abs() > eps
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = ro - v0
    u = _dot3(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = _dot3(rd, qvec) * inv_det
    t = _dot3(e2, qvec) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps)
    return hit, t, u, v


def trace_lbvh(bvh: LBVH, origins: torch.Tensor, directions: torch.Tensor,
               max_steps: int = 2048) -> dict:
    """Nearest-hit wavefront trace via stackless escape-link traversal, on
    the tree's device.

    ``origins`` / ``directions`` f32[R, 3]. Returns dict(hit, t, tri
    (original index, -1 on miss), point, normal (geometric,
    normalize(cross(e1, e2)))), plus host ints ``steps`` (traversal
    steps run), ``syncs`` (host syncs: the live-ray checks) and
    ``compactions``.
    """
    dev = bvh.tri_verts.device
    n = bvh.num_tris
    leaf_base = n - 1
    origins = torch.as_tensor(origins, dtype=f32).to(dev)
    directions = torch.as_tensor(directions, dtype=f32).to(dev)
    r = origins.shape[0]
    left = bvh.left.to(i64)
    escape = bvh.escape.to(i64)

    # full-width state; the live rows' copies below, indexed by ``idx``
    node_f = torch.zeros(r, dtype=i64, device=dev)
    if n == 0:
        node_f.fill_(-1)
    t_f = torch.full((r,), _BIG, dtype=f32, device=dev)
    tri_f = torch.full((r,), -1, dtype=i32, device=dev)
    idx = torch.arange(r, device=dev)
    node, t, tri = node_f.clone(), t_f.clone(), tri_f.clone()
    o, d = origins, directions
    inv_d, deg = _safe_inv(d), _degenerate_axes(d)

    steps = syncs = compactions = 0
    while idx.numel():
        live = node >= 0
        n_live = int(live.sum())
        syncs += 1
        if n_live == 0 or steps >= max_steps:
            break
        if n_live <= idx.numel() // 2:
            # compact to the live rows (a ray at node -1 never changes)
            node_f[idx], t_f[idx], tri_f[idx] = node, t, tri
            keep = torch.nonzero(live)[:, 0]
            idx, node, t, tri = idx[keep], node[keep], t[keep], tri[keep]
            o, d, inv_d, deg = o[keep], d[keep], inv_d[keep], deg[keep]
            compactions += 1
        for _ in range(min(_CHECK_EVERY, max_steps - steps)):
            alive = node >= 0
            node_c = node.clamp(0, 2 * n - 2)
            tn, tf = _slab(o, inv_d, deg, bvh.aabb_min[node_c],
                           bvh.aabb_max[node_c])
            box_hit = (tn <= tf) & (tf > 0) & (tn < t) & alive
            is_leaf = node_c >= leaf_base
            tri_id = (node_c - leaf_base).clamp(0, n - 1)
            tv = bvh.tri_verts[tri_id]
            hit, tt, _, _ = moller_trumbore(o, d, tv[:, 0], tv[:, 1],
                                            tv[:, 2])
            better = box_hit & is_leaf & hit & (tt < t)
            t = torch.where(better, tt, t)
            tri = torch.where(better, bvh.tri_index[tri_id], tri)
            nxt = torch.where(box_hit & ~is_leaf, left[node_c],
                              escape[node_c])
            node = torch.where(alive, nxt, node)
            steps += 1
    node_f[idx], t_f[idx], tri_f[idx] = node, t, tri

    hit = tri_f >= 0
    t_out = torch.where(hit, t_f, 0.0)
    point = origins + directions * t_out[:, None]
    # geometric normal of the hit triangle, by its sorted position
    inv_order = torch.zeros(max(n, 1), dtype=i64, device=dev)
    inv_order.index_copy_(0, bvh.tri_index.to(i64),
                          torch.arange(n, device=dev))
    tv = bvh.tri_verts[inv_order[tri_f.clamp(0, n - 1).to(i64)]]
    nrm = unit_normals(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    nrm = torch.where(hit[:, None], nrm, 0.0)
    return dict(hit=hit, t=t_out, tri=tri_f, point=point, normal=nrm,
                steps=steps, syncs=syncs, compactions=compactions)
