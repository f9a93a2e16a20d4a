"""Stackless wavefront octree ray tracing: the exact DDA oracle.

Counterpart of ``ray_tracing_octrees_tpu/trace/octree_trace.py::
trace_octree`` (with ``_safe_inv``, ``_degenerate_axes`` and ``_slab``).
The reference's per-pixel stack traversal (``intersectOctreeIterative``,
RayTracerBVH.cpp:239-327) becomes hierarchical DDA with restart: every
ray repeatedly finds the octree leaf containing its current point by
descending the occupancy pyramid (one lookup per level, no stack), stops
if the leaf is solid (hit at the leaf box's entry t), and otherwise
advances past the leaf box's exit plane. The traversal is front to back
by construction, so it returns the true nearest hit.
"""

from __future__ import annotations

import torch

from ray_tracing_octrees_tpu_torch.core.octree import OccupancyPyramid

_BIG = 1e30
# alive-check period: dead rays never change, so testing for a live ray
# every few steps (one host sync each) gives the same result as testing
# every step, as long as the step bound still stops the loop exactly
_CHECK_EVERY = 8


def _safe_inv(d):
    eps = 1e-12
    return 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d)


def _degenerate_axes(d):
    """Axes the ray effectively does not move along (relative to |d|)."""
    mx = d.abs().amax(dim=-1, keepdim=True)
    return d.abs() <= mx * 1e-7


def _slab(o, inv_d, deg, bmin, bmax):
    """Ray-AABB slab test (intersectAABB, RayTracerBVH.cpp:226-236).

    Degenerate axes (``deg``) are handled explicitly: the interval is
    (-inf, inf) when the origin lies within the slab and empty otherwise
    (the 1/eps trick mis-signs the exit plane when the origin sits exactly
    on a cell boundary with a denormal direction component).

    Returns (t_near, t_far); hit iff t_near <= t_far and t_far > 0.
    """
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    inside = (o >= bmin) & (o <= bmax)
    lo = torch.where(deg, torch.where(inside, -_BIG, _BIG),
                     torch.minimum(t1, t2))
    hi = torch.where(deg, torch.where(inside, _BIG, -_BIG),
                     torch.maximum(t1, t2))
    return lo.amax(dim=-1), hi.amin(dim=-1)


def trace_octree(pyramid: OccupancyPyramid, origins: torch.Tensor,
                 directions: torch.Tensor, grid_origin, voxel_size,
                 max_steps: int = 512) -> dict:
    """Nearest solid-leaf hit for each ray, on the rays' device.

    ``origins`` / ``directions`` f32[N, 3] world (directions normalized),
    ``grid_origin`` f32[3], ``voxel_size`` a scalar. Returns dict with hit
    (bool[N]), t (f32[N]), point (f32[N, 3] world), normal (f32[N, 3]),
    steps (int32[N]).
    """
    f32 = torch.float32
    dev = origins.device
    n_levels = pyramid.num_levels
    origins = origins.to(f32)
    directions = directions.to(f32)
    org = torch.as_tensor(grid_origin, dtype=f32, device=dev).reshape(3)
    vs = torch.as_tensor(voxel_size, dtype=f32, device=dev).reshape(())

    # voxel-space ray; the world parameter t is kept by scaling d, not o
    o = (origins - org[None, :]) / vs
    d = directions / vs
    inv_d = _safe_inv(d)
    deg = _degenerate_axes(d)
    zero = torch.zeros((), dtype=f32, device=dev)
    root = torch.full((), float(pyramid.root_size), dtype=f32, device=dev)
    t_root_near, t_root_far = _slab(o, inv_d, deg, zero, root)
    alive = (t_root_near <= t_root_far) & (t_root_far > 0)
    t = torch.clamp(t_root_near, min=0.0)

    n = origins.shape[0]
    # advances the sample point ~1e-3 voxels along the ray, floored by the
    # f32 ulp at the current t
    eps_t = 1e-3 * vs

    def nudge(t):
        return t + torch.maximum(eps_t, t.abs() * 2e-6)

    def find_leaf(p):
        """(solid, cell_min, cell_size) of the leaf holding voxel floor(p):
        the coarsest uniform cell on the root-to-voxel path."""
        v = torch.floor(p).to(torch.int32)
        leaf_level = torch.zeros(n, dtype=torch.int32, device=dev)
        solid = torch.zeros(n, dtype=torch.bool, device=dev)
        found = torch.zeros(n, dtype=torch.bool, device=dev)
        for k in range(n_levels - 1, -1, -1):
            code = pyramid.cell_code(k, v[:, 0] >> k, v[:, 1] >> k,
                                     v[:, 2] >> k)
            uniform = code != 1
            take = uniform & ~found
            leaf_level = torch.where(take, k, leaf_level)
            solid = torch.where(take, code == 2, solid)
            found = found | uniform
        size = (1 << leaf_level).to(f32)
        lv = leaf_level[:, None]
        cell_min = ((v >> lv) << lv).to(f32)
        return solid, cell_min, size

    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t_hit = torch.zeros(n, dtype=f32, device=dev)
    cmin_out = torch.zeros((n, 3), dtype=f32, device=dev)
    csize_out = torch.zeros(n, dtype=f32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)

    # The reference loops while any ray is alive and steps.max() <
    # max_steps. Each step raises steps.max() by at most one, so from a
    # check that read max m, up to max_steps - m steps run before the bound
    # can trip; steps after every ray died change nothing.
    while True:
        live, m = (int(x) for x in torch.stack(
            [alive.any().to(torch.int32), steps.max()]).tolist())
        if not live or m >= max_steps:
            break
        for _ in range(min(_CHECK_EVERY, max_steps - m)):
            p = o + d * nudge(t)[:, None]
            solid, cmin, csize = find_leaf(p)
            t_near, t_far = _slab(o, inv_d, deg, cmin, cmin + csize[:, None])
            new_hit = alive & solid
            hit = hit | new_hit
            t_hit = torch.where(new_hit, torch.clamp(t_near, min=0.0), t_hit)
            cmin_out = torch.where(new_hit[:, None], cmin, cmin_out)
            csize_out = torch.where(new_hit, csize, csize_out)
            # advance empty-leaf rays past the cell exit
            t = torch.where(alive & ~solid, torch.maximum(t_far, nudge(t)), t)
            alive = alive & ~solid & (t < t_root_far)
            steps = steps + alive.to(torch.int32)

    # hit point and leaf normal normalize(p - nodeCenter)
    # (RayTracerBVH.cpp:283-287)
    point = origins + directions * t_hit[:, None]
    center_world = org[None, :] + (cmin_out + 0.5 * csize_out[:, None]) * vs
    nrm = point - center_world
    nrm = nrm / torch.clamp(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                            min=1e-30)
    nrm = torch.where(hit[:, None], nrm, 0.0)
    return dict(hit=hit, t=t_hit, point=point, normal=nrm, steps=steps)
