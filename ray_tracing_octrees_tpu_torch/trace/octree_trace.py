"""Stackless wavefront octree ray tracing: the exact DDA oracle.

Counterpart of ``ray_tracing_octrees_tpu/trace/octree_trace.py``:
``trace_octree`` (with ``_safe_inv``, ``_degenerate_axes`` and ``_slab``),
its one-lookup form ``trace_octree_fast``, ``cull_pyramid`` and the node
buffer's ``compact_visible_nodes``.
The reference's per-pixel stack traversal (``intersectOctreeIterative``,
RayTracerBVH.cpp:239-327) becomes hierarchical DDA with restart: every
ray repeatedly finds the octree leaf containing its current point by
descending the occupancy pyramid (one lookup per level, no stack), stops
if the leaf is solid (hit at the leaf box's entry t), and otherwise
advances past the leaf box's exit plane. The traversal is front to back
by construction, so it returns the true nearest hit.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tracing_octrees_tpu_torch.core.octree import (
    LinearOctree, OccupancyPyramid, build_pyramid, decode_skip_radius,
)
from ray_tracing_octrees_tpu_torch.ops.compaction import scatter_drop
from ray_tracing_octrees_tpu_torch.render.frustum import frustum_planes
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _sqrt

_BIG = 1e30
# alive-check period: dead rays never change, so testing for a live ray
# every few steps (one host sync each) gives the same result as testing
# every step, as long as the step bound still stops the loop exactly
_CHECK_EVERY = 8
# trace_octree_fast's check period; a check that finds at most half of
# the rows alive compacts to them
_FAST_CHECK_EVERY = 4


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

    return _hit_epilogue(origins, directions, org, vs, hit, t_hit, cmin_out,
                         csize_out, steps)


def _hit_epilogue(origins, directions, org, vs, hit, t_hit, cmin, csize,
                  steps) -> dict:
    """Hit point and leaf normal normalize(p - nodeCenter)
    (RayTracerBVH.cpp:283-287), in world space; the result dict. The
    normal's length is ``_sqrt`` of its squares summed in order (no device
    reduction), so the card's normal equals the CPU's bit for bit."""
    point = origins + directions * t_hit[:, None]
    center_world = org[None, :] + (cmin + 0.5 * csize[:, None]) * vs
    nrm = point - center_world
    n0, n1, n2 = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    nlen = _sqrt(n0 * n0 + n1 * n1 + n2 * n2)
    nrm = nrm / torch.clamp(nlen, min=1e-30)[:, None]
    nrm = torch.where(hit[:, None], nrm, 0.0)
    return dict(hit=hit, t=t_hit, point=point, normal=nrm, steps=steps)


def _slab3(o3, inv3, deg3, bmin3, bmax3):
    """:func:`_slab` one axis at a time (per-axis tensors or scalars):
    the same ops, its max / min reductions nested (exact)."""
    lo, hi = [], []
    for a in range(3):
        t1 = (bmin3[a] - o3[a]) * inv3[a]
        t2 = (bmax3[a] - o3[a]) * inv3[a]
        inside = (o3[a] >= bmin3[a]) & (o3[a] <= bmax3[a])
        lo.append(torch.where(deg3[a], torch.where(inside, -_BIG, _BIG),
                              torch.minimum(t1, t2)))
        hi.append(torch.where(deg3[a], torch.where(inside, _BIG, -_BIG),
                              torch.maximum(t1, t2)))
    return (torch.maximum(torch.maximum(lo[0], lo[1]), lo[2]),
            torch.minimum(torch.minimum(hi[0], hi[1]), hi[2]))


def _ray_consts(d3):
    """(1 / d, degenerate flags) per axis: :func:`_safe_inv` and
    :func:`_degenerate_axes` one axis at a time."""
    mx = torch.maximum(torch.maximum(d3[0].abs(), d3[1].abs()), d3[2].abs())
    return (tuple(_safe_inv(d) for d in d3),
            tuple(d.abs() <= mx * 1e-7 for d in d3))


def trace_octree_fast(leaf_vol: torch.Tensor, origins: torch.Tensor,
                      directions: torch.Tensor, grid_origin, voxel_size,
                      max_steps: int = 512, ball_skip: bool = False,
                      ladder: tuple = (), t_start=None, live_mask=None,
                      const_origin: bool = False, const_dir: bool = False,
                      safety_cap: int = 0) -> dict:
    """:func:`trace_octree` with the pyramid descent folded into one lookup
    of ``leaf_vol`` (``core/octree.py::build_leaf_volume``) per step, on
    the leaf volume's device.

    With ``ball_skip=False`` every sampled point, and so every output, is
    :func:`trace_octree`'s, bit for bit. ``ball_skip=True`` also advances
    empty rays past the packed Chebyshev empty ball [v - r, v + r + 1)
    when it reaches farther than the leaf box: a solid-free region, so no
    hit is skipped, though the sample sequence (and so the rare
    nudge-epsilon grazing case) may differ.

    ``t_start`` f32[N] (a conservative start t, world units) and
    ``live_mask`` bool[N] (rays proven to miss start dead) are the seeds
    of ``slab_sweep.sweep_seed`` / ``query_shadow_seed``.
    ``const_origin`` / ``const_dir``: the caller's promise that every row
    of ``origins`` / ``directions`` equals row 0 (a pinhole bundle, a
    directional shadow bundle); that component is then one scalar.

    The rays run on the rows still alive: a check every
    ``_FAST_CHECK_EVERY`` steps (one host sync) reads the live count and
    the largest step count, and compacts to the live rows when at most
    half of the current rows are alive. Per-ray arithmetic does not
    depend on the width, so the compaction changes no output. As in the
    reference's lockstep loop, every ray stops once the largest step
    count of all rays reaches ``max_steps``. ``ladder`` and
    ``safety_cap``, the reference's fixed-width compaction schedule, are
    accepted and change nothing here.

    Returns dict(hit, t, point, normal, steps) as :func:`trace_octree`,
    plus host ints ``syncs`` (host syncs: the checks), ``compactions``
    and ``iterations`` (DDA steps run).
    """
    del ladder, safety_cap
    f32, i32 = torch.float32, torch.int32
    dev = leaf_vol.device
    S = int(leaf_vol.shape[0])
    top = S.bit_length() - 1
    lv_flat = leaf_vol.reshape(-1)
    origins = origins.to(f32)
    directions = directions.to(f32)
    org = torch.as_tensor(grid_origin, dtype=f32, device=dev).reshape(3)
    vs = torch.as_tensor(voxel_size, dtype=f32, device=dev).reshape(())
    n = origins.shape[0]

    # per-axis voxel-space rays; a shared component is one scalar
    rows = (lambda x, a: x[0, a]) if const_origin else (lambda x, a: x[:, a])
    o3 = tuple((rows(origins, a) - org[a]) / vs for a in range(3))
    rows = (lambda x, a: x[0, a]) if const_dir else (lambda x, a: x[:, a])
    d3 = tuple(rows(directions, a) / vs for a in range(3))
    inv3, deg3 = _ray_consts(d3)
    zero = torch.zeros((), dtype=f32, device=dev)
    root = torch.full((), float(S), dtype=f32, device=dev)
    t_root_near, t_root_far = _slab3(o3, inv3, deg3, (zero,) * 3, (root,) * 3)
    alive = ((t_root_near <= t_root_far) & (t_root_far > 0)).expand(n)
    t = torch.clamp(t_root_near, min=0.0).expand(n)
    if t_start is not None:
        t = torch.maximum(t, t_start)
    if live_mask is not None:
        alive = alive & live_mask
    alive = alive.contiguous()
    t = t.contiguous()
    eps_t = 1e-3 * vs

    def nudge(t):
        return t + torch.maximum(eps_t, t.abs() * 2e-6)

    def find_leaf(p3):
        v3 = tuple(torch.floor(p).to(i32) for p in p3)
        inb = ((v3[0] >= 0) & (v3[1] >= 0) & (v3[2] >= 0)
               & (v3[0] < S) & (v3[1] < S) & (v3[2] < S))
        vc = tuple(v.clamp(0, S - 1).long() for v in v3)
        lv = lv_flat[(vc[2] * S + vc[1]) * S + vc[0]].to(i32)
        # out-of-cube voxels resolve at the root level, uniform-empty
        level = torch.where(inb, (lv >> 1) & 0xF, top)
        solid = inb & ((lv & 1) > 0)
        size = torch.bitwise_left_shift(torch.ones_like(level), level).to(f32)
        cmin3 = tuple(((v >> level) << level).to(f32) for v in v3)
        radius = torch.where(inb, decode_skip_radius(lv >> 5), 0)
        return solid, cmin3, size, v3, radius

    # full-width results; the live rows' state below, indexed by ``idx``
    hit_f = torch.zeros(n, dtype=torch.bool, device=dev)
    th_f = torch.zeros(n, dtype=f32, device=dev)
    cm_f = torch.zeros((n, 3), dtype=f32, device=dev)
    cs_f = torch.zeros(n, dtype=f32, device=dev)
    steps_f = torch.zeros(n, dtype=i32, device=dev)
    idx = torch.arange(n, device=dev)
    per_row = lambda x: x.dim() > 0
    ray = dict(o3=o3, d3=d3, inv3=inv3, deg3=deg3, t_root_far=t_root_far)

    def fresh(m):
        z = torch.zeros(m, dtype=f32, device=dev)
        return (torch.zeros(m, dtype=torch.bool, device=dev), z, z, z, z, z,
                torch.zeros(m, dtype=i32, device=dev))

    hit, t_hit, cm0, cm1, cm2, csize, steps = fresh(n)

    def write_back():
        hit_f[idx] = hit
        th_f[idx] = t_hit
        cm_f[idx] = torch.stack([cm0, cm1, cm2], dim=1)
        cs_f[idx] = csize
        steps_f[idx] = steps

    syncs = compactions = iterations = 0
    m_all = 0
    while idx.shape[0]:
        width = int(idx.shape[0])
        n_alive, m_act = (int(x) for x in torch.stack(
            [alive.sum().to(i32), steps.max()]).tolist())
        syncs += 1
        m_all = max(m_all, m_act)
        if n_alive == 0 or m_all >= max_steps:
            break
        if n_alive <= width // 2:
            # compact to the live rows: their ranks give their slots, the
            # dead rows all land in one spare slot (no host sync)
            write_back()
            slot = torch.where(alive, torch.cumsum(alive, 0) - 1, n_alive)
            sel = torch.empty(n_alive + 1, dtype=torch.long, device=dev)
            sel.scatter_(0, slot, torch.arange(width, device=dev))
            sel = sel[:n_alive]
            idx = idx[sel]
            t = t[sel]
            steps = steps[sel]
            alive = torch.ones(n_alive, dtype=torch.bool, device=dev)
            hit, t_hit, cm0, cm1, cm2, csize, _ = fresh(n_alive)
            ray = {k: (tuple(x[sel] if per_row(x) else x for x in v)
                       if isinstance(v, tuple)
                       else (v[sel] if per_row(v) else v))
                   for k, v in ray.items()}
            compactions += 1
        o_, d_, inv_, deg_ = ray["o3"], ray["d3"], ray["inv3"], ray["deg3"]
        for _ in range(min(_FAST_CHECK_EVERY, max_steps - m_all)):
            tn = nudge(t)
            p3 = tuple(o_[a] + d_[a] * tn for a in range(3))
            solid, cmin3, cs, v3, radius = find_leaf(p3)
            t_near, t_far = _slab3(o_, inv_, deg_, cmin3,
                                   tuple(c + cs for c in cmin3))
            new_hit = alive & solid
            hit = hit | new_hit
            t_hit = torch.where(new_hit, torch.clamp(t_near, min=0.0), t_hit)
            cm0 = torch.where(new_hit, cmin3[0], cm0)
            cm1 = torch.where(new_hit, cmin3[1], cm1)
            cm2 = torch.where(new_hit, cmin3[2], cm2)
            csize = torch.where(new_hit, cs, csize)
            if ball_skip:
                bmin3 = tuple((v - radius).to(f32) for v in v3)
                bmax3 = tuple((v + radius).to(f32) + 1.0 for v in v3)
                t_far = torch.maximum(
                    t_far, _slab3(o_, inv_, deg_, bmin3, bmax3)[1])
            t = torch.where(alive & ~solid, torch.maximum(t_far, nudge(t)), t)
            alive = alive & ~solid & (t < ray["t_root_far"])
            steps = steps + alive.to(i32)
            iterations += 1
    write_back()

    out = _hit_epilogue(origins, directions, org, vs, hit_f, th_f, cm_f, cs_f,
                        steps_f)
    out.update(syncs=syncs, compactions=compactions, iterations=iterations)
    return out


def cull_pyramid(pyramid: OccupancyPyramid, grid_origin, voxel_size,
                 view_proj, margin: float) -> OccupancyPyramid:
    """Frustum-cull the scene by blanking occupancy outside the frustum,
    on the pyramid's device.

    The effect of updateNodesWithFrustumCulling (RayTracerBVH.cpp:
    725-813, margin 150): space outside the inflated frustum becomes
    empty, so traversal skips it; applied at the finest level and
    reduced again. The p-vertex test is separable: for each plane the
    distance field is a sum of three 1-D terms, evaluated by broadcast.
    """
    f32 = torch.float32
    occ = pyramid.code_levels[0] > 0
    dev = occ.device
    planes = frustum_planes(view_proj, dev)
    dz, dy, dx = occ.shape
    origin = torch.as_tensor(grid_origin, dtype=f32, device=dev).reshape(3)
    vs = torch.as_tensor(voxel_size, dtype=f32, device=dev).reshape(())
    xs = origin[0] + torch.arange(dx, dtype=f32, device=dev) * vs
    ys = origin[1] + torch.arange(dy, dtype=f32, device=dev) * vs
    zs = origin[2] + torch.arange(dz, dtype=f32, device=dev) * vs
    visible = torch.ones(occ.shape, dtype=torch.bool, device=dev)
    for p in range(6):
        a, b, c, d = planes[p, 0], planes[p, 1], planes[p, 2], planes[p, 3]
        px = a * (xs + torch.where(a > 0, vs, 0.0))
        py = b * (ys + torch.where(b > 0, vs, 0.0))
        pz = c * (zs + torch.where(c > 0, vs, 0.0))
        dist = px[None, None, :] + py[None, :, None] + pz[:, None, None] + d
        # test_aabb's per-axis margin, along the plane normal
        infl = margin * (a.abs() + b.abs() + c.abs())
        visible &= dist >= -infl
    return build_pyramid(occ & visible)


def compact_visible_nodes(tree: LinearOctree, visible: torch.Tensor):
    """Node-buffer compaction with child remap (RayTracerBVH.cpp:765-813).

    ``visible``: bool[N]. Returns (tree2, new_count): tree2 has the
    visible nodes moved to the front in their original order, children
    of culled nodes set to -1 and the trailing slots zero (children -1),
    at the static size N; the root is always kept. ``new_count`` is an
    int32 0-d tensor on the tree's device.
    """
    n = tree.num_nodes
    # the root is always kept (the reference keeps index 0)
    vis = visible.to(tree.device) | (
        torch.arange(n, device=tree.device) == 0)
    new_idx = torch.cumsum(vis.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(vis, new_idx, n)
    scatter = lambda a, fill=0: scatter_drop(n, slots, a, fill)

    # child remap: old child -> its new index if visible, else -1
    child = tree.children.long().clamp(0, n - 1)
    child_ok = (tree.children >= 0) & vis[child]
    remapped = torch.where(child_ok, new_idx[child], -1)
    tree2 = dataclasses.replace(
        tree, x=scatter(tree.x), y=scatter(tree.y), z=scatter(tree.z),
        size=scatter(tree.size), is_leaf=scatter(tree.is_leaf),
        is_solid=scatter(tree.is_solid), is_uniform=scatter(tree.is_uniform),
        children=scatter(remapped, fill=-1), level=scatter(tree.level))
    return tree2, vis.sum(dtype=torch.int32)
