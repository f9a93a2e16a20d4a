"""Interactive carving: radiation splatting and mouse picking.

Counterpart of ``ray_tracing_octrees_tpu/ops/carve.py``: the radiation
splat compute kernel (pointRadComputeSrc, VolumeRaycastRenderer.cpp:
308-462: sharpened cubic B-spline weights with a 16-entry jitter table,
added into the radiation volume), its dispatch policy
(dispatchRadiationCompute, :495-631: radius clamp 6), and the CPU
picking ray march (intersectBuildingVoxel, main.cpp:209-334). Each runs
on its inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.ops.sampling import _f32
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _sqrt

f32 = torch.float32

_JITTER_OFFSETS = np.array(
    [
        [-0.4, -0.4, -0.4], [0.4, -0.4, -0.4], [-0.4, 0.4, -0.4], [0.4, 0.4, -0.4],
        [-0.4, -0.4, 0.4], [0.4, -0.4, 0.4], [-0.4, 0.4, 0.4], [0.4, 0.4, 0.4],
        [-0.2, -0.2, -0.2], [0.2, -0.2, -0.2], [-0.2, 0.2, -0.2], [0.2, 0.2, -0.2],
        [-0.2, -0.2, 0.2], [0.2, -0.2, 0.2], [-0.2, 0.2, 0.2], [0.2, 0.2, 0.2],
    ],
    np.float32,
)

# the 3^3 neighbour offsets of the picking march's surface probe
_PROBE = np.array([(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dx in (-1, 0, 1)], np.int32)


def bspline_1d(x: torch.Tensor) -> torch.Tensor:
    """Sharper cubic B-spline (pointRadComputeSrc:343-351)."""
    x = x.abs()
    inner = (2.0 / 3.0) + 0.7 * x * x * (x - 2.0)
    t = 1.6 - x
    outer = (t * t * t) / 5.0
    return torch.where(x < 0.7, inner, torch.where(x < 1.6, outer, 0.0))


def splat_radiation(radiation: torch.Tensor, world_pos, radius, box_min,
                    box_max) -> torch.Tensor:
    """``radiation`` (f32[Z, Y, X]) with one radiation point added.

    The shader's jittered dual evaluation: w = 0.5 * (B(nd) + B(nd +
    j*0.05)) where j indexes the 16-entry table by (x + 4y + 16z) mod 16
    (pointRadComputeSrc:398-428). Radius is clamped to 6, as the
    dispatcher does (dispatchRadiationCompute, VolumeRaycastRenderer.cpp:
    497-505); it is in voxel units.
    """
    dev = radiation.device
    as_f = lambda v: _f32(v, dev)
    dz, dy, dx = radiation.shape
    radius = torch.clamp(as_f(radius).reshape(()), max=6.0)
    box_min, box_max = as_f(box_min), as_f(box_max)
    dims = torch.tensor([dx, dy, dz], dtype=f32, device=dev)
    center = (as_f(world_pos) - box_min) / (box_max - box_min) * dims

    ar = lambda n: torch.arange(n, dtype=f32, device=dev)
    nd_x = (ar(dx) - center[0]) / radius
    nd_y = (ar(dy) - center[1]) / radius
    nd_z = (ar(dz) - center[2]) / radius
    w = (bspline_1d(nd_z)[:, None, None] * bspline_1d(nd_y)[None, :, None]
         * bspline_1d(nd_x)[None, None, :])

    ai = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    ji = (ai(dx)[None, None, :] + ai(dy)[None, :, None] * 4
          + ai(dz)[:, None, None] * 16) % 16
    jit = torch.as_tensor(_JITTER_OFFSETS, device=dev)[ji] * 0.05
    w2 = (bspline_1d(nd_x[None, None, :] + jit[..., 0])
          * bspline_1d(nd_y[None, :, None] + jit[..., 1])
          * bspline_1d(nd_z[:, None, None] + jit[..., 2]))
    final_w = 0.5 * (w + w2)
    dist = _sqrt(nd_x[None, None, :] ** 2 + nd_y[None, :, None] ** 2
                 + nd_z[:, None, None] ** 2)
    final_w = torch.where((dist <= 1.6) & (final_w > 1e-4), final_w, 0.0)
    return radiation + final_w


def pick_voxel(grid: VoxelGrid, ray_origin, ray_dir, box_min, box_max,
               max_steps: int = 8000):
    """First filled voxel along a ray (intersectBuildingVoxel,
    main.cpp:209-334), on the grid's device.

    Marches at voxelSize/2 steps with quarter steps near surfaces (the
    3^3 neighbour probe); returns (hit bool tensor, pos f32[3], offset
    one tenth of a step back toward the camera, where the reference
    places the splat). One step at a time, with a host check of the stop
    rule after each, as the reference's loop.
    """
    dev = grid.device
    as_f = lambda v: _f32(v, dev)
    ro, rd = as_f(ray_origin), as_f(ray_dir)
    box_min, box_max = as_f(box_min), as_f(box_max)

    inv = 1.0 / torch.where(rd.abs() < 1e-12, 1e-12, rd)
    t1 = (box_min - ro) * inv
    t2 = (box_max - ro) * inv
    t_near = torch.clamp(torch.minimum(t1, t2).max(), min=0.0)
    t_far = torch.maximum(t1, t2).min()

    step = grid.voxel_size.to(f32) * 0.5
    dims = torch.tensor(grid.dims_xyz, dtype=f32, device=dev)
    dims_i = torch.tensor(grid.dims_xyz, dtype=torch.int32, device=dev)
    probe = torch.as_tensor(_PROBE, device=dev)

    missed = t_near > t_far
    # a missed box starts the loop stopped; the result masks it out
    t, hit, pos = t_near, missed, torch.zeros(3, dtype=f32, device=dev)
    for _ in range(max_steps):
        if not bool((t <= t_far) & ~hit):
            break
        p = ro + rd * t
        uvw = (p - box_min) / (box_max - box_min)
        inside = ((uvw >= 0.0) & (uvw < 1.0)).all()
        v = torch.minimum(torch.clamp((uvw * dims).to(torch.int32), min=0),
                          dims_i - 1)
        filled = inside & (grid.occ[v[2], v[1], v[0]] > 0)
        nb = v[None, :] + probe
        near_surface = (grid.sample_safe(nb[:, 0], nb[:, 1], nb[:, 2])
                        > 0).any()
        adv = torch.where(inside & near_surface, step * 0.25, step)
        new_hit = hit | filled
        pos = torch.where(filled & ~hit, p - rd * (step * 0.1), pos)
        t = torch.where(new_hit, t, t + adv)
        hit = new_hit
    return hit & ~missed, pos
