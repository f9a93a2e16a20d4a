"""Octree ray-trace pipeline (the reference's "BVHRayTrace" mode).

Counterpart of ``ray_tracing_octrees_tpu/models/octree_raytracer.py``:
the model of ``RayTracerBVH`` (RayTracerBVH.{h,cpp}). Per-pixel pinhole
rays are traced against the scene octree with Lambert shading
(``shade``, RayTracerBVH.cpp:331-336: warm base colour * N.L + ambient,
black background) and an optional shadow ray per hit. The traversal is
the stackless hierarchical DDA of ``trace/octree_trace.py`` rather than a
per-thread stack; :class:`OctreeRayTracer` routes a frame to the fastest
exact tracer whose envelope holds the pose (fast-exact when configured,
then sweep-exact, then the DDA), or to the slab-sweep fast frame.

The linear (node buffer) octree is not ported yet: binding one raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from ray_tracing_octrees_tpu_torch.core.octree import (
    OccupancyPyramid, build_leaf_volume, build_pyramid,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera, generate_rays
from ray_tracing_octrees_tpu_torch.trace import fast_exact, slab_sweep
from ray_tracing_octrees_tpu_torch.trace import sweep_exact
from ray_tracing_octrees_tpu_torch.trace.octree_trace import (
    cull_pyramid, trace_octree, trace_octree_fast,
)
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _host, _unit

LINEAR_TREE_MISSING = (
    "the linear octree (set_octree(tree=...)) is not ported yet: "
    "ROADMAP.md queue 1, item 4 (surface extraction)")


def lambert_shade(normal, hit, light_dir, base_color, ambient):
    """shade() (RayTracerBVH.cpp:331-336): base * max(0, N . -L) + ambient,
    black where ``hit`` is False; f32[N, 3] on ``normal``'s device."""
    f32 = torch.float32
    dev = normal.device
    l = _unit(torch.as_tensor(light_dir, dtype=f32, device=dev))
    ndotl = torch.clamp(-(normal * l[None, :]).sum(-1), min=0.0)
    base = torch.as_tensor(base_color, dtype=f32, device=dev)
    amb = torch.as_tensor(ambient, dtype=f32, device=dev)
    color = base[None, :] * ndotl[:, None] + amb[None, :]
    return torch.where(hit[:, None], color, 0.0)


def render_octree_image(
    pyramid: OccupancyPyramid,
    grid_origin,
    voxel_size,
    cam_pos,
    view,
    width: int,
    height: int,
    fov_deg,
    aspect,
    light_dir=(-1.0, -1.0, -1.0),
    base_color=(1.0, 0.8, 0.6),
    ambient=(0.1, 0.1, 0.1),
    max_steps: int = 512,
    shadows: bool = False,
    leaf_vol=None,
    ball_skip: bool = False,
    bands: int = 1,
    seed_live=None,
    seed_t=None,
    shadow_live_vol=None,
    shadow_seed=None,
    stats: Optional[dict] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Full frame: ray generation, stackless octree trace, Lambert shade.

    Returns f32[height, width, 4] (row 0 the top, as generateRay's ny
    flip). With ``shadows`` a shadow ray is traced from each hit toward
    the light (the "primary + shadow rays" configuration).

    ``leaf_vol`` (``core/octree.build_leaf_volume``): trace through
    ``trace_octree_fast``, one leaf lookup per DDA step, with ``ball_skip``
    and the seeds ``seed_live`` / ``seed_t`` (``slab_sweep.sweep_seed``,
    primary rays only); without it ``trace_octree``. ``shadow_live_vol``
    (``slab_sweep.light_blocked_volume``) and ``shadow_seed``
    (``slab_sweep.build_shadow_seed``) prune shadow rays that provably
    reach the light. ``bands`` traces row bands one after another (the
    same image). The reference's fixed-width compaction schedules
    (``ladder``, ``shadow_ladder``, ``safety_cap``) have no counterpart:
    the port's DDA compacts to the live rays. ``stats``, when given,
    is filled with per-trace counts: ``traces``, a list of dict(kind,
    syncs, compactions, iterations, steps) with ``steps`` the per-ray
    step counts (a tensor).
    """
    dev = resolve_device(device)
    f32 = torch.float32
    origin = torch.as_tensor(np.asarray(_host(grid_origin), np.float32),
                             device=dev)
    vs = torch.as_tensor(np.float32(_host(voxel_size)), device=dev)
    origins, dirs = generate_rays(
        width, height, np.asarray(_host(cam_pos), np.float32),
        np.asarray(_host(view), np.float32), float(_host(fov_deg)),
        float(_host(aspect)), device=dev)
    if stats is not None:
        stats.setdefault("traces", [])

    def trace(o, d, kind, live=None, ts=None, const_origin=False,
              const_dir=False):
        if leaf_vol is None:
            # the pyramid descent takes no seeds (as the reference's)
            res = trace_octree(pyramid, o, d, origin, vs, max_steps=max_steps)
        else:
            res = trace_octree_fast(
                leaf_vol, o, d, origin, vs, max_steps=max_steps,
                ball_skip=ball_skip, t_start=ts, live_mask=live,
                const_origin=const_origin, const_dir=const_dir)
        if stats is not None:
            stats["traces"].append(dict(
                kind=kind, syncs=res.get("syncs"),
                compactions=res.get("compactions"),
                iterations=res.get("iterations"), steps=res["steps"]))
        return res

    amb = torch.as_tensor(ambient, dtype=f32, device=dev)

    def shade_rays(o_b, d_b, live_b=None, ts_b=None):
        # primary rays form a pinhole bundle: every origin is cam_pos
        res = trace(o_b, d_b, "primary", live_b, ts_b, const_origin=True)
        color = lambert_shade(res["normal"], res["hit"], light_dir,
                              base_color, ambient)
        if not shadows:
            return color
        l = _unit(torch.as_tensor(light_dir, dtype=f32, device=dev))
        # offset along the normal to leave the surface cell
        shadow_o = res["point"] + res["normal"] * (vs * 2.0)
        shadow_d = (-l)[None, :].expand(shadow_o.shape)
        # miss pixels (point = normal = 0) park far past the volume along
        # the shadow direction, so they die at step 0
        shadow_o = torch.where(res["hit"][:, None], shadow_o,
                               shadow_d * 3e7)
        s_live = res["hit"]
        if shadow_live_vol is not None:
            # a False flag at the origin's voxel proves no solid toward the
            # light; out-of-bounds origins stay live
            origin_p = origin - np.float32(slab_sweep.SEED_DILATION) * vs
            v = torch.floor((shadow_o - origin_p[None, :]) / vs).to(
                torch.int32)
            dzv, dyv, dxv = shadow_live_vol.shape
            inb = ((v[:, 0] >= 0) & (v[:, 1] >= 0) & (v[:, 2] >= 0)
                   & (v[:, 0] < dxv) & (v[:, 1] < dyv) & (v[:, 2] < dzv))
            flag = shadow_live_vol[v[:, 2].clamp(0, dzv - 1).long(),
                                   v[:, 1].clamp(0, dyv - 1).long(),
                                   v[:, 0].clamp(0, dxv - 1).long()]
            s_live = torch.where(inb, flag, True) & res["hit"]
        s_ts = None
        if shadow_seed is not None:
            ss_live, s_ts = slab_sweep.query_shadow_seed(
                shadow_seed, shadow_o, origin, vs)
            s_live = s_live & ss_live
        sres = trace(shadow_o, shadow_d, "shadow", s_live, s_ts,
                     const_dir=True)
        occluded = sres["hit"] & res["hit"]
        return torch.where(occluded[:, None], amb.expand(color.shape), color)

    if bands <= 1:
        color = shade_rays(origins, dirs, seed_live, seed_t)
    else:
        # row bands, traced one after another by the same per-ray ops
        rows = -(-height // bands)
        colors = []
        for b in range(bands):
            r0, r1 = b * rows, min((b + 1) * rows, height)
            if r0 >= r1:
                break
            sl = slice(r0 * width, r1 * width)
            colors.append(shade_rays(
                origins[sl], dirs[sl],
                None if seed_live is None else seed_live[sl],
                None if seed_t is None else seed_t[sl]))
        color = torch.cat(colors, dim=0)
    img = torch.cat([color, torch.ones_like(color[:, :1])], dim=-1)
    return img.reshape(height, width, 4)


@dataclasses.dataclass
class OctreeRayTracer:
    """Stateful pipeline (RayTracerBVH's set / render API).

    ``render`` draws one frame on the tracer's device (CUDA unless
    ``device="cpu"``): with ``fast=True`` the slab-sweep frame
    (``slab_sweep.render_fast_frame``, voxel-centre normals and the
    directional shadow volume); otherwise the exact tracers in the
    config's order: fast-exact (``config.raytrace.use_fast_exact``), then
    sweep-exact (``use_sweep_exact``), then the DDA with the leaf volume,
    seeds and ball skip. ``last_path`` names the tracer the last frame
    took ("fast", "fast_exact", "sweep_exact" or "dda").
    """

    config: EngineConfig = DEFAULT_CONFIG
    device: DeviceLike = None
    pyramid: Optional[OccupancyPyramid] = None
    culled_pyramid: Optional[OccupancyPyramid] = None
    grid_origin: Optional[np.ndarray] = None
    voxel_size: Optional[float] = None
    last_path: Optional[str] = None

    def set_octree(self, grid, pyramid: Optional[OccupancyPyramid] = None,
                   tree=None):
        """setOctree (RayTracerBVH.cpp:430-505): bind the scene (a
        ``core/grid.VoxelGrid``). ``tree``, the flat node buffer, needs
        the linear octree, which is not ported: passing one raises."""
        if tree is not None:
            raise NotImplementedError(LINEAR_TREE_MISSING)
        self._dev = resolve_device(self.device)
        self.pyramid = pyramid if pyramid is not None else build_pyramid(
            grid.occ.to(self._dev))
        self.culled_pyramid = None
        self.grid_origin = np.asarray(_host(grid.origin), np.float32)
        self.voxel_size = float(_host(grid.voxel_size))
        self.last_path = None
        self._fast_vol = None
        self._fast_shadow = None
        self._layouts = None
        self._leaf_vol = None
        self._seed_layouts = None
        self._shadow_blk = None
        self._exact_sfld = None

    def _ensure_leaf_vol(self):
        """Packed per-voxel leaf descriptors of the one-lookup DDA (S^3
        bytes, once per scene)."""
        if self._leaf_vol is None:
            self._leaf_vol = build_leaf_volume(self.pyramid)
        return self._leaf_vol

    def _ensure_seed_vol(self):
        """Dilated occupancy of the conservative DDA seeds, with its
        sweep-order copies kept across frames."""
        if self._seed_layouts is None:
            self._seed_layouts = slab_sweep.SweepLayouts(
                slab_sweep.dilate_occupancy(self.pyramid.code_levels[0] > 0,
                                            device=self._dev))
        return self._seed_layouts

    def _ensure_shadow_blk(self):
        """Conservative light-occludability volume of the shadow prune."""
        if self._shadow_blk is None:
            to_light = tuple(-c for c in self.config.raytrace.light_dir)
            self._shadow_blk = slab_sweep.light_blocked_volume(
                self._ensure_seed_vol().volume, to_light)
        return self._shadow_blk

    def _ensure_fast(self):
        """The occupancy volume, its directional shadow volume (swept
        toward the light at -light_dir) and their sweep layouts."""
        if self._fast_vol is None:
            self._fast_vol = (self.pyramid.code_levels[0] > 0).to(
                torch.float32)
            to_light = -np.asarray(self.config.raytrace.light_dir, np.float32)
            self._fast_shadow = slab_sweep.shadow_volume(
                self._fast_vol, to_light, device=self._dev)
            self._layouts = slab_sweep.SweepLayouts(self._fast_vol,
                                                    self._fast_shadow)

    def _frame_layouts(self, shadows: bool):
        self._ensure_fast()
        return self._layouts if shadows else self._layouts.without_shadow()

    def _eye_inside(self, camera: Camera) -> bool:
        return _eye_inside_volume(self.grid_origin, self.voxel_size,
                                  self.pyramid.code_levels[0].shape,
                                  camera.get_pos())

    def _ensure_exact_shadow_field(self):
        """The sweep-exact shadow field (per scene and light), None when
        the light is outside the field's slope envelope."""
        if self._exact_sfld is None:
            self._ensure_fast()
            self._exact_sfld = (sweep_exact.build_shadow_field(
                self._fast_vol, self.config.raytrace.light_dir,
                self.voxel_size, layouts=self._layouts, device=self._dev),)
        return self._exact_sfld[0]

    def _render_fast_exact(self, camera: Camera, width: int, height: int,
                           aspect: float, shadows: bool):
        """Fast-exact cube frame, or None outside its envelope: exact hit,
        t and shadow, voxel-granularity normals."""
        rt = self.config.raytrace
        lay = self._frame_layouts(shadows)
        return fast_exact.render_fast_exact_frame(
            self._fast_vol, lay.shadow, self.grid_origin, self.voxel_size,
            camera.get_pos(), camera.get_view(), self.config.camera.fov_deg,
            aspect, width, height, light_dir=rt.light_dir,
            base_color=rt.base_color, ambient=rt.ambient, layouts=lay,
            device=self._dev)

    def _render_sweep_exact(self, camera: Camera, width: int, height: int,
                            aspect: float, shadows: bool):
        """Sweep-exact frame, or None outside its envelope (the caller
        falls back to the DDA)."""
        rt = self.config.raytrace
        self._ensure_fast()
        sfld = self._ensure_exact_shadow_field() if shadows else None
        if shadows and sfld is None:
            return None
        out = sweep_exact.render_exact_frame(
            self._fast_vol, self._ensure_leaf_vol(), self.grid_origin,
            self.voxel_size, camera.get_pos(), camera.get_view(), width,
            height, self.config.camera.fov_deg, aspect,
            light_dir=rt.light_dir, base_color=rt.base_color,
            ambient=rt.ambient, shadows=shadows, shadow_field=sfld,
            layouts=self._layouts, device=self._dev)
        return None if out is None else out[0]

    def update_frustum(self, view_proj):
        """The culling step of renderSceneComputeWithCulling
        (RayTracerBVH.cpp:743-812): blank occupancy outside the frustum,
        which the DDA trace then skips. The node-buffer compaction needs
        the linear octree, which :meth:`set_octree` refuses."""
        self.culled_pyramid = cull_pyramid(
            self.pyramid, self.grid_origin, self.voxel_size, view_proj,
            self.config.raytrace.frustum_margin)

    def render(self, camera: Camera, width: int, height: int, aspect: float,
               use_culling: bool = False, shadows: bool = False,
               fast: bool = False) -> torch.Tensor:
        """One frame, f32[height, width, 4] rgba (see the class)."""
        rt = self.config.raytrace
        fov = self.config.camera.fov_deg
        if fast:
            self._ensure_fast()
            # an interior eye whose cone holds rays pointing backward along
            # the sweep axis would read misses from the half-volume sweep:
            # such poses go to the exact tracers
            if self._eye_inside(camera) and _frustum_crosses_sweep_plane(
                    camera.get_view(), fov, aspect):
                fast = False
        if fast:
            lay = self._frame_layouts(shadows)
            self.last_path = "fast"
            return slab_sweep.render_fast_frame(
                self._fast_vol, lay.shadow, self.grid_origin,
                self.voxel_size, camera.get_pos(), camera.get_view(), fov,
                aspect, width, height, light_dir=rt.light_dir,
                base_color=rt.base_color, ambient=rt.ambient, layouts=lay,
                device=self._dev)
        # the exact tracers skip the frustum cull: primary rays lie in the
        # frustum by construction, and the reference's node culling only
        # speeds its traversal up (RayTracerBVH.cpp:743-812)
        if rt.use_fast_exact:
            img = self._render_fast_exact(camera, width, height, aspect,
                                          shadows)
            if img is not None:
                self.last_path = "fast_exact"
                return img
        if rt.use_sweep_exact:
            img = self._render_sweep_exact(camera, width, height, aspect,
                                           shadows)
            if img is not None:
                self.last_path = "sweep_exact"
                return img
        pyr = (self.culled_pyramid if use_culling and self.culled_pyramid
               is not None else self.pyramid)
        # the leaf volume serves the scene pyramid; the culled one differs
        # per pose and keeps the per-level descent
        lv = self._ensure_leaf_vol() if pyr is self.pyramid else None
        seed_live = seed_t = None
        if lv is not None and rt.exact_seed:
            live, ts, ext = slab_sweep.sweep_seed(
                self._ensure_seed_vol().volume, self.grid_origin,
                self.voxel_size, camera.get_pos(), camera.get_view(), fov,
                aspect, width, height, layouts=self._ensure_seed_vol(),
                device=self._dev)
            if ext:
                seed_live, seed_t = live, ts
        self.last_path = "dda"
        return render_octree_image(
            pyr, self.grid_origin, self.voxel_size, camera.get_pos(),
            camera.get_view(), width, height, fov, aspect,
            light_dir=rt.light_dir, base_color=rt.base_color,
            ambient=rt.ambient, max_steps=rt.max_traversal_steps,
            shadows=shadows, leaf_vol=lv,
            ball_skip=bool(lv is not None and rt.exact_ball_skip),
            seed_live=seed_live, seed_t=seed_t,
            shadow_live_vol=(self._ensure_shadow_blk()
                             if lv is not None and shadows
                             and rt.exact_shadow_prune else None),
            device=self._dev)


def _frustum_crosses_sweep_plane(view, fov_deg: float, aspect: float) -> bool:
    """True when some frustum-corner ray points backward along the sweep
    axis the interior half-volume sweep would pick (the most view-aligned
    axis): |look_ax| <= tan(fov/2) * (aspect * |right_ax| + |up_ax|). A
    pixel ray is nx * right + ny * up + look with |nx| <= aspect *
    tan_half and |ny| <= tan_half, so this bounds the smallest axis
    component over the cone."""
    v = np.asarray(view, np.float64)
    look = -v[2, :3]
    ax = int(np.argmax(np.abs(look)))
    t = math.tan(math.radians(float(fov_deg)) / 2.0)
    spread = t * (float(aspect) * abs(v[0, ax]) + abs(v[1, ax]))
    return abs(look[ax]) <= spread * (1.0 + 1e-6)


def _eye_inside_volume(grid_origin, voxel_size, dims_zyx, cam_pos) -> bool:
    cam_vox = (np.asarray(cam_pos, np.float64)
               - np.asarray(grid_origin, np.float64)) / float(voxel_size)
    dz, dy, dx = dims_zyx
    return bool((0 <= cam_vox[0] <= dx) and (0 <= cam_vox[1] <= dy)
                and (0 <= cam_vox[2] <= dz))
