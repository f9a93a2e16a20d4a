"""VolumeRaycast pipeline: the advanced-shading volume renderer.

Counterpart of ``ray_tracing_octrees_tpu/models/volume_raycaster.py``,
the model of ``VolumeRaycastRenderer`` (VolumeRaycastRenderer.{h,cpp}):
owns the eight volume "textures" (mip chain, working/culled copy,
radiation, gradients, edge factors, AO, indirect light, skip distances),
the frustum working-volume update, the octree skip probe, carving, and
the frame: :meth:`VolumeRaycastRenderer.draw_fast` (the sweep frame of
:mod:`..trace.raymarch_sweep`, the production path) and
:meth:`VolumeRaycastRenderer.draw` (the per-ray oracle of
:mod:`..trace.raymarch`). Everything runs on the renderer's device: CUDA
unless ``device="cpu"``. Given a linear octree, the frustum update takes
the reference's exact octree-visibility working volume.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import (
    LinearOctree, OccupancyPyramid, build_pyramid, padded_cube_size,
)
from ray_tracing_octrees_tpu_torch.ops.carve import pick_voxel, splat_radiation
from ray_tracing_octrees_tpu_torch.ops.compaction import mark_true
from ray_tracing_octrees_tpu_torch.ops.precompute import (
    ambient_occlusion, build_skip_distance, indirect_lighting,
    precompute_volume,
)
from ray_tracing_octrees_tpu_torch.ops.sampling import _f32, build_mip_chain
from ray_tracing_octrees_tpu_torch.render.camera import (
    Camera, generate_rays, perspective,
)
from ray_tracing_octrees_tpu_torch.render.frustum import (
    frustum_planes, test_aabb, visible_node_mask,
)
from ray_tracing_octrees_tpu_torch.trace.octree_trace import trace_octree
from ray_tracing_octrees_tpu_torch.trace.raymarch import (
    MAIN_LIGHT_COLOR, MAIN_LIGHT_DIR, VolumeTextures, raymarch_volume,
)
from ray_tracing_octrees_tpu_torch.trace.raymarch_sweep import (
    prepare_volume_scene, render_volume_frame,
)
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _host

f32 = torch.float32


def _working_volume(occ: torch.Tensor, origin, voxel_size, view_proj,
                    margin: float) -> torch.Tensor:
    """updateFrustumCulling's working volume (VolumeRaycastRenderer.cpp:
    1367-1481), on ``occ``'s device.

    8^3-cell visibility grid against the (42-degree-narrowed) frustum with
    a 0.8-reduced margin; voxels of invisible cells are zeroed.
    """
    dev = occ.device
    dz, dy, dx = occ.shape
    cell = 8
    gx, gy, gz = dx // cell + 1, dy // cell + 1, dz // cell + 1
    planes = frustum_planes(view_proj, dev)
    ox = _f32(_host(origin), dev)
    vs = _f32(_host(voxel_size), dev)
    ar = lambda n: torch.arange(n, dtype=f32, device=dev) * cell
    zz, yy, xx = torch.meshgrid(ar(gz), ar(gy), ar(gx), indexing="ij")
    lo = ox + torch.stack([xx, yy, zz], -1) * vs
    hi = lo + cell * vs
    margin = float(np.float32(margin) * np.float32(0.8))
    visible = test_aabb(planes, lo, hi, margin) >= 0     # [gz, gy, gx]
    vis_vox = visible.repeat_interleave(cell, 0).repeat_interleave(
        cell, 1).repeat_interleave(cell, 2)[:dz, :dy, :dx]
    return torch.where(vis_vox, (occ > 0).to(f32), 0.0)


def _working_volume_octree(occ: torch.Tensor, tree: LinearOctree, origin,
                           voxel_size, view_proj, margin) -> torch.Tensor:
    """The exact octree-visibility working volume, on ``occ``'s device.

    The reference's alternative culling (optimizedFrustumCulling /
    markVisibleNodesOnly / updateWorkingVolumeWithVisibility,
    VolumeRaycastRenderer.cpp:1068-1139, 1484-1580): frustum-classify the
    octree nodes, then keep only the voxels under visible solid leaves,
    node-exact instead of the 8^3-cell grid of :func:`_working_volume`.
    Each level's leaves paint their cells into the padded 2^L cube (one
    scatter and a nearest upsample a level), cropped to the grid.
    """
    dev = occ.device
    tree = tree.to(dev)
    vis = visible_node_mask(tree, origin, voxel_size, view_proj, margin)
    keep = vis & tree.is_leaf & tree.is_solid
    dz, dy, dx = occ.shape
    P = padded_cube_size(dx, dy, dz)
    # node ids grouped by level, ascending within each, in one upload
    level_np = tree.level.cpu().numpy()
    by_level = upload(np.argsort(level_np, kind="stable").astype(np.int32),
                      dev)
    counts = np.bincount(level_np)
    ends = np.cumsum(counts)
    mask = torch.zeros((dz, dy, dx), dtype=torch.bool, device=dev)
    for k in np.nonzero(counts)[0]:
        ids = by_level[ends[k] - counts[k]:ends[k]]
        s, g = 1 << int(k), P >> int(k)
        lin = ((tree.z[ids] // s * g + tree.y[ids] // s) * g
               + tree.x[ids] // s).long()
        lvl = torch.zeros(g * g * g + 1, dtype=torch.bool, device=dev)
        mark_true(lvl, lin, keep[ids])
        lvl = lvl[:-1].reshape(g, 1, g, 1, g, 1).expand(
            g, s, g, s, g, s).reshape(P, P, P)
        mask |= lvl[:dz, :dy, :dx]
    return torch.where(mask, (occ > 0).to(f32), 0.0)


@dataclasses.dataclass
class VolumeRaycastRenderer:
    """Stateful pipeline (init / draw / carve APIs mirror the reference)."""

    config: EngineConfig = DEFAULT_CONFIG
    device: DeviceLike = None
    textures: Optional[VolumeTextures] = None
    pyramid: Optional[OccupancyPyramid] = None
    grid: Optional[VoxelGrid] = None
    octree_skip_t: float = 0.0
    precompute_needed: bool = False
    use_frustum_culling: bool = False
    enable_octree_skip: bool = True
    use_mip_skipping: bool = True
    prev_cam_pos: Optional[np.ndarray] = None
    prev_look_dir: Optional[np.ndarray] = None
    time_value: float = 0.0
    splat_points: list = dataclasses.field(default_factory=list)
    # the sweep scene and the VolumeTextures it was built from: every
    # texture change makes a new VolumeTextures (dataclasses.replace), so
    # comparing identity is exact invalidation
    _sweep_scene: Optional[object] = None
    _sweep_src: Optional[VolumeTextures] = None
    # host copies of the grid's placement, read every frame
    _origin: Optional[np.ndarray] = None
    _voxel: Optional[float] = None

    # -- init (VolumeRaycastRenderer::init, .cpp:1334-1365) -----------------
    def init(self, grid: VoxelGrid,
             pyramid: Optional[OccupancyPyramid] = None):
        """Bind a scene (a ``core/grid.VoxelGrid``, moved to the renderer's
        device) and build its textures."""
        dev = resolve_device(self.device)
        grid = VoxelGrid(grid.occ.to(dev), grid.origin.to(dev),
                         grid.voxel_size.to(dev))
        self.grid = grid
        self._origin = grid.origin.cpu().numpy().astype(np.float32)
        self._voxel = float(grid.voxel_size.cpu())
        self.pyramid = pyramid if pyramid is not None else build_pyramid(
            grid.occ)
        vol = (grid.occ > 0).to(f32)
        box_min, box_max = grid.world_min, grid.world_max
        radiation = torch.zeros_like(vol)
        grad_mag, grad_dir, edge = precompute_volume(vol, radiation)
        self.textures = VolumeTextures(
            vol_mips=build_mip_chain(vol),
            working=vol,
            radiation=radiation,
            grad_mag=grad_mag,
            grad_dir=grad_dir,
            edge_factor=edge,
            ao=ambient_occlusion(grid.occ),
            indirect=torch.zeros(vol.shape + (3,), dtype=f32, device=dev),
            skip=build_skip_distance(grid.occ, grid.voxel_size, box_min,
                                     box_max),
            box_min=box_min,
            box_max=box_max,
        )
        self._sweep_scene = self._sweep_src = None
        return self

    # -- precompute refresh (dispatchPrecompute, .cpp:843-905) ---------------
    def run_precompute(self):
        tex = self.textures
        grad_mag, grad_dir, edge = precompute_volume(tex.vol_mips[0],
                                                     tex.radiation)
        self.textures = dataclasses.replace(
            tex, grad_mag=grad_mag, grad_dir=grad_dir, edge_factor=edge)
        self.precompute_needed = False

    # -- indirect lighting (updateIndirectLighting, .cpp:1903-1941) ----------
    def update_indirect_lighting(self, strength: float = 0.2):
        tex = self.textures
        ind = indirect_lighting(
            tex.vol_mips[0], tex.grad_dir, tex.radiation, MAIN_LIGHT_DIR,
            MAIN_LIGHT_COLOR / np.float32(4.0), strength=strength,
            radius=self.config.raymarch.indirect_light_radius)
        self.textures = dataclasses.replace(tex, indirect=ind)

    # -- frustum culling (updateFrustumCulling, .cpp:1367-1481) --------------
    def update_frustum_culling(self, camera: Camera, aspect: float,
                               tree: Optional[LinearOctree] = None):
        """The 8^3-cell working volume; with ``tree`` (a linear octree)
        the reference's exact octree-visibility variant
        (optimizedFrustumCulling, .cpp:1068-1139, 1484-1580)."""
        cfg = self.config.raymarch
        proj = perspective(cfg.frustum_fov_narrow_deg, aspect, 0.01, 5000.0)
        vp = (proj @ camera.get_view()).astype(np.float32)
        if tree is not None:
            working = _working_volume_octree(
                self.grid.occ, tree, self.grid.origin, self.grid.voxel_size,
                vp, 20.0)
        else:
            working = _working_volume(self.grid.occ, self.grid.origin,
                                      self.grid.voxel_size, vp, 20.0)
        self.textures = dataclasses.replace(self.textures, working=working)
        self.prev_cam_pos = camera.get_pos()
        self.prev_look_dir = camera.get_look_dir()

    # -- octree skip probe (drawRaycast, .cpp:1598-1664) ---------------------
    def update_octree_skip(self, camera: Camera, aspect: float):
        """7x7 central ray grid -> first-hit t, 15th percentile, 0.75
        safety, 0.4 temporal blend into octreeSkipT. Reads the hits back
        to the host, as the reference does."""
        cfg = self.config.raymarch
        k = cfg.octree_skip_probe
        res = 100     # the central k x k pixels of a virtual 100x100 view
        origins, dirs = generate_rays(
            res, res, camera.get_pos(), camera.get_view(),
            self.config.camera.fov_deg, aspect, device=self.grid.device)
        c0 = res // 2 - k // 2
        idx = torch.tensor([(c0 + iy) * res + (c0 + ix) for iy in range(k)
                            for ix in range(k)], device=origins.device)
        res_t = trace_octree(self.pyramid, origins[idx], dirs[idx],
                             self.grid.origin, self.grid.voxel_size,
                             max_steps=256)
        t = res_t["t"].cpu().numpy()
        hit = res_t["hit"].cpu().numpy()
        if hit.any():
            ts = np.sort(t[hit])
            q = ts[min(int(len(ts) * cfg.octree_skip_percentile),
                       len(ts) - 1)]
            new_skip = float(q) * cfg.octree_skip_safety
        else:
            new_skip = 0.0
        b = cfg.octree_skip_blend
        self.octree_skip_t = (1.0 - b) * self.octree_skip_t + b * new_skip

    # -- carving (updateSplatPoints + dispatchRadiationCompute) --------------
    def add_splat(self, world_pos, radius: Optional[float] = None):
        r = radius if radius is not None else \
            self.config.raymarch.carve_default_radius
        self.splat_points.append((np.asarray(world_pos, np.float32), float(r)))

    def dispatch_radiation(self):
        """Apply the queued splats (radius clamp 6)."""
        tex = self.textures
        rad = tex.radiation
        for pos, r in self.splat_points:
            rad = splat_radiation(rad, pos, r, tex.box_min, tex.box_max)
        self.splat_points = []
        self.textures = dataclasses.replace(tex, radiation=rad)
        self.precompute_needed = True

    def carve_at_screen(self, camera: Camera, sx: float, sy: float,
                        width: int, height: int, aspect: float) -> bool:
        """Mouse-click carve (mouseButtonCallback path, main.cpp:643-702)."""
        ndc_x = (sx / width) * 2.0 - 1.0
        ndc_y = 1.0 - (sy / height) * 2.0
        inv_v = np.linalg.inv(camera.get_view())
        inv_p = np.linalg.inv(camera.get_proj(aspect))
        clip = np.array([ndc_x, ndc_y, 1.0, 1.0], np.float32)
        view = inv_p @ clip
        view = view / view[3]
        world = (inv_v @ view)[:3]
        rd = world - camera.get_pos()
        rd = rd / np.linalg.norm(rd)
        hit, pos = pick_voxel(
            self.grid, camera.get_pos(), rd, self.textures.box_min,
            self.textures.box_max,
            max_steps=self.config.raymarch.pick_max_steps)
        if bool(hit):
            self.add_splat(pos.cpu().numpy(),
                           self.config.raymarch.carve_default_radius)
            self.dispatch_radiation()
            return True
        return False

    # -- frame (drawRaycast, .cpp:1583-1692) ---------------------------------
    def draw(self, camera: Camera, width: int, height: int,
             aspect: float) -> dict:
        """The per-ray oracle frame (:func:`raymarch.raymarch_volume`)."""
        if self.precompute_needed:
            self.run_precompute()
        if self.enable_octree_skip:
            self.update_octree_skip(camera, aspect)
        out = raymarch_volume(
            self.textures, camera.get_pos(),
            np.linalg.inv(camera.get_view()),
            np.linalg.inv(camera.get_proj(aspect)), width, height,
            time_value=self.time_value,
            octree_skip_t=self.octree_skip_t if self.enable_octree_skip
            else 0.0,
            prev_cam_pos=self.prev_cam_pos, prev_look_dir=self.prev_look_dir,
            use_frustum_culling=self.use_frustum_culling,
            enable_octree_skip=self.enable_octree_skip,
            use_mip_skip=self.use_mip_skipping,
            max_steps=self.config.raymarch.max_steps,
            device=self.grid.device)
        self.prev_cam_pos = camera.get_pos()
        self.prev_look_dir = camera.get_look_dir()
        return out

    def sweep_scene(self):
        """The sweep scene of the current textures, built again after any
        texture change (carving, precompute, indirect light)."""
        if self.precompute_needed:
            self.run_precompute()
        if self._sweep_scene is None or self._sweep_src is not self.textures:
            self._sweep_scene = prepare_volume_scene(
                self.textures, self._voxel, device=self.grid.device)
            self._sweep_src = self.textures
        return self._sweep_scene

    def draw_fast(self, camera: Camera, width: int, height: int,
                  aspect: float) -> dict:
        """The sweep-space frame: the production VOLUME_RAYCAST path
        (:func:`raymarch_sweep.render_volume_frame`). ``draw`` stays as the
        reference-semantics oracle. The frustum working volume is not
        applied here (it culls memory, not visibility)."""
        out = render_volume_frame(
            self.sweep_scene(), self._origin, camera.get_pos(),
            camera.get_view(), camera.config.fov_deg, aspect, width, height,
            time_value=float(self.time_value), device=self.grid.device)
        self.prev_cam_pos = camera.get_pos()
        self.prev_look_dir = camera.get_look_dir()
        return out
