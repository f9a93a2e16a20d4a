"""Offline application shell: the engine's orchestration layer.

Counterpart of ``ray_tracing_octrees_tpu/render/app.py``, the headless
equivalent of the reference's ``main.cpp`` application (the GLFW window,
``Assignment4`` callbacks and the frame loop): the five-mode state
machine, input semantics, scene bootstrap (cache -> CSV -> sphere),
per-mode frame scheduling with cached-frame reuse, camera-change
detection, the DC triangle disk cache keyed by camera pose, the octree
wireframe overlay, carving, and FPS / throughput stats.

Every model and grid lives on the application's device (CUDA unless
``device="cpu"``). ``frame()`` returns host numpy arrays: a rendered
frame is copied to the host once, a replayed frame returns the cached
array itself. An extracted mesh stays on the device for the rasterizer
and is copied to the host once per extraction; the z-buffer of the last
rasterized pose stays on the device for the overlay's depth test.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import struct
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
from ray_tracing_octrees_tpu_torch.core.cache import (
    load_voxel_grid, save_voxel_grid,
)
from ray_tracing_octrees_tpu_torch.core.grid import (
    VoxelGrid, building_center, make_sphere_grid, recenter_filled_voxels,
)
from ray_tracing_octrees_tpu_torch.core.octree import (
    build_linear_octree, build_node_id_volume, build_pyramid,
)
from ray_tracing_octrees_tpu_torch.models.extraction import (
    MarchingCubesRenderer, VoxelBlockRenderer,
)
from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
    OctreeRayTracer,
)
from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
    VolumeRaycastRenderer,
)
from ray_tracing_octrees_tpu_torch.ops.dual_contouring import (
    adaptive_dual_contouring, tree_host_meta,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.render.frustum import visible_node_mask
from ray_tracing_octrees_tpu_torch.render.raster import (
    rasterize_lines, rasterize_triangles,
)
from ray_tracing_octrees_tpu_torch.render.wireframe import octree_wireframe
from ray_tracing_octrees_tpu_torch.utils.logging import get_logger
from ray_tracing_octrees_tpu_torch.utils.profiling import (
    FrameProfiler, StageTimer,
)

log = get_logger("app")


class RenderMode(enum.Enum):
    """The five pipelines, cycled by 'R' (main.cpp:495-501, 546-564)."""

    MARCHING_CUBES = 0
    BLOCKS = 1
    DUAL_CONTOURING = 2
    VOLUME_RAYCAST = 3
    OCTREE_RAYTRACE = 4

    def next(self) -> "RenderMode":
        return RenderMode((self.value + 1) % 5)


def load_scene(config: EngineConfig, search_dirs=(".",),
               device: DeviceLike = None) -> VoxelGrid:
    """Scene bootstrap (main.cpp:1022-1075): cache -> CSV -> sphere, on
    ``device``.

    A cache file under a search directory loads first; then
    ``DT/DTVerts.csv`` and ``DT/DTFaces.csv`` voxelize through the native
    library (which raises when it cannot be built) and the grid is saved
    to ``config.cache_filename``; only where no data is found does the
    sphere stand in. The CSV grid is recentred twice, as the reference's
    array port does (once before it is saved, once after)."""
    dev = resolve_device(device)
    if config.use_buildings:
        for d in search_dirs:
            path = os.path.join(d, config.cache_filename)
            if os.path.exists(path):
                log.info("loading scene cache %s", path)
                return recenter_filled_voxels(load_voxel_grid(path,
                                                              device=dev))
        verts = faces = None
        for d in search_dirs:
            v = os.path.join(d, "DT", "DTVerts.csv")
            f = os.path.join(d, "DT", "DTFaces.csv")
            if os.path.exists(v) and os.path.exists(f):
                verts, faces = v, f
                break
        if verts:
            from ray_tracing_octrees_tpu_torch.ingest.voxelize import (
                load_csv_into_voxel_grid,
            )

            grid = load_csv_into_voxel_grid(verts, faces, config.voxel_size,
                                            device=dev)
            if grid is not None:
                grid = recenter_filled_voxels(grid)
                save_voxel_grid(config.cache_filename, grid)
                return recenter_filled_voxels(grid)
        log.warning("no building data found; falling back to sphere scene")
    return recenter_filled_voxels(make_sphere_grid(config.sphere_dim,
                                                   device=dev))


@dataclasses.dataclass
class TriangleCache:
    """DC triangle disk cache keyed by camera pose (main.cpp:27-92).

    Files hold count + float32 triangle/normal dumps; the key hashes camera
    position, theta, phi and aspect to 4 decimals. The reference's array
    port writes and reads the same files.
    """

    directory: str = "triangle_cache"

    def filename(self, camera: Camera, aspect: float) -> str:
        return os.path.join(
            self.directory, f"dc_triangles_{camera.pose_key(aspect):012x}.bin"
        )

    def save(self, camera: Camera, aspect: float, verts, normals, count: int):
        os.makedirs(self.directory, exist_ok=True)
        v = np.asarray(verts)[:count].astype(np.float32)
        n = np.asarray(normals)[:count].astype(np.float32)
        with open(self.filename(camera, aspect), "wb") as f:
            f.write(struct.pack("<Q", count))
            f.write(v.tobytes())
            f.write(n.tobytes())

    def load(self, camera: Camera, aspect: float):
        path = self.filename(camera, aspect)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            (count,) = struct.unpack("<Q", f.read(8))
            v = np.frombuffer(f.read(count * 36), np.float32).reshape(count, 3, 3)
            n = np.frombuffer(f.read(count * 12), np.float32).reshape(count, 3)
        return v, n, count


class Mesh(NamedTuple):
    """An extracted mesh: host rows (``verts``, ``normals``, ``count``)
    and the same rows on the device for the rasterizer."""

    verts: np.ndarray
    normals: np.ndarray
    count: int
    verts_dev: torch.Tensor
    normals_dev: torch.Tensor


@dataclasses.dataclass
class Application:
    """Headless engine shell mirroring Assignment4 + the main loop."""

    config: EngineConfig = DEFAULT_CONFIG
    grid: Optional[VoxelGrid] = None
    mode: RenderMode = RenderMode.MARCHING_CUBES
    device: DeviceLike = None

    # toggles (key bindings, main.cpp:525-709)
    wireframe_fill: bool = False          # W
    show_octree_wireframe: bool = False   # S
    update_frustum_requested: bool = True  # F
    peel_plane: float = 0.0               # Up/Down (state only in reference)
    render_mode_toggle: bool = False      # X (state only in reference)
    force_dc_regenerate: bool = False     # G

    def __post_init__(self):
        self.camera = Camera(theta=0.4, phi=0.8, radius=3.0, config=self.config.camera)
        self.profiler = FrameProfiler(log=log.info)
        self.timer = StageTimer()
        self.tri_cache = TriangleCache()
        self._frame_idx = 0
        self._raycast_counter = 0
        self._raytrace_counter = 0
        # host frame and its device copy per ray mode
        self._cached_frames: Dict[RenderMode, np.ndarray] = {}
        self._cached_dev: Dict[RenderMode, torch.Tensor] = {}
        self._cached_mesh: Optional[Mesh] = None
        self._prev_view: Optional[np.ndarray] = None
        self._last_zbuf: Optional[torch.Tensor] = None
        self._last_zbuf_pose = None

    # -- scene -----------------------------------------------------------------
    def setup(self, grid: Optional[VoxelGrid] = None, search_dirs=(".",)):
        self._dev = dev = resolve_device(self.device)
        self.grid = (grid if grid is not None else
                     load_scene(self.config, search_dirs, device=dev)).to(dev)
        self.pyramid = build_pyramid(self.grid.occ)
        self.tree = build_linear_octree(self.grid.occ, device=dev)
        self._dc_accel = None  # lazy (node_id_vol, tree_meta) for adaptive DC
        self.mc = MarchingCubesRenderer(self.config, device=dev)
        self.blocks = VoxelBlockRenderer(self.config, device=dev)
        self.raytracer = OctreeRayTracer(self.config, device=dev)
        self.raytracer.set_octree(self.grid, self.pyramid, tree=self.tree)
        self.raycaster = VolumeRaycastRenderer(self.config, device=dev).init(
            self.grid, self.pyramid)
        self._origin = self.grid.origin.cpu().numpy().astype(np.float32)
        self._voxel = np.float32(self.grid.voxel_size.cpu())
        center = building_center(self.grid)
        self.building_center = center
        extent = (self.grid.world_max - self.grid.world_min).cpu().numpy()
        radius = 1.5 * float(np.max(extent))
        self.camera.radius = max(radius, self.config.camera.min_radius)
        log.info(
            "scene ready: dims=%s nodes=%d center=%s",
            self.grid.dims_xyz, self.tree.num_nodes, np.round(center, 2),
        )
        return self

    # -- input semantics ---------------------------------------------------------
    def handle_key(self, key: str):
        """Keyboard semantics (keyCallback, main.cpp:525-622)."""
        k = key.upper()
        if k == "R":
            self.mode = self.mode.next()
            self._cached_frames.clear()
            self._cached_dev.clear()
            self._cached_mesh = None
            log.info("mode -> %s", self.mode.name)
        elif k == "W":
            self.wireframe_fill = not self.wireframe_fill
        elif k == "S":
            self.show_octree_wireframe = not self.show_octree_wireframe
        elif k == "F":
            self.update_frustum_requested = True
        elif k == "C":
            self.camera.set_target(self.building_center)
        elif k == "UP":
            self.peel_plane += 1.0
        elif k == "DOWN":
            self.peel_plane -= 1.0
        elif k == "X":
            self.render_mode_toggle = not self.render_mode_toggle
        elif k == "O":
            self.raycaster.enable_octree_skip = not self.raycaster.enable_octree_skip
        elif k == "M":
            self.raycaster.use_mip_skipping = not self.raycaster.use_mip_skipping
        elif k == "G":
            self.force_dc_regenerate = True
            self._cached_mesh = None

    def orbit(self, dx: float, dy: float):
        self.camera.increment_phi(dx)
        self.camera.increment_theta(dy)

    def pan(self, dx: float, dy: float):
        self.camera.pan(dx, dy)

    def zoom(self, dr: float):
        self.camera.increment_r(dr)

    def click(self, sx: float, sy: float, width: int, height: int) -> bool:
        """Left click: carve in VolumeRaycast mode (main.cpp:643-702)."""
        if self.mode is not RenderMode.VOLUME_RAYCAST:
            return False
        return self.raycaster.carve_at_screen(
            self.camera, sx, sy, width, height, width / height
        )

    # -- frame loop ---------------------------------------------------------------
    def camera_changed(self) -> bool:
        """View-matrix element delta > 1e-4 (hasCameraChanged, main.cpp:755-771)."""
        view = self.camera.get_view()
        changed = (
            self._prev_view is None
            or np.abs(view - self._prev_view).max() > 1e-4
        )
        self._prev_view = view
        return changed

    def _view_proj(self, aspect: float) -> np.ndarray:
        return (self.camera.get_proj(aspect) @ self.camera.get_view()).astype(
            np.float32)

    def _extract_mesh(self, aspect: float) -> Mesh:
        vp = self._view_proj(aspect)
        if self.mode is RenderMode.MARCHING_CUBES:
            with self.timer.stage("extract/mc"):
                verts, normals, count = self.mc.render(self.grid, view_proj=vp)
                count = int(count)
        elif self.mode is RenderMode.BLOCKS:
            with self.timer.stage("extract/blocks"):
                verts, normals, count = self.blocks.render(self.grid, self.tree, view_proj=vp)
                count = int(count)
        else:  # DUAL_CONTOURING with pose-keyed disk cache (main.cpp:110-121)
            if not self.force_dc_regenerate:
                cached = self.tri_cache.load(self.camera, aspect)
                if cached is not None:
                    v, n, count = cached
                    # (the file's arrays are read-only: upload copies)
                    return Mesh(v, n, count, upload(v.copy(), self._dev),
                                upload(n.copy(), self._dev))
            with self.timer.stage("extract/dc"):
                mask = visible_node_mask(
                    self.tree, self.grid.origin, self.grid.voxel_size, vp,
                    self.config.extraction_frustum_margin,
                )
                if self._dc_accel is None:
                    # per-scene acceleration (the g_octreeMap analog +
                    # host tree metadata), built on first DC extraction
                    self._dc_accel = (
                        build_node_id_volume(self.tree),
                        tree_host_meta(self.tree),
                    )
                verts, normals, count = adaptive_dual_contouring(
                    self.grid, self.tree, node_mask=mask,
                    node_id_vol=self._dc_accel[0],
                    tree_meta=self._dc_accel[1], device_out=True,
                    device=self._dev,
                )
        # copies: the extraction's buffers hold max_triangles rows
        verts, normals = verts[:count].clone(), normals[:count].clone()
        mesh = Mesh(verts.cpu().numpy(), normals.cpu().numpy(), count, verts,
                    normals)
        if self.mode is RenderMode.DUAL_CONTOURING:
            self.tri_cache.save(self.camera, aspect, mesh.verts, mesh.normals,
                                count)
            self.force_dc_regenerate = False
        log.info("%s: %d triangles", self.mode.name, count)
        return mesh

    def frame(self, width: int, height: int) -> dict:
        """One frame: returns dict with 'color' (f32[H,W,4]) plus per-mode
        extras ('mesh' for extraction modes, 'wireframe' when toggled,
        'depth' for a rendered volume frame), all host numpy arrays.

        Scheduling matches the reference: VolumeRaycast renders every 7th
        frame, the octree ray trace every 6th or on camera change; other
        frames replay the cached image (main.cpp:1204, 1348, drawCachedFrame).
        """
        aspect = width / height
        changed = self.camera_changed()
        out: dict = {}
        mode = self.mode
        color_host = None

        if mode in (RenderMode.MARCHING_CUBES, RenderMode.BLOCKS, RenderMode.DUAL_CONTOURING):
            if self._cached_mesh is None or (changed and self.update_frustum_requested):
                self._cached_mesh = self._extract_mesh(aspect)
            mesh = self._cached_mesh
            out["mesh"] = dict(verts=mesh.verts, normals=mesh.normals, count=mesh.count)
            color = self._rasterize_preview(mesh, width, height)
        elif mode is RenderMode.VOLUME_RAYCAST:
            self._raycast_counter += 1
            if (
                mode not in self._cached_frames
                or self._raycast_counter % self.config.raymarch.frame_interval == 0
            ):
                if self.update_frustum_requested and self.raycaster.use_frustum_culling:
                    self.raycaster.update_frustum_culling(self.camera, aspect)
                with self.timer.stage("raycast", items=width * height):
                    if self.config.raymarch.use_sweep:
                        res = self.raycaster.draw_fast(
                            self.camera, width, height, aspect)
                    else:
                        res = self.raycaster.draw(
                            self.camera, width, height, aspect)
                self._cache_frame(mode, res["color"])
                out["depth"] = res["depth"].cpu().numpy()
            color, color_host = self._cached_dev[mode], self._cached_frames[mode]
        else:  # OCTREE_RAYTRACE
            self._raytrace_counter += 1
            if (
                mode not in self._cached_frames
                or changed
                or self._raytrace_counter % self.config.raytrace.frame_interval == 0
            ):
                if self.update_frustum_requested:
                    self.raytracer.update_frustum(self._view_proj(aspect))
                with self.timer.stage("raytrace", items=width * height):
                    img = self.raytracer.render(
                        self.camera, width, height, aspect,
                        use_culling=self.update_frustum_requested,
                    )
                self._cache_frame(mode, img)
            color, color_host = self._cached_dev[mode], self._cached_frames[mode]

        if self.show_octree_wireframe:
            vp = self._view_proj(aspect)
            segs, n_lines = octree_wireframe(
                self.tree, self._origin, self._voxel, vp,
                self.config.extraction_frustum_margin,
            )
            n_lines = int(n_lines)
            out["wireframe"] = dict(segments=segs.cpu().numpy(), count=n_lines)
            # draw the overlay depth-tested over the frame, as the
            # reference's white overrideColor line pass does
            # (main.cpp:1381-1409)
            if n_lines > 0:
                # Depth-test only against a z-buffer rasterized at THIS
                # pose; a buffer from a previous pose (or from a mode
                # that never rasterized) would occlude lines incorrectly.
                zb = self._last_zbuf
                if self._last_zbuf_pose != self._pose_token():
                    zb = None
                h, w = color.shape[:2]
                if zb is None or tuple(zb.shape) != (h, w):
                    zb = torch.full((h, w), 2.0, dtype=torch.float32,
                                    device=self._dev)
                # the drawn lines only: the rows past the count draw nothing
                color = rasterize_lines(color, zb, segs[:n_lines], vp, w, h)
                color_host = None

        out["color"] = color.cpu().numpy() if color_host is None else color_host
        self._frame_idx += 1
        self.raycaster.time_value = self._frame_idx / 60.0
        self.profiler.tick(mode.name)
        return out

    def _cache_frame(self, mode: RenderMode, img: torch.Tensor) -> None:
        """Keep a rendered ray-mode frame on the device and on the host
        (one copy); replayed frames return the host array itself."""
        self._cached_dev[mode] = img
        self._cached_frames[mode] = img.cpu().numpy()

    def _rasterize_preview(self, mesh: Mesh, width, height) -> torch.Tensor:
        """Filled-triangle Phong render of extracted meshes, on the device.

        The reference rasterizes via GL (test.vert/frag,
        main.cpp:1252-1259); headless, render/raster.py reproduces the
        MVP transform, z-buffered barycentric coverage, and the exact
        test.frag lighting terms. The depth buffer is kept for the
        wireframe overlay's depth test.
        """
        if mesh.count == 0:
            img = torch.zeros((height, width, 4), dtype=torch.float32,
                              device=self._dev)
            img[..., 3] = 1.0
            self._last_zbuf = None
            self._last_zbuf_pose = None
            return img
        colors = upload(np.asarray(self.config.mesh_base_color, np.float32),
                        self._dev).expand(mesh.count, 3)
        img, zbuf = rasterize_triangles(
            mesh.verts_dev, mesh.normals_dev, colors,
            self._view_proj(width / height), width, height,
            cam_pos=self.camera.get_pos(),
        )
        self._last_zbuf = zbuf
        self._last_zbuf_pose = self._pose_token()
        return img

    def _pose_token(self):
        """Hashable camera-pose snapshot keying pose-dependent buffers."""
        return tuple(
            np.asarray(self.camera.get_view(), np.float64).ravel().tolist())


def main(argv=None) -> None:
    """Headless render CLI: ``rto-render --mode VOLUME_RAYCAST --frames 3``.

    The CLI face of the application shell (the reference's interactive
    window, minus GLFW): loads the scene (cache -> CSV -> sphere), renders
    N frames in the requested mode while orbiting, writes PNGs. Runs on
    CUDA unless ``--device cpu``.
    """
    import argparse

    from ray_tracing_octrees_tpu_torch.config import (
        add_config_args, config_from_args,
    )
    from ray_tracing_octrees_tpu_torch.render.image import write_png

    p = argparse.ArgumentParser(prog="rto-render", description=main.__doc__)
    p.add_argument("--mode", default="OCTREE_RAYTRACE",
                   choices=[m.name for m in RenderMode])
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--orbit", type=float, default=0.05,
                   help="camera theta step per frame (radians)")
    p.add_argument("--out", default="frames", help="output directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    add_config_args(p)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    app = Application(config=cfg, device=args.device)
    app.setup()
    app.mode = RenderMode[args.mode]
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        out = app.frame(args.width, args.height)
        path = os.path.join(args.out, f"{args.mode.lower()}_{i:03d}.png")
        write_png(path, out["color"])
        log.info("wrote %s", path)
        app.orbit(args.orbit / cfg.camera.orbit_rate, 0.0)


if __name__ == "__main__":
    main()
