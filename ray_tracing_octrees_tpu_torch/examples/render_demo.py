"""Render one frame per pipeline to PNG: the headless demo.

Counterpart of ``examples/render_demo.py`` of the reference package:

    python -m ray_tracing_octrees_tpu_torch.examples.render_demo [outdir]

writes seven frames (fast, exact and fast-exact ray traces, Marching
Cubes, blocks, the volume raymarch and a volume close-up) into
``outdir`` (default ``frames_torch``). It loads the scene as the
application does (cache -> CSV -> sphere) on the CUDA device;
``main(outdir, device="cpu", width=..., height=..., config=...)`` runs
it on the CPU. Extraction modes render filled Phong triangles
(``render/raster.py``, test.frag parity); ray modes render their
native images.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

from ray_tracing_octrees_tpu_torch._device import DeviceLike
from ray_tracing_octrees_tpu_torch.config import EngineConfig

FRAMES = ("raytrace_fast.png", "raytrace_exact.png",
          "raytrace_fast_exact.png", "marching_cubes.png", "blocks.png",
          "volume_raycast.png", "volume_raycast_closeup.png")


def main(outdir: str = "frames_torch", device: DeviceLike = None,
         width: int = 960, height: int = 540,
         config: Optional[EngineConfig] = None) -> List[str]:
    """Write the seven frames; returns their paths."""
    from ray_tracing_octrees_tpu_torch.render.app import Application, RenderMode
    from ray_tracing_octrees_tpu_torch.render.image import write_png

    os.makedirs(outdir, exist_ok=True)
    app = Application(config=config or EngineConfig(), device=device).setup()
    app.camera.theta = 0.9
    app.camera.phi = 0.8
    app.camera.radius = 0.75 * app.camera.radius / 1.5  # 0.75x scene extent
    app.camera.set_target(app.building_center)

    W, H = width, height
    paths = []

    def write(name, img, note=""):
        path = os.path.join(outdir, name)
        write_png(path, img)
        paths.append(path)
        print(f"wrote {name}{note}")

    # fast slab-sweep ray trace
    write(FRAMES[0], app.raytracer.render(app.camera, W, H, W / H, fast=True,
                                          shadows=True))
    # exact octree ray trace (reference semantics; routes to the
    # sweep-exact tracer for this exterior pose, DDA-ladder fallback)
    write(FRAMES[1], app.raytracer.render(app.camera, W, H, W / H,
                                          shadows=True))
    # fast-exact cube tracer (trace/fast_exact.py)
    rt_cfg = app.raytracer.config
    try:
        app.raytracer.config = dataclasses.replace(rt_cfg, raytrace=(
            dataclasses.replace(rt_cfg.raytrace, use_fast_exact=True)))
        write(FRAMES[2], app.raytracer.render(app.camera, W, H, W / H,
                                              shadows=True))
    finally:
        app.raytracer.config = rt_cfg

    # marching cubes preview
    app.mode = RenderMode.MARCHING_CUBES
    out = app.frame(W, H)
    write(FRAMES[3], out["color"], f" ({out['mesh']['count']} tris)")

    # blocks preview
    app.mode = RenderMode.BLOCKS
    app._cached_mesh = None
    out = app.frame(W, H)
    write(FRAMES[4], out["color"], f" ({out['mesh']['count']} tris)")

    # volume raymarch via the sweep fast path at full demo resolution
    app.mode = RenderMode.VOLUME_RAYCAST
    write(FRAMES[5], app.frame(W, H)["color"])

    # close-up pose with the full shading stack engaged (the bright wash
    # is the per-ray oracle's too: its gamma and tone map saturate)
    app.camera.radius *= 0.35
    app.camera.theta = 0.45
    app._cached_frames.clear()
    write(FRAMES[6], app.frame(W, H)["color"])
    return paths


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "frames_torch")
