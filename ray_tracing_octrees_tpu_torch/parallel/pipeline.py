"""Two-stage software pipeline of the fast frame over a pose sequence.

Counterpart of ``ray_tracing_octrees_tpu/parallel/pipeline.py``. The
reference pipelines frames by re-blitting cached FBOs while heavy modes
re-render every Nth frame (main.cpp:1204, 1348). Here the fast frame
splits into two stages: (1) the sweep, which makes the packed depth +
shadow table, and (2) the per-pixel finish: ray set-up, the table lookup
through ``warp_lookup`` and the shading. Stage 1 of pose i+1 is enqueued
before stage 2 of pose i.

On CUDA the sweeps run on one stream and the finishes on a second, so
the two overlap on the card. An event orders each table's finish after
its sweep, and ``record_stream`` keeps each table's memory from reuse
until its finish has run: the caching allocator's reuse takes the place
of the reference's donated buffers. On the CPU the stages run in the
same order on one stream.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ss


def render_fast_frames_pipelined(
    volume,
    shadow_vol,
    grid_origin,
    voxel_size,
    poses: Sequence[Tuple[np.ndarray, np.ndarray]],  # (cam_pos, view) pairs
    fov_deg: float,
    aspect: float,
    width: int,
    height: int,
    light_dir=(-1.0, -1.0, -1.0),
    base_color=(1.0, 0.8, 0.6),
    ambient=(0.1, 0.1, 0.1),
    inter_h: int = 1024,
    inter_w: int = 1024,
    layouts: Optional[ss.SweepLayouts] = None,
    device: DeviceLike = None,
) -> List[torch.Tensor]:
    """Render a pose sequence as a two-stage pipeline: f32[H, W, 4] rgba
    frames on ``device`` (CUDA unless ``device="cpu"``).

    Each frame equals ``slab_sweep.render_fast_frame(..., fused=False)``
    at the same pose bit for bit; only the scheduling differs.
    ``layouts`` (one per scene, as for ``render_fast_frame``) keeps the
    sweep-order copies across poses and calls."""
    dev = resolve_device(device)
    layouts = ss._scene_layouts(volume, shadow_vol, layouts, dev)
    origin = np.asarray(ss._host(grid_origin), np.float32)
    vox = float(ss._host(voxel_size))
    cuda = dev.type == "cuda"

    # the layouts are made (or found) on the caller's stream, first
    prepared = [ss._frame_setup(layouts, origin, vox, cam_pos, view, fov_deg,
                                aspect, light_dir, base_color, ambient)
                for cam_pos, view in poses]
    if cuda:
        main = torch.cuda.current_stream(dev)
        sweep_stream = torch.cuda.Stream(dev)
        finish_stream = torch.cuda.Stream(dev)
        sweep_stream.wait_stream(main)
        finish_stream.wait_stream(main)
        on = torch.cuda.stream
    else:
        sweep_stream = finish_stream = None
        on = lambda s: contextlib.nullcontext()

    def sweep(axis_world, flip, sab, _window, scal_np, vol_bf, shv):
        if cuda:
            # layouts of a call without caller's layouts die with the call
            for t in (vol_bf, shv):
                if t is not None:
                    t.record_stream(sweep_stream)
        scal = upload(scal_np, dev)
        packed = ss._sweep_all(vol_bf, scal, *sab, inter_h, inter_w, flip,
                               shadow_sw=shv)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(sweep_stream)
        return packed, scal_np, axis_world, ready

    def finish(packed, scal_np, axis_world, ready):
        if cuda:
            finish_stream.wait_event(ready)
            # the table was made on the sweep stream: keep its memory from
            # reuse there until this stream has read it
            packed.record_stream(finish_stream)
        scal = upload(scal_np, dev)
        consts = upload(ss._view_consts(scal_np), dev)
        lin, behind, dirs, d_s_n = ss._warp_setup(
            scal, axis_world, inter_h, inter_w, width, height, consts)
        w_val = ss._warp_values(packed, lin, inter_h, inter_w, width, height)
        return ss._finish_shade(w_val, behind, dirs, d_s_n, scal, width,
                                height, layouts.shadow is not None)

    frames: List[torch.Tensor] = []
    pending = None   # pose i's table while pose i+1's sweep is enqueued
    for args in prepared:
        with on(sweep_stream):
            table = sweep(*args)
        if pending is not None:
            with on(finish_stream):
                frames.append(finish(*pending))
        pending = table
    if pending is not None:
        with on(finish_stream):
            frames.append(finish(*pending))
    if cuda:
        main.wait_stream(finish_stream)
        for f in frames:
            f.record_stream(main)
    return frames
