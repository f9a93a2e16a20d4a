"""Multi-frame and multi-device paths. Ported so far: the two-stage
pipelined fast frames; ``mesh``, ``sharding`` and ``distributed`` are
still to come (ROADMAP queue 1, item 8)."""

from ray_tracing_octrees_tpu_torch.parallel.pipeline import (
    render_fast_frames_pipelined,
)

__all__ = ["render_fast_frames_pipelined"]
