"""Multi-frame and multi-device paths: the two-stage pipelined fast
frames on one card, and the device mesh, the sharded and slab-segmented
frames and the distributed start-up on ``torch.distributed``."""

from ray_tracing_octrees_tpu_torch.parallel.mesh import make_mesh, ray_sharding
from ray_tracing_octrees_tpu_torch.parallel.sharding import (
    trace_sharded,
    render_image_sharded,
    marching_cubes_halo,
)
from ray_tracing_octrees_tpu_torch.parallel.pipeline import (
    render_fast_frames_pipelined,
)
from ray_tracing_octrees_tpu_torch.parallel.distributed import (
    initialize_distributed,
    local_slice,
)

__all__ = [
    "make_mesh",
    "ray_sharding",
    "trace_sharded",
    "render_image_sharded",
    "marching_cubes_halo",
    "render_fast_frames_pipelined",
    "initialize_distributed",
    "local_slice",
]
