from ray_tracing_octrees_tpu_torch.utils.logging import get_logger
from ray_tracing_octrees_tpu_torch.utils.profiling import FrameProfiler, StageTimer

__all__ = ["get_logger", "FrameProfiler", "StageTimer"]
