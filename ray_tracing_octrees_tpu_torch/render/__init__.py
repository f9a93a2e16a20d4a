from ray_tracing_octrees_tpu_torch.render.camera import Camera, look_at, perspective
from ray_tracing_octrees_tpu_torch.render.frustum import (
    frustum_planes,
    test_aabb,
    classify_nodes,
)

__all__ = [
    "Camera",
    "look_at",
    "perspective",
    "frustum_planes",
    "test_aabb",
    "classify_nodes",
]
