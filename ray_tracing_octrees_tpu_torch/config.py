"""Configuration the port's slice needs: the orbital camera's settings.

Counterpart of ``ray_tracing_octrees_tpu/config.py::CameraConfig``, kept
as its own copy so the port never imports the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Orbital camera (Camera.cpp)."""

    fov_deg: float = 45.0
    near: float = 0.1
    far: float = 5000.0
    min_radius: float = 0.1
    orbit_rate: float = 0.01             # dt / 100
    pan_rate: float = 0.001              # radius * 0.001
