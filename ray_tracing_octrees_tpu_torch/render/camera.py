"""Orbital camera and projection math.

Counterpart of ``ray_tracing_octrees_tpu/render/camera.py`` (Camera.{h,cpp}):
a spherical-coordinate orbit (theta = elevation, phi = azimuth, radius)
around a pannable target, lookAt view and a 45-degree perspective
projection. Matrices are float32 numpy arrays in row-major math convention
(M @ column_vector). ``generate_rays`` is the pinhole ray generator
(``generateRay``, RayTracerBVH.cpp:338-355) on tensors.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.config import CameraConfig
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _fdiv, _sqrt
from ray_tracing_octrees_tpu_torch.trace.warp_kernel import view_rotation


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """Right-handed lookAt matrix (glm::lookAt semantics)."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = target - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_deg: float, aspect: float, near: float, far: float):
    """glm::perspective (OpenGL clip conventions, -1..1 depth)."""
    f = 1.0 / math.tan(math.radians(fovy_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


@dataclasses.dataclass
class Camera:
    """Orbital camera (Camera.cpp:8-95). Host-side state; matrices are numpy."""

    theta: float = 0.0
    phi: float = 0.0
    radius: float = 3.0
    target: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    config: CameraConfig = CameraConfig()

    def get_pos(self) -> np.ndarray:
        eye = self.radius * np.array(
            [
                math.cos(self.theta) * math.sin(self.phi),
                math.sin(self.theta),
                math.cos(self.theta) * math.cos(self.phi),
            ],
            np.float32,
        )
        return eye + self.target.astype(np.float32)

    def get_view(self) -> np.ndarray:
        return look_at(self.get_pos(), self.target)

    def get_proj(self, aspect: float) -> np.ndarray:
        c = self.config
        return perspective(c.fov_deg, aspect, c.near, c.far)

    def get_look_dir(self) -> np.ndarray:
        d = self.target.astype(np.float32) - self.get_pos()
        return d / np.linalg.norm(d)

    # -- interaction (Camera.cpp:53-84) ----------------------------------------
    def increment_theta(self, dt: float) -> None:
        nt = self.theta + dt * self.config.orbit_rate
        if -math.pi / 2 < nt < math.pi / 2:
            self.theta = nt

    def increment_phi(self, dp: float) -> None:
        self.phi -= dp * self.config.orbit_rate
        if self.phi > 2.0 * math.pi:
            self.phi -= 2.0 * math.pi
        elif self.phi < 0.0:
            self.phi += 2.0 * math.pi

    def increment_r(self, dr: float) -> None:
        self.radius = max(self.config.min_radius, self.radius - dr)

    def pan(self, dx: float, dy: float) -> None:
        look = self.get_look_dir()
        right = np.cross(look, np.array([0.0, 1.0, 0.0], np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(right, look)
        up = up / np.linalg.norm(up)
        self.target = self.target + (-dx * right + dy * up) * (
            self.radius * self.config.pan_rate)

    def set_target(self, t) -> None:
        self.target = np.asarray(t, np.float32)

    def pose_key(self, aspect: float) -> int:
        """Camera-pose cache hash (generateCacheFilename, main.cpp:27-45)."""
        pos = self.get_pos()
        h = 0
        for v in (pos[0], pos[1], pos[2], self.theta, self.phi, aspect):
            h ^= hash(round(float(v), 4)) + 0x9E3779B9 + (h << 6) + (h >> 2)
        return h & 0xFFFFFFFFFFFF


def generate_rays(width: int, height: int, cam_pos, view, fov_deg, aspect,
                  device: DeviceLike = None):
    """Per-pixel pinhole rays (generateRay, RayTracerBVH.cpp:338-355).

    Returns (origins f32[H*W, 3], directions f32[H*W, 3]) with pixel
    (px, py) at flat index py*width + px; py = 0 is the TOP row.

    tan(fov / 2) and the rotation come from the host
    (``warp_kernel.view_rotation``); the rest is f32 elementwise ops (IEEE
    divisions by ``_fdiv``, roots by ``_sqrt``, the sums of products as
    the multiply-adds the reference's compiled form fuses them into,
    ``raymarch._fma``), so the card's rays equal the CPU's bit for bit.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    tan_half, rot = view_rotation(fov_deg, view)
    tan_half, rot = float(tan_half), rot.tolist()
    px = _fdiv(torch.arange(width, dtype=f32, device=dev) + 0.5,
               width) * 2.0 - 1.0
    py = 1.0 - _fdiv(torch.arange(height, dtype=f32, device=dev) + 0.5,
                     height) * 2.0
    nx = px * float(aspect) * tan_half
    ny = py * tan_half
    nyg, nxg = torch.meshgrid(ny, nx, indexing="ij")
    nxg, nyg = nxg.reshape(-1), nyg.reshape(-1)
    # normalize (nx, ny, -1) in view space: z * z = 1 adds last
    n1 = _sqrt(_fma(nyg, nyg, nxg * nxg) + 1.0)
    dv = (nxg / n1, nyg / n1, -1.0 / n1)
    # rotate, d_view @ rot.T, and normalize in world space
    dw = [_fma(dv[2], rot[c][2], _fma(dv[1], rot[c][1], dv[0] * rot[c][0]))
          for c in range(3)]
    n2 = _sqrt(_fma(dw[2], dw[2], _fma(dw[1], dw[1], dw[0] * dw[0])))
    d_world = torch.stack([c / n2 for c in dw], -1)
    origins = torch.as_tensor(np.asarray(cam_pos, np.float32),
                              device=dev)[None, :].expand_as(d_world)
    return origins, d_world
