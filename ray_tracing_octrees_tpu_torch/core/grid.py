"""Dense binary voxel grid: the scene's core tensor.

Counterpart of ``ray_tracing_octrees_tpu/core/grid.py``. Occupancy is a
C-contiguous ``uint8[dimZ, dimY, dimX]`` tensor indexed ``occ[z, y, x]``,
the reference's x-major flat buffer (``index = x + y*dimX + z*dimX*dimY``,
453-skeleton/OctreeVoxel.h:28-42) reshaped. 1 = FILLED, 0 = EMPTY.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Binary occupancy grid with world placement.

    Attributes:
      occ:        uint8[dimZ, dimY, dimX]; 1 = FILLED, 0 = EMPTY.
      origin:     float32[3] = (minX, minY, minZ) world coordinate of the
                  (0,0,0) voxel's min corner.
      voxel_size: float32[] uniform voxel edge length in world units.
    """

    occ: torch.Tensor
    origin: torch.Tensor
    voxel_size: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.occ.device

    @property
    def dim_x(self) -> int:
        return self.occ.shape[2]

    @property
    def dim_y(self) -> int:
        return self.occ.shape[1]

    @property
    def dim_z(self) -> int:
        return self.occ.shape[0]

    @property
    def dims_xyz(self) -> Tuple[int, int, int]:
        return (self.dim_x, self.dim_y, self.dim_z)

    def to(self, device) -> "VoxelGrid":
        return VoxelGrid(self.occ.to(device), self.origin.to(device),
                         self.voxel_size.to(device))

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.occ.shape))

    @property
    def world_min(self) -> torch.Tensor:
        return self.origin

    @property
    def world_max(self) -> torch.Tensor:
        dims = torch.tensor([self.dim_x, self.dim_y, self.dim_z],
                            dtype=torch.float32, device=self.device)
        return self.origin + dims * self.voxel_size

    def at_xyz(self, x, y, z) -> torch.Tensor:
        """Occupancy at integer voxel coords (no bounds checking)."""
        return self.occ[z, y, x]

    def scalar_field_safe(self, x, y, z) -> torch.Tensor:
        """-1.0 where FILLED, +1.0 where EMPTY or out of range: the sign
        convention of ``localMC``'s getScalar (OctreeVoxel.cpp:787-792) and
        DC's calculateIntersection (AdaptiveDualContouringRenderer.cpp:1253).
        """
        return torch.where(self.sample_safe(x, y, z) > 0, -1.0, 1.0).to(
            torch.float32)

    def grid_to_world(self, x, y, z) -> torch.Tensor:
        """World position f32[..., 3] of the voxel-corner lattice point
        (x, y, z): origin + index * voxelSize, as ``gridToWorld``
        (AdaptiveDualContouringRenderer.cpp:1358-1364)."""
        return self._world(x, y, z, 0.0)

    def voxel_center(self, x, y, z) -> torch.Tensor:
        """World position f32[..., 3] of voxel (x, y, z)'s centre."""
        return self._world(x, y, z, 0.5)

    def _world(self, x, y, z, shift: float) -> torch.Tensor:
        """origin + (index + shift) * voxelSize per axis, rounded once as
        a multiply-add, as in the reference package's compiled extraction
        (through f64: the same bits on every device)."""
        v = self.voxel_size.double()
        f = lambda c: torch.as_tensor(c, device=self.device).to(
            torch.float32) + shift
        return torch.stack([(f(c).double() * v + self.origin[a]).float()
                            for a, c in enumerate((x, y, z))], dim=-1)

    def sample_safe(self, x, y, z) -> torch.Tensor:
        """Occupancy with out-of-range treated as EMPTY.

        Matches ``getVoxelSafe`` (OctreeVoxel.cpp:694-702): out-of-range
        coordinates read as EMPTY. Vectorized over any index shape.
        """
        x, y, z = (torch.as_tensor(c, device=self.device) for c in (x, y, z))
        inb = ((x >= 0) & (y >= 0) & (z >= 0) & (x < self.dim_x)
               & (y < self.dim_y) & (z < self.dim_z))
        xc = x.clamp(0, self.dim_x - 1).long()
        yc = y.clamp(0, self.dim_y - 1).long()
        zc = z.clamp(0, self.dim_z - 1).long()
        return torch.where(inb, self.occ[zc, yc, xc], 0).to(torch.uint8)

    @staticmethod
    def create(occ, origin=(0.0, 0.0, 0.0), voxel_size=1.0,
               device: DeviceLike = None) -> "VoxelGrid":
        dev = resolve_device(device)
        if not torch.is_tensor(occ):
            occ = torch.from_numpy(np.ascontiguousarray(occ))
        occ = occ.to(device=dev, dtype=torch.uint8)
        if occ.ndim != 3:
            raise ValueError(f"occ must be 3D (Z,Y,X), got {tuple(occ.shape)}")
        return VoxelGrid(
            occ=occ.contiguous(),
            origin=torch.tensor(np.asarray(origin, np.float32), device=dev),
            voxel_size=torch.tensor(np.float32(voxel_size), device=dev),
        )


def generate_test_volume(dim_x: int, dim_y: int, dim_z: int,
                         device: DeviceLike = None) -> torch.Tensor:
    """Multi-shell sphere density: +1 in the shell, -1 elsewhere.

    Bit-matches ``generateTestVolume`` (main.cpp:337-372) and the JAX
    package's version: every step is f32 in the same order. Returns
    float32[dimZ, dimY, dimX].
    """
    dev = resolve_device(device)
    f32 = torch.float32
    cx = np.float32(0.5 * (dim_x - 1))
    cy = np.float32(0.5 * (dim_y - 1))
    cz = np.float32(0.5 * (dim_z - 1))
    min_dim = float(min(dim_x, dim_y, dim_z))
    r_outer = torch.tensor(np.float32(0.4 * min_dim), device=dev)
    r_inner = torch.tensor(np.float32(0.2 * min_dim), device=dev)
    x = torch.arange(dim_x, dtype=f32, device=dev) - float(cx)
    y = torch.arange(dim_y, dtype=f32, device=dev) - float(cy)
    z = torch.arange(dim_z, dtype=f32, device=dev) - float(cz)
    # the correctly rounded f32 root on every device (through f64): the
    # CPU's vectorized f32 torch.sqrt is an ulp off on some inputs
    dist = torch.sqrt((
        (x * x)[None, None, :] + (y * y)[None, :, None] + (z * z)[:, None, None]
    ).double()).to(f32)
    outside = (dist < r_inner) | (dist > r_outer)
    return torch.where(outside, -1.0, 1.0).to(f32)


def make_sphere_grid(dim: int = 256, device: DeviceLike = None) -> VoxelGrid:
    """The reference's sphere scene (main.cpp:1050-1071).

    origin (-0.5,-0.5,-0.5), voxelSize 1/dim, FILLED where density > 0.
    """
    dev = resolve_device(device)
    vol = generate_test_volume(dim, dim, dim, device=dev)
    occ = (vol > 0.0).to(torch.uint8)
    return VoxelGrid.create(occ, origin=(-0.5, -0.5, -0.5),
                            voxel_size=1.0 / dim, device=dev)


def filled_world_bounds(grid: VoxelGrid):
    """(min, max, any_filled) of the world AABB of FILLED voxel *centers*.

    Matches ``recenterFilledVoxels`` (main.cpp:376-422) and the
    building-centre scan (main.cpp:1080-1105). Host-side numpy.
    """
    occ = grid.occ.cpu().numpy() > 0
    origin = grid.origin.cpu().numpy().astype(np.float32)
    vs = float(grid.voxel_size.cpu())
    any_filled = bool(occ.any())

    def axis_bounds(mask_1d, origin_c):
        idx = np.nonzero(mask_1d)[0]
        lo = idx[0] if idx.size else 0
        hi = idx[-1] if idx.size else -1
        return (origin_c + (lo + 0.5) * vs, origin_c + (hi + 0.5) * vs)

    lo_x, hi_x = axis_bounds(occ.any(axis=(0, 1)), origin[0])
    lo_y, hi_y = axis_bounds(occ.any(axis=(0, 2)), origin[1])
    lo_z, hi_z = axis_bounds(occ.any(axis=(1, 2)), origin[2])
    lo = np.array([lo_x, lo_y, lo_z], np.float32)
    hi = np.array([hi_x, hi_y, hi_z], np.float32)
    return lo, hi, any_filled


def recenter_filled_voxels(grid: VoxelGrid) -> VoxelGrid:
    """Shift the origin so the filled-region centre sits at the world origin
    (main.cpp:376-422). A grid with no filled voxels is returned unchanged."""
    lo, hi, any_filled = filled_world_bounds(grid)
    if not any_filled:
        return grid
    center = 0.5 * (lo + hi)
    new_origin = grid.origin.cpu().numpy().astype(np.float32) - center
    return dataclasses.replace(
        grid, origin=torch.tensor(new_origin, device=grid.device))


def building_center(grid: VoxelGrid) -> np.ndarray:
    """Centre of the filled AABB (main.cpp:1080-1105); zeros when empty."""
    lo, hi, any_filled = filled_world_bounds(grid)
    return 0.5 * (lo + hi) if any_filled else np.zeros(3, np.float32)
