"""Binary voxel-grid disk cache, byte-compatible with the reference format.

Counterpart of ``ray_tracing_octrees_tpu/core/cache.py``. File layout
(CacheUtils.cpp:5-58, little-endian, packed):

    int32   dimX, dimY, dimZ
    float32 minX, minY, minZ
    float32 voxelSize
    uint64  dataSize                  (size_t on x86-64)
    uint8   data[dataSize]            (x-major: x + y*dimX + z*dimX*dimY)
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ray_tracing_octrees_tpu_torch._device import DeviceLike
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid

_HEADER_FMT = "<iiiffffQ"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)  # 36 bytes


def save_voxel_grid(filename: str, grid: VoxelGrid) -> bool:
    """Serialize a grid to the reference's binary format (CacheUtils.cpp:5-29)."""
    occ = grid.occ.cpu().numpy().astype(np.uint8)
    origin = grid.origin.cpu().numpy().astype(np.float32)
    header = struct.pack(
        _HEADER_FMT, grid.dim_x, grid.dim_y, grid.dim_z,
        float(origin[0]), float(origin[1]), float(origin[2]),
        float(np.float32(grid.voxel_size.cpu())), occ.size,
    )
    with open(filename, "wb") as f:
        f.write(header)
        f.write(occ.tobytes(order="C"))
    return True


def _read_header(f):
    raw = f.read(_HEADER_SIZE)
    if len(raw) != _HEADER_SIZE:
        raise ValueError("truncated voxel-grid cache header")
    dim_x, dim_y, dim_z, min_x, min_y, min_z, voxel_size, data_size = \
        struct.unpack(_HEADER_FMT, raw)
    return dim_x, dim_y, dim_z, (min_x, min_y, min_z), voxel_size, data_size


def load_voxel_grid(filename: str, device: DeviceLike = None) -> VoxelGrid:
    """Load a full grid (CacheUtils.cpp:32-58). Raises on missing/corrupt file."""
    with open(filename, "rb") as f:
        dim_x, dim_y, dim_z, origin, voxel_size, data_size = _read_header(f)
        if data_size != dim_x * dim_y * dim_z:
            raise ValueError(
                f"cache dims {dim_x}x{dim_y}x{dim_z} disagree with payload {data_size}")
        data = np.frombuffer(f.read(data_size), dtype=np.uint8, count=data_size)
    occ = data.reshape(dim_z, dim_y, dim_x)
    return VoxelGrid.create(occ.copy(), origin=origin, voxel_size=voxel_size,
                            device=device)


def load_voxel_grid_partial(filename: str, start_layer: int, num_layers: int,
                            device: DeviceLike = None) -> VoxelGrid:
    """Load a contiguous Z-slab [start_layer, start_layer+num_layers).

    Matches ``loadVoxelGridPartial`` (CacheUtils.cpp:60-111): dimZ =
    num_layers and minZ shifted by start_layer * voxelSize.
    """
    with open(filename, "rb") as f:
        dim_x, dim_y, dim_z, origin, voxel_size, _ = _read_header(f)
        if start_layer < 0 or start_layer >= dim_z or start_layer + num_layers > dim_z:
            raise ValueError(
                f"requested layers [{start_layer}, {start_layer + num_layers}) out of"
                f" bounds for dimZ={dim_z}")
        layer_size = dim_x * dim_y
        f.seek(start_layer * layer_size, os.SEEK_CUR)
        count = layer_size * num_layers
        data = np.frombuffer(f.read(count), dtype=np.uint8, count=count)
    occ = data.reshape(num_layers, dim_y, dim_x)
    new_origin = (origin[0], origin[1], origin[2] + start_layer * voxel_size)
    return VoxelGrid.create(occ.copy(), origin=new_origin,
                            voxel_size=voxel_size, device=device)
