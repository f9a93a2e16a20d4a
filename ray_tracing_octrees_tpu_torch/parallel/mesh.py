"""Device-mesh construction for multi-device rendering.

Counterpart of ``ray_tracing_octrees_tpu/parallel/mesh.py``, on
``torch.distributed``: a mesh is a ``DeviceMesh`` over SPMD ranks (one
process per card, or gloo ranks on the CPU), and a sharding is a list of
DTensor placements, one per mesh axis. The scale-out maps

  ray batches  -> data parallel over the ``dp`` mesh axis (each rank traces
                  a contiguous slab of pixels; no communication),
  voxel grid   -> Z-slab sharding over the ``tp`` axis, mirroring the
                  reference's partial Z-slab cache loads
                  (CacheUtils.cpp:60-111), with halo / all-gather
                  collectives where stencils or traversal need neighbours.

The slab-segmented frames take a one-axis ``("sp",)`` mesh:
``init_device_mesh(device_type, (n,), mesh_dim_names=("sp",))``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    device: DeviceLike = None,
) -> DeviceMesh:
    """A (dp, tp) mesh over ranks [0, n) of the process group, as the
    reference's mesh over the first ``n_devices`` devices.

    Defaults: n = the group's world size; tp = 2 when n is even and > 1,
    else 1; dp = n / tp. Rays ride ``dp``; grid Z-slabs ride ``tp``. Rank
    r < n sits at (r // tp, r % tp). n above the world size raises. Every
    rank of the group calls it, since creating the axes' sub-groups is
    collective; a rank at or past n gets the mesh with ``get_coordinate()``
    None, and the :mod:`~ray_tracing_octrees_tpu_torch.parallel.sharding`
    functions return None there without joining a collective. The mesh's
    device type is CUDA unless ``device="cpu"``; without CUDA and without
    that this raises. The group must have been started
    (:func:`~ray_tracing_octrees_tpu_torch.parallel.distributed.
    initialize_distributed`).
    """
    dev = resolve_device(device)
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if tp is None:
        tp = 2 if (n % 2 == 0 and n > 1) else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != n_devices={n}")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    if n > dist.get_world_size():
        raise ValueError(f"n_devices={n} > the group's "
                         f"{dist.get_world_size()} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(dp, tp),
                      mesh_dim_names=("dp", "tp"))


def ray_sharding(mesh: DeviceMesh) -> List[Placement]:
    """Rays [N, 3] sharded over dp (replicated over tp)."""
    return [Shard(0), Replicate()]


def image_sharding(mesh: DeviceMesh) -> List[Placement]:
    """Flat per-pixel outputs [N, C] sharded over dp."""
    return [Shard(0), Replicate()]


def grid_z_sharding(mesh: DeviceMesh) -> List[Placement]:
    """Voxel grid (Z, Y, X) sharded over Z on tp."""
    return [Replicate(), Shard(0)]


def replicated(mesh: DeviceMesh) -> List[Placement]:
    return [Replicate()] * mesh.ndim
