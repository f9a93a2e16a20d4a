"""Scene state across the two packages.

This system has no weights: what crosses between the JAX reference and
the port is the scene, an occupancy grid with its world placement, and
the structures built from it, such as the occupancy pyramid, the linear
octree, the volume renderer's textures (after carving or indirect
light, its whole state), the triangle LBVH and the traceable MC mesh
scene. These helpers move them through numpy, which both packages read.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
from ray_tracing_octrees_tpu_torch.core.octree import (
    LinearOctree, OccupancyPyramid,
)
from ray_tracing_octrees_tpu_torch.trace.lbvh import LBVH
from ray_tracing_octrees_tpu_torch.trace.mesh_grid import MCMeshScene
from ray_tracing_octrees_tpu_torch.trace.raymarch import VolumeTextures


def grid_from_numpy(occ, origin, voxel_size,
                    device: DeviceLike = None) -> VoxelGrid:
    """VoxelGrid on ``device`` from numpy ``occ`` (uint8[Z, Y, X]),
    ``origin`` (3 floats) and ``voxel_size``."""
    return VoxelGrid.create(np.asarray(occ, np.uint8), origin=origin,
                            voxel_size=voxel_size, device=device)


def grid_to_numpy(grid: VoxelGrid):
    """(occ uint8[Z, Y, X], origin f32[3], voxel_size f32) as numpy."""
    return (grid.occ.cpu().numpy().astype(np.uint8),
            grid.origin.cpu().numpy().astype(np.float32),
            np.float32(grid.voxel_size.cpu()))


def pyramid_from_numpy(code_levels,
                       device: DeviceLike = None) -> OccupancyPyramid:
    """OccupancyPyramid on ``device`` from the per-level uint8 code arrays
    (finest first), e.g. the JAX ``OccupancyPyramid.code_levels``."""
    dev = resolve_device(device)
    return OccupancyPyramid([
        torch.as_tensor(np.array(c, np.uint8), device=dev)
        for c in code_levels])


def pyramid_to_numpy(pyramid: OccupancyPyramid):
    """The per-level uint8 code arrays (finest first) as numpy."""
    return [c.cpu().numpy().astype(np.uint8) for c in pyramid.code_levels]


def _getter(src):
    """Field access on a mapping of names to arrays, or on any object with
    those attributes."""
    return src.__getitem__ if isinstance(src, Mapping) else \
        lambda k: getattr(src, k)


def linear_octree_from_numpy(src, device: DeviceLike = None) -> LinearOctree:
    """LinearOctree on ``device`` from ``src``: a mapping of its field
    names to arrays, or any object with those attributes, such as the JAX
    package's ``LinearOctree``. Integer fields become int32, the flags
    bool."""
    dev = resolve_device(device)
    get = _getter(src)
    as_t = lambda name: torch.as_tensor(np.array(
        get(name), bool if name.startswith("is_") else np.int32), device=dev)
    return LinearOctree(**{f.name: as_t(f.name)
                           for f in dataclasses.fields(LinearOctree)})


def linear_octree_to_numpy(tree: LinearOctree) -> dict:
    """The fields of ``tree`` as numpy arrays, by name."""
    return {f.name: getattr(tree, f.name).cpu().numpy()
            for f in dataclasses.fields(LinearOctree)}


def textures_from_numpy(src, device: DeviceLike = None) -> VolumeTextures:
    """VolumeTextures on ``device`` from ``src``: a mapping of its field
    names to arrays (``vol_mips`` a list of them), or any object with
    those attributes, such as the JAX package's ``VolumeTextures``."""
    dev = resolve_device(device)
    get = _getter(src)
    as_t = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    return VolumeTextures(**{
        f.name: [as_t(m) for m in get(f.name)] if f.name == "vol_mips"
        else as_t(get(f.name)) for f in dataclasses.fields(VolumeTextures)})


def textures_to_numpy(tex: VolumeTextures) -> dict:
    """The fields of ``tex`` as f32 numpy arrays, by name (``vol_mips`` a
    list)."""
    as_np = lambda t: t.cpu().numpy().astype(np.float32)
    return {f.name: [as_np(m) for m in tex.vol_mips] if f.name == "vol_mips"
            else as_np(getattr(tex, f.name))
            for f in dataclasses.fields(VolumeTextures)}


def lbvh_from_numpy(src, device: DeviceLike = None) -> LBVH:
    """LBVH on ``device`` from ``src``: a mapping of its field names to
    arrays, or any object with those attributes, such as the JAX
    package's ``LBVH``. Vertices and boxes become f32, the rest int32."""
    dev = resolve_device(device)
    get = _getter(src)
    as_t = lambda name: torch.as_tensor(np.array(
        get(name), np.float32 if name in ("tri_verts", "aabb_min",
                                          "aabb_max") else np.int32),
        device=dev)
    return LBVH(**{f.name: as_t(f.name) for f in dataclasses.fields(LBVH)})


def lbvh_to_numpy(bvh: LBVH) -> dict:
    """The fields of ``bvh`` as numpy arrays, by name."""
    return {f.name: getattr(bvh, f.name).cpu().numpy()
            for f in dataclasses.fields(LBVH)}


def mc_scene_from_numpy(src, device: DeviceLike = None) -> MCMeshScene:
    """MCMeshScene on ``device`` from ``src``: a mapping of ``case_vol``,
    ``shadow_cell`` (None for a scene without shadows), ``origin`` and
    ``voxel_size``, or any object with those attributes, such as the JAX
    package's ``MCMeshScene``."""
    dev = resolve_device(device)
    get = _getter(src)
    as_t = lambda a: None if a is None else torch.as_tensor(
        np.array(a, np.float32), device=dev)
    return MCMeshScene(case_vol=as_t(get("case_vol")),
                       shadow_cell=as_t(get("shadow_cell")),
                       origin=np.array(get("origin"), np.float32),
                       voxel_size=float(get("voxel_size")))


def mc_scene_to_numpy(scene: MCMeshScene) -> dict:
    """``case_vol``, ``shadow_cell`` (or None), ``origin`` and
    ``voxel_size`` as numpy values, by name."""
    as_np = lambda t: None if t is None else t.cpu().numpy().astype(
        np.float32)
    return dict(case_vol=as_np(scene.case_vol),
                shadow_cell=as_np(scene.shadow_cell),
                origin=np.asarray(scene.origin, np.float32),
                voxel_size=scene.voxel_size)
