"""Triangle-mesh voxelization into the binary grid.

Counterpart of ``ray_tracing_octrees_tpu/ingest/voxelize.py``, the port
of ``loadCSVDataIntoVoxelGrid`` (BuildingLoader.cpp:152-290):

  * padded float64 AABB of all vertices (padding = one voxel),
  * grid dims = ceil(extent / voxelSize), auto-coarsened so no axis
    exceeds 1000 (the reference scales voxelSize by the integer ratio
    max(dim // 1000), computed in size_t math),
  * for every face, the voxel-AABB of the triangle (clamped, with the
    reference's "+1" on the high side) is scanned and voxel CENTERS
    passing the projected barycentric point-in-triangle test
    (isPointInTriangle, BuildingLoader.cpp:131-149) are marked FILLED.

Three implementations, one set of voxels:
  * :func:`voxelize_triangles`: host numpy, per face over its voxel box,
    the reference package's loop;
  * :func:`voxelize_triangles_dense`: tensors on the device. The
    reference tests every face of a chunk against the whole grid and
    masks by the face's box (O(faces x voxels)); here each face of a
    chunk tests only the cells of its own box, enumerated up to the
    chunk's largest box, and marks them with one ``index_fill_`` (an
    idempotent write, so order does not matter);
  * ``native.runtime.voxelize_triangles``: the OpenMP C++ loop.

All three round the point-in-triangle test as the reference package's
numpy voxelizer does (:func:`point_in_triangle`: f32 dots, u and v in
float64), so they give its grid on every input. The reference package's
OpenMP library and dense form round u and v in f32 instead, and differ
from its numpy grid where voxel centres fall on a face's diagonal, as on
the seeded city of :mod:`.city`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.config import IngestConfig
from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid

_CFG = IngestConfig()
# cells tested per chunk of the dense voxelizer (faces x largest box)
_DENSE_CELLS = 1 << 22


def point_in_triangle(p, a, b, c):
    """Projected barycentric containment (isPointInTriangle,
    BuildingLoader.cpp:131-149) over [..., 3] tensors or arrays
    (broadcast); the 3D dots implicitly project p onto the triangle plane.

    Rounded as the reference package's numpy voxelizer rounds it, on
    every device: the dots (summed left to right), the denominator and the
    numerators in the inputs' precision, each operation alone; u and v in
    float64 from them (that code's guard term is a float64 array)."""
    p, a, b, c = (torch.as_tensor(x) for x in (p, a, b, c))
    dot = lambda u, v: u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] \
        + u[..., 2] * v[..., 2]
    v0 = c - a
    v1 = b - a
    v2 = p - a
    dot00, dot01, dot02 = dot(v0, v0), dot(v0, v1), dot(v0, v2)
    dot11, dot12 = dot(v1, v1), dot(v1, v2)
    denom = dot00 * dot11 - dot01 * dot01
    ok = denom.abs() >= 1e-7
    inv = 1.0 / torch.where(ok, denom, 1.0).double()
    u = (dot11 * dot02 - dot01 * dot12).double() * inv
    v = (dot00 * dot12 - dot01 * dot02).double() * inv
    return ok & (u >= 0) & (v >= 0) & (u + v <= 1)


def grid_geometry(tri_verts: np.ndarray, voxel_size: float,
                  max_axis: int = _CFG.max_grid_axis):
    """Bounds, auto-coarsened voxel size, and dims
    (BuildingLoader.cpp:166-211), in float64 on the host."""
    pts = tri_verts.reshape(-1, 3).astype(np.float64)
    finite = np.isfinite(pts).all(axis=1)
    pts = pts[finite]
    lo = pts.min(axis=0) - voxel_size
    hi = pts.max(axis=0) + voxel_size
    dims = np.ceil((hi - lo) / voxel_size).astype(np.int64)
    if (dims > max_axis).any():
        # the reference computes the scale with integer division (size_t)
        scale = max(int(d) // max_axis for d in dims)
        voxel_size = voxel_size * scale
        dims = np.ceil((hi - lo) / voxel_size).astype(np.int64)
    return lo, hi, float(voxel_size), tuple(int(d) for d in dims)


def voxelize_triangles(
    tri_verts: np.ndarray,  # float64[K, 3, 3] (x=easting, y=northing, z=elev)
    voxel_size: float,
    max_axis: int = _CFG.max_grid_axis,
    device: DeviceLike = None,
) -> VoxelGrid:
    """Host voxelizer (numpy), the OpenMP face loop one face at a time;
    the grid on ``device``."""
    lo, hi, vs, (dx, dy, dz) = grid_geometry(tri_verts, voxel_size, max_axis)
    occ = np.zeros((dz, dy, dx), np.uint8)
    tv = tri_verts.astype(np.float32)
    lo32 = lo.astype(np.float32)
    vs32 = np.float32(vs)

    for k in range(tv.shape[0]):
        a, b, c = tv[k]
        tmin = np.minimum(np.minimum(a, b), c)
        tmax = np.maximum(np.maximum(a, b), c)
        s = np.maximum(0, ((tmin - lo32) / vs32).astype(np.int32))
        e = np.minimum(
            np.array([dx - 1, dy - 1, dz - 1]),
            ((tmax - lo32) / vs32).astype(np.int32) + 1,
        )
        if (e < s).any():
            continue
        xs = lo32[0] + (np.arange(s[0], e[0] + 1, dtype=np.float32) + 0.5) * vs32
        ys = lo32[1] + (np.arange(s[1], e[1] + 1, dtype=np.float32) + 0.5) * vs32
        zs = lo32[2] + (np.arange(s[2], e[2] + 1, dtype=np.float32) + 0.5) * vs32
        zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
        centers = np.stack([xx, yy, zz], axis=-1)
        inside = point_in_triangle(centers, a, b, c).numpy()
        if inside.any():
            sub = occ[s[2]: e[2] + 1, s[1]: e[1] + 1, s[0]: e[0] + 1]
            sub[inside] = 1
    return VoxelGrid.create(occ, origin=(lo[0], lo[1], lo[2]),
                            voxel_size=vs, device=device)


def voxelize_triangles_dense(
    tri_verts,  # f32[K, 3, 3]
    voxel_size: float,
    max_axis: int = _CFG.max_grid_axis,
    device: DeviceLike = None,
) -> VoxelGrid:
    """Device voxelizer: the set :func:`voxelize_triangles` marks, each
    face tested on the cells of its own voxel box, on ``device``.

    One host sync reads the boxes' sizes; faces are then taken in order
    of box volume, in chunks of at most ``_DENSE_CELLS`` cells (chunk
    faces times the chunk's largest box), each chunk one pass of tensor
    ops and one ``index_fill_``.
    """
    dev = resolve_device(device)
    tri_np = np.asarray(tri_verts, np.float64)
    lo, _, vs, (dx, dy, dz) = grid_geometry(tri_np, voxel_size, max_axis)
    tv = upload(tri_np.astype(np.float32), dev)
    lo32 = upload(lo.astype(np.float32), dev)
    vs32 = torch.full((), np.float32(vs), device=dev)
    a, b, c = tv[:, 0], tv[:, 1], tv[:, 2]
    tmin = torch.minimum(torch.minimum(a, b), c)
    tmax = torch.maximum(torch.maximum(a, b), c)
    s = torch.clamp(((tmin - lo32) / vs32).to(torch.int32), min=0)
    top = torch.tensor([dx - 1, dy - 1, dz - 1], dtype=torch.int32,
                       device=dev)
    e = torch.minimum(top, ((tmax - lo32) / vs32).to(torch.int32) + 1)
    ext = torch.clamp(e - s + 1, min=0)
    ext = ext * (ext > 0).all(dim=1, keepdim=True)      # empty boxes: 0
    ext_h = ext.cpu().numpy().astype(np.int64)            # the one sync
    n_cells = dx * dy * dz
    occ = torch.zeros(n_cells + 1, dtype=torch.uint8, device=dev)
    order = np.argsort(ext_h.prod(1), kind="stable")
    order = order[ext_h[order].prod(1) > 0]
    i = 0
    while i < order.size:
        # grow the chunk while faces x its largest box stays in budget
        j, box = i + 1, ext_h[order[i]].copy()
        while j < order.size:
            nb = np.maximum(box, ext_h[order[j]])
            if (j + 1 - i) * int(nb.prod()) > _DENSE_CELLS:
                break
            box, j = nb, j + 1
        idx = upload(order[i:j], dev)
        _fill_chunk(occ, a[idx], b[idx], c[idx], s[idx], ext[idx], box,
                    lo32, vs32, (dx, dy, dz))
        i = j
    return VoxelGrid.create(occ[:n_cells].reshape(dz, dy, dx),
                            origin=(lo[0], lo[1], lo[2]), voxel_size=vs,
                            device=dev)


def _fill_chunk(occ, a, b, c, s, ext, box, lo32, vs32, dims) -> None:
    """Mark the cells of the chunk's faces' boxes whose centres pass the
    test: cells enumerated on a [bz, by, bx] lattice from each face's box
    corner ``s`` (int32[C, 3], x y z), kept where inside the face's
    ``ext``; the rest write the spare last slot of ``occ``."""
    dx, dy, dz = dims
    dev = occ.device
    bx, by, bz = (int(v) for v in box)
    off = [torch.arange(n, dtype=torch.int32, device=dev) for n in (bx, by, bz)]
    shape = {0: (1, 1, 1, bx), 1: (1, 1, by, 1), 2: (1, bz, 1, 1)}
    cell, keep = [], None
    for ax in range(3):
        o = off[ax].reshape(shape[ax])
        cell.append(s[:, ax].reshape(-1, 1, 1, 1) + o)
        k = o < ext[:, ax].reshape(-1, 1, 1, 1)
        keep = k if keep is None else keep & k
    centre = torch.stack(torch.broadcast_tensors(*[
        lo32[ax] + (cell[ax].to(torch.float32) + 0.5) * vs32
        for ax in range(3)]), dim=-1)
    tri = lambda v: v[:, None, None, None, :]
    inside = point_in_triangle(centre, tri(a), tri(b), tri(c)) & keep
    flat = (cell[2].to(torch.int64) * dy + cell[1]) * dx + cell[0]
    flat = torch.where(inside, flat, dx * dy * dz)
    occ.index_fill_(0, flat.reshape(-1), 1)


def load_csv_into_voxel_grid(verts_path, faces_path, voxel_size: float = 5.0,
                             use_native: bool = True,
                             device: DeviceLike = None
                             ) -> Optional[VoxelGrid]:
    """End-to-end CSV -> VoxelGrid (loadCSVDataIntoVoxelGrid), on
    ``device``; None when no triangle survives.

    ``use_native=True`` runs every stage in the native library (CSV parse
    where both paths are file paths, face assembly, the OpenMP
    voxelizer); a library that cannot be built raises with the
    compiler's output. ``use_native=False`` runs the numpy stages.
    """
    from ray_tracing_octrees_tpu_torch.ingest.csv_loader import (
        assemble_triangles, load_csv_faces, load_csv_vertices,
    )

    dev = resolve_device(device)
    rt = None
    if use_native:
        from ray_tracing_octrees_tpu_torch.native import runtime as rt

        rt._load()
    if rt is not None and isinstance(verts_path, str) \
            and isinstance(faces_path, str):
        verts = rt.parse_csv_file(verts_path, 8, 8)
        faces = rt.parse_csv_file(faces_path, 4, 4)
    else:
        verts = load_csv_vertices(verts_path)
        faces = load_csv_faces(faces_path)
    if verts.size == 0 or faces.size == 0:
        return None
    if rt is not None:
        tris, _ = rt.assemble_triangles_native(verts, faces)
    else:
        tris, _ = assemble_triangles(verts, faces)
    if tris.size == 0:
        return None
    if rt is not None:
        return rt.voxelize_triangles(tris, voxel_size, device=dev)
    return voxelize_triangles(tris, voxel_size, device=dev)
