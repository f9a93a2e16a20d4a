"""ctypes bindings + build at first use of the native ingest runtime.

Counterpart of ``ray_tracing_octrees_tpu/native/runtime.py``, over the
port's own copy of ``voxelizer.cpp`` (CSV parsing, the OpenMP
voxelizer, the binary grid cache). The library is compiled at first use,
never at import, with ``g++ -O3 -fopenmp -shared -fPIC
-ffp-contract=off`` (``$CXX`` first when set, then the usual names:
the first compiler that builds it) into
``<package>/_build/voxelizer-<hash>.so`` (the hash covers the source and
the flags); a private temporary file renamed into place keeps two
processes building at once safe.

No quiet fallback: a failed build raises with the compiler's output.
:func:`available` says whether the library builds and loads, for
callers that choose the plain numpy route themselves.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device

SRC = Path(__file__).resolve().parent / "voxelizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the C++ compilers tried in turn, $CXX first when set: the first that
# builds the source with CXX_FLAGS is used (one whose OpenMP runtime is
# missing fails, and the next is tried)
CXX_CANDIDATES = tuple(dict.fromkeys(
    [c for c in (os.environ.get("CXX"),) if c]
    + ["g++", "c++", "/usr/bin/g++", "clang++"]))
# -ffp-contract=off: each f32 operation rounds alone, as the dense
# voxelizer's tensor ops do (a target with FMA would otherwise fuse the
# point-in-triangle dots and move boundary voxels)
CXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_libs = {}
BUILD_INFO = {}   # the last build: compiler, seconds, each attempt's output


def _target() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"voxelizer-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    failed = []
    for cxx in CXX_CANDIDATES:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except OSError as e:
            failed.append(f"{' '.join(cmd)}: {e}")
            continue
        if p.returncode == 0:
            os.replace(tmp, target)
            BUILD_INFO.update(compiler=cxx, seconds=time.perf_counter() - t0,
                              failed=failed)
            return
        tmp.unlink(missing_ok=True)
        failed.append(f"{' '.join(cmd)} (exit {p.returncode})\n"
                      f"{p.stdout}{p.stderr}")
    raise RuntimeError("native runtime build failed:\n" + "\n".join(failed))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_float, c_ll = ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    p_f32 = ctypes.POINTER(ctypes.c_float)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "voxelize_tris": (c_ll, [p_f32, c_ll, c_float, c_float, c_float,
                                 c_float, c_int, c_int, c_int, p_u8]),
        "save_voxel_grid": (c_int, [ctypes.c_char_p, c_int, c_int, c_int,
                                    c_float, c_float, c_float, c_float,
                                    p_u8]),
        "read_grid_header": (c_int, [ctypes.c_char_p,
                                     ctypes.POINTER(c_int), p_f32, p_f32,
                                     ctypes.POINTER(ctypes.c_uint64)]),
        "load_voxel_grid_slab": (c_int, [ctypes.c_char_p, c_int, c_int,
                                         p_u8]),
        "parse_csv": (c_ll, [ctypes.c_char_p, c_int, c_int, p_f64, c_ll]),
        "assemble_triangles": (c_ll, [p_f64, c_ll, p_f64, c_ll, p_f32,
                                      p_u8]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when the build
    or the load fails."""
    target = _target()
    with _lock:
        lib = _libs.get(target)
        if lib is None:
            if not target.exists():
                _build(target)
            lib = _libs[target] = _declare(ctypes.CDLL(str(target)))
    return lib


def available() -> bool:
    """Whether the native library builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def voxelize_triangles(tri_verts: np.ndarray, voxel_size: float,
                       max_axis: Optional[int] = None,
                       device: DeviceLike = None):
    """Native OpenMP voxelizer, on ``device``; the geometry rules of
    ``ingest.voxelize.voxelize_triangles``."""
    from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid
    from ray_tracing_octrees_tpu_torch.ingest.voxelize import (
        _CFG, grid_geometry,
    )

    dev = resolve_device(device)
    lib = _load()
    lo, _, vs, (dx, dy, dz) = grid_geometry(
        np.asarray(tri_verts), voxel_size,
        _CFG.max_grid_axis if max_axis is None else max_axis)
    occ = np.zeros(dx * dy * dz, np.uint8)
    tris = np.ascontiguousarray(tri_verts, np.float32)
    lib.voxelize_tris(_ptr(tris, ctypes.c_float), tris.shape[0],
                      lo[0], lo[1], lo[2], vs, dx, dy, dz,
                      _ptr(occ, ctypes.c_uint8))
    return VoxelGrid.create(occ.reshape(dz, dy, dx),
                            origin=(lo[0], lo[1], lo[2]), voxel_size=vs,
                            device=dev)


def parse_csv_file(path: str, min_tokens: int, n_numeric: int) -> np.ndarray:
    """Native tolerant CSV parse (loadCSVVertices / loadCSVFaces
    semantics): float64[rows, n_numeric]. Two calls: count, then fill."""
    lib = _load()
    n = lib.parse_csv(str(path).encode(), min_tokens, n_numeric, None, 0)
    if n < 0:
        raise IOError(f"cannot read CSV: {path}")
    out = np.zeros((int(n), n_numeric), np.float64)
    n2 = lib.parse_csv(str(path).encode(), min_tokens, n_numeric,
                       _ptr(out, ctypes.c_double), n)
    return out[: int(n2)]


def assemble_triangles_native(verts: np.ndarray, faces: np.ndarray):
    """Native (mesh#, vertex#) face resolution; the drop rules of
    ``ingest.csv_loader.assemble_triangles``. Returns (tris f32[K, 3, 3],
    kept bool[M])."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float64)
    f = np.ascontiguousarray(faces, np.float64)
    tris = np.zeros((f.shape[0], 3, 3), np.float32)
    kept = np.zeros(f.shape[0], np.uint8)
    k = lib.assemble_triangles(_ptr(v, ctypes.c_double), v.shape[0],
                               _ptr(f, ctypes.c_double), f.shape[0],
                               _ptr(tris, ctypes.c_float),
                               _ptr(kept, ctypes.c_uint8))
    return tris[: int(k)], kept.astype(bool)


def save_grid(path: str, grid) -> bool:
    """Write ``grid`` in the binary cache format (``core/cache.py``'s)."""
    lib = _load()
    occ = np.ascontiguousarray(grid.occ.cpu().numpy().astype(np.uint8))
    origin = grid.origin.cpu().numpy().astype(np.float32)
    return bool(lib.save_voxel_grid(
        str(path).encode(), grid.dim_x, grid.dim_y, grid.dim_z,
        float(origin[0]), float(origin[1]), float(origin[2]),
        float(grid.voxel_size.cpu()), _ptr(occ, ctypes.c_uint8)))


def load_grid(path: str, start_layer: int = 0,
              num_layers: Optional[int] = None, device: DeviceLike = None):
    """Read a cache file, whole or the Z-slab [start_layer, start_layer +
    num_layers), as a VoxelGrid on ``device``."""
    from ray_tracing_octrees_tpu_torch.core.grid import VoxelGrid

    dev = resolve_device(device)
    lib = _load()
    dims = (ctypes.c_int * 3)()
    mins = (ctypes.c_float * 3)()
    vs = ctypes.c_float()
    count = ctypes.c_uint64()
    if not lib.read_grid_header(str(path).encode(), dims, mins,
                                ctypes.byref(vs), ctypes.byref(count)):
        raise IOError(f"cannot read grid header: {path}")
    dx, dy, dz = dims[0], dims[1], dims[2]
    if num_layers is None:
        num_layers = dz - start_layer
    out = np.zeros(dx * dy * num_layers, np.uint8)
    if not lib.load_voxel_grid_slab(str(path).encode(), start_layer,
                                    num_layers, _ptr(out, ctypes.c_uint8)):
        raise IOError(f"cannot read grid slab: {path}")
    origin = (mins[0], mins[1], mins[2] + start_layer * vs.value)
    return VoxelGrid.create(out.reshape(num_layers, dy, dx), origin=origin,
                            voxel_size=vs.value, device=dev)
