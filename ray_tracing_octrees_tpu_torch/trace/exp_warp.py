"""Launchers of ``csrc/exp_warp.cu``: the warp experiments' four kernels.

The public wrappers live in :mod:`ray_tracing_octrees_tpu_torch.tools`
(one module per retired TPU experiment under ``tools/``). Each checks its
arguments, runs its plain PyTorch version on CPU tensors, and on CUDA
tensors calls one launcher here and counts the launch. A launcher takes
checked, contiguous CUDA tensors, allocates the output, launches on the
current stream and raises if the launch fails. There is no fallback.

Kernels 1, 3 and 4 come in forms (:func:`form`): the tile's own
instantiation, which reads 16-byte runs of the index fields, where the
tile has one and every index field is 16-byte aligned (the output is a
fresh allocation, which is); else the general instantiation (for kernel
4, the first port's kernel). Both are kernels of the source, and
:data:`FORM_LAUNCHES` counts each form's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ray_tracing_octrees_tpu_torch.trace import _build

# kernel 1's tiles with a compile-time instantiation; kernel 3 has 8 x 128
ONEHOT_TILES = ((8, 128), (16, 128), (32, 128), (16, 256))
# the general instantiation holds at most 16 pixels in each of 256 threads
GENERAL_MAX_PX = 256 * 16
_FORM_CODE = {"general": 0, "vector": 1}
FORM_LAUNCHES: Dict[str, int] = {
    f"{k} {f}": 0 for k in ("onehot_window", "row_window", "col_window")
    for f in _FORM_CODE}

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "onehot_window_launch": [_c_ptr, _c_int, _c_int, _c_ptr, _c_ptr, _c_int,
                             _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr],
    "ablate_launch": [_c_ptr, _c_int, _c_int, _c_ptr, _c_ptr, _c_int, _c_int,
                      _c_int, _c_ptr],
    "row_window_launch": [_c_ptr, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr,
                          _c_int, _c_int, _c_int, _c_int, _c_ptr],
    "col_window_launch": [_c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int,
                          _c_int, _c_int, _c_ptr],
}


def _call(entry: str, like: torch.Tensor, shape, *args) -> torch.Tensor:
    """Allocate f32 ``shape`` on ``like``'s device and run ``entry`` with
    ``args`` (ints and tensors, the output pointer placed by ``None``)."""
    fn = getattr(_build.load("exp_warp"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    dev = like.device
    with torch.cuda.device(dev):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        cargs = [out.data_ptr() if a is None else
                 a.data_ptr() if torch.is_tensor(a) else a for a in args]
        rc = fn(*cargs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    return out


def form(instantiated: bool, *tensors: torch.Tensor) -> str:
    """The form of kernel 1, 3 or 4 for a tile (``instantiated``: it has its
    own instantiation) and the index fields ``tensors``: "vector" where
    every one is 16-byte aligned, else "general"."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return "vector" if instantiated and aligned else "general"


def _check_32bit(**tensors: torch.Tensor) -> None:
    """Kernels 1 and 3, and kernel 4's vector form, index with 32-bit
    offsets."""
    for name, t in tensors.items():
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name} has {t.numel()} elements; the kernel "
                             f"takes fewer than 2^31")


def _launch_form(kernel: str, entry: str, tile_form: str, like, shape,
                 *args) -> torch.Tensor:
    """:func:`_call` of ``entry`` with the source's code of ``tile_form``
    appended to ``args``; counts the launch in :data:`FORM_LAUNCHES`."""
    out = _call(entry, like, shape, *args, _FORM_CODE[tile_form])
    FORM_LAUNCHES[f"{kernel} {tile_form}"] += 1
    return out


def onehot_window(t_hl: torch.Tensor, lin: torch.Tensor, ty: int, tx: int,
                  win: int) -> torch.Tensor:
    """Kernel 1 on bf16 ``t_hl`` [2 TH, TW] and int32 ``lin`` [H, W]."""
    th, tw = t_hl.shape[0] // 2, t_hl.shape[1]
    h, w = lin.shape
    _check_32bit(t_hl=t_hl, lin=lin)
    f = form((ty, tx) in ONEHOT_TILES, lin)
    if f == "general" and ty * tx > GENERAL_MAX_PX:
        raise ValueError(f"tile {ty}x{tx} has {ty * tx} pixels; the general "
                         f"instantiation takes at most {GENERAL_MAX_PX}")
    return _launch_form("onehot_window", "onehot_window_launch", f, lin,
                        (h, w), t_hl, th, tw, lin, None, h, w, ty, tx, win)


def ablate(t_hl: torch.Tensor, lin: torch.Tensor, kind: int) -> torch.Tensor:
    """Kernel 2, ablation ``kind``: 0 null, 1 intops, 2 twload, 3 select."""
    th, tw = t_hl.shape[0] // 2, t_hl.shape[1]
    h, w = lin.shape
    return _call("ablate_launch", lin, (h, w), t_hl, th, tw, lin, None, h, w,
                 kind)


def row_window(table: torch.Tensor, row_idx: torch.Tensor,
               col_idx: Optional[torch.Tensor], win: int) -> torch.Tensor:
    """Kernel 3 on f32 ``table`` [TH, C]; ``col_idx`` None reads column x."""
    th, tc = table.shape
    h, w = row_idx.shape
    _check_32bit(table=table, row_idx=row_idx)
    idx = (row_idx,) if col_idx is None else (row_idx, col_idx)
    return _launch_form("row_window", "row_window_launch", form(True, *idx),
                        row_idx, (h, w), table, th, tc, row_idx,
                        0 if col_idx is None else col_idx, None, h, w, win)


def col_window(m_rows: torch.Tensor, col_idx: torch.Tensor,
               win: int) -> torch.Tensor:
    """Kernel 4 on f32 ``m_rows`` [H, V] and int32 ``col_idx`` [H, W]."""
    h, w = col_idx.shape
    _check_32bit(m_rows=m_rows, col_idx=col_idx)
    return _launch_form("col_window", "col_window_launch",
                        form(True, col_idx), col_idx, (h, w), m_rows,
                        m_rows.shape[1], col_idx, None, h, w, win)
