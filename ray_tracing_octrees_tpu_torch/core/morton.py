"""Morton (Z-order) encoding for 3D integer coordinates.

Counterpart of ``ray_tracing_octrees_tpu/core/morton.py``: 10 bits per
axis packed into 30-bit codes (the LBVH's triangle sort) and a 21-bit
variant packed into 63-bit codes. The reference works in uint32 and
uint64; PyTorch's unsigned types lack most operations on CUDA, so codes
are carried in int64 here. Both widths fit, since bit 63 is never set,
and every code equals the reference's bit for bit.
"""

from __future__ import annotations

import torch

i64 = torch.int64


def _part1by2_10(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.to(i64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _compact1by2_10(v: torch.Tensor) -> torch.Tensor:
    v = v.to(i64) & 0x09249249
    v = (v ^ (v >> 2)) & 0x030C30C3
    v = (v ^ (v >> 4)) & 0x0300F00F
    v = (v ^ (v >> 8)) & 0x030000FF
    v = (v ^ (v >> 16)) & 0x000003FF
    return v


def morton_encode_10(x, y, z) -> torch.Tensor:
    """30-bit Morton code (int64) from 10-bit x, y, z (x in the lowest
    interleave slot)."""
    return (_part1by2_10(x) | (_part1by2_10(y) << 1)
            | (_part1by2_10(z) << 2))


def morton_decode_10(code):
    code = code.to(i64) & 0xFFFFFFFF
    return (_compact1by2_10(code), _compact1by2_10(code >> 1),
            _compact1by2_10(code >> 2))


def _part1by2_21(v: torch.Tensor) -> torch.Tensor:
    v = v.to(i64) & 0x1FFFFF
    v = (v | (v << 32)) & 0x1F00000000FFFF
    v = (v | (v << 16)) & 0x1F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def morton_encode_21(x, y, z) -> torch.Tensor:
    """63-bit Morton code (int64) from 21-bit x, y, z."""
    return (_part1by2_21(x) | (_part1by2_21(y) << 1)
            | (_part1by2_21(z) << 2))


def quantize_to_morton_grid(points: torch.Tensor, lo, hi, bits: int = 10):
    """Quantize f32 positions [N, 3] into the [0, 2^bits) integer lattice:
    (qx, qy, qz) int64[N]."""
    n = (1 << bits) - 1
    t = (points - lo) / torch.clamp(hi - lo, min=1e-30)
    q = torch.clamp(t * float(n + 1), 0, n).to(i64)
    return q[..., 0], q[..., 1], q[..., 2]
