"""3D texture sampling: the tensor form of the GL sampler stack.

Counterpart of ``ray_tracing_octrees_tpu/ops/sampling.py``. The
reference's volume renderer reads eight 3D textures with trilinear
filtering, CLAMP_TO_EDGE wrap and mip pyramids (VolumeRaycastRenderer.h:
92-99). These helpers reproduce GL sampling over plain tensors:
normalized coordinate c maps to texel space c*N - 0.5, 8-corner lerp,
indices clamped to the edge.

Layout: volumes are [Z, Y, X] (+ an optional channel dim); ``uvw`` is
(u, v, w) = (x, y, z) normalized to [0, 1], as GLSL's sampler3D. Every
function runs on its inputs' device.

:func:`sample_lod` reads a whole mip chain through :class:`MipStack`,
the levels flattened into one buffer: each sample reads its two levels
only, with that level's extents, which gives the same values as the
reference's trilinear sample of every level followed by a select.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Union

import numpy as np
import torch

f32 = torch.float32


def _f32(v, dev) -> torch.Tensor:
    """``v`` (a tensor, array or numbers) as an f32 tensor on ``dev``."""
    if torch.is_tensor(v):
        return v.to(device=dev, dtype=f32)
    return torch.tensor(np.array(v, np.float32), device=dev)


def sample_nearest(vol: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """Nearest-texel fetch with clamp-to-edge. vol [Z,Y,X(,C)], uvw [...,3]."""
    dz, dy, dx = vol.shape[:3]
    # texel space (truncation = texel index)
    t = uvw * _geometry(dz, dy, dx, vol.device)[2]
    ix = t[..., 0].to(torch.int32).clamp(0, dx - 1).long()
    iy = t[..., 1].to(torch.int32).clamp(0, dy - 1).long()
    iz = t[..., 2].to(torch.int32).clamp(0, dz - 1).long()
    return vol[iz, iy, ix]


def _trilinear(flat: torch.Tensor, base, uvw: torch.Tensor,
               dmax: torch.Tensor, strides: torch.Tensor,
               dims: torch.Tensor) -> torch.Tensor:
    """GL_LINEAR + CLAMP_TO_EDGE over a flat [N(, C)] buffer holding a
    volume from row ``base`` (an int, or int64 per sample). ``dmax``
    (int64 (X, Y, Z) extents less one), ``strides`` (int64 flat strides of
    x, y, z) and ``dims`` (f32 extents) are [3] or per sample [..., 3].

    The eight corners are read by one gather into [x, y, z, samples]
    order; the lerps run x, then y, then z over contiguous halves, each
    corner pair as the reference pairs them, so the result is the
    reference's arithmetic.
    """
    lead = uvw.shape[:-1]
    t = uvw * dims - 0.5
    i0 = torch.floor(t).to(torch.int32)
    f = (t - i0.to(f32)).reshape(-1, 3).T      # [3, M]
    i0 = i0.long()
    c0 = torch.minimum(torch.clamp(i0, min=0), dmax) * strides
    c1 = torch.minimum(torch.clamp(i0 + 1, min=0), dmax) * strides
    o = torch.stack([c0, c1]).reshape(2, -1, 3)       # [corner, M, axis]
    idx = (o[:, None, None, :, 0] + o[None, :, None, :, 1]
           + o[None, None, :, :, 2])                   # [x, y, z, M]
    if torch.is_tensor(base):
        idx = idx + base.reshape(-1)
    elif base:
        idx = idx + base
    v = flat[idx.reshape(8, -1)].to(f32)               # [8, M(, C)]
    g = 1.0 - f
    if flat.ndim == 2:
        f, g = f[..., None], g[..., None]
    v = v[:4] * g[0] + v[4:] * f[0]           # x: [y, z, M]
    v = v[:2] * g[1] + v[2:] * f[1]           # y: [z, M]
    v = v[0] * g[2] + v[1] * f[2]             # z: [M]
    return v.reshape(lead + tuple(flat.shape[1:]))


@functools.lru_cache(maxsize=None)
def _geometry(dz: int, dy: int, dx: int, dev: torch.device):
    """(dmax, strides, dims) of a [dz, dy, dx] volume, as _trilinear
    takes them. Kept per shape and device (never written to), so a
    sample in a loop on the card copies nothing from the host."""
    i64 = torch.int64
    return (torch.tensor([dx - 1, dy - 1, dz - 1], dtype=i64, device=dev),
            torch.tensor([1, dx, dx * dy], dtype=i64, device=dev),
            torch.tensor([dx, dy, dz], dtype=f32, device=dev))


def sample_trilinear(vol: torch.Tensor, uvw: torch.Tensor) -> torch.Tensor:
    """GL_LINEAR + CLAMP_TO_EDGE trilinear sample.

    vol: [Z, Y, X] or [Z, Y, X, C]; uvw: [..., 3] normalized. Returns
    [...] or [..., C] float32.
    """
    dz, dy, dx = vol.shape[:3]
    flat = vol.reshape((dz * dy * dx,) + tuple(vol.shape[3:]))
    return _trilinear(flat, 0, uvw, *_geometry(dz, dy, dx, vol.device))


def build_mip_chain(vol: torch.Tensor,
                    max_levels: int | None = None) -> List[torch.Tensor]:
    """GL-style box-filtered mip pyramid of a [Z, Y, X] float volume.

    Levels halve (floor) each dimension down to 1; the chain length matches
    glGenerateMipmap on the same extents.
    """
    levels = [vol.to(f32)]
    while max(levels[-1].shape) > 1:
        if max_levels is not None and len(levels) >= max_levels:
            break
        v = levels[-1]
        nz, ny, nx = (max(1, n // 2) for n in v.shape)
        sz, sy, sx = (2 if n > 1 else 1 for n in v.shape)
        v = v[: nz * sz, : ny * sy, : nx * sx]
        v = v.reshape(nz, sz, ny, sy, nx, sx).mean(dim=(1, 3, 5))
        levels.append(v)
    return levels


class MipStack:
    """A mip chain flattened into one buffer, for per-sample level reads.

    ``flat`` f32[sum of level sizes]; per level, ``offset`` its first
    row and ``dmax``, ``strides`` and ``dims`` its geometry
    (:func:`_trilinear`'s).
    """

    def __init__(self, mips: Sequence[torch.Tensor]):
        dev = mips[0].device
        self.n = len(mips)
        self.flat = torch.cat([m.reshape(-1).to(f32) for m in mips])
        sizes = [m.numel() for m in mips]
        offs = [sum(sizes[:k]) for k in range(self.n)]
        self.offset = torch.tensor(offs, dtype=torch.int64, device=dev)
        self.shapes = [tuple(m.shape) for m in mips]
        geo = [_geometry(*m.shape, dev) for m in mips]
        self.dmax, self.strides, self.dims = (torch.stack(g) for g in
                                              zip(*geo))

    def sample(self, uvw: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
        """Trilinear sample of each ``uvw`` in its own ``level`` (int64,
        within the chain): the value of ``sample_trilinear(mips[level],
        uvw)``."""
        return _trilinear(self.flat, self.offset[level], uvw,
                          self.dmax[level], self.strides[level],
                          self.dims[level])


Mips = Union[Sequence[torch.Tensor], MipStack]


def _stack(mips: Mips) -> MipStack:
    return mips if isinstance(mips, MipStack) else MipStack(mips)


def sample_lod(mips: Mips, uvw: torch.Tensor, lod) -> torch.Tensor:
    """textureLod: trilinear in each level, lerp between mip levels.

    ``mips`` a chain (list) or its :class:`MipStack`; ``lod`` a number or
    a tensor broadcasting with the samples; levels outside the chain
    clamp. Two trilinear samples per lookup.
    """
    st = _stack(mips)
    lod = torch.clamp(torch.as_tensor(lod, dtype=f32, device=uvw.device),
                      0.0, float(st.n - 1))
    lod = lod.expand(uvw.shape[:-1])
    l0 = torch.floor(lod).to(torch.int32)
    frac = lod - l0.to(f32)
    l0 = l0.long()
    # both levels in one read
    out = st.sample(uvw.expand((2,) + uvw.shape),
                    torch.stack([l0, torch.clamp(l0 + 1, max=st.n - 1)]))
    return out[0] * (1 - frac) + out[1] * frac


def sample_lod_nearest_level(mips: Mips, uvw: torch.Tensor,
                             lod) -> torch.Tensor:
    """textureLod with the nearest mip level (half the reads of
    :func:`sample_lod`)."""
    st = _stack(mips)
    lod = torch.as_tensor(lod, dtype=f32, device=uvw.device)
    li = torch.clamp(torch.round(lod), 0, st.n - 1).to(torch.int32).long()
    return st.sample(uvw, li.expand(uvw.shape[:-1]))
