"""Volume precompute passes: Sobel gradients, edge factors, AO, indirect
light, and the low-res skip-distance texture.

Counterpart of ``ray_tracing_octrees_tpu/ops/precompute.py``: tensor
ports of the reference's precompute compute shader
(VolumeRaycastRenderer.cpp:633-769), the neighbourhood-density AO bake
(createAmbientOcclusionTexture, :1824-1880), the indirect-bounce kernel
(indirectLightingComputeSrc, :1695-1791) and the heightmap-based
skip-distance texture (buildSkipDistanceTexture, :1201-1331).

All passes are dense stencils over [Z, Y, X] float volumes, on their
inputs' device: shifted views of one zero-padded copy, no scatter. Square
roots and divisions by constants round alike on the card and the CPU
(``slab_sweep._sqrt``, ``_cdiv``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ray_tracing_octrees_tpu_torch.ops.sampling import _f32, sample_trilinear
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _cdiv, _sqrt, _unit

f32 = torch.float32


def _padded(vol: torch.Tensor, p: int) -> torch.Tensor:
    """``vol`` [Z, Y, X(, C)] zero-padded by ``p`` on each spatial side."""
    pad = (0, 0) * (vol.ndim - 3) + (p, p) * 3
    return F.pad(vol, pad)


def _shift(pad: torch.Tensor, p: int, shape, dx: int, dy: int, dz: int):
    """View of :func:`_padded`'s ``pad`` (pad ``p``) at (x+dx, y+dy, z+dz):
    out-of-range reads 0, as the shader's sampleVolume outside the box."""
    dzs, dys, dxs = shape[:3]
    return pad[p + dz: p + dz + dzs, p + dy: p + dy + dys,
               p + dx: p + dx + dxs]


def _shift_sample(vol: torch.Tensor, dx: int, dy: int, dz: int):
    """vol sampled at (x+dx, y+dy, z+dz) with out-of-range -> 0."""
    p = max(abs(dx), abs(dy), abs(dz), 1)
    return _shift(_padded(vol, p), p, vol.shape, dx, dy, dz)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last dim of size 3, summed in order."""
    return _sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                 + v[..., 2] * v[..., 2])


def sobel_gradient(volume: torch.Tensor,
                   radiation: torch.Tensor) -> torch.Tensor:
    """3D Sobel gradient, radiation-aware, negated to point solid -> empty.

    computeSobelGradient (VolumeRaycastRenderer.cpp:664-698): 27 taps with
    weights w=(1,2,1) per axis; taps whose radiation exceeds 0.5 are
    attenuated by max(0, 1-rad). Returns f32[Z, Y, X, 3].
    """
    s = (-1, 0, 1)
    w = (1.0, 2.0, 1.0)
    vol_p = _padded(volume.to(f32), 1)
    rad_p = _padded(radiation.to(f32), 1)
    shape = volume.shape
    gx = torch.zeros(shape, dtype=f32, device=volume.device)
    gy = torch.zeros_like(gx)
    gz = torch.zeros_like(gx)
    for iz in range(3):
        for iy in range(3):
            for ix in range(3):
                weight = float(np.float32(w[ix] * w[iy] * w[iz]))
                dx, dy, dz = s[ix], s[iy], s[iz]
                rad = _shift(rad_p, 1, shape, dx, dy, dz)
                wgt = torch.where(
                    rad > 0.5, weight * torch.clamp(1.0 - rad, min=0.0),
                    weight)
                val = _shift(vol_p, 1, shape, dx, dy, dz) * wgt
                if dx:
                    gx = gx + val * float(dx)
                if dy:
                    gy = gy + val * float(dy)
                if dz:
                    gz = gz + val * float(dz)
    return -torch.stack([gx, gy, gz], dim=-1)


def _smooth01(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def precompute_volume(volume: torch.Tensor, radiation: torch.Tensor):
    """The full precompute pass: (gradient magnitude, normal, edge factor).

    Ports the shader main + detectEdges (VolumeRaycastRenderer.cpp:703-769):
      edge = iso-proximity*0.7 + norm-grad-mag*0.2 + tangent-curvature*0.1,
    with carve-boundary enhancement from the radiation volume. The
    shader's one-voxel world offsets are +-1 texel on the lattice
    (shifted reads); its tangent offsets are fractional texels
    (trilinear samples).
    """
    volume = volume.to(f32)
    radiation = radiation.to(f32)
    dev = volume.device
    grad = sobel_gradient(volume, radiation)
    grad_mag = _norm3(grad)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    normal = torch.where(
        (grad_mag > 0.001)[..., None],
        grad / torch.clamp(grad_mag[..., None], min=1e-30), up)

    center = volume
    dist_to_iso = (center - 0.5).abs()
    # smoothstep(0, edgeThreshold, distToIso), edgeThreshold 0.1
    edge_factor = 1.0 - _smooth01(torch.clamp(_cdiv(dist_to_iso, 0.1),
                                              0.0, 1.0))
    norm_grad_mag = torch.clamp(_cdiv(grad_mag, 10.0), max=1.0)

    # tangent curvature: density variation along two tangents of the
    # normal, one world voxel away (fractional texel offsets)
    alt = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=dev)
    t1 = torch.linalg.cross(normal, up.expand_as(normal), dim=-1)
    t1_alt = torch.linalg.cross(normal, alt.expand_as(normal), dim=-1)
    t1 = torch.where((_norm3(t1) < 0.1)[..., None], t1_alt, t1)
    t1 = t1 / torch.clamp(_norm3(t1)[..., None], min=1e-30)
    t2 = torch.linalg.cross(normal, t1, dim=-1)

    dz, dy, dx = volume.shape
    ar = lambda n: torch.arange(n, dtype=f32, device=dev)
    zz, yy, xx = torch.meshgrid(ar(dz), ar(dy), ar(dx), indexing="ij")
    uvw = torch.stack([_cdiv(xx + 0.5, dx), _cdiv(yy + 0.5, dy),
                       _cdiv(zz + 0.5, dz)], dim=-1)
    del xx, yy, zz
    texel = torch.as_tensor(np.float32(1.0) / np.array([dx, dy, dz],
                                                       np.float32),
                            device=dev)

    def vol_at(off):
        return sample_trilinear(volume,
                                torch.clamp(uvw + off * texel, 0.0, 1.0))

    curvature = ((vol_at(t1) - center).abs() + (vol_at(-t1) - center).abs()
                 + (vol_at(t2) - center).abs()
                 + (vol_at(-t2) - center).abs()) / 4.0
    del t1, t2, t1_alt

    # carve-boundary enhancement
    r0 = radiation
    r1 = sample_trilinear(radiation,
                          torch.clamp(uvw + normal * texel, 0.0, 1.0))
    carve_edge = _smooth01(torch.clamp(_cdiv(torch.maximum(r0, r1), 0.3),
                                       0.0, 1.0))
    edge_factor = torch.where((r1 > 0.1) | (r0 > 0.1),
                              torch.maximum(edge_factor, carve_edge),
                              edge_factor)
    edge = edge_factor * 0.7 + norm_grad_mag * 0.2 + curvature * 0.1
    return grad_mag, normal, edge


def ambient_occlusion(occ: torch.Tensor) -> torch.Tensor:
    """26-neighbour density AO (createAmbientOcclusionTexture, :1833-1867).

    ao = (filled neighbours / 26) * 0.7 for interior voxels; the one-voxel
    border stays 0, as the reference's loop bounds leave it.
    """
    f = (occ > 0).to(f32)
    pad = _padded(f, 1)
    acc = torch.zeros_like(f)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx or dy or dz:
                    acc = acc + _shift(pad, 1, f.shape, dx, dy, dz)
    # (filled / 26) * 0.7 as the reference's compiled form rounds it: one
    # product with the folded constant 0.7 / 26
    ao = acc * float(np.float32(0.7) / np.float32(26.0))
    out = torch.zeros_like(ao)
    out[1:-1, 1:-1, 1:-1] = ao[1:-1, 1:-1, 1:-1]
    return out


def indirect_lighting(volume: torch.Tensor, normals: torch.Tensor,
                      radiation: torch.Tensor, light_dir, light_color,
                      strength: float = 1.0, radius: int = 6) -> torch.Tensor:
    """Bounce-light gather (indirectLightingComputeSrc, :1713-1790).

    For empty/carved voxels, sums light from directly-lit solid neighbours
    within ``radius``: falloff 1/(1+d^2) times the bounce cosine
    max(0, dot(n_neighbor, -dir_neighbor_to_voxel)). Returns [Z, Y, X, 3].
    One offset at a time (~900 at radius 6), once per scene state.
    """
    dev = volume.device
    l = _unit(torch.as_tensor(np.asarray(light_dir, np.float32), device=dev))
    lc = torch.as_tensor(np.asarray(light_color, np.float32), device=dev)
    ndotl = (normals[..., 0] * l[0] + normals[..., 1] * l[1]
             + normals[..., 2] * l[2])
    lit = (ndotl > 0.0) & (volume > 0.5) & (radiation < 0.1)
    receiver = (volume < 0.5) | (radiation > 0.1)

    r = int(radius)
    lit_p = _padded(lit.to(f32), r)
    nrm_p = _padded(normals.to(f32), r)
    shape = volume.shape
    out = torch.zeros(tuple(shape) + (3,), dtype=f32, device=dev)
    for dz in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                dist = float(np.sqrt(dx * dx + dy * dy + dz * dz))
                if dist > r or (dx == 0 and dy == 0 and dz == 0):
                    continue
                # neighbour at p + (dx, dy, dz); bounce direction
                # neighbour -> p
                b = -np.array([dx, dy, dz], np.float32) / np.float32(dist)
                n_lit = _shift(lit_p, r, shape, dx, dy, dz)
                n = _shift(nrm_p, r, shape, dx, dy, dz)
                dot = (n[..., 0] * float(b[0]) + n[..., 1] * float(b[1])
                       + n[..., 2] * float(b[2]))
                bounce = torch.clamp(-dot, min=0.0)
                falloff = float(np.float32(1.0 / (1.0 + dist * dist)))
                out = out + (n_lit * bounce * falloff)[..., None] * lc
    out = out * float(np.float32(strength))
    return torch.where(receiver[..., None], out, 0.0)


def build_skip_distance(occ: torch.Tensor, voxel_size, box_min, box_max,
                        factor: int = 8) -> torch.Tensor:
    """Low-res skip-distance volume (buildSkipDistanceTexture, :1201-1331).

    Downsampled dims max(dim/8, 16); per column (x, z) the first solid
    sample height bounds a vertical empty run; voxels above solid space
    get a fixed one-block skip. Values are normalized distances.
    """
    dev = occ.device
    occ = occ > 0
    dz, dy, dx = occ.shape
    sx = max(dx // factor, 16)
    sy = max(dy // factor, 16)
    sz = max(dz // factor, 16)
    i64 = torch.int64
    # the original grid at mapped coordinates (integer division map)
    ox = (torch.arange(sx, dtype=i64, device=dev) * dx) // sx
    oy = (torch.arange(sy, dtype=i64, device=dev) * dy) // sy
    oz = (torch.arange(sz, dtype=i64, device=dev) * dz) // sz
    sub = occ[oz[:, None, None], oy[None, :, None], ox[None, None, :]]

    # heightmap: first y with a solid sample, scanning upward (0 if none)
    ys = torch.arange(sy, dtype=torch.int32, device=dev)
    first_solid = torch.where(sub.any(dim=1),
                              torch.argmax(sub.to(torch.uint8), dim=1),
                              0).to(torch.int32)     # [sz, sx]

    vsize = _f32(voxel_size, dev).reshape(())
    box_min, box_max = _f32(box_min, dev), _f32(box_max, dev)
    y_extent = box_max[1] - box_min[1]
    max_extent = torch.max(box_max - box_min)

    below = ys[None, :, None] < first_solid[:, None, :]
    empty_height = ((first_solid[:, None, :] - ys[None, :, None]).to(f32)
                    * float(np.float32(dy / sy)) * vsize)
    skip_below = empty_height * 0.8 / y_extent
    block = vsize * float(np.float32(dx / sx))
    skip_empty = block / max_extent
    return torch.where(below, skip_below,
                       torch.where(~sub, skip_empty, 0.0)).to(f32)
