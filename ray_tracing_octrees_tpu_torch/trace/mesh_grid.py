"""Grid-wavefront triangle tracer for extracted Marching-Cubes meshes.

Counterpart of ``ray_tracing_octrees_tpu/trace/mesh_grid.py``, the
reference's triangle-traced frame of an extracted MC mesh (primary rays
and the shadow term). Over a binary occupancy grid every MC vertex is a
cell-edge midpoint and the triangles of a cell are a pure function of
its 8-bit corner case, so the mesh is "the case grid + one 256-entry
table", and tracing factors into:

1. one DETECTION slab sweep (``exact_tap_words``, ``_sweep_candidates``):
   per table texel, a per-slab bit field of exactly the slabs where the
   ray's lateral footprint holds a surface cell;
2. consume ROUNDS: each unresolved texel ray takes its next candidate
   slab, fetches the cases of its footprint cells from a packed case
   volume (one lookup for a 2x2 window where the frame's slope allows,
   else three for the 3x3 window) and runs exact Moller-Trumbore against
   their triangles in the dot-constant form of :func:`_mt_const_np`;
   a miss advances to the next candidate slab;
3. one winner normal and one shadow lookup at the struck cell, texel
   shading, and the per-pixel warp: the packed 24-bit colour table read
   through :func:`warp_kernel.warp_lookup` (``slab_sweep._warp_values``).

The reference runs the rounds on a fixed-width compaction ladder (XLA's
static shapes) and counts rows past a stage as ``overflow``; here every
round runs on exactly the rows still unresolved, so ``overflow`` is 0 by
construction and each round costs one host sync (the compaction). The
reference's MXU forms are not copied: the one-hot bf16 fetch of the
dot-constant table is a row gather (every entry a multiple of 1/8, exact
in f32) and its selector matmuls are the same lane sums written out in
the reference's order as explicit adds, so the card and the CPU round
alike. Per-scene layouts (case and shadow volumes in sweep order, per
sweep axis, flip and crop) live on the scene (:class:`MCMeshScene`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch._device import (
    DeviceLike, resolve_device, upload,
)
from ray_tracing_octrees_tpu_torch.ops import mc_tables as t
from ray_tracing_octrees_tpu_torch.ops.marching_cubes import _cell_cases, norm3
from ray_tracing_octrees_tpu_torch.trace import slab_sweep
from ray_tracing_octrees_tpu_torch.trace.raymarch import _fma
from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
    _AXIS_SELECTORS, CH, SweepLayouts, _cdiv, _exact_matmul,
    _frame_scalars_np, _host, _sweep_geometry, _view_consts,
    _warp_setup, first_set_from, shadow_volume,
)

f32, i32, i64 = torch.float32, torch.int32, torch.int64
_BIG = 3.0e38
_MT_EPS = 1e-7
# rows of one slab pass (a round's larger row sets run in parts)
_PASS_ROWS = 1 << 18


# --------------------------------------------------------------------------
# case -> triangle tables (cell-local midpoint vertices)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _case_tables_np():
    """verts f32[256, 5, 3, 3]: each case's triangles, cell-local xyz in
    {0, .5, 1}. Padding triangles (beyond TRI_COUNTS[case]) collapse to a
    single point (edge 0's midpoint): det == 0, never a hit."""
    off = np.asarray(t.CORNER_OFFSETS, np.float32)        # [8, 3] (x, y, z)
    mid = (off[t.EDGE_CORNERS[:, 0]] + off[t.EDGE_CORNERS[:, 1]]) * 0.5
    return mid[t.TRI_EDGES]                               # [256, 5, 3, 3]


def case_triangle_table(device: DeviceLike = None) -> torch.Tensor:
    """The cell-local triangle table, f32[256, 45], on ``device``."""
    verts = _case_tables_np()
    return torch.as_tensor(verts.reshape(256, 45), device=resolve_device(
        device))


# --------------------------------------------------------------------------
# scene preparation
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MCMeshScene:
    """Traceable form of an extracted MC mesh: the case grid + tables.

    ``origin`` is a host value (the frame's set-up reads it every pose);
    ``layouts`` keeps the case and shadow volumes' sweep-order copies
    across frames (one per scene, built here when not given).
    """

    case_vol: torch.Tensor               # f32[Zc, Yc, Xc]; case id or 0
    shadow_cell: Optional[torch.Tensor]  # f32[Zc, Yc, Xc] per-cell shadow
    origin: np.ndarray                   # f32[3] world min corner
    voxel_size: float
    layouts: Optional[SweepLayouts] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.layouts is None:
            object.__setattr__(self, "layouts", SweepLayouts(
                self.case_vol, self.shadow_cell))

    @property
    def device(self) -> torch.device:
        return self.case_vol.device


def prepare_mc_scene(occ, grid_origin, voxel_size, to_light=None,
                     device: DeviceLike = None) -> MCMeshScene:
    """Bind a binary occupancy grid's implied MC mesh for tracing, on
    ``device``.

    ``to_light``: optional world-space direction TOWARD the light; when
    given, a per-cell shadow term (cumulative occlusion along the light,
    ``slab_sweep.shadow_volume``) is kept for the frame's shading.
    """
    dev = resolve_device(device)
    occ = (occ if torch.is_tensor(occ) else torch.from_numpy(
        np.array(occ))).to(dev) > 0
    case = _cell_cases(occ)
    ntri = torch.as_tensor(t.TRI_COUNTS, device=dev)[case.long()]
    case_vol = torch.where(ntri > 0, case, 0).to(f32)
    shadow_cell = None
    if to_light is not None:
        sv = shadow_volume(occ.to(f32), to_light, device=dev)
        zc, yc, xc = case_vol.shape
        shadow_cell = sv[:zc, :yc, :xc].contiguous()
    return MCMeshScene(
        case_vol=case_vol, shadow_cell=shadow_cell,
        origin=np.asarray(_host(grid_origin), np.float32).reshape(3),
        voxel_size=float(_host(voxel_size)))


# --------------------------------------------------------------------------
# detection: hats, volumes, the candidate bit field
# --------------------------------------------------------------------------

def _texel_coords(scal, inter_h: int, inter_w: int):
    """(ua f32[IH], ub f32[IW]): the table's texel centres on the
    reference plane, in voxel units of the A and B axes. As the
    reference's compiled trace rounds them: the division by the table
    size a multiply-add with its f32 reciprocal (exact for 1024)."""
    dev = scal.device
    a_min, a_max, b_min, b_max = scal[4], scal[5], scal[6], scal[7]

    def centres(lo, hi, n: int):
        i = torch.arange(n, dtype=f32, device=dev) + 0.5
        return _fma((hi - lo) * i, float(np.float32(1.0) / np.float32(n)),
                    lo)

    return centres(a_min, a_max, inter_h), centres(b_min, b_max, inter_w)


def _texel_slab_coords(scal, ua, ub, sp: int, s_valid: int, flip: bool):
    """Texel centres projected onto each of ``sp`` layout slabs: (pa
    f32[sp, IH], pb f32[sp, IW]), ``slab_sweep._slab_coords`` over
    :func:`_texel_coords`."""
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    o_all = torch.arange(sp, dtype=f32, device=scal.device)
    k_all = (float(s_valid) - 1.0 - o_all) if flip else o_all
    s_all = (z0 - eye_s) / (k_all + 0.5 - eye_s)
    return ((ua[None, :] - eye_a) / s_all[:, None] + eye_a,
            (ub[None, :] - eye_b) / s_all[:, None] + eye_b)


def _mask_taps(p_all, size: int, w3):
    """3-tap neighbour-mask hat: weight w3[i] on the cell holding
    p + (i - 1), bf16[..., size] (sums of distinct powers of two)."""
    d = p_all[..., None] - torch.arange(size, dtype=f32, device=p_all.device)
    m = torch.zeros(d.shape, dtype=f32, device=d.device)
    for off, w in zip((-1.0, 0.0, 1.0), w3):
        e = d + off
        m = m + w * ((e >= 0) & (e < 1)).to(f32)
    return m.to(torch.bfloat16)


def _footprint_mask(p_all, half, base: float, wlo: float, whi: float):
    """Exact footprint factor: base, plus wlo where the ray's in-slab
    footprint reaches the cell before floor(p), plus whi where it reaches
    the cell after."""
    fp = torch.floor(p_all)
    lo = torch.floor(p_all - half[None, :]) - fp
    hi = torch.floor(p_all + half[None, :]) - fp
    return base + wlo * (lo <= -1.0).to(f32) + whi * (hi >= 1.0).to(f32)


def _build_detect_hats(scal, sp: int, s_valid: int, a_size: int,
                       b_size: int, inter_h: int, inter_w: int, flip: bool):
    """Per-frame 3-tap neighbour-mask hats + exact footprint masks.

    The mask weight of lateral offset (da, db) is 8^(da+1) * 2^(db+1), so
    one product chain with a-hats weighted {1, 8, 64} and b-hats weighted
    {1, 2, 4} samples the 3x3 neighbourhood's occupancy as 9 bits; the
    footprint mask fm = am * bm keeps the bits of cells the texel's ray
    actually crosses in the slab (am = 8 + (lo_a <= -1) + 64 (hi_a >= 1),
    lo / hi = floor(pa -+ half_a) - floor(pa)).

    Returns (ma_w bf16[sp, IH, A], mb_w bf16[sp, IW, B], am f32[sp, IH],
    bm f32[sp, IW]), the ``hats`` of :func:`_sweep_candidates`.
    """
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    ua, ub = _texel_coords(scal, inter_h, inter_w)
    pa_all, pb_all = _texel_slab_coords(scal, ua, ub, sp, s_valid, flip)
    half_a = 0.5 * ((ua - eye_a) / (z0 - eye_s)).abs()
    half_b = 0.5 * ((ub - eye_b) / (z0 - eye_s)).abs()
    ma_w = _mask_taps(pa_all, a_size, (1.0, 8.0, 64.0))
    mb_w = _mask_taps(pb_all, b_size, (1.0, 2.0, 4.0))
    am = _footprint_mask(pa_all, half_a, 8.0, 1.0, 64.0)
    bm = _footprint_mask(pb_all, half_b, 2.0, 1.0, 4.0)
    return ma_w, mb_w, am, bm


def _detect_volume(case_sw: torch.Tensor) -> torch.Tensor:
    """Binarized case volume (0/1 bf16) in sweep layout [sp, A, B]."""
    return (case_sw > 0).to(torch.bfloat16)


def _build_packed_cases(case_sw: torch.Tensor) -> torch.Tensor:
    """{1, 256, 65536}-packed a-triples of the sweep-layout case volume.

    pk[o, a, b] = case[o, a-1, b] + 256 case[o, a, b] + 65536 case[o, a+1,
    b] (zeros past the a edges), f32: every value below 2^24, exact.
    Flattened [sp * A * B].
    """
    cs = case_sw.to(f32)
    z = torch.zeros_like(cs[:, :1])
    am1 = torch.cat([z, cs[:, :-1]], 1)     # case at a-1
    ap1 = torch.cat([cs[:, 1:], z], 1)      # case at a+1
    return (am1 + 256.0 * cs + 65536.0 * ap1).reshape(-1)


def _build_packed_cases4(case_sw: torch.Tensor) -> torch.Tensor:
    """Byte-packed 2x2 windows of the sweep-layout case volume.

    pk4[o, a, b] = case(a, b) | case(a, b+1) << 8 | case(a+1, b) << 16 |
    case(a+1, b+1) << 24 (zeros past the a / b edges): the reference's
    uint32 word, held in int32 (bit 31 as the sign; read a byte back
    with an arithmetic shift and a mask). Flattened [sp * A * B].
    """
    cs = case_sw.to(i64)
    zb = torch.zeros_like(cs[:, :, :1])
    c01 = torch.cat([cs[:, :, 1:], zb], 2)          # case at b+1
    za = torch.zeros_like(cs[:, :1, :])
    c10 = torch.cat([cs[:, 1:, :], za], 1)          # case at a+1
    c11 = torch.cat([c01[:, 1:, :], za], 1)         # case at a+1, b+1
    w = cs | (c01 << 8) | (c10 << 16) | (c11 << 24)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(i32).reshape(-1)


def _sweep_candidates(detect_sw, hats, inter_h: int, inter_w: int,
                      exact_acc: bool = False) -> torch.Tensor:
    """One detection sweep builds a frame's whole candidate bit field:
    int32[IH * IW, sp / 32], bit (o & 31) of word [texel, o >> 5] set iff
    the texel's footprint in slab o holds a solid cell
    (:func:`candidate_chunk` per 32-slab chunk). The reference also takes
    the slab count, the sweep sizes and the flip; the hats carry them.
    """
    sp = detect_sw.shape[0]
    words = torch.empty((sp // CH, inter_h * inter_w), dtype=torch.int32,
                        device=detect_sw.device)
    for ci in range(sp // CH):
        words[ci] = pack_chunk(candidate_chunk(
            detect_sw, hats, ci * CH, (ci + 1) * CH, exact_acc)[1])
    return words.t().contiguous()


def exact_tap_words(sl, ma, mb, wide: bool):
    """Bit-exact weighted tap words det[c, h, w] = sum occ * wa * wb (f32).

    ``sl`` bf16[c, A, B] occupancy, ``ma`` bf16[c, IH, A] and ``mb``
    bf16[c, IW, B] tap weights (powers of two). Each a-contraction sums
    bf16 products in f32 and rounds once to bf16 (exact: its integer sums
    stay below 256); the b-contraction keeps f32 (exact: integer sums
    below 2^24). Both run under :func:`slab_sweep._exact_matmul`, so the
    card neither rounds f32 products to TF32 nor reduces bf16 partial
    sums in reduced precision.

    ``wide`` (5-tap axes, weights to 4096): the a-contraction's sums reach
    4681, past bf16's 8-bit significand, so the weights split into two
    chains whose sums stay below 256 (bf16-exact integers), each
    contracted alone and recombined in f32: det = detL + 512 * detH.
    Contracting them as one would round (the reference's round-5 leak).
    """
    f32, bf16 = torch.float32, torch.bfloat16
    with _exact_matmul():
        if not wide:
            hb = torch.einsum("cab,cha->cbh", sl, ma)
            return torch.einsum("cbh,cwb->chw", hb.to(f32), mb.to(f32))
        ma_f = ma.to(f32)
        ma_lo = torch.where(ma_f < 512.0, ma_f, 0.0).to(bf16)
        ma_hi = torch.where(ma_f >= 512.0, ma_f * (1.0 / 512.0), 0.0).to(bf16)
        hb_lo = torch.einsum("cab,cha->cbh", sl, ma_lo)
        hb_hi = torch.einsum("cab,cha->cbh", sl, ma_hi)
        mb_f = mb.to(f32)
        det_lo = torch.einsum("cbh,cwb->chw", hb_lo.to(f32), mb_f)
        det_hi = torch.einsum("cbh,cwb->chw", hb_hi.to(f32), mb_f)
    return det_lo + 512.0 * det_hi


def candidate_chunk(detect_sw, hats, lo: int, hi: int, wide: bool):
    """Slabs ``lo:hi`` of the detection sweep: (tap words int32[c, IH,
    IW], candidate flags bool[c, IH, IW]), a flag set iff the texel's
    footprint in that slab holds a solid cell.

    ``detect_sw`` bf16[sp, A, B] 0/1 occupancy in sweep order, ``hats``
    (ma_w, mb_w, am, bm) the tap weights and footprint masks of
    :func:`_build_detect_hats`, ``sweep_exact._widened_perspective_hats``
    or ``_ortho_hats``: the tap words (:func:`exact_tap_words`,
    split-chain exact with ``wide``) AND the separable footprint mask.
    """
    ma_w, mb_w, am_f, bm_f = hats
    det = exact_tap_words(detect_sw[lo:hi], ma_w[lo:hi], mb_w[lo:hi],
                          wide).to(torch.int32)
    fm = (am_f[lo:hi, :, None] * bm_f[lo:hi, None, :]).to(torch.int32)
    return det, (det & fm) != 0


def pack_chunk(flags) -> torch.Tensor:
    """bool[CH, IH, IW] flags of one 32-slab chunk -> its words
    int32[IH * IW], bit c set by slab c."""
    i32 = torch.int32
    bit_of = torch.arange(CH, dtype=i32, device=flags.device)[:, None, None]
    # distinct bits: the int32 sum is their OR (bit 31 included)
    return torch.bitwise_left_shift(flags.to(i32), bit_of).sum(
        0, dtype=i32).reshape(-1)


# --------------------------------------------------------------------------
# the dot-constant Moller-Trumbore table
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _mt_const_np(axis_world: int) -> np.ndarray:
    """[256, 128] packed Moller-Trumbore dot-constant table, f32 (every
    entry a multiple of 1/8 bounded by ~3: exact in bf16, asserted, as
    the reference's bf16 table).

    With the ray in cell-local sweep coordinates (ro' = ro_sab - cell,
    w = ro' x rd) every MT quantity is a dot of a per-(case, triangle)
    constant with a per-row vector::

        det     = rd . (e2 x e1)
        u * det = e2 . w  - rd . (e2 x v0)
        v * det = -e1 . w - rd . (v0 x e1)
        t * det = n . ro' - n . v0            (n = e1 x e2)

    Lane layout: 0..89 six 15-lane j-blocks (j = rd_s, rd_a, rd_b, w_s,
    w_a, w_b), each det*5 | ud*5 | vd*5; 90..109 four 5-lane j-blocks
    (j = ro'_s, ro'_a, ro'_b, 1): td*5; 110..124 n[tri * 3 + comp].
    Triangle vertices are the case table's, permuted xyz -> (s, a, b)
    for ``axis_world``.
    """
    verts = _case_tables_np()                    # [256, 5, 3, 3] xyz
    perm = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}[axis_world]
    v = verts[..., perm].astype(np.float64)         # (s, a, b) coords
    v0, v1, v2 = v[:, :, 0], v[:, :, 1], v[:, :, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    k_det = np.cross(e2, e1)
    k_u_rd = -np.cross(e2, v0)
    k_u_w = e2
    k_v_rd = -np.cross(v0, e1)
    k_v_w = -e1
    k_t_ro = n
    k_t_1 = -(n * v0).sum(-1)

    tab = np.zeros((256, 128), np.float64)
    for j in range(3):                              # rd j-blocks
        b = j * 15
        tab[:, b:b + 5] = k_det[..., j]
        tab[:, b + 5:b + 10] = k_u_rd[..., j]
        tab[:, b + 10:b + 15] = k_v_rd[..., j]
    for j in range(3):                              # w j-blocks
        b = (3 + j) * 15
        tab[:, b + 5:b + 10] = k_u_w[..., j]
        tab[:, b + 10:b + 15] = k_v_w[..., j]
    for j in range(3):                              # ro' j-blocks (td)
        tab[:, 90 + j * 5:95 + j * 5] = k_t_ro[..., j]
    tab[:, 105:110] = k_t_1
    for tri in range(5):
        tab[:, 110 + tri * 3:113 + tri * 3] = n[:, tri]

    rt = torch.from_numpy(tab).to(torch.bfloat16).double().numpy()
    if not np.array_equal(rt, tab):
        raise AssertionError("MT dot-constant table not bf16-exact")
    return tab.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mt_const(axis_world: int, dev: torch.device) -> torch.Tensor:
    """:func:`_mt_const_np` on ``dev``, uploaded once a device."""
    return upload(_mt_const_np(axis_world), dev)


@functools.lru_cache(maxsize=None)
def _selectors(axis_world: int, dev: torch.device):
    """The world-axis unit vectors of the sweep's (s, a, b) axes, f32[3]
    each, on ``dev`` (uploaded once a device: a copy from pageable host
    memory would wait for the queued work every frame)."""
    return tuple(upload(v, dev) for v in _AXIS_SELECTORS[axis_world])


# --------------------------------------------------------------------------
# the consume rounds
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Sweep:
    """A frame's sweep constants: the eye, the slab count and sizes, and
    the packed case volume with its footprint width."""

    eye_s: torch.Tensor
    eye_a: torch.Tensor
    eye_b: torch.Tensor
    z0: torch.Tensor
    s_valid: int
    a_size: int
    b_size: int
    flip: bool
    kcells: int
    pk: torch.Tensor
    mtc: torch.Tensor


def _slab_pass(sw: _Sweep, o_i, uaf, ubf, half_a, half_b):
    """Resolve one candidate slab per row: packed case fetch + exact MT.

    ``o_i`` int32[m] the rows' candidate slabs, the rest their texels'
    window coordinates and footprint half-spans. Returns (anyhit, t_min
    (|rd| units), case, tri, cell_a, cell_b) of the nearest hit in the
    slab's footprint cells: the first (cell, triangle) in the reference's
    slot order whose t is least, as its slot-by-slot strict-less update
    picks it. All K footprint cells run as one [m, K] batch, at most
    ``_PASS_ROWS`` rows at a time (the [rows, K, 128] table rows bound
    the memory).
    """
    if o_i.numel() > _PASS_ROWS:
        parts = [_slab_pass(sw, *(x[i:i + _PASS_ROWS] for x in (
            o_i, uaf, ubf, half_a, half_b)))
            for i in range(0, o_i.numel(), _PASS_ROWS)]
        return tuple(torch.cat(p) for p in zip(*parts))
    dev = o_i.device
    o_f = o_i.to(f32)
    o_l = o_i.to(i64)
    k = (float(sw.s_valid) - 1.0 - o_f) if sw.flip else o_f
    s_scale = (sw.z0 - sw.eye_s) / (k + 0.5 - sw.eye_s)
    pa = (uaf - sw.eye_a) / s_scale + sw.eye_a
    pb = (ubf - sw.eye_b) / s_scale + sw.eye_b
    npk = sw.pk.numel()
    A, B = sw.a_size, sw.b_size

    if sw.kcells == 4:
        # |slope| <= 1: the footprint's cells sit inside the 2x2 window at
        # (fa0, fb0): one lookup of the byte-packed windows; slot j is
        # byte j, cell (fa0 + j // 2, fb0 + j % 2)
        fa0 = torch.clamp(torch.floor(pa - half_a), 0.0, float(A - 2))
        fb0 = torch.clamp(torch.floor(pb - half_b), 0.0, float(B - 2))
        fi4 = (o_l * A + fa0.to(i64)) * B + fb0.to(i64)
        p4 = sw.pk[fi4.clamp(0, npk - 1)]
        j = torch.arange(4, device=dev)
        cse = ((p4[:, None] >> (8 * j).to(i32)) & 0xFF).to(i64)
        cell_a = fa0[:, None] + (j // 2).to(f32)
        cell_b = fb0[:, None] + (j % 2).to(f32)
    else:
        # the 3x3 footprint: three lookups of the packed a-triples at b
        # offsets -1, 0, 1; slot j = 3 da + db is cell (ca + da - 1,
        # cb + db - 1)
        ca = torch.floor(pa)
        cb = torch.floor(pb)
        fi = (o_l * A + ca.to(i64)) * B + cb.to(i64)
        off = torch.arange(-1, 2, device=dev)
        v = sw.pk[(fi[:, None] + off).clamp(0, npk - 1)]          # [m, db]
        cbo = cb[:, None] + off
        q = torch.where((cbo >= 0) & (cbo <= B - 1), v, 0.0).to(i64)
        cases = torch.stack([q & 0xFF, (q >> 8) & 0xFF, q >> 16], 2)
        cse = cases.transpose(1, 2).reshape(-1, 9)                # [m, da db]
        j = torch.arange(9, device=dev)
        cell_a = ca[:, None] + (j // 3 - 1).to(f32)
        cell_b = cb[:, None] + (j % 3 - 1).to(f32)

    # dot-constant MT: per footprint cell, one row of the table gives
    # det / u*det / v*det / t*det for all 5 triangles; the lane sums are
    # written out in the reference's j order
    rd_s = sw.z0 - sw.eye_s
    rd_a = (uaf - sw.eye_a)[:, None]
    rd_b = (ubf - sw.eye_b)[:, None]
    ro_s = (sw.eye_s - k)[:, None]
    ro_a = sw.eye_a - cell_a                                      # [m, K]
    ro_b = sw.eye_b - cell_b
    q6 = (rd_s, rd_a, rd_b, _fma(ro_a, rd_b, -(ro_b * rd_a)),
          _fma(ro_b, rd_s, -(ro_s * rd_b)), _fma(ro_s, rd_a, -(ro_a * rd_s)))
    col = lambda x: x[..., None] if x.dim() else x
    fk = sw.mtc[cse]                                              # [m, K, 128]

    def lanes(lo: int):
        acc = fk[..., lo:lo + 5] * col(q6[0])
        for jj in range(1, 6):
            acc = acc + fk[..., lo + 15 * jj:lo + 15 * jj + 5] * col(q6[jj])
        return acc

    det, ud, vd = lanes(0), lanes(5), lanes(10)
    td = (fk[..., 90:95] * col(ro_s) + fk[..., 95:100] * col(ro_a)
          + fk[..., 100:105] * col(ro_b) + fk[..., 105:110])
    sgn = torch.sign(det)
    ok = det.abs() > _MT_EPS
    tt = td / torch.where(ok, det, 1.0)
    hit5 = (ok & (ud * sgn >= 0) & (vd * sgn >= 0)
            & ((ud + vd - det) * sgn <= 0) & (tt > _MT_EPS))
    ttm = torch.where(hit5, tt, _BIG)                             # [m, K, 5]
    # the first least t in (slot, triangle) order
    best_tt, first = ttm.reshape(ttm.shape[0], -1).min(dim=1)
    slot = (first // 5)[:, None]
    pick = lambda x: x.gather(1, slot)[:, 0]
    return (best_tt < _BIG, best_tt, pick(cse), first % 5, pick(cell_a),
            pick(cell_b))


def _consume_rounds(sw: _Sweep, cand_bits, uaf, ubf, half_a, half_b,
                    rd_len, max_rounds: int, tol_texels: int) -> dict:
    """Rounds of (next candidate slab -> :func:`_slab_pass`) while more
    than ``tol_texels`` texels are unresolved and fewer than
    ``max_rounds`` rounds ran. Every round runs on exactly the unresolved
    rows (one host sync, the compaction), so every live row advances once
    a round, as on the reference's ladder when its overflow is 0.

    Returns the full-width state (ptr, hit, t world, fi cell index,
    case, tri) and host values rounds, unresolved, hist (unresolved after
    each round, 0 past the last), syncs.
    """
    n = cand_bits.shape[0]
    dev = cand_bits.device
    st = dict(ptr=torch.zeros(n, dtype=i32, device=dev),
              hit=torch.zeros(n, dtype=torch.bool, device=dev),
              t=torch.zeros(n, dtype=f32, device=dev),
              fi=torch.zeros(n, dtype=i64, device=dev),
              case=torch.zeros(n, dtype=i64, device=dev),
              tri=torch.zeros(n, dtype=i64, device=dev))
    act = torch.nonzero((cand_bits != 0).any(dim=1))[:, 0]
    hist = [0] * max_rounds
    rounds, syncs = 0, 1
    while rounds < max_rounds and act.numel() > tol_texels:
        ptr = st["ptr"][act]
        has, o_i = first_set_from(cand_bits[act], ptr)
        anyhit, t_min, wcase, wtri, wca, wcb = _slab_pass(
            sw, o_i, uaf[act], ubf[act], half_a[act], half_b[act])
        newly = has & anyhit
        st["ptr"][act] = torch.where(has & ~anyhit, o_i + 1, ptr)
        st["hit"][act] = newly
        st["t"][act] = torch.where(newly, t_min * rd_len[act], 0.0)
        st["fi"][act] = torch.where(newly, (o_i.to(i64) * sw.a_size
                                            + wca.to(i64)) * sw.b_size
                                    + wcb.to(i64), 0)
        st["case"][act] = torch.where(newly, wcase, 0)
        st["tri"][act] = torch.where(newly, wtri, 0)
        act = act[~(newly | ~has)]
        syncs += 1
        hist[rounds] = int(act.numel())
        rounds += 1
    st.update(rounds=rounds, unresolved=int(act.numel()), hist=hist,
              syncs=syncs)
    return st


# --------------------------------------------------------------------------
# the texel trace
# --------------------------------------------------------------------------

def _texel_rays(scal, axis_world: int, inter_h: int, inter_w: int):
    """Per-texel rays (eye -> reference-plane texel centre) and their
    sweep quantities: dict(uaf, ubf [N], half_a, half_b [N], ray_o,
    ray_d [N, 3] world (ray_d unnormalized), rd_len [N])."""
    eye_s, eye_a, eye_b, z0 = scal[0], scal[1], scal[2], scal[3]
    voxel_size, grid_origin, cam_pos = scal[10], scal[12:15], scal[15:18]
    ua, ub = _texel_coords(scal, inter_h, inter_w)
    n = inter_h * inter_w
    uaf = ua[:, None].expand(inter_h, inter_w).reshape(-1)
    ubf = ub[None, :].expand(inter_h, inter_w).reshape(-1)
    sel_s, sel_a, sel_b = _selectors(axis_world, scal.device)
    p_ref_vox = (z0 * sel_s[None, :] + uaf[:, None] * sel_a[None, :]
                 + ubf[:, None] * sel_b[None, :])
    p_ref_world = grid_origin[None, :] + p_ref_vox * voxel_size
    ro = cam_pos[None, :].expand(n, 3)
    rd = p_ref_world - ro
    return dict(uaf=uaf, ubf=ubf,
                half_a=0.5 * ((uaf - eye_a) / (z0 - eye_s)).abs(),
                half_b=0.5 * ((ubf - eye_b) / (z0 - eye_s)).abs(),
                ray_o=ro, ray_d=rd, rd_len=norm3(rd))


def _winner(st: dict, rays: dict, axis_world: int, mtc, shadow_sw):
    """The texel results from the rounds' state: hit, t, the winner's
    unit world normal (sweep normal from the table, permuted to world
    axes), hit point, and the shadow term at the struck cell."""
    hit = st["hit"]
    n_tab = mtc[:, 110:125].reshape(256, 5, 3)
    nrm_sab = n_tab[st["case"], st["tri"]]                 # [N, 3], exact
    sel_s, sel_a, sel_b = _selectors(axis_world, hit.device)
    det_sign = -1.0 if axis_world == 1 else 1.0
    nrm_w = det_sign * (nrm_sab[:, 0:1] * sel_s[None, :]
                        + nrm_sab[:, 1:2] * sel_a[None, :]
                        + nrm_sab[:, 2:3] * sel_b[None, :])
    nl = norm3(nrm_w, keepdim=True)
    nrm_w = torch.where(hit[:, None], nrm_w / torch.clamp(nl, min=1e-30), 0.0)
    if shadow_sw is not None:
        shf = shadow_sw.reshape(-1).to(f32)
        sh_at = shf[st["fi"].clamp(0, shf.numel() - 1)]
        sh = torch.where(hit, (sh_at > 0.5).to(f32), 0.0)
    else:
        sh = torch.zeros_like(st["t"])
    t_hit = torch.where(hit, st["t"], 0.0)
    rd, rd_len = rays["ray_d"], rays["rd_len"]
    point = rays["ray_o"] + rd * torch.where(
        hit, st["t"] / torch.clamp(rd_len, min=1e-30), 0.0)[:, None]
    return dict(hit=hit, t=t_hit, normal=nrm_w, point=point, shadow=sh,
                case=st["case"].to(i32), tri=st["tri"].to(i32))


def _trace_texels(case_sw, shadow_sw, scal, s_valid: int, a_size: int,
                  b_size: int, inter_h: int, inter_w: int, flip: bool,
                  axis_world: int, max_rounds: int, tol_texels: int,
                  kcells: int = 9,
                  mark: Optional[Callable[[str], None]] = None) -> dict:
    """Full texel-space trace: one detection sweep, then consume rounds.

    ``scal`` the f32 frame scalars on the device. ``mark(stage)``, when
    given, is called after each stage ("hats", "detection sweep",
    "rounds", "normal"), for a caller timing them. Returns dict of
    per-texel tensors (flattened [IH * IW]): hit, t (world), normal
    [N, 3], point, shadow, case, tri, ray_o, ray_d; and host values
    rounds, unresolved, overflow (0), blocked (0), hist (list), syncs.
    """
    mark = mark or (lambda _stage: None)
    dev = case_sw.device
    sp = case_sw.shape[0]
    hats = _build_detect_hats(scal, sp, s_valid, a_size, b_size, inter_h,
                              inter_w, flip)
    pk = (_build_packed_cases4(case_sw) if kcells == 4
          else _build_packed_cases(case_sw))
    mtc = _mt_const(axis_world, dev)
    rays = _texel_rays(scal, axis_world, inter_h, inter_w)
    mark("hats")
    cand_bits = _sweep_candidates(_detect_volume(case_sw), hats, inter_h,
                                  inter_w)
    mark("detection sweep")
    sw = _Sweep(eye_s=scal[0], eye_a=scal[1], eye_b=scal[2], z0=scal[3],
                s_valid=s_valid, a_size=a_size, b_size=b_size, flip=flip,
                kcells=kcells, pk=pk, mtc=mtc)
    st = _consume_rounds(sw, cand_bits, rays["uaf"], rays["ubf"],
                         rays["half_a"], rays["half_b"], rays["rd_len"],
                         max_rounds, tol_texels)
    mark("rounds")
    res = _winner(st, rays, axis_world, mtc, shadow_sw)
    mark("normal")
    res.update(ray_o=rays["ray_o"], ray_d=rays["ray_d"],
               rounds=st["rounds"], unresolved=st["unresolved"],
               overflow=0, blocked=0, hist=st["hist"], syncs=st["syncs"])
    return res


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def _scene_sweep_setup(scene: MCMeshScene, camera_pos, view,
                       fov_deg: float, aspect: float):
    """Host set-up of a pose: (axis_world, flip, (S, A, B), case_sw,
    shadow_sw, scal_np, kcells). The sweep-order volumes come from the
    scene's layouts; ``kcells`` is 4 where every texel's lateral slope is
    at most 1 (the 2x2 window holds its footprint), else 9."""
    vs = float(scene.voxel_size)
    axis_world, flip, (S, A, B), eyes, window, crop_lo = _sweep_geometry(
        tuple(scene.case_vol.shape), scene.origin, vs, camera_pos, view)
    flip = bool(flip)
    case_sw = scene.layouts.get("volume", axis_world, flip, S, crop_lo)
    shadow_sw = None
    if scene.shadow_cell is not None:
        shadow_sw = scene.layouts.get("shadow", axis_world, flip, S, crop_lo)
    origin_c = scene.origin + _AXIS_SELECTORS[axis_world][0] * np.float32(
        crop_lo * vs)
    scal_np = _frame_scalars_np(
        *eyes[:3], eyes[3], *window, fov_deg, aspect, vs, S, origin_c,
        np.asarray(camera_pos, np.float32), view)
    eye_s, eye_a, eye_b, z0 = eyes
    a_min, a_max, b_min, b_max = window
    smax = max(abs(a_min - eye_a), abs(a_max - eye_a), abs(b_min - eye_b),
               abs(b_max - eye_b)) / max(abs(z0 - eye_s), 1e-12)
    kcells = 4 if smax <= 1.0 else 9
    return (axis_world, flip, (S, A, B), case_sw, shadow_sw, scal_np,
            kcells)


def _scene_device(scene: MCMeshScene, device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if scene.device != dev:
        raise ValueError(f"the scene is on {scene.device}, not {dev}")
    return dev


def trace_mc_mesh_texels(scene: MCMeshScene, camera_pos, view,
                         fov_deg: float = 45.0, aspect: float = 1.0,
                         inter_h: int = 1024, inter_w: int = 1024,
                         max_rounds: int = 16, tol_texels: int = 0,
                         device: DeviceLike = None) -> dict:
    """Texel-space trace (the raw wavefront): one ray per table texel, on
    ``device`` (the scene's).

    The per-texel rays (``ray_o``, ``ray_d``) are returned so a caller can
    feed the identical ray set to the exact LBVH tracer and compare 1:1.
    """
    dev = _scene_device(scene, device)
    (axis_world, flip, (S, A, B), case_sw, shadow_sw, scal_np,
     kcells) = _scene_sweep_setup(scene, camera_pos, view, fov_deg, aspect)
    return _trace_texels(case_sw, shadow_sw, upload(scal_np, dev), S, A, B,
                         inter_h, inter_w, flip, axis_world, max_rounds,
                         tol_texels, kcells=kcells)


def _shade_texels(res: dict, scal, inter_h: int, inter_w: int,
                  has_shadow: bool) -> torch.Tensor:
    """Texel-space two-sided Lambert + shadow, as packed 24-bit colours:
    f32[IH, IW], r * 65536 + g * 256 + b of round(colour * 255), -1 on a
    miss. The directional light makes shading view-independent, so each
    texel's colour serves its pixels."""
    light_dir, base_color, ambient = scal[34:37], scal[37:40], scal[40:43]
    nrm = res["normal"]
    dot = lambda a, b: _fma(a[..., 2], b[..., 2], _fma(
        a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))
    nrm = torch.where((dot(nrm, res["ray_d"]) > 0)[:, None], -nrm, nrm)
    l = light_dir / norm3(light_dir)
    ndotl = torch.clamp(-dot(nrm, l[None, :]), min=0.0)
    color = _fma(base_color[None, :], ndotl[:, None], ambient[None, :])
    if has_shadow:
        color = torch.where((res["shadow"] > 0.5)[:, None],
                            ambient[None, :], color)
    rgb8 = torch.clamp(torch.round(color * 255.0), 0.0, 255.0)
    packed = rgb8[:, 0] * 65536.0 + rgb8[:, 1] * 256.0 + rgb8[:, 2]
    return torch.where(res["hit"], packed, -1.0).reshape(inter_h, inter_w)


def _unpack_pixels(w_val, behind, width: int, height: int) -> torch.Tensor:
    """Looked-up packed colours -> f32[H, W, 4] rgba (misses black)."""
    hit = (w_val >= 0.0) & ~behind
    r = torch.floor(w_val * (1.0 / 65536.0))
    g = torch.floor((w_val - r * 65536.0) * (1.0 / 256.0))
    b = w_val - r * 65536.0 - g * 256.0
    rgb = _cdiv(torch.stack([r, g, b], -1), 255.0)
    rgb = torch.where(hit[:, None], rgb, 0.0)
    rgba = torch.cat([rgb, torch.ones_like(rgb[:, :1])], -1)
    return rgba.reshape(height, width, 4)


def _frame_setup(scene: MCMeshScene, camera_pos, view, fov_deg: float,
                 aspect: float, light_dir, base_color, ambient):
    """The frame's host set-up: (:func:`_scene_sweep_setup`'s tuple, the
    frame scalars with the light and colours)."""
    setup = _scene_sweep_setup(scene, camera_pos, view, fov_deg, aspect)
    scal_np = setup[5].copy()
    scal_np[34:37] = light_dir
    scal_np[37:40] = base_color
    scal_np[40:43] = ambient
    return setup, scal_np


def _mesh_frame(scene: MCMeshScene, scal_np, setup, width: int, height: int,
                inter_h: int, inter_w: int, max_rounds: int, tol_texels: int,
                mark: Optional[Callable[[str], None]] = None):
    """The frame after the host set-up: texel trace, shade, then the
    per-pixel lookup of the packed colours through ``warp_lookup``.
    Returns (rgba f32[H, W, 4], the texel trace's dict)."""
    mark = mark or (lambda _stage: None)
    dev = scene.device
    axis_world, flip, (S, A, B), case_sw, shadow_sw, _, kcells = setup
    scal = upload(scal_np, dev)
    consts = upload(_view_consts(scal_np), dev)
    mark("set-up")
    res = _trace_texels(case_sw, shadow_sw, scal, S, A, B, inter_h, inter_w,
                        flip, axis_world, max_rounds, tol_texels,
                        kcells=kcells, mark=mark)
    packed = _shade_texels(res, scal, inter_h, inter_w,
                           shadow_sw is not None)
    lin, behind, _, _ = _warp_setup(scal, axis_world, inter_h, inter_w,
                                    width, height, consts)
    mark("shade")
    w_val = slab_sweep._warp_values(packed, lin, inter_h, inter_w, width,
                                    height)
    mark("warp_lookup")
    img = _unpack_pixels(w_val, behind, width, height)
    mark("unpack")
    return img, res


def render_mc_mesh_frame(
    scene: MCMeshScene,
    camera_pos,
    view,
    fov_deg: float,
    aspect: float,
    width: int,
    height: int,
    light_dir=(-1.0, -1.0, -1.0),
    base_color=(1.0, 0.8, 0.6),
    ambient=(0.1, 0.1, 0.1),
    inter_h: int = 1024,
    inter_w: int = 1024,
    max_rounds: int = 8,
    tol_texels: int = 512,
    with_stats: bool = False,
    device: DeviceLike = None,
):
    """Triangle-traced frame of the extracted MC mesh, Lambert + shadow:
    f32[H, W, 4] rgba on ``device`` (the scene's).

    ``tol_texels``: the rounds stop when at most this many table texels
    remain unresolved (they shade as miss); 512 of 1M texels bounds the
    error at < 0.05 % of rays while capping tail rounds. ``inter_h`` and
    ``inter_w`` are at most 1024 (the lookup kernel's table width).
    ``with_stats`` also returns dict(rounds, unresolved, overflow,
    blocked, hist, syncs) of host values.
    """
    _scene_device(scene, device)
    setup, scal_np = _frame_setup(scene, camera_pos, view, fov_deg, aspect,
                                  light_dir, base_color, ambient)
    img, res = _mesh_frame(scene, scal_np, setup, width, height, inter_h,
                           inter_w, max_rounds, tol_texels)
    if with_stats:
        return img, {k: res[k] for k in ("rounds", "unresolved", "overflow",
                                         "blocked", "hist", "syncs")}
    return img
