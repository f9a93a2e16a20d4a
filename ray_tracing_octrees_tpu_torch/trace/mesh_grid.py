"""Tap words and the candidate bit field of the detection sweep.

Counterpart of ``ray_tracing_octrees_tpu/trace/mesh_grid.py::
exact_tap_words`` and ``_sweep_candidates``, the functions of that module
the exact tracers need; the mesh tracer itself is not ported yet.
"""

from __future__ import annotations

import torch

from ray_tracing_octrees_tpu_torch.trace.slab_sweep import CH, _exact_matmul


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
    ``sweep_exact._widened_perspective_hats`` or ``_ortho_hats``: the tap
    words (:func:`exact_tap_words`, split-chain exact with ``wide``) AND
    the separable footprint mask.
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
