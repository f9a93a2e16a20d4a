"""Tap words of the detection sweep.

Counterpart of ``ray_tracing_octrees_tpu/trace/mesh_grid.py::
exact_tap_words``, the one function of that module the exact fast frame
needs; the mesh tracer itself is not ported yet.
"""

from __future__ import annotations

import torch

from ray_tracing_octrees_tpu_torch.trace.slab_sweep import _exact_matmul


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
