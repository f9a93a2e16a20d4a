"""Every wrapper of the warp experiments beside its plain version, and
the seeded edge fields on which each window rule shows.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold each CUDA kernel
bitwise against its plain version over :func:`kernel_cases` of the
experiments' own inputs and of each set of :func:`edge_inputs`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ray_tracing_octrees_tpu_torch.tools import (
    exp_onehot_warp as ow, exp_warp2pass as w2, exp_warp_ablate as ab,
    exp_warp_kernel as wk, exp_warp_tune as wt, exp_warp_tune2 as wt2,
)

TH, TW = ow.TH, ow.TW

def wrappers() -> dict:
    """Every wrapper that launches a kernel of ``exp_warp.cu``, by name,
    with its row of the kernel table."""
    out = {"onehot_warp": (4, ow.onehot_warp),
           "onehot_warp_grouped": (4, ow.onehot_warp_grouped),
           "warp_pallas": (6, wk.warp_pallas),
           "warp": (7, wt.warp),
           "warp_slim": (8, wt2.warp_slim),
           "warp_persel": (8, wt2.warp_persel),
           "warp_pass1": (9, w2.warp_pass1),
           "warp_pass2": (9, w2.warp_pass2)}
    for kind in ab.KINDS:
        out[f"ablate_{kind}"] = (5, ab.make_call(kind))
    return out


Case = Tuple[int, str, object, object, tuple]


def kernel_cases(t_hl=None, lin=None, table=None, iu=None, iv=None,
                 t9=None, iustar=None, iv9=None, tiles=()) -> List[Case]:
    """(row, label, wrapper, plain version, args) for every wrapper whose
    inputs are given: the one-hot forms on ``t_hl`` / ``lin`` (every
    ``win`` and every tile of the experiments' lists that divides ``lin``,
    and ``warp`` at each further ``(ty, tx, win)`` of ``tiles``),
    ``warp_pallas`` on ``table`` / ``iu`` / ``iv``, and both passes of the
    two-pass warp on ``t9`` / ``iustar`` / ``iv9``."""
    cases: List[Case] = []
    if lin is not None:
        h, w = lin.shape
        for win in (64, 128):
            cases.append((4, f"onehot_warp w{win}", ow.onehot_warp,
                          ow.onehot_warp_reference, (t_hl, lin, win)))
            cases.append((4, f"onehot_warp_grouped w{win}",
                          ow.onehot_warp_grouped,
                          ow.onehot_warp_grouped_reference, (t_hl, lin, win)))
        for kind in ab.KINDS:
            cases.append((5, f"ablate {kind}", ab.make_call(kind),
                          lambda t, l, k=kind: ab.ablate_reference(t, l, k),
                          (t_hl, lin)))
        for ty, tx, win, sel in wt.CONFIGS:
            if h % ty == 0 and w % tx == 0:
                cases.append((7, f"warp ({ty},{tx}) w{win} sel{int(sel)}",
                              wt.warp, wt.warp_reference,
                              (t_hl, lin, ty, tx, win, sel)))
        for name, ty, tx, win in wt2.CONFIGS:
            if name != "ctrl" and h % ty == 0 and w % tx == 0:
                fn = wt2.warp_slim if name == "slim" else wt2.warp_persel
                plain = (wt2.warp_slim_reference if name == "slim"
                         else wt2.warp_persel_reference)
                cases.append((8, f"warp_{name} ({ty},{tx}) w{win}", fn,
                              plain, (t_hl, lin, ty, tx, win)))
        for ty, tx, win in tiles:
            cases.append((7, f"warp ({ty},{tx}) w{win} sel0", wt.warp,
                          wt.warp_reference, (t_hl, lin, ty, tx, win, False)))
    if iu is not None:
        cases.append((6, "warp_pallas", wk.warp_pallas,
                      wk.warp_pallas_reference, (table, iu, iv)))
    if iustar is not None:
        m = w2.warp_pass1_reference(t9, iustar)
        cases.append((9, "warp_pass1", w2.warp_pass1,
                      w2.warp_pass1_reference, (t9, iustar)))
        cases.append((9, "warp_pass2", w2.warp_pass2,
                      w2.warp_pass2_reference, (m, iv9)))
    return cases


# a tile of kernel 1 with no instantiation of its own
GENERAL_TILE = (8, 64, 64)


def _offset_view(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` at a storage offset of one element, so
    its data is not 16-byte aligned."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def _one_hot_lin(rng, h: int, w: int) -> np.ndarray:
    """int32 [h, w] ``(iu << 10) | iv`` on which kernel 1's rule shows:
    ``iu`` spanning 90 rows per 8-row tile, a tile at the top, a tile past
    the table's last row, and 5 % invalid pixels of several negative
    values."""
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    iu = 300 + (yy * 3 + xx // 3) % 90 + rng.integers(0, 3, (h, w))
    iu[8:16, :128] = 13 + (xx[:, :128] // 2) % 40 + yy[8:16] % 3
    iu[8:16, 128:256] = 990 + (xx[:, 128:256] * 7) % 110
    iv = (xx * 5 + yy * 37 + rng.integers(0, 4, (h, w))) % TW
    lin = ((iu << 10) | iv).astype(np.int32)
    bad = rng.random((h, w)) < 0.05
    lin[bad] = rng.choice(np.array([-1, -5, -(1 << 20),
                                    np.iinfo(np.int32).min], np.int32),
                          bad.sum())
    return lin


def _row_fields(rng, h: int, w: int, th: int, tc: int):
    """int32 ``iu``, ``iv`` [h, w] for kernel 3: ``iu`` spanning 90 rows
    per tile, a tile at the table's end, a tile to the left of it at rows
    20-89, and -1 rows in one tile only (which pull its window to row 0);
    ``iv`` in [0, tc)."""
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    iu = (40 + (yy * 5 + xx // 2) % 90 + rng.integers(0, 3, (h, w)))
    iu[:8, 128:256] = th - 30 + xx[:, 128:256] % 50
    iu[8:16, :128] = 20 + xx[:, :128] % 70
    iu[16:24:3, 256:384:17] = -1     # -1 rows in one tile only
    iv = (xx * 3 + yy * 11 + rng.integers(0, 5, (h, w))) % tc
    return iu.astype(np.int32), iv.astype(np.int32)


def edge_inputs(device, seed: int = 0) -> Dict[str, dict]:
    """Seeded fields on which every rule and every form of the kernels
    shows, as sets of :func:`kernel_cases` keywords on ``device``, by
    label. Every set shares a signed f32 table with -0.0 and +0.0 texels
    (its hi/lo split is not exact) and adds ``warp`` at the tile
    :data:`GENERAL_TILE`, which has no instantiation of its own:

    - "edge fields": a 64 x 512 ``lin`` whose ``iu`` spans 90 rows per
      8-row tile, with a tile past the table's last row, a tile at the
      top, invalid pixels of several negative values and an all-invalid
      32 x 256 corner (whole tiles of every configuration); 64 x 512
      ``iu`` / ``iv`` for ``warp_pallas``: ``iu`` spanning 90 rows per
      tile, a tile at the table's end, and a tile holding -1 rows, which
      pull its window to row 0; a 256 x 512 table, 40 x 512 ``iustar``
      and ``iv`` for the two-pass warp: H % 128 != 0, so the padded zeros
      set ``vmin`` to 0;
    - "offset views": the same index fields as contiguous views at a
      storage offset of one element, which take the general forms;
    - "72x640": 72 x 640 fields, 45 tiles of 8 x 128 (a count that is
      not a multiple of a grid of resident blocks), for kernels 1 and 3
      and both passes (``iustar`` on a 256 x 640 table);
    - "invalid 32x128 tiles": a 64 x 512 ``lin`` in which whole 32 x 128
      tiles are invalid beside valid ones: one of -1, one of int32's
      least value, one of several negative values;
    - "256x520 unpadded": the two-pass warp at a height that is a
      multiple of 128, so no tile of pass 2 is padded, and 65 tiles
      across (an odd count): 256 x 512 ``iustar`` and a 256 x 520 ``iv``
      in [100, 430) (windows that start above 0 and leave pixels out),
      with a tile whose window clips at ``V - 256``, one holding a
      negative index and one holding indices past ``V``.
    """
    rng = np.random.default_rng(seed)
    t = rng.uniform(-512, 512, (TH, TW)).astype(np.float32)
    z = rng.random((TH, TW))
    t[z < 0.1] = -0.0
    t[(z >= 0.1) & (z < 0.15)] = 0.0
    h, w = 64, 512
    lin = _one_hot_lin(rng, h, w)
    lin[32:, 256:] = -1
    iu6, iv6 = _row_fields(rng, h, w, TH, TW)
    h9, u9, v9 = 40, 256, 512
    y9 = np.arange(h9)[:, None]
    x9 = np.arange(v9)[None, :]
    ius = np.clip(40 + (y9 * 5 + x9 // 2) % 90 + rng.integers(0, 3, (h9, v9)),
                  -3, u9 + 5)
    iv9 = (x9 * 2 + y9 * 3 + rng.integers(0, 3, (h9, v9))) % 480
    iv9[:, :8] += 20

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    table = dev(t)
    t_hl = ow.split_hi_lo(table)
    tiles = (GENERAL_TILE,)
    base = dict(t_hl=t_hl, lin=dev(lin), table=table,
                iu=dev(iu6, np.int32), iv=dev(iv6, np.int32),
                t9=table[:u9, :v9].contiguous(), iustar=dev(ius, np.int32),
                iv9=dev(iv9, np.int32), tiles=tiles)
    offset = dict(base)
    for k in ("lin", "iu", "iv", "iustar", "iv9"):
        offset[k] = _offset_view(base[k])
    h7, w7 = 72, 640
    iu7, iv7 = _row_fields(rng, h7, w7, TH, TW)
    ius7, _ = _row_fields(rng, h7, w7, u9, w7)
    ius7 = np.clip(ius7, -3, u9 + 5)
    iv97 = (np.arange(w7)[None, :] * 2 + np.arange(h7)[:, None] * 3
            + rng.integers(0, 3, (h7, w7))) % w7
    small = dict(t_hl=t_hl, lin=dev(_one_hot_lin(rng, h7, w7)), table=table,
                 iu=dev(iu7), iv=dev(iv7), t9=table[:u9, :w7].contiguous(),
                 iustar=dev(ius7, np.int32), iv9=dev(iv97, np.int32),
                 tiles=tiles)
    lin32 = _one_hot_lin(rng, h, w)
    lin32[:32, 128:256] = -1
    lin32[32:, :128] = np.iinfo(np.int32).min
    lin32[32:, 384:] = rng.choice(np.array([-1, -1024, -(1 << 30)],
                                           np.int32), (32, 128))
    h8, w8 = 256, 520
    y8 = np.arange(h8)[:, None]
    x8 = np.arange(w8)[None, :]
    iv8 = 100 + (x8 * 2 + y8 * 3 + rng.integers(0, 3, (h8, w8))) % 330
    iv8[:128, 24:32] = v9 - 40 + (x8[:, 24:32] + y8[:128]) % 40
    iv8[5, 8] = -7
    iv8[130:140, 16:24] = v9 + 40
    ius8 = np.clip(_row_fields(rng, h8, v9, u9, v9)[0], -3, u9 + 5)
    return {"edge fields": base, "offset views": offset, "72x640": small,
            "invalid 32x128 tiles": dict(t_hl=t_hl, lin=dev(lin32),
                                         tiles=tiles),
            "256x520 unpadded": dict(t9=base["t9"], iustar=dev(ius8),
                                     iv9=dev(iv8, np.int32), tiles=tiles)}


def bits_equal_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of elements whose f32 bit patterns are equal."""
    return float((a.contiguous().view(torch.int32)
                  == b.contiguous().view(torch.int32)).float().mean())
