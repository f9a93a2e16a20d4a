"""Every wrapper of the warp experiments beside its plain version, and
the seeded edge fields on which each window rule shows.

``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold each CUDA kernel
bitwise against its plain version over :func:`kernel_cases` of the
drivers' inputs and of :func:`edge_inputs`.
"""

from __future__ import annotations

from typing import List, Tuple

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
                 t9=None, iustar=None, iv9=None) -> List[Case]:
    """(row, label, wrapper, plain version, args) for every wrapper whose
    inputs are given: the one-hot forms on ``t_hl`` / ``lin`` (every
    ``win`` and every tile that divides ``lin``), ``warp_pallas`` on
    ``table`` / ``iu`` / ``iv``, and both passes of the two-pass warp on
    ``t9`` / ``iustar`` / ``iv9``."""
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


def edge_inputs(device, seed: int = 0) -> dict:
    """Seeded fields on which every rule shows, as :func:`kernel_cases`
    keywords, on ``device``:

    - a signed f32 table with -0.0 and +0.0 texels (its hi/lo split is
      not exact);
    - a 64 x 512 ``lin`` whose ``iu`` spans 90 rows per 8-row tile, with
      a tile past the table's last row, a tile at the top, invalid pixels
      of several negative values and an all-invalid 32 x 256 corner
      (whole tiles of every configuration);
    - 64 x 512 ``iu`` / ``iv`` for ``warp_pallas``: ``iu`` spanning 90
      rows per tile, a tile at the table's end, and a tile holding -1
      rows, which pull its window to row 0;
    - a 256 x 512 table, 40 x 512 ``iustar`` and ``iv`` for the two-pass
      warp: H % 128 != 0, so the padded zeros set ``vmin`` to 0.
    """
    rng = np.random.default_rng(seed)
    t = rng.uniform(-512, 512, (TH, TW)).astype(np.float32)
    z = rng.random((TH, TW))
    t[z < 0.1] = -0.0
    t[(z >= 0.1) & (z < 0.15)] = 0.0
    h, w = 64, 512
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
    lin[32:, 256:] = -1
    iu6 = (40 + (yy * 5 + xx // 2) % 90 + rng.integers(0, 3, (h, w)))
    iu6[:8, 128:256] = TH - 30 + xx[:, 128:256] % 50
    iu6[8:16, :128] = 20 + xx[:, :128] % 70
    iu6[16:24:3, 256:384:17] = -1     # -1 rows in one tile only
    iv6 = (xx * 3 + yy * 11 + rng.integers(0, 5, (h, w))) % TW
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
    return dict(t_hl=ow.split_hi_lo(table), lin=dev(lin), table=table,
                iu=dev(iu6, np.int32), iv=dev(iv6, np.int32),
                t9=table[:u9, :v9].contiguous(), iustar=dev(ius, np.int32),
                iv9=dev(iv9, np.int32))


def bits_equal_share(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of elements whose f32 bit patterns are equal."""
    return float((a.contiguous().view(torch.int32)
                  == b.contiguous().view(torch.int32)).float().mean())
