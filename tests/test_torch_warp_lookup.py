"""Port vs JAX reference: the per-pixel table lookups.

The plain versions of the port's lookup kernels (``warp_lookup`` and
``warp_lookup_multi`` on CPU tensors) are held bitwise against the JAX
Pallas ``warp_lookup`` / ``warp_lookup_multi`` run interpreted on the
CPU, as ``tests/test_warp_kernel.py`` runs them: a gather has no
rounding. The CUDA kernels run only on a card: their tests are in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.trace.warp_kernel import (
    CONFIG_FAST, CONFIG_WIDE, split_hi_lo, split_hi_mid_lo,
)
from ray_tracing_octrees_tpu.trace import warp_kernel as jw
from ray_tracing_octrees_tpu_torch.trace import warp_kernel as tw

torch.set_num_threads(2)


def _packed_table(rng, th, tw):
    """The packed sweep encoding: k + 0.5, optionally +2048, or -1."""
    k = rng.integers(0, 512, (th, tw)).astype(np.float32)
    sh = rng.integers(0, 2, (th, tw)).astype(np.float32) * 2048.0
    miss = rng.random((th, tw)) < 0.3
    return np.where(miss, -1.0, k + 0.5 + sh).astype(np.float32)


def _lin(rng, h, w, th, tw, n_miss=5):
    """(iu << 10) | iv over the table, smooth as a warp's, with some -1."""
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    iu = np.clip((yy * 0.9 + xx * 0.05 + 37).astype(np.int32), 0, th - 1)
    iv = np.clip((xx * 1.7 + yy * 0.2 + 101).astype(np.int32), 0, tw - 1)
    lin = ((iu << 10) | iv).astype(np.int32)
    lin[0, :n_miss] = -1
    lin[h - 1, w - n_miss:] = -1
    return lin


@pytest.mark.parametrize("cfg", [CONFIG_FAST, CONFIG_WIDE])
def test_lookup_matches_reference_kernel(cfg):
    """Two-plane (hi/lo) packed table of 1024 columns, with -1 pixels."""
    rng = np.random.default_rng(1)
    ty, tx, win = cfg
    t = _packed_table(rng, 1024, 1024)
    lin = _lin(rng, 2 * ty, 2 * tx, 1024, 1024)
    ref = np.asarray(jw.warp_lookup(split_hi_lo(jnp.asarray(t)),
                                    jnp.asarray(lin), ty, tx, win))
    out = tw.warp_lookup(torch.from_numpy(t), torch.from_numpy(lin))
    assert out.dtype == torch.float32 and out.shape == lin.shape
    assert np.array_equal(out.numpy(), ref)
    assert (out.numpy()[lin < 0] == -1.0).all()


def test_lookup_narrow_table_single_plane():
    """A 512x768 table (TW < 1024) with n_planes=1: +-1 values, exact in
    bf16 — the sweep-exact dead-test configuration."""
    rng = np.random.default_rng(7)
    th, tw_ = 512, 768
    t = np.where(rng.random((th, tw_)) < 0.5, 1.0, -1.0).astype(np.float32)
    ty, tx, win = CONFIG_FAST
    yy = np.arange(ty)[:, None]
    xx = np.arange(2 * tx)[None, :]
    iu = np.clip((yy * 0.8 + xx * 0.03 + 11).astype(np.int32), 0, th - 1)
    iv = np.clip((xx * 2.3 + yy * 0.4 + 5).astype(np.int32), 0, tw_ - 1)
    lin = ((iu << 10) | iv).astype(np.int32)
    lin[3, :7] = -1
    ref = np.asarray(jw.warp_lookup(jnp.asarray(t, jnp.bfloat16),
                                    jnp.asarray(lin), ty, tx, win,
                                    n_planes=1))
    out = tw.warp_lookup(torch.from_numpy(t), torch.from_numpy(lin))
    assert np.array_equal(out.numpy(), ref)
    assert np.array_equal(out.numpy(), np.where(lin < 0, -1.0, t[iu, iv]))


def test_lookup_multi_matches_reference_kernel():
    """Splits (2, 3, 3): a packed sweep plane and two 24-bit integer
    planes, as the exact fast frame warps them."""
    rng = np.random.default_rng(5)
    th = tw_ = 1024
    ty, tx, win = CONFIG_FAST
    p0 = _packed_table(rng, th, tw_)
    p1 = rng.integers(0, 1 << 24, (th, tw_)).astype(np.float32)
    p2 = rng.integers(0, 1 << 24, (th, tw_)).astype(np.float32)
    lin = _lin(rng, 2 * ty, 2 * tx, th, tw_, n_miss=9)
    stack = jnp.concatenate([split_hi_lo(jnp.asarray(p0)),
                             split_hi_mid_lo(jnp.asarray(p1)),
                             split_hi_mid_lo(jnp.asarray(p2))], axis=0)
    ref = [np.asarray(r) for r in jw.warp_lookup_multi(
        stack, (2, 3, 3), jnp.asarray(lin), ty, tx, win)]
    out = tw.warp_lookup_multi(torch.from_numpy(np.stack([p0, p1, p2])),
                               torch.from_numpy(lin))
    assert out.shape == (3,) + lin.shape
    for p in range(3):
        assert np.array_equal(out[p].numpy(), ref[p]), p
    miss = lin < 0
    assert (out[0].numpy()[miss] == -1.0).all()
    assert (out[1:].numpy()[:, miss] == 0.0).all()


@pytest.mark.parametrize("which", ["all_miss", "no_miss"])
def test_lookup_all_or_no_miss(which):
    rng = np.random.default_rng(11)
    t = _packed_table(rng, 64, 200)
    if which == "all_miss":
        lin = np.full((8, 16), -1, np.int32)
    else:
        lin = ((rng.integers(0, 64, (8, 16)) << 10)
               | rng.integers(0, 200, (8, 16))).astype(np.int32)
    safe = np.maximum(lin, 0)
    ref = np.where(lin < 0, -1.0, t[safe >> 10, safe & 1023])
    out = tw.warp_lookup(torch.from_numpy(t), torch.from_numpy(lin))
    assert np.array_equal(out.numpy(), ref)
    multi = tw.warp_lookup_multi(torch.from_numpy(np.stack([t, t + 1.0])),
                                 torch.from_numpy(lin)).numpy()
    assert np.array_equal(multi[0], ref)
    assert np.array_equal(multi[1], np.where(lin < 0, 0.0, ref + 1.0))


def test_cpu_wrappers_run_plain_version_uncounted():
    rng = np.random.default_rng(2)
    t = torch.from_numpy(_packed_table(rng, 32, 64))
    lin = torch.from_numpy(_lin(rng, 8, 8, 32, 64))
    before = (tw.warp_lookup.launches, tw.warp_lookup_multi.launches)
    assert torch.equal(tw.warp_lookup(t, lin),
                       tw.warp_lookup_reference(t, lin))
    assert torch.equal(tw.warp_lookup_multi(t[None], lin),
                       tw.warp_lookup_multi_reference(t[None], lin))
    assert (tw.warp_lookup.launches, tw.warp_lookup_multi.launches) == before


def _lin_field(kind):
    """An int32 lin field for the form chooser: aligned, a view at a 4-byte
    storage offset, a pixel count that is not a multiple of 4, or 2-D."""
    base = torch.arange(4097, dtype=torch.int32)
    if kind == "aligned":
        return base[:4096].clone()
    if kind == "offset":
        return base[1:4097]
    if kind == "ragged":
        return base[:4095].clone()
    return base[:4096].clone().reshape(64, 64)


@pytest.mark.parametrize("kind,want", [("aligned", "vector"),
                                       ("offset", "general"),
                                       ("ragged", "vector+general"),
                                       ("2-d", "vector")])
def test_lookup_form_choice(kind, want):
    """The single-plane kernel's vector form takes the first n & ~3 pixels
    of a 16-byte aligned lin field; the general form the last 1-3 pixels
    of such a field, or all of an unaligned one."""
    lin = _lin_field(kind)
    assert lin.is_contiguous()
    forms = tw.lookup_forms(lin)
    assert "+".join(f for f, _ in forms) == want
    assert sum(k for _, k in forms) == lin.numel()
    if kind == "ragged":
        assert forms == [("vector", 4092), ("general", 3)]


def test_out_of_table_indices_clamp():
    """Indices past the table clamp to its edge (the kernel never reads
    outside the table)."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    lin = torch.tensor([(5 << 10) | 1, (1 << 10) | 9, 1023], dtype=torch.int32)
    assert tw.warp_lookup(t, lin).tolist() == [9.0, 7.0, 3.0]


BAD = {
    "bf16 table": lambda t, l: (t.to(torch.bfloat16), l),
    "int64 lin": lambda t, l: (t, l.long()),
    "wide table": lambda t, l: (torch.zeros(4, 1100), l),
    "1-d table": lambda t, l: (t.reshape(-1), l),
    "strided lin": lambda t, l: (t, l.t()),
}


@pytest.mark.parametrize("case", list(BAD))
def test_lookup_rejects_bad_arguments(case):
    t = torch.zeros(4, 8)
    lin = torch.zeros(6, 5, dtype=torch.int32)
    tt, ll = BAD[case](t, lin)
    with pytest.raises((TypeError, ValueError)):
        tw.warp_lookup(tt, ll)
    with pytest.raises((TypeError, ValueError)):
        tw.warp_lookup_multi(tt[None] if tt.ndim == 2 else tt, ll)
