"""Port vs JAX reference: the warp experiments (``tools/exp_*warp*``).

Each plain version in ``ray_tracing_octrees_tpu_torch/tools`` is held bit
for bit (f32 bit patterns) against the experiment's Pallas kernel run
interpreted on the CPU. The kernels of ``exp_onehot_warp``,
``exp_warp_ablate``, ``exp_warp_tune`` and ``exp_warp_tune2`` take no
``interpret`` flag, so their imported bodies are wrapped here in a
``pl.pallas_call(..., interpret=True)`` with the experiment's grid,
BlockSpecs and scratch; ``warp_pallas`` and ``warp_two_pass`` take
``interpret=True``. The fields make every window rule show: tiles whose
``iu`` spans more than the window, indices past the table, all-invalid
tiles, negative ``iu``, -0.0 texels and unrounded tables (whose hi/lo
split is not exact). The CUDA kernels run only on a card: their tests are
in ``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools import exp_onehot_warp as j_ow
from tools import exp_warp2pass as j_w2
from tools import exp_warp_ablate as j_ab
from tools import exp_warp_kernel as j_wk
from tools import exp_warp_tune as j_wt
from tools import exp_warp_tune2 as j_wt2
from ray_tracing_octrees_tpu.core.grid import (
    building_center as j_center, make_sphere_grid as j_sphere,
)
from ray_tracing_octrees_tpu.render.camera import Camera as JCamera
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu_torch.tools import exp_onehot_warp as t_ow
from ray_tracing_octrees_tpu_torch.tools import exp_warp2pass as t_w2
from ray_tracing_octrees_tpu_torch.tools import exp_warp_ablate as t_ab
from ray_tracing_octrees_tpu_torch.tools import exp_warp_kernel as t_wk
from ray_tracing_octrees_tpu_torch.tools import exp_warp_tune as t_wt
from ray_tracing_octrees_tpu_torch.tools import exp_warp_tune2 as t_wt2

torch.set_num_threads(2)

TH = TW = 1024


def _bits_equal(a, b) -> bool:
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    b = np.ascontiguousarray(np.asarray(b, np.float32))
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _table(kind: str) -> np.ndarray:
    """f32 [TH, TW]: the packed encoding (k + 0.5 [+2048] or -1, exact
    in hi/lo), an unrounded uniform(0, 512) table, or signed values with
    -0.0 and +0.0 texels."""
    rng = np.random.default_rng(3)
    if kind == "packed":
        k = rng.integers(0, 512, (TH, TW)).astype(np.float32) + 0.5
        k += rng.integers(0, 2, (TH, TW)).astype(np.float32) * 2048.0
        return np.where(rng.random((TH, TW)) < 0.3, -1.0, k).astype(
            np.float32)
    if kind == "uniform":
        return rng.uniform(0, 512, (TH, TW)).astype(np.float32)
    t = rng.uniform(-512, 512, (TH, TW)).astype(np.float32)
    zero = rng.random((TH, TW))
    t[zero < 0.1] = -0.0
    t[(zero >= 0.1) & (zero < 0.15)] = 0.0
    return t


def _lin(h: int = 32, w: int = 256) -> np.ndarray:
    """int32 [h, w] ``(iu << 10) | iv`` that exercises every window rule:
    ``iu`` spanning 90 rows per tile, a tile past the table's last row,
    a tile at the top (umin rounds down to 8), invalid pixels of several
    negative values, and an all-invalid 8 x 128 tile."""
    rng = np.random.default_rng(4)
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    iu = 300 + (yy * 3 + xx // 3) % 90 + rng.integers(0, 3, (h, w))
    if h >= 16:
        iu[8:16, :128] = 13 + (xx[:, :128] // 2) % 40 + yy[8:16] % 3
        iu[8:16, 128:] = 990 + (xx[:, 128:] * 7) % 110   # up to 1099 > TH
    iv = (xx * 5 + yy * 37 + rng.integers(0, 4, (h, w))) % TW
    lin = ((iu << 10) | iv).astype(np.int32)
    bad = rng.random((h, w)) < 0.05
    lin[bad] = rng.choice(np.array([-1, -5, -(1 << 20), np.iinfo(np.int32).min],
                                   np.int32), bad.sum())
    lin[h - 8:, w - 128:] = -1
    return lin


def _split_both(t: np.ndarray):
    """(JAX split, port split); the port's must equal the tool's."""
    j = j_ow.split_hi_lo(jnp.asarray(t))
    p = t_ow.split_hi_lo(torch.as_tensor(np.array(t)))
    assert np.array_equal(np.asarray(j).view(np.uint16),
                          p.view(torch.int16).numpy().view(np.uint16))
    return j, p


def _interp(kernel, t_hl, lin, ty: int, tx: int, scratch=()):
    """A tool's one-hot kernel body under the tool's grid and specs,
    interpreted on the CPU."""
    h, w = lin.shape
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(h // ty, w // tx),
        in_specs=[
            pl.BlockSpec((2 * TH, TW), lambda i, j: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((ty, tx), lambda i, j: (i, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((ty, tx), lambda i, j: (i, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32),
        scratch_shapes=list(scratch),
        interpret=True,
    )(t_hl, jnp.asarray(lin)))


def _window_rule(t: np.ndarray, lin: np.ndarray, ty, tx, win):
    """The one-hot window rule in numpy, independent of both packages."""
    h, w = lin.shape
    inv = lin < 0
    iu = np.where(inv, TH - 1, lin >> 10)
    m = iu.reshape(h // ty, ty, w // tx, tx).min(axis=(1, 3))
    umin = np.repeat(np.repeat((np.clip(m, 0, TH - win) >> 3) << 3, ty, 0),
                     tx, 1)
    u = umin + np.clip(iu - umin, 0, win - 1)
    hi = t.astype(jnp.bfloat16).astype(np.float32)
    lo = (t - hi).astype(jnp.bfloat16).astype(np.float32)
    iv = lin & (TW - 1)
    return np.where(inv, np.float32(-1.0), hi[u, iv] + lo[u, iv])


# --------------------------------------------------------------------------
# row 4: exp_onehot_warp
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["packed", "uniform", "signed"])
def test_split_hi_lo_bitwise(kind):
    t = _table(kind)
    _, p = _split_both(t)
    assert p.dtype == torch.bfloat16 and p.shape == (2 * TH, TW)
    hl = p.float().numpy()
    assert np.array_equal(hl[:TH] + hl[TH:], t) == (kind == "packed")


@pytest.mark.parametrize("form", ["onehot_warp", "onehot_warp_grouped"])
@pytest.mark.parametrize("win", [64, 128])
@pytest.mark.parametrize("kind", ["packed", "uniform", "signed"])
def test_onehot_warp_matches_interpret(form, win, kind):
    t = _table(kind)
    lin = _lin(16, 256) if kind != "packed" else _lin()
    j_hl, t_hl = _split_both(t)
    if form == "onehot_warp":
        ref = _interp(functools.partial(j_ow._kernel, win), j_hl, lin, 8, 128)
    else:
        ref = _interp(functools.partial(j_ow._kernel_grouped, win), j_hl, lin,
                      8, 128, [pltpu.VMEM((8 * 128, 2 * win), jnp.float32)])
    out = getattr(t_ow, form)(t_hl, torch.from_numpy(lin), win)
    assert out.dtype == torch.float32
    assert _bits_equal(out.numpy(), ref)
    assert _bits_equal(ref, _window_rule(t, lin, 8, 128, win))
    assert _bits_equal(getattr(t_ow, form + "_reference")(
        t_hl, torch.from_numpy(lin), win), ref)


def test_window_rule_differs_from_gather():
    """The rule is not the plain gather: clamped pixels read the window's
    edge row, and an unrounded table loses bits in the split."""
    t = _table("uniform")
    lin = _lin()
    _, t_hl = _split_both(t)
    out = t_ow.onehot_warp(t_hl, torch.from_numpy(lin), 64).numpy()
    valid = lin >= 0
    safe = np.where(valid, lin, 0)
    gather = t[np.minimum(safe >> 10, TH - 1), safe & 1023]
    assert (out != gather)[valid].mean() > 0.5
    assert (out[~valid] == -1.0).all()


# --------------------------------------------------------------------------
# row 5: exp_warp_ablate
# --------------------------------------------------------------------------

_ABLATE_BODIES = {"null": j_ab._k_null, "intops": j_ab._k_intops,
                  "twload": j_ab._k_twload, "select": j_ab._k_select}


@pytest.mark.parametrize("kind", list(_ABLATE_BODIES))
def test_ablation_matches_interpret(kind):
    t = _table("signed")
    lin = _lin()
    j_hl, t_hl = _split_both(t)
    ref = _interp(_ABLATE_BODIES[kind], j_hl, lin, 8, 128)
    out = t_ab.make_call(kind)(t_hl, torch.from_numpy(lin))
    assert _bits_equal(out.numpy(), ref)
    assert _bits_equal(t_ab.ablate_reference(t_hl, torch.from_numpy(lin),
                                             kind), ref)
    if kind != "null":
        assert (ref[lin < 0] == -1.0).all()


def test_ablation_synthetic_fields_match_tool():
    """The driver's seeded table and lin fields are the experiment's: the
    same rng calls in the same order."""
    rng = np.random.default_rng(0)
    t_ref = rng.uniform(0, 512, (TH, TW)).astype(np.float32)
    t2, lins = t_ab.synthetic_inputs(64, 256)
    assert _bits_equal(t2, t_ref) and len(lins) == 4
    base_u = rng.integers(0, TH - 60)
    iu = np.clip(base_u + (np.arange(64)[:, None] // 24) % 50
                 + rng.integers(0, 4, (64, 256)), 0, TH - 1)
    iv = np.clip((np.arange(256)[None, :] // 2) % TW
                 + rng.integers(0, 4, (64, 256)), 0, TW - 1)
    assert np.array_equal(lins[0], (iu * TW + iv).astype(np.int32))


# --------------------------------------------------------------------------
# rows 7 and 8: exp_warp_tune, exp_warp_tune2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", t_wt.CONFIGS)
def test_tune_warp_matches_interpret(cfg):
    ty, tx, win, mxu_sel = cfg
    t = _table("signed")
    lin = _lin()
    j_hl, t_hl = _split_both(t)
    ref = _interp(functools.partial(j_wt._kernel, ty, tx, win, mxu_sel),
                  j_hl, lin, ty, tx,
                  [pltpu.VMEM((ty * tx, 2 * win), jnp.float32)])
    out = t_wt.warp(t_hl, torch.from_numpy(lin), ty, tx, win, mxu_sel)
    assert _bits_equal(out.numpy(), ref)
    assert _bits_equal(ref, _window_rule(t, lin, ty, tx, win))


@pytest.mark.parametrize("name,ty,tx,win",
                         [c for c in t_wt2.CONFIGS if c[0] != "ctrl"])
def test_tune2_warp_matches_interpret(name, ty, tx, win):
    t = _table("uniform")
    lin = _lin()
    j_hl, t_hl = _split_both(t)
    body = j_wt2._k_slim if name == "slim" else j_wt2._k_persel
    scratch = ((ty * tx, win) if name == "slim" else (ty, tx))
    ref = _interp(functools.partial(body, ty, tx, win), j_hl, lin, ty, tx,
                  [pltpu.VMEM(scratch, jnp.float32)])
    fn = t_wt2.warp_slim if name == "slim" else t_wt2.warp_persel
    assert _bits_equal(fn(t_hl, torch.from_numpy(lin), ty, tx, win).numpy(),
                       ref)


def test_tune_configs_are_the_tools():
    """The drivers sweep the experiments' own config lists."""
    import inspect

    src = inspect.getsource(j_wt.main)
    for ty, tx, win, sel in t_wt.CONFIGS:
        assert f"({ty}, {tx}, {win}, {sel})" in src
    src2 = inspect.getsource(j_wt2.main)
    for name, ty, tx, win in t_wt2.CONFIGS:
        assert f'("{name}", ' in src2 and f"{ty}, {tx}, {win})" in src2


def test_tune_synthetic_fields_match_tool():
    rng = np.random.default_rng(0)
    t_ref = np.round(rng.uniform(0, 512, (TH, TW)).astype(np.float32)) + 0.5
    t2, lins = t_wt.synthetic_inputs(64, 256)
    assert _bits_equal(t2, t_ref)
    yy, xx = np.arange(64)[:, None], np.arange(256)[None, :]
    for k, lin in enumerate(lins):
        iu = np.clip((yy * 0.35 + xx * 0.02 + k).astype(np.int32), 0, TH - 1)
        iv = np.clip((xx * 0.52 + yy * 0.01 + 3 * k).astype(np.int32), 0,
                     TW - 1)
        assert np.array_equal(lin, (iu * TW + iv).astype(np.int32))


# --------------------------------------------------------------------------
# row 6: exp_warp_kernel
# --------------------------------------------------------------------------

def _iu_iv(h, w, th, c, seed):
    """``iu`` spanning 90 rows per tile, a tile at the table's end, a tile
    with -1 pixels (its window pulled to row 0) and ``iv`` in [0, c)."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    iu = (40 + (yy * 5 + xx // 2) % 90 + rng.integers(0, 3, (h, w))).astype(
        np.int32)
    iu[:8, 128:256] = th - 30 + (xx[:, 128:256] % 50)
    iu[8:16, :128] = np.where(rng.random((8, 128)) < 0.1, -1, 20 + xx[:, :128]
                              % 70)
    iu[:8, 256:384:13] = -1           # -1 rows in one tile only
    iv = ((xx * 3 + yy * 11 + rng.integers(0, 5, (h, w))) % c).astype(
        np.int32)
    return iu, iv


@pytest.mark.parametrize("kind", ["uniform", "signed"])
def test_warp_pallas_matches_interpret(kind):
    t = _table(kind)[:, :600].copy()
    iu, iv = _iu_iv(16, 384, TH, 600, 5)
    ref = np.asarray(j_wk.warp_pallas(jnp.asarray(t), jnp.asarray(iu),
                                      jnp.asarray(iv), interpret=True))
    args = (torch.from_numpy(t), torch.from_numpy(iu), torch.from_numpy(iv))
    assert _bits_equal(t_wk.warp_pallas(*args).numpy(), ref)
    assert _bits_equal(t_wk.warp_pallas_reference(*args).numpy(), ref)
    assert (ref == 0).mean() > 0.05
    if kind == "signed":
        assert not np.signbit(ref[ref == 0]).any()


def test_warp_pallas_rejects_iv_out_of_range():
    t = torch.zeros(64, 100)
    iu = torch.zeros(8, 128, dtype=torch.int32)
    for bad in (-1, 100):
        iv = torch.zeros(8, 128, dtype=torch.int32)
        iv[3, 7] = bad
        with pytest.raises(ValueError):
            t_wk.warp_pallas(t, iu, iv)
    with pytest.raises(ValueError):
        t_wk.warp_pallas(torch.zeros(63, 100), iu, iu)


def test_split_lin_floors():
    lin = torch.tensor([[-1, 0, 1023, 1024, 5000]], dtype=torch.int32)
    iu, iv = t_wk.split_lin(lin)
    assert iu.tolist() == [[-1, 0, 0, 1, 4]]
    assert iv.tolist() == [[1023, 0, 1023, 0, 5000 % 1024]]


# --------------------------------------------------------------------------
# row 9: exp_warp2pass
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h", [40, 128])
def test_two_pass_matches_interpret(h):
    """V = 512 and, at H = 40, a padded last y-tile: its vmin is 0, so
    pixels with iv >= 256 come out 0."""
    rng = np.random.default_rng(6)
    u, v, w = 200, 512, 256
    t = _table("signed")[:u, :v].copy()
    ius, _ = _iu_iv(h, v, u, v, 7)
    ius = np.clip(ius, -3, u + 5).astype(np.int32)
    iv = ((np.arange(w)[None, :] * 2 + np.arange(h)[:, None] * 3
           + rng.integers(0, 3, (h, w))) % 480).astype(np.int32)
    iv[:, :8] += 20
    ref = np.asarray(j_w2.warp_two_pass(jnp.asarray(t), jnp.asarray(ius),
                                        jnp.asarray(iv), interpret=True))
    args = (torch.from_numpy(t), torch.from_numpy(ius), torch.from_numpy(iv))
    out = t_w2.warp_two_pass(*args).numpy()
    assert _bits_equal(out, ref)
    assert _bits_equal(t_w2.warp_two_pass_reference(*args).numpy(), ref)
    assert (ref != 0).mean() > 0.05
    if h % 128:
        assert (ref[iv >= 256] == 0).all()


def test_two_pass_rejects_small_tables():
    ius = torch.zeros(8, 256, dtype=torch.int32)
    iv = torch.zeros(8, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        t_w2.warp_two_pass(torch.zeros(63, 256), ius, iv)
    with pytest.raises(ValueError):
        t_w2.warp_two_pass(torch.zeros(64, 128), ius[:, :128], iv)


# --------------------------------------------------------------------------
# the slice: the drivers' inputs from both packages
# --------------------------------------------------------------------------

DIM, W, H = 64, 256, 64


@pytest.fixture(scope="module")
def bench_inputs():
    """The bench pose on the 64^3 sphere, 256 x 64 image, 1024^2 table,
    built as the experiments build it (JAX) and by the port's driver."""
    grid = j_sphere(DIM)
    vol = (jnp.asarray(grid.occ) > 0).astype(jnp.float32)
    extent = float(np.max(np.asarray(grid.world_max)
                          - np.asarray(grid.world_min)))
    cam = JCamera(theta=0.9, phi=0.8, radius=0.75 * extent)
    cam.set_target(np.asarray(j_center(grid)))
    aw, flip, (S, A, B), eyes, window, _crop = js._sweep_geometry(
        vol, grid.origin, grid.voxel_size, cam.get_pos(), cam.get_view())
    vol_bf = js._layout_volume(vol, aw, flip, S, A, B)
    scal_np = np.asarray(js._frame_scalars(
        *eyes[:3], eyes[3], *window, 45.0, W / H, float(grid.voxel_size), S,
        np.asarray(grid.origin, np.float32),
        np.asarray(cam.get_pos(), np.float32), cam.get_view()))
    packed = js._sweep_all(vol_bf, jnp.asarray(scal_np), vol_bf.shape[0] // 32,
                           S, A, B, TH, TW, bool(flip))
    lin, behind, _, _ = js._warp_setup(jnp.asarray(scal_np), aw, TH, TW, W, H)
    lin_np = np.where(np.asarray(behind).reshape(H, W), -1,
                      np.asarray(lin).reshape(H, W)).astype(np.int32)
    port = t_ow.bench_pose_inputs(DIM, W, H, 1, "cpu")[0]
    return dict(table=np.array(packed).reshape(TH, TW), lin=lin_np,
                scal=scal_np, axis=aw, port=port)


def test_bench_inputs_equal(bench_inputs):
    """Axis, scalars and table bitwise. ``lin`` is equal but where a ray
    meets the reference plane within an ulp of a texel edge: XLA fuses
    the reference's ray math into FMAs, so such a pixel lands one texel
    over in one coordinate (1 of 16384 pixels here)."""
    b = bench_inputs
    p = b["port"]
    assert p["axis"] == b["axis"]
    assert _bits_equal(p["scal"], b["scal"])
    assert _bits_equal(p["table"].numpy(), b["table"])
    assert (b["table"] >= 0).any() and (b["lin"] >= 0).any()
    lt, lj = p["lin"].numpy(), b["lin"]
    diff = lt != lj
    assert diff.sum() <= 4
    assert ((lt[diff] >= 0) & (lj[diff] >= 0)).all()
    du = np.abs((lt[diff] >> 10) - (lj[diff] >> 10))
    dv = np.abs((lt[diff] & 1023) - (lj[diff] & 1023))
    assert (du + dv == 1).all()


def test_bench_inputs_onehot(bench_inputs):
    b = bench_inputs
    j_hl, t_hl = _split_both(b["table"])
    lin = b["port"]["lin"]
    for win in (64, 128):
        ref = _interp(functools.partial(j_ow._kernel, win), j_hl,
                      lin.numpy(), 8, 128)
        out = t_ow.onehot_warp(t_hl, lin, win)
        assert _bits_equal(out.numpy(), ref), win


def test_bench_inputs_warp_pallas_and_two_pass(bench_inputs):
    b = bench_inputs
    lin = b["port"]["lin"].numpy()
    iu_np, iv_np = lin // 1024, lin % 1024
    iu, iv = t_wk.split_lin(b["port"]["lin"])
    assert np.array_equal(iu.numpy(), iu_np)
    assert np.array_equal(iv.numpy(), iv_np)
    t = b["table"]
    ref = np.asarray(j_wk.warp_pallas(jnp.asarray(t), jnp.asarray(iu_np),
                                      jnp.asarray(iv_np), interpret=True))
    assert _bits_equal(t_wk.warp_pallas(torch.from_numpy(t), iu, iv).numpy(),
                       ref)
    ius_j = j_w2.inverse_row_homography(b["scal"], b["axis"], TH, TW, W, H)
    ius_t = t_w2.inverse_row_homography(b["port"]["scal"], b["port"]["axis"],
                                        TH, TW, W, H)
    assert ius_t.dtype == np.int32 and np.array_equal(ius_t, ius_j)
    ref2 = np.asarray(j_w2.warp_two_pass(jnp.asarray(t), jnp.asarray(ius_j),
                                         jnp.asarray(iv_np), interpret=True))
    out2 = t_w2.warp_two_pass(torch.from_numpy(t), torch.from_numpy(ius_t),
                              iv)
    assert _bits_equal(out2.numpy(), ref2)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_inverse_row_homography_bitwise(axis):
    """Every sweep axis: the port's copy reads the port's selectors."""
    rng = np.random.default_rng(8 + axis)
    scal = np.zeros(43, np.float32)
    scal[0:8] = (-30.5, 12.25, 9.75, 0.5, -4.0, 60.0, -3.0, 58.0)
    scal[8:12] = (45.0, 1.6, 0.01, 64)
    view = np.eye(4, dtype=np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    view[:3, :3] = q.astype(np.float32)
    scal[18:34] = view.reshape(-1)
    a = j_w2.inverse_row_homography(scal, axis, 512, 384, 160, 96)
    b = t_w2.inverse_row_homography(scal, axis, 512, 384, 160, 96)
    assert np.array_equal(a, b) and len(np.unique(b)) > 10


# --------------------------------------------------------------------------
# the wrappers on CPU tensors
# --------------------------------------------------------------------------

def _all_wrappers(t_hl, lin, t2, iu, iv, ius):
    return [
        (t_ow.onehot_warp, (t_hl, lin, 64)),
        (t_ow.onehot_warp_grouped, (t_hl, lin, 64)),
        (t_wt.warp, (t_hl, lin, 8, 128, 64)),
        (t_wt2.warp_slim, (t_hl, lin, 8, 128, 64)),
        (t_wt2.warp_persel, (t_hl, lin, 8, 128, 64)),
        (t_wk.warp_pallas, (t2, iu, iv)),
        (t_w2.warp_pass1, (t2[:, :256].contiguous(), ius)),
    ] + [(t_ab.make_call(k), (t_hl, lin)) for k in t_ab.KINDS]


def test_cpu_wrappers_run_plain_versions_uncounted():
    t = _table("packed")
    _, t_hl = _split_both(t)
    lin = torch.from_numpy(_lin(8, 128))
    t2 = torch.from_numpy(t)
    iu, iv = t_wk.split_lin(torch.clamp(lin, min=0))
    ius = torch.zeros(8, 256, dtype=torch.int32)
    wrappers = _all_wrappers(t_hl, lin, t2, iu, iv, ius)
    before = [fn.launches for fn, _ in wrappers]
    for fn, args in wrappers:
        assert fn(*args).shape == args[1].shape
    assert [fn.launches for fn, _ in wrappers] == before


BAD = {
    "f32 t_hl": lambda t, l: (t.float(), l),
    "int64 lin": lambda t, l: (t, l.long()),
    "short table": lambda t, l: (t[:1024], l),
    "ragged lin": lambda t, l: (t, l[:, :100].contiguous()),
    "strided lin": lambda t, l: (t, l[:, ::2]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_onehot_wrappers_reject_bad_arguments(case):
    _, t_hl = _split_both(_table("packed"))
    lin = torch.from_numpy(_lin(8, 256))
    tt, ll = BAD[case](t_hl, lin)
    for fn, args in [(t_ow.onehot_warp, (64,)), (t_wt.warp, (8, 128, 64)),
                     (t_wt2.warp_slim, (8, 128, 64))]:
        with pytest.raises((TypeError, ValueError)):
            fn(tt, ll, *args)
    with pytest.raises((TypeError, ValueError)):
        t_ab.make_call("select")(tt, ll)
    with pytest.raises(ValueError):
        t_ab.make_call("gather")


# --------------------------------------------------------------------------
# the edge sets of tools/cases.py: every case's plain version against the
# experiment's Pallas body, interpreted
# --------------------------------------------------------------------------

from ray_tracing_octrees_tpu_torch.tools import cases as t_cases  # noqa: E402
from ray_tracing_octrees_tpu_torch.trace import exp_warp as t_ew  # noqa: E402


@pytest.fixture(scope="module")
def edge_sets():
    return t_cases.edge_inputs("cpu")


def _interp_pass1(t, ius):
    """Pass 1 of ``tools/exp_warp2pass.py`` under its grid and specs."""
    (u, v), h = t.shape, ius.shape[0]
    return np.asarray(pl.pallas_call(
        j_w2._pass1_kernel,
        grid=(h // 8, v // 128),
        in_specs=[pl.BlockSpec((u, 128), lambda i, j: (0, j)),
                  pl.BlockSpec((8, 128), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((8, 128), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((h, v), jnp.float32),
        interpret=True,
    )(jnp.asarray(t), jnp.asarray(ius)))


def _interp_pass2(m, iv):
    """Pass 2 of ``tools/exp_warp2pass.py`` on ``M``: its transposes, zero
    padding, grid and specs."""
    (h, w), v = iv.shape, m.shape[1]
    hp = (-h) % 128
    mt = jnp.pad(jnp.transpose(jnp.asarray(m)), ((0, 0), (0, hp)))
    ivt = jnp.pad(jnp.transpose(jnp.asarray(iv)), ((0, 0), (0, hp)))
    out_t = pl.pallas_call(
        j_w2._pass2_kernel,
        grid=(w // 8, (h + hp) // 128),
        in_specs=[pl.BlockSpec((v, 128), lambda i, j: (0, j)),
                  pl.BlockSpec((8, 128), lambda i, j: (i, j))],
        out_specs=pl.BlockSpec((8, 128), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((w, h + hp), jnp.float32),
        interpret=True,
    )(mt, ivt)
    return np.asarray(jnp.transpose(out_t[:, :h]))


def _pallas_reference(row, name, args):
    """The experiment's Pallas body, interpreted, on a case's arguments."""
    np_args = [a.numpy() if torch.is_tensor(a) and a.dtype != torch.bfloat16
               else a for a in args]
    if row in (4, 5, 7, 8):
        j_hl = jnp.asarray(args[0].float().numpy()).astype(jnp.bfloat16)
        lin = np_args[1]
        if row == 4:
            win = args[2]
            if name.startswith("onehot_warp_grouped"):
                return _interp(functools.partial(j_ow._kernel_grouped, win),
                               j_hl, lin, 8, 128,
                               [pltpu.VMEM((8 * 128, 2 * win), jnp.float32)])
            return _interp(functools.partial(j_ow._kernel, win), j_hl, lin,
                           8, 128)
        if row == 5:
            return _interp(_ABLATE_BODIES[name.split()[1]], j_hl, lin, 8, 128)
        ty, tx, win = args[2:5]
        if row == 7:
            return _interp(functools.partial(j_wt._kernel, ty, tx, win,
                                             args[5]), j_hl, lin, ty, tx,
                           [pltpu.VMEM((ty * tx, 2 * win), jnp.float32)])
        slim = name.startswith("warp_slim")
        return _interp(functools.partial(
            j_wt2._k_slim if slim else j_wt2._k_persel, ty, tx, win), j_hl,
            lin, ty, tx,
            [pltpu.VMEM((ty * tx, win) if slim else (ty, tx), jnp.float32)])
    if row == 6:
        return np.asarray(j_wk.warp_pallas(*map(jnp.asarray, np_args),
                                           interpret=True))
    if name == "warp_pass1":
        return _interp_pass1(*np_args)
    return _interp_pass2(*np_args)


EDGE_ROWS = [("edge fields", 7)] + [
    (label, row) for label in ("offset views", "72x640")
    for row in (4, 5, 6, 7, 8, 9)
    if not (label == "72x640" and row == 8)] + [
    ("invalid 32x128 tiles", row) for row in (4, 5, 7, 8)] + [
    ("256x520 unpadded", 9)]


@pytest.mark.parametrize("label,row", EDGE_ROWS)
def test_edge_sets_match_interpret(edge_sets, label, row):
    """Each wrapper on the edge set's CPU tensors (its plain version)
    equals the experiment's Pallas body bit for bit: index fields at a
    storage offset, 45 tiles of 8 x 128, whole invalid 32 x 128 tiles, and
    ``warp`` at the tile (8, 64), which has no instantiation on the card."""
    kc = [c for c in t_cases.kernel_cases(**edge_sets[label]) if c[0] == row]
    assert kc
    for _, name, fn, plain, args in kc:
        out = fn(*args)
        assert _bits_equal(out.numpy(), _pallas_reference(row, name, args)), \
            name
        assert _bits_equal(plain(*args).numpy(), out.numpy()), name


def test_edge_sets_have_their_structure(edge_sets):
    """The offset views are contiguous and not 16-byte aligned, 72 x 640
    holds 45 tiles of 8 x 128, the invalid set has whole invalid 32 x 128
    tiles beside valid ones, and every set adds the tile (8, 64)."""
    base, off = edge_sets["edge fields"], edge_sets["offset views"]
    for k in ("lin", "iu", "iv", "iustar", "iv9"):
        assert off[k].is_contiguous() and off[k].storage_offset() == 1
        assert off[k].data_ptr() % 16 != 0
        assert torch.equal(off[k], base[k])
    h, w = edge_sets["72x640"]["lin"].shape
    assert (h // 8) * (w // 128) == 45
    lin = edge_sets["invalid 32x128 tiles"]["lin"].numpy()
    tiles = lin.reshape(2, 32, 4, 128).transpose(0, 2, 1, 3).reshape(8, -1)
    whole = (tiles < 0).all(axis=1)
    assert whole.sum() == 3 and (tiles >= 0).any(axis=1).sum() == 5
    assert all(s["tiles"] == (t_cases.GENERAL_TILE,)
               for s in edge_sets.values())
    assert (t_cases.GENERAL_TILE[:2] not in t_ew.ONEHOT_TILES)


FORMS = {"aligned": (True, 0, "vector"),
         "offset 1": (True, 1, "general"),
         "offset 4": (True, 4, "vector"),
         "no instantiation": (False, 0, "general")}


@pytest.mark.parametrize("case", list(FORMS))
def test_kernel_form_choice(case):
    """The tile's own instantiation only where it has one and every index
    field is 16-byte aligned."""
    instantiated, offset, want = FORMS[case]
    flat = torch.zeros(64 + offset, dtype=torch.int32)
    idx = flat[offset:]
    assert t_ew.form(instantiated, idx) == want
    assert t_ew.form(instantiated, torch.zeros(64, dtype=torch.int32),
                     idx) == want


def test_kernel_32bit_offsets_checked():
    """Kernels 1 and 3 index with 32-bit offsets: an input of 2^31
    elements is refused."""
    t_ew._check_32bit(lin=torch.zeros(1, dtype=torch.int32).expand(2 ** 31
                                                                    - 1))
    with pytest.raises(ValueError):
        t_ew._check_32bit(lin=torch.zeros(1, dtype=torch.int32).expand(
            2 ** 31))


@pytest.mark.parametrize("seed,h", [(0, 40), (1, 136), (2, 200), (3, 296)])
def test_pass2_padded_tiles_take_vmin_zero(seed, h):
    """Kernel 4's vector form gives a tile that reaches past the last row
    vmin = 0 without taking its min: exact, since the zeros that pad y to
    a multiple of 128 take part in the min. On random fields (H % 128 !=
    0, indices below 0 and at or past V) every padded tile's vmin in
    the plain version is 0, whole tiles have theirs, and the plain
    version equals the interpreted Pallas body."""
    w, v, win = 64, 512, t_w2.WIN2
    rng = np.random.default_rng(seed)
    iv = rng.integers(150, v + 60, (h, w))
    bad = rng.random((h, w)) < 0.002
    iv[bad] = rng.choice(np.array([-1, -(1 << 31), v, (1 << 31) - 1]),
                         bad.sum())
    iv = torch.as_tensor(iv.astype(np.int32))
    vmin = t_w2.pass2_vmin(iv, v, win)
    full = (h // 128) * 128
    assert bool((vmin[full:] == 0).all())
    tiles = iv[:full].reshape(-1, 128, w // 8, 8).amin(dim=(1, 3))
    want = tiles.clamp(0, v - win).repeat_interleave(128, 0) \
        .repeat_interleave(8, 1)
    assert torch.equal(vmin[:full], want)
    assert h < 128 or bool((want > 0).any())
    m = rng.uniform(-4, 4, (h, v)).astype(np.float32)
    m[rng.random((h, v)) < 0.1] = -0.0
    out = t_w2.warp_pass2(torch.as_tensor(m), iv)
    assert _bits_equal(out.numpy(), _interp_pass2(m, iv.numpy()))


@pytest.mark.parametrize("label", ["edge fields", "offset views", "72x640",
                                   "256x520 unpadded"])
def test_col_window_form_choice(edge_sets, label):
    """Kernel 4 takes its vector form on an aligned ``iv`` and the first
    port's kernel, its general form, on one at a storage offset."""
    iv = edge_sets[label]["iv9"]
    want = "general" if label == "offset views" else "vector"
    assert t_ew.form(True, iv) == want
    assert t_ew.form(True, t_cases._offset_view(iv)) == "general"


def test_col_window_32bit_offsets_checked():
    """Kernel 4 indexes with 32-bit offsets: an ``M`` of 2^31 elements is
    refused before any launch."""
    iv = torch.zeros((8, 8), dtype=torch.int32)
    m = torch.zeros(1, dtype=torch.float32).expand(8, 2 ** 28)
    with pytest.raises(ValueError, match="2\\^31"):
        t_ew.col_window(m, iv, t_w2.WIN2)
