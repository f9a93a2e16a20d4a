"""Port vs JAX reference: the fused per-pixel frame (warp_kernel).

``warp_frame_reference`` (the CUDA kernel's plain PyTorch version) is held
against the JAX ``warp_frame`` Pallas kernel run interpreted on the CPU,
with the split table and ``(ty, tx, win) = (32, 128, 256)`` as
``tests/test_warp_kernel.py`` runs it. The CUDA kernel itself runs only on
a card: its tests are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu.render.camera import Camera
from ray_tracing_octrees_tpu.trace import slab_sweep as js
from ray_tracing_octrees_tpu.trace import warp_kernel as jw
from ray_tracing_octrees_tpu_torch.trace import warp_kernel as tw

torch.set_num_threads(2)

TO_LIGHT = (0.5, 0.9, 0.4)
W, H, INTER = 256, 64, 256
POSES = {
    "exterior": dict(theta=0.5, phi=0.8, radius=2.2),
    "below": dict(theta=-0.9, phi=4.0, radius=2.0),
    "interior": dict(theta=0.05, phi=3.2, radius=0.05,
                     target=np.array([0.0, 0.0, -0.3], np.float32)),
}


@pytest.fixture(scope="module")
def scene():
    g = make_sphere_grid(32)
    vol = (np.asarray(g.occ) > 0).astype(np.float32)
    sv = js.shadow_volume(vol, TO_LIGHT)
    return g, vol, sv


def _frame_inputs(scene, name, with_shadow=True):
    """(packed table f32[INTER, INTER], per-frame scalars, sweep axis) from
    the reference's own sweep."""
    g, vol, sv = scene
    p = dict(POSES[name])
    target = p.pop("target", None)
    cam = Camera(**p)
    if target is not None:
        cam.set_target(target)
    aw, flip, (S, A, B), eyes, window, crop = js._sweep_geometry(
        vol, g.origin, g.voxel_size, cam.get_pos(), cam.get_view())
    scal = js._frame_scalars_np(
        *eyes[:3], eyes[3], *window, 45.0, W / H, float(g.voxel_size), S,
        np.asarray(g.origin, np.float32), cam.get_pos(), cam.get_view(),
        tuple(-c for c in TO_LIGHT), (1.0, 0.8, 0.6), (0.1, 0.1, 0.1))
    vb = js._layout_volume(vol, aw, flip, S, A, B, crop)
    shv = js._relayout_sweep(sv, aw, flip, vb.shape[0], A, B, crop, S) \
        if with_shadow else None
    packed = np.array(js._sweep_all(
        vb, jnp.asarray(scal), vb.shape[0] // 32, S, A, B, INTER, INTER,
        bool(flip), shadow_sw=shv)).reshape(INTER, INTER)
    return packed, scal, aw


@pytest.mark.parametrize("name", list(POSES))
def test_frame_scalars(scene, name):
    _, scal, aw = _frame_inputs(scene, name)
    kj = np.asarray(jw.frame_scalars_kernel(jnp.asarray(scal), aw))
    kt = tw.frame_scalars(scal)
    assert kt.dtype == np.float32 and kt.shape == (35,)
    # f32 tan and f32 inverses from two libraries: ulp-scale apart; the
    # absolute 1e-7 covers rotation entries that are 0 in exact arithmetic
    np.testing.assert_allclose(kt, kj, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_shadow", [True, False])
@pytest.mark.parametrize("name", list(POSES))
def test_reference_matches_pallas_kernel(scene, name, with_shadow):
    packed, scal, aw = _frame_inputs(scene, name, with_shadow)
    kj = jw.frame_scalars_kernel(jnp.asarray(scal), aw)
    t_hl = jw.split_hi_lo(jnp.asarray(packed))
    out_j = np.asarray(jw.warp_frame(t_hl, kj, 32, 128, 256, aw, W, H,
                                     with_shadow))[:H, :W]
    out_t = tw.warp_frame_reference(torch.from_numpy(packed),
                                    tw.frame_scalars(scal), aw, W, H,
                                    with_shadow)
    assert out_t.dtype == torch.int32 and out_t.shape == (H, W)
    rgb_j = np.asarray(jw.unpack_frame_rgb(jnp.asarray(out_j), W, H))
    rgb_t = tw.unpack_frame_rgb(out_t, W, H).numpy()
    close = np.abs(rgb_t - rgb_j).max(-1) <= 1.5 / 255.0
    assert close.mean() > 0.995, f"pixel agreement {close.mean():.4f}"
    assert (out_t.numpy() != 0).any()


@pytest.mark.parametrize("with_shadow", [True, False])
@pytest.mark.parametrize("name", list(POSES))
def test_early_exits_exact_on_pallas_kernel(scene, name, with_shadow):
    """The CUDA kernel stops after the texel for a miss (packs 0) and, with
    shadows on, for a shadowed hit (packs ``ambient_word``). Both hold on
    the JAX kernel's own output, and on the plain version's: they are
    selects, whatever the shading would give."""
    packed, scal, aw = _frame_inputs(scene, name, with_shadow)
    kj = jw.frame_scalars_kernel(jnp.asarray(scal), aw)
    out_j = np.asarray(jw.warp_frame(jw.split_hi_lo(jnp.asarray(packed)), kj,
                                     32, 128, 256, aw, W, H,
                                     with_shadow))[:H, :W]
    table = torch.from_numpy(packed)
    ks = tw.frame_scalars(scal)
    _, _, _, invalid, iu, iv = tw._texels(
        INTER, INTER, tw._check(table, ks, aw, W, H), aw, W, H, "cpu")
    val = torch.where(invalid, -1.0, table[iu.long(), iv.long()]).numpy()
    miss = val < 0
    shadowed = (val >= 2048) if with_shadow else np.zeros_like(miss)
    out_t = tw.warp_frame_reference(table, ks, aw, W, H, with_shadow).numpy()
    word = tw.ambient_word(ks)
    assert word == (26 << 16) | (26 << 8) | 26     # ambient 0.1
    for out in (out_j, out_t):
        assert (out[miss] == 0).all()
        assert (out[shadowed] == word).all()
    if name == "interior":    # inside the sphere: every ray hits a shell
        assert not miss.any() and (shadowed.all() or not with_shadow)
    else:
        assert miss.any() and (~miss & ~shadowed).any()
        assert shadowed.any() or not with_shadow


@pytest.mark.parametrize("ambient", [(0.1, 0.1, 0.1), (0.0, 0.5, 1.0),
                                     (-0.2, 1.3, 0.2549019753932953)])
def test_ambient_word_matches_plain_rounding(ambient):
    """The host's packed ambient word equals the plain version's f32
    ``clamp(c * 255 + 0.5, 0, 255)`` and truncation, clamps included."""
    ks = np.zeros(35, np.float32)
    ks[23:26] = ambient
    col = torch.tensor(ks[23:26])
    q = torch.clamp(col * 255.0 + 0.5, 0.0, 255.0).to(torch.int32).tolist()
    assert tw.ambient_word(ks) == (q[0] << 16) | (q[1] << 8) | q[2]


def _vox_numerators(packed, scal, aw):
    """Every f32 numerator the kernel divides by vox on a frame: d_s, d_a
    and d_b of each pixel's ray, and pin_c - org_c of each hit (the plain
    version's own arithmetic)."""
    table = torch.from_numpy(packed)
    ks = tw._check(table, tw.frame_scalars(scal), aw, W, H)
    k, d3, behind, invalid, iu, iv = tw._texels(INTER, INTER, ks, aw, W, H,
                                                "cpu")
    val = torch.where(invalid, -1.0, table[iu.long(), iv.long()])
    hit = (val >= 0) & ~behind
    vox, eye_s = k[tw._KS_VOX], k[tw._KS_EYE_S]
    z_f = torch.clamp(val - torch.where(val >= 2048.0, 2048.0, 0.0), min=0.0)
    d_len = torch.sqrt(d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2])
    d_s = d3[tw._SAB_IDX[aw][0]]
    t_w = torch.where(hit, (z_f - eye_s) * vox * d_len / d_s, 0.0)
    nums = list(d3)
    for c in range(3):
        dir_c = d3[c] / d_len
        p_c = k[tw._KS_CAM + c] + dir_c * t_w
        nums.append(((p_c + dir_c * (0.25 * vox)) - k[tw._KS_ORG + c])[hit])
    return float(vox), np.concatenate([n.reshape(-1).numpy() for n in nums])


@pytest.mark.parametrize("name", list(POSES))
def test_vox_reciprocal_divisions_exact(scene, name):
    """The kernel multiplies by vox_reciprocal(vox) where it is exact (vox a
    power of two, as here: 1/32): every division by vox of the frame, in
    f32, equals that product bit for bit."""
    packed, scal, aw = _frame_inputs(scene, name)
    vox, nums = _vox_numerators(packed, scal, aw)
    r = tw.vox_reciprocal(vox)
    assert r == 32.0 and nums.dtype == np.float32 and nums.size > 3 * W * H
    quo = nums / np.float32(vox)
    prod = nums * np.float32(r)
    assert np.array_equal(quo.view(np.int32), prod.view(np.int32))


def test_vox_reciprocal_only_where_exact():
    """Powers of two (normal or not, with a finite reciprocal) get theirs;
    on random f32 bit patterns, subnormals and infinities included, the
    product equals the quotient bitwise. Anything else gets 0."""
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2 ** 31 - 1, 200_000, dtype=np.int64)
    x = bits.astype(np.uint32).view(np.float32)
    x = np.concatenate([x, -x, np.float32([0.0, -0.0, np.inf, -np.inf])])
    x = x[~np.isnan(x)]
    with np.errstate(over="ignore", under="ignore"):
        for e in (-8, -5, 0, 3, 20, -127, 126):
            v = np.float32(2.0) ** np.float32(e)
            r = tw.vox_reciprocal(v)
            assert r != 0.0 and float(r) * float(v) == 1.0
            assert np.array_equal((x / v).view(np.int32),
                                  (x * np.float32(r)).view(np.int32))
    for v in (1 / 255, 0.1, 3.0, 0.0, np.inf, np.nan, 2.0 ** -140):
        assert tw.vox_reciprocal(v) == 0.0


def test_cpu_wrapper_runs_reference_without_counting(scene):
    packed, scal, aw = _frame_inputs(scene, "exterior")
    table = torch.from_numpy(packed)
    ks = tw.frame_scalars(scal)
    before = tw.warp_frame.launches
    out = tw.warp_frame(table, ks, aw, W, H, True)
    assert tw.warp_frame.launches == before
    assert torch.equal(out, tw.warp_frame_reference(table, ks, aw, W, H, True))


def test_unpack_matches_reference():
    rng = np.random.default_rng(11)
    packed = rng.integers(0, 1 << 24, size=(9, 13), dtype=np.int32)
    j = np.asarray(jw.unpack_frame_rgb(jnp.asarray(packed), 11, 7))
    t = tw.unpack_frame_rgb(torch.from_numpy(packed), 11, 7).numpy()
    assert np.array_equal(j, t)


def _good_args():
    table = torch.full((256, 256), -1.0)
    ks = np.zeros(35, np.float32)
    ks[10] = 1.0
    return table, ks


@pytest.mark.parametrize("bad", [
    "dtype", "ndim", "contiguous", "kscal_count", "kscal_dtype", "axis",
    "size",
])
def test_wrapper_rejects_bad_arguments(bad):
    table, ks = _good_args()
    aw, w, h = 0, 8, 8
    if bad == "dtype":
        table = table.to(torch.bfloat16)
    elif bad == "ndim":
        table = table.reshape(-1)
    elif bad == "contiguous":
        table = torch.full((256, 512), -1.0)[:, ::2]
    elif bad == "kscal_count":
        ks = np.zeros(34, np.float32)
    elif bad == "kscal_dtype":
        ks = np.zeros(35, np.float64)
    elif bad == "axis":
        aw = 3
    elif bad == "size":
        w = 0
    with pytest.raises((TypeError, ValueError)):
        tw.warp_frame(table, ks, aw, w, h, True)
    with pytest.raises((TypeError, ValueError)):
        tw.warp_frame_reference(table, ks, aw, w, h, True)
