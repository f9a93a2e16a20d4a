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
