"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device (a
CUDA kernel has no CPU mode). The file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import slab_sweep, warp_kernel

pytestmark = pytest.mark.cuda

TO_LIGHT = (0.5, 0.9, 0.4)
W, H = 640, 360
POSES = {
    "exterior": dict(theta=0.9, phi=0.8, radius=0.75),
    "below": dict(theta=-0.9, phi=4.0, radius=2.0),
    "interior": dict(theta=0.05, phi=3.2, radius=0.05,
                     target=np.array([0.0, 0.0, -0.3], np.float32)),
}


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.set_num_threads(2)
    g = make_sphere_grid(64, device="cuda")
    vol = (g.occ > 0).to(torch.float32)
    sv = slab_sweep.shadow_volume(vol, TO_LIGHT, device="cuda")
    return g, vol, sv, slab_sweep.SweepLayouts(vol, sv)


def _camera(name):
    p = dict(POSES[name])
    target = p.pop("target", None)
    cam = Camera(**p)
    if target is not None:
        cam.set_target(target)
    return cam


def _table(scene, name):
    g, vol, sv, lay = scene
    cam = _camera(name)
    return slab_sweep._frame_table(
        vol, sv, g.origin.cpu().numpy(), float(g.voxel_size.cpu()),
        cam.get_pos(), cam.get_view(), 45.0, W / H,
        tuple(-c for c in TO_LIGHT), layouts=lay, device="cuda")


@pytest.mark.parametrize("name", list(POSES))
def test_warp_frame_kernel_matches_plain(scene, name):
    """Bitwise: the kernel and its plain version round every f32 op the
    same way (the kernel is built without FMA contraction)."""
    table, ks, aw, has_sh = _table(scene, name)
    before = warp_kernel.warp_frame.launches
    out = warp_kernel.warp_frame(table, ks, aw, W, H, has_sh)
    assert warp_kernel.warp_frame.launches == before + 1
    ref = warp_kernel.warp_frame_reference(table, ks, aw, W, H, has_sh)
    torch.cuda.synchronize()
    assert out.is_cuda and out.dtype == torch.int32 and out.shape == (H, W)
    assert torch.equal(out, ref)


def test_warp_frame_rejects_bf16_table(scene):
    table, ks, aw, has_sh = _table(scene, "exterior")
    with pytest.raises(TypeError):
        warp_kernel.warp_frame(table.to(torch.bfloat16), ks, aw, W, H, has_sh)


@pytest.mark.parametrize("name", list(POSES))
def test_frame_on_card_matches_cpu(scene, name):
    """The whole frame on the card against the same frame on the CPU: the
    sweep's bf16 products round once after f32 sums on both, so the
    tables agree; the 1.5/255 bar covers the rest."""
    g, vol, sv, lay = scene
    cam = _camera(name)
    args = (g.origin.cpu().numpy(), float(g.voxel_size.cpu()), cam.get_pos(),
            cam.get_view(), 45.0, W / H, W, H)
    kw = dict(light_dir=tuple(-c for c in TO_LIGHT))
    gpu = slab_sweep.render_fast_frame(vol, sv, *args, **kw, layouts=lay,
                                       device="cuda").cpu()
    vol_c, sv_c = vol.cpu(), sv.cpu()
    cpu = slab_sweep.render_fast_frame(vol_c, sv_c, *args, **kw, device="cpu")
    close = (gpu - cpu).abs().amax(-1) <= 1.5 / 255.0
    assert float(close.float().mean()) > 0.995
