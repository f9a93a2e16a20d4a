"""Port vs JAX reference: the two-stage pipelined fast frames
(``parallel/pipeline.py``).

JAX's ``tests/test_parallel.py::test_pipelined_frames_match_per_frame``
on the port: the 32^3 sphere, three poses at 64x64 with 128^2 tables.
The port's pipelined frames equal its own per-pose
``render_fast_frame(fused=False)`` bit for bit (on the CPU the stages run
on one stream; on the card the two-stream run is held in
``tests/test_torch_cuda.py``). Against JAX's pipelined frames they agree
on every hit, within JAX's atol of 1e-5 on all but a few pixels and
within 1.5/255 on all: the frames' rays differ from JAX's by an ulp (XLA
fuses the ray math and inverts the view inside its program), and the
voxel-centre normal amplifies that where a hit lies near a voxel centre.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ray_tracing_octrees_tpu.core.grid import make_sphere_grid as j_sphere
from ray_tracing_octrees_tpu.parallel.pipeline import (
    render_fast_frames_pipelined as j_pipelined,
)
from ray_tracing_octrees_tpu.trace.slab_sweep import (
    shadow_volume as j_shadow_volume,
)
from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
from ray_tracing_octrees_tpu_torch.parallel import (
    render_fast_frames_pipelined,
)
from ray_tracing_octrees_tpu_torch.render.camera import Camera
from ray_tracing_octrees_tpu_torch.trace import slab_sweep as ss

torch.set_num_threads(2)

W = H = 64
TO_LIGHT = (0.5, 0.9, 0.4)
LIGHT = (-0.5, -0.9, -0.4)
KW = dict(light_dir=LIGHT, inter_h=128, inter_w=128)


def _poses():
    poses = []
    for i in range(3):
        cam = Camera(theta=0.4 + 0.1 * i, phi=0.7, radius=2.0)
        poses.append((cam.get_pos(), cam.get_view()))
    return poses


@pytest.fixture(scope="module")
def scene():
    g = make_sphere_grid(32, device="cpu")
    vol = (g.occ > 0).to(torch.float32)
    sv = ss.shadow_volume(vol, TO_LIGHT, device="cpu")
    return g, vol, sv


@pytest.fixture(scope="module")
def jax_frames():
    g = j_sphere(32)
    vol = (jnp.asarray(g.occ) > 0).astype(jnp.float32)
    sv = j_shadow_volume(vol, TO_LIGHT)
    return [np.asarray(f) for f in j_pipelined(
        vol, sv, g.origin, g.voxel_size, _poses(), 45.0, 1.0, W, H, **KW)]


def _per_pose(g, vol, sv, pose, layouts=None):
    return ss.render_fast_frame(vol, sv, g.origin.numpy(),
                                float(g.voxel_size), *pose, 45.0, 1.0, W, H,
                                layouts=layouts, device="cpu", fused=False,
                                **KW)


def test_pipelined_frames_match_per_frame(scene, jax_frames):
    g, vol, sv = scene
    poses = _poses()
    frames = render_fast_frames_pipelined(
        vol, sv, g.origin, g.voxel_size, poses, 45.0, 1.0, W, H,
        device="cpu", **KW)
    assert len(frames) == 3
    for pose, f, ref in zip(poses, frames, jax_frames):
        assert f.shape == (H, W, 4) and f.dtype == torch.float32
        assert torch.equal(f, _per_pose(g, vol, sv, pose))
        f = f.numpy()
        np.testing.assert_array_equal(f[..., :3].max(-1) > 0,
                                      ref[..., :3].max(-1) > 0)
        d = np.abs(f - ref).max(-1)
        assert (d <= 1e-5).mean() > 0.985
        assert d.max() <= 1.5 / 255.0
        assert (f[..., :3].max(-1) > 0).mean() > 0.1


def test_pipelined_without_shadow(scene):
    g, vol, _ = scene
    poses = _poses()
    frames = render_fast_frames_pipelined(
        vol, None, g.origin, g.voxel_size, poses, 45.0, 1.0, W, H,
        device="cpu", **KW)
    for pose, f in zip(poses, frames):
        assert torch.equal(f, _per_pose(g, vol, None, pose))


def test_pipelined_keeps_layouts(scene):
    """With the scene's layouts the sweep-order copies are made once and
    kept; the frames are the same."""
    g, vol, sv = scene
    lay = ss.SweepLayouts(vol, sv)
    poses = _poses()
    first = render_fast_frames_pipelined(
        vol, sv, g.origin, g.voxel_size, poses, 45.0, 1.0, W, H,
        layouts=lay, device="cpu", **KW)
    kept = dict(lay._cache)
    assert kept
    again = render_fast_frames_pipelined(
        vol, sv, g.origin, g.voxel_size, poses[::-1], 45.0, 1.0, W, H,
        layouts=lay, device="cpu", **KW)
    assert all(lay._cache[k] is v for k, v in kept.items())
    for a, b in zip(first, again[::-1]):
        assert torch.equal(a, b)
    assert render_fast_frames_pipelined(
        vol, sv, g.origin, g.voxel_size, [], 45.0, 1.0, W, H,
        layouts=lay, device="cpu", **KW) == []


def test_pipelined_needs_a_device_named(scene):
    """Without CUDA the entry point raises unless the caller names the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, vol, sv = scene
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_fast_frames_pipelined(vol, sv, g.origin, g.voxel_size,
                                     _poses(), 45.0, 1.0, W, H, **KW)
