"""Port vs JAX reference: the entry points
(``ray_tracing_octrees_tpu_torch/graft_entry.py`` against the repository
root's ``__graft_entry__.py``), on the CPU.

- ``entry(device="cpu")``'s step against ``jax.jit`` of JAX's ``entry()``
  step (the 64^3 sphere at 256x256, shadows): equal hit masks, colours
  within 1e-4 (the bar ``tests/test_torch_dda.py`` holds the port's
  ``render_octree_image`` to against JAX's: the port's rays differ from
  JAX's by an ulp where XLA fuses them, which moves a leaf normal by up to
  ~1e-5).
- ``dryrun_multichip(4, device="cpu")`` runs to its end: four gloo ranks,
  each holding the sharded and segmented frames to the one-device frames
  at the JAX dry run's 1e-5. JAX's ``dryrun_multichip`` is never called
  here (it resets JAX's backends in this process).
- Without CUDA both entry points raise unless given ``device="cpu"``.
"""

import importlib

import numpy as np
import pytest
import torch

from ray_tracing_octrees_tpu_torch import graft_entry

torch.set_num_threads(2)


def _hits(img):
    return np.asarray(img)[..., :3].max(-1) > 0


def test_entry_matches_jax_step():
    import jax

    jfn, jargs = importlib.import_module("__graft_entry__").entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    assert all(t.device.type == "cpu" for t in args[1:])
    got = fn(*args).numpy()
    assert got.shape == want.shape == (256, 256, 4)
    np.testing.assert_array_equal(_hits(got), _hits(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    lit = _hits(want)
    assert lit.any() and not lit.all()
    # shadowed pixels: hits at the ambient colour
    amb = np.all(np.isclose(want[..., :3], 0.1), axis=-1) & lit
    assert amb.any()


def test_dryrun_multichip_on_four_cpu_ranks():
    rec = graft_entry.dryrun_multichip(4, device="cpu")
    assert rec["n"] == 4 and rec["backend"] == "gloo"
    assert rec["device"] == "cpu"
    # the CPU runs the kernels' plain versions: no launch
    assert rec["launches"] == [dict.fromkeys(graft_entry.ROW_KERNELS, 0)] * 4


def test_dryrun_multichip_rejects_no_ranks():
    with pytest.raises(ValueError, match="n_devices=0"):
        graft_entry.dryrun_multichip(0, device="cpu")


def test_entry_points_need_a_device_named():
    """Without CUDA the entry points raise unless the caller names the
    CPU; nothing falls back to it quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(1)
