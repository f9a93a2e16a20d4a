"""Entry points of the port: a one-device render step and a multi-device
dry run.

Counterpart of ``__graft_entry__.py`` at the repository root (the JAX
package's, which stays as it is):

- :func:`entry` returns ``(fn, example_args)``: ``fn`` is the flagship
  render step, :func:`render_octree_image` (rays, stackless pyramid
  traversal, Lambert + shadow shading, an RGBA frame) at 256x256 on the
  64^3 sphere, its arguments on the device;
- :func:`dryrun_multichip` runs the JAX dry run's body on an n-rank
  process group, one spawned process a rank: ``make_mesh(n)``,
  :func:`render_image_sharded` and :func:`trace_shardmap` on the 16^3
  sphere at 16x16 against the one-device :func:`render_octree_image`,
  then the slab-segmented fast and volume frames on an ``("sp",)`` mesh
  against :func:`render_fast_frame` (``fused=False``) and
  :func:`render_volume_frame`, each within the JAX dry run's
  ``atol = rtol = 1e-5``. A rank raises on a mismatch, and the call
  raises if any rank failed.

Backends: NCCL on CUDA when n is at most the card count (one rank a
card); gloo ranks sharing the cards otherwise (rank r on card r modulo
the count); gloo on the CPU with ``device="cpu"``. The JAX dry run pins
the CPU with n virtual devices because of a runtime mismatch on its TPU
host; nothing here needs that.

    python -m ray_tracing_octrees_tpu_torch.graft_entry

runs :func:`entry`'s step, then :func:`dryrun_multichip` over every card.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Tuple

import torch

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device

TOL = 1e-5   # the JAX dry run's atol and rtol
# the row kernels whose launches each dry-run rank reports
ROW_KERNELS = ("warp_frame", "warp_lookup", "warp_lookup_multi")


def entry(device: DeviceLike = None) -> Tuple[Callable, tuple]:
    """(fn, example_args): the render step on the flagship model, the
    octree ray tracer, on ``device`` (CUDA unless ``device="cpu"``).
    ``fn(pyr, origin, vsize, cam_pos, view)`` returns f32[256, 256, 4]."""
    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        render_octree_image,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import Camera

    dev = resolve_device(device)
    grid = make_sphere_grid(64, device=dev)
    pyramid = build_pyramid(grid.occ)
    cam = Camera(theta=0.4, phi=0.9, radius=2.0)
    width = height = 256

    def fn(pyr, origin, vsize, cam_pos, view):
        return render_octree_image(
            pyr, origin, vsize, cam_pos, view, width, height, 45.0, 1.0,
            shadows=True, device=dev)

    example_args = (
        pyramid,
        grid.origin,
        grid.voxel_size,
        torch.as_tensor(cam.get_pos(), dtype=torch.float32, device=dev),
        torch.as_tensor(cam.get_view(), dtype=torch.float32, device=dev),
    )
    return fn, example_args


def _backend(dev: torch.device, n: int) -> str:
    """NCCL for one rank a card, gloo otherwise (see the module)."""
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _require_close(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.allclose(got, want, atol=TOL,
                                                     rtol=TOL):
        err = (float((got - want).abs().max())
               if got.shape == want.shape else None)
        raise AssertionError(f"{name}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, max abs err {err}")


def _dryrun_rank(rank: int, n: int, device_type: str, backend: str,
                 store: str, out_dir: str) -> None:
    """One rank of :func:`dryrun_multichip`: the JAX dry run's body, each
    result checked; writes its row kernels' launches to
    ``rank<r>.json``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tracing_octrees_tpu_torch.core.grid import make_sphere_grid
    from ray_tracing_octrees_tpu_torch.core.octree import build_pyramid
    from ray_tracing_octrees_tpu_torch.models.octree_raytracer import (
        render_octree_image,
    )
    from ray_tracing_octrees_tpu_torch.models.volume_raycaster import (
        VolumeRaycastRenderer,
    )
    from ray_tracing_octrees_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from ray_tracing_octrees_tpu_torch.parallel.mesh import make_mesh
    from ray_tracing_octrees_tpu_torch.parallel.sharding import (
        render_image_sharded, sweep_frame_segmented, trace_shardmap,
        volume_frame_segmented,
    )
    from ray_tracing_octrees_tpu_torch.render.camera import (
        Camera, generate_rays,
    )
    from ray_tracing_octrees_tpu_torch.trace import warp_kernel
    from ray_tracing_octrees_tpu_torch.trace.raymarch_sweep import (
        prepare_volume_scene, render_volume_frame,
    )
    from ray_tracing_octrees_tpu_torch.trace.slab_sweep import (
        render_fast_frame, shadow_volume,
    )

    torch.set_num_threads(1)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if backend == "nccl" or dev.type == "cpu":
        initialize_distributed(store, n, rank, device=dev)
    else:
        # gloo ranks sharing a card: initialize_distributed starts NCCL
        dist.init_process_group("gloo", init_method=store, world_size=n,
                                rank=rank)
    try:
        grid = make_sphere_grid(16, device=dev)
        mesh = make_mesh(n, device=dev)
        cam = Camera(theta=0.3, phi=0.5, radius=2.0)
        width = height = 16
        pos, view = cam.get_pos(), cam.get_view()
        origins, dirs = generate_rays(width, height, pos, view, 45.0, 1.0,
                                      device=dev)

        img = render_image_sharded(
            mesh, grid.occ, origins, dirs, grid.origin, grid.voxel_size,
            max_steps=64, shadows=True)
        if tuple(img.shape) != (width * height, 4):
            raise AssertionError(f"render_image_sharded: {tuple(img.shape)}")
        res = trace_shardmap(mesh, grid.occ, origins, dirs, grid.origin,
                             grid.voxel_size, max_steps=64)
        if res["hit"].shape[0] < width * height:
            raise AssertionError(f"trace_shardmap: {res['hit'].shape[0]} "
                                 f"rays")

        # cross-check: the sharded step against the one-device render
        ref = render_octree_image(
            build_pyramid(grid.occ), grid.origin, grid.voxel_size, pos, view,
            width, height, 45.0, 1.0, max_steps=64, shadows=True,
            device=dev).reshape(-1, 4)
        _require_close("render_image_sharded", img, ref)

        # the production fast frame, slab-segmented over an "sp" axis
        vol = (grid.occ > 0).to(torch.float32)
        sv = shadow_volume(vol, (-1.0, -1.0, -1.0), device=dev)
        smesh = init_device_mesh(dev.type, (n,), mesh_dim_names=("sp",))
        fast = sweep_frame_segmented(
            smesh, vol, sv, grid.origin, grid.voxel_size, pos, view, 45.0,
            1.0, width, height)
        ref_fast = render_fast_frame(
            vol, sv, grid.origin, grid.voxel_size, pos, view, 45.0, 1.0,
            width, height, device=dev, fused=False)
        _require_close("sweep_frame_segmented", fast, ref_fast)

        # the slab-segmented VOLUME_RAYCAST fast frame
        rr = VolumeRaycastRenderer(device=dev).init(grid)
        vscene = prepare_volume_scene(rr.textures, float(grid.voxel_size),
                                      device=dev)
        vref = render_volume_frame(vscene, grid.origin, pos, view, 45.0, 1.0,
                                   width, height, device=dev)
        vout = volume_frame_segmented(smesh, vscene, grid.origin, pos, view,
                                      45.0, 1.0, width, height)
        _require_close("volume_frame_segmented", vout["color"],
                       vref["color"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({k: getattr(warp_kernel, k).launches
                       for k in ROW_KERNELS}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> dict:
    """The full multi-device render step over an n-rank group on tiny
    shapes (see the module): ``n_devices`` processes are spawned, each a
    rank, on CUDA unless ``device="cpu"``. Raises if any rank failed.
    Returns dict(n, backend, device, launches: each rank's launches of
    the row kernels)."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices} < 1")
    backend = _backend(dev, n_devices)
    with tempfile.TemporaryDirectory(prefix="rto_dryrun_") as tmp:
        mp.start_processes(
            _dryrun_rank,
            args=(n_devices, dev.type, backend, f"file://{tmp}/store", tmp),
            nprocs=n_devices, join=True, start_method="spawn")
        launches = []
        for r in range(n_devices):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                launches.append(json.load(f))
    return dict(n=n_devices, backend=backend, device=dev.type,
                launches=launches)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok", tuple(out.shape))
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok")
