"""Multi-process start-up on ``torch.distributed``.

Counterpart of ``ray_tracing_octrees_tpu/parallel/distributed.py``. The
reference is a single-process GL program; the scale-out runs one process
per card (SPMD ranks in place of a JAX device mesh). After
:func:`initialize_distributed` the meshes of
:mod:`ray_tracing_octrees_tpu_torch.parallel.mesh` lay ``dp`` / ``tp``
over the ranks, and the collectives of
:mod:`ray_tracing_octrees_tpu_torch.parallel.sharding` run on the process
group's backend: NCCL between cards, gloo on the CPU.

Usage (one call per process, before any collective):

    from ray_tracing_octrees_tpu_torch.parallel import initialize_distributed
    initialize_distributed()                               # torchrun's env
    initialize_distributed("host0:1234", 4, 1)             # explicit
    initialize_distributed("file:///tmp/rto", 8, r, device="cpu")  # gloo
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ray_tracing_octrees_tpu_torch._device import DeviceLike, resolve_device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> bool:
    """``torch.distributed.init_process_group`` from the call or the
    environment.

    The arguments come from the call, else from the JAX package's
    variables ``RTO_TPU_COORDINATOR`` / ``RTO_TPU_NUM_PROCS`` /
    ``RTO_TPU_PROC_ID`` (the names are kept, so one launch script drives
    both packages). The counterpart of the TPU pod's auto-detection is a
    launcher's environment: with ``MASTER_ADDR`` and ``WORLD_SIZE`` set
    (``torchrun``) the group starts from ``env://``. A coordinator
    ``host:port`` becomes ``tcp://host:port``; one with a scheme
    (``tcp://``, ``file://``) is used as it is.

    The backend is NCCL on CUDA (the default device) and gloo when the
    caller passes ``device="cpu"``. On CUDA the process takes card
    ``LOCAL_RANK`` (else its rank modulo the cards' count) as its current
    device. Without CUDA and without ``device="cpu"`` this raises.

    Returns True when it started a multi-process group, False when no
    coordinator is configured or a group already exists (nothing is
    started; callers need no code change either way, as the reference
    runs single-process).
    """
    dev = resolve_device(device)
    coordinator_address = coordinator_address or os.environ.get(
        "RTO_TPU_COORDINATOR")
    if num_processes is None and "RTO_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["RTO_TPU_NUM_PROCS"])
    if process_id is None and "RTO_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["RTO_TPU_PROC_ID"])
    launched = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if (coordinator_address is None and not launched) or dist.is_initialized():
        return False
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    if dev.type == "cuda":
        rank = process_id if process_id is not None else int(
            os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, **kw)
    return True


def local_slice(array_len: int) -> slice:
    """The contiguous [start, stop) this process owns of a globally even
    partition: the per-rank analog of the reference's partial Z-slab
    cache loads (CacheUtils.cpp:62-111). One process (no group) owns all
    of it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = (array_len + n - 1) // n
    return slice(i * per, min(array_len, (i + 1) * per))
