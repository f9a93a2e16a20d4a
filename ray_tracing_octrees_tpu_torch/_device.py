"""Device choice shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With ``device=None`` and no CUDA device this raises: the port never
    carries on on the CPU unless the caller asked for it. A CUDA device
    comes back with its index (``cuda`` -> ``cuda:<current>``), so it
    compares equal to a tensor's device.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(a, device: torch.device) -> torch.Tensor:
    """Host array ``a`` on ``device``, without waiting for the device.

    A copy from pageable host memory to CUDA waits for all queued work
    first; a copy from pinned memory is only queued on the current stream
    (the pinned buffer is held until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
