"""Prefix-sum stream compaction: the replacement for push_back / atomicAdd.

Counterpart of ``ray_tracing_octrees_tpu/ops/compaction.py``. Every
dynamically sized emission of the reference (triangle vectors, hermite
buffers, SSBO atomic counters) becomes mask -> inclusive cumsum ->
scatter into a bounded buffer, rows past its capacity dropped (SURVEY.md
§2.8's "atomics -> prefix sums"). The scatter writes every dropped row
into one slot past the end, which is then cut off, so the kept slots are
unique and the result is deterministic; nothing here waits for the
device.
"""

from __future__ import annotations

from typing import Tuple

import torch


def scatter_drop(capacity: int, slots: torch.Tensor, values: torch.Tensor,
                 fill=0) -> torch.Tensor:
    """``out[slots] = values`` into a buffer of ``capacity`` rows (filled
    with ``fill``), rows whose slot is outside [0, capacity) dropped (the
    reference's ``.at[slots].set(values, mode="drop")``)."""
    values = values.reshape((slots.numel(),)
                            + tuple(values.shape[slots.dim():]))
    slots = slots.reshape(-1).long()
    slots = torch.where((slots >= 0) & (slots < capacity), slots, capacity)
    out = torch.full((capacity + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[slots] = values
    return out[:capacity]


def mark_true(flags: torch.Tensor, idx: torch.Tensor,
              on: torch.Tensor) -> None:
    """``flags[idx[on]] = True`` in place, with no host sync (the
    reference's bool ``.at[idx].max(on, mode="drop")``): the rows that are
    off write the spare last slot of ``flags`` (bool[N + 1]), which the
    caller cuts off. ``index_fill_`` takes True as a kernel argument;
    ``flags[i] = True`` on CUDA would copy it from the host and wait."""
    spare = flags.shape[0] - 1
    flags.index_fill_(0, torch.where(on, idx.long(), spare).reshape(-1), True)


def compact_indices(mask: torch.Tensor,
                    capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the true entries of ``mask`` (flattened), packed front
    first: (idx int32[capacity], count int32 0-d tensor). Entries past
    count are 0; entries past capacity drop."""
    m = mask.reshape(-1)
    pos = torch.cumsum(m.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = torch.where(m, pos, capacity)
    idx = torch.arange(m.shape[0], dtype=torch.int32, device=m.device)
    count = torch.clamp(m.sum(dtype=torch.int32), max=capacity)
    return scatter_drop(capacity, slots, idx), count


def compact_rows(data: torch.Tensor, mask: torch.Tensor, capacity: int):
    """Rows of ``data`` where ``mask`` is true, packed front first:
    (rows [capacity, ...], count); rows past count are zero."""
    idx, count = compact_indices(mask, capacity)
    flat = data.reshape((-1,) + tuple(data.shape[mask.dim():]))
    rows = flat[idx.long()]
    valid = torch.arange(capacity, device=data.device) < count
    valid = valid.reshape((capacity,) + (1,) * (rows.dim() - 1))
    return torch.where(valid, rows, torch.zeros((), dtype=rows.dtype,
                                                device=rows.device)), count
