"""Slot clearing for the resident KV cache.

The counterpart of ``repro.serving.kvpool.clear_slots``; the pool and its
continuous-batching bookkeeping belong to a later part of the port.
"""

from __future__ import annotations

import torch


def clear_slots(cache, slot_mask: torch.Tensor, batch: int):
    """Clear masked slots, in place, in every cache tensor whose leading
    axis is the batch (the port keeps one cache dict per layer, so the
    reference's stacked axis 1 is axis 0 here).

    Float state is zeroed, while integer tensors -- the per-slot absolute
    positions -- are set to **-1**, because ``pos = 0`` is a valid position
    under the masking rule ``valid(k) = pos[k] >= 0``: zeroing them would leave
    the stale key at slot 0 attendable by the next request.
    """
    if isinstance(cache, dict):
        for leaf in cache.values():
            clear_slots(leaf, slot_mask, batch)
    elif isinstance(cache, (list, tuple)):
        for leaf in cache:
            clear_slots(leaf, slot_mask, batch)
    elif isinstance(cache, torch.Tensor) and cache.ndim >= 1 and cache.shape[0] == batch:
        m = slot_mask.to(device=cache.device, dtype=torch.bool)
        m = m.reshape((batch,) + (1,) * (cache.ndim - 1))
        cache.masked_fill_(m, -1 if not cache.is_floating_point() else 0)
    return cache
