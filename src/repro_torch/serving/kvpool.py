"""Slot-pooled KV cache for continuous batching.

The counterpart of ``repro.serving.kvpool``: the fp pool and the kv8 pool
(int8 values with fp32 scales per slot and head).  The pool owns one
batched decode cache (``model.init_cache(n_slots, ...)``) whose batch axis
is a pool of *slots*; each slot holds at most one in-flight request.  The
layout invariants it relies on:

  * the port keeps one cache dict per layer, each tensor with the slot on
    axis 0 (the reference stacks layers, with the slot on axis 1), so writing
    one slot is one in-place copy into ``tensor[slot]`` per cache tensor;
  * the caches' per-slot absolute-position arrays (``pos``, the only integer
    tensors) drive the attention masking rule ``valid(k) = pos[k] >= 0``.  A
    free slot is ``pos = -1`` everywhere, which makes its old keys
    unreachable the moment the slot is released -- freeing is a masking
    operation, not (only) a zeroing one.

Host-side, ``positions[slot]`` mirrors the device state: the next absolute
position the slot will write (prompt length right after admission, +1 per
decoded token), or -1 while free.  That vector, as ``pos_vector()``, is
exactly the per-slot position argument of the vector-``pos`` decode step.

The decode step updates the resident cache in place (the reference donates
it and rebinds the result), and ``gather_slot`` returns a copy, so a slot's
working cache is never a view a later step could change.

Chunked prefill round-trips a slot through ``gather_slot`` and
``write_slot`` (``next_pos=None`` mid-prefill): the chunk's K/V rows land in
the pool at their absolute offsets while ``positions[slot]`` stays -1, so a
partially prefilled slot is invisible to decode steps under the same
masking rule that protects freed slots.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.obs import profile as _obs_profile

# ---------------------------------------------------------------------------
# Quantized pool storage (kv8).
#
# With ``quantize_kv_cache`` the pool's *resident* form is int8 values plus
# fp32 scales per (layer, slot, head); the fp tree the engine's decode step
# consumes is made on access and re-quantized on assignment, so the
# scheduler drives the same ``pool.cache`` interface either way.  Scales are
# symmetric absmax over each slot's sequence and head-dim axes.  Freeing a
# slot zeroes its floats, so a freed slot quantizes to exact zeros and stays
# unreachable behind the same ``pos = -1`` mask that protects the fp pool.
# ---------------------------------------------------------------------------

_KV_QMAX = 127.0
# The reference's jitted ``absmax / 127`` compiles to a multiply by the fp32
# reciprocal (XLA folds division by a constant), so the port multiplies too:
# its scales are the reference's bit for bit.
_KV_INV_QMAX = float(np.float32(1.0) / np.float32(_KV_QMAX))
_KV_KEYS = frozenset({"qv", "qs"})


def _kv_quantizable(leaf: torch.Tensor) -> bool:
    """Float cache state with a slot axis (attention K/V).  Integer tensors
    are the ``pos`` masks and always stay exact."""
    return leaf.is_floating_point() and leaf.ndim >= 2


def _kv_scale_axes(leaf: torch.Tensor) -> tuple[int, ...]:
    """Reduce absmax over everything except the slot (0) and, for (B, S, H,
    hd) attention caches, the head axis (2): the per-head-per-slot scale.
    The reference stacks layers on axis 0 and keeps (0, 1, 3) of its
    (L, B, S, H, hd) leaves -- the same numbers, one layer at a time."""
    keep = {0} | ({2} if leaf.ndim >= 4 else set())
    return tuple(i for i in range(leaf.ndim) if i not in keep)


def _is_qleaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == _KV_KEYS


def quantize_kv(cache: Any) -> Any:
    """fp cache tree -> quantized pool form: each float tensor becomes
    {"qv": int8, "qs": fp32}; integer tensors are kept (not copied)."""
    if isinstance(cache, dict):
        return {k: quantize_kv(v) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(quantize_kv(v) for v in cache)
    if not _kv_quantizable(cache):
        return cache
    x = cache.float()
    absmax = x.abs().amax(dim=_kv_scale_axes(cache), keepdim=True)
    qs = torch.where(absmax > 0, absmax * _KV_INV_QMAX, 1.0)
    qv = torch.round(x / qs).clamp_(-_KV_QMAX, _KV_QMAX).to(torch.int8)  # round half to even, as jnp.round
    return {"qv": qv, "qs": qs}


def dequantize_kv(qcache: Any, dtype: torch.dtype) -> Any:
    """Quantized pool form -> a fresh fp cache tree at ``dtype`` (integer
    tensors are cloned, so writes into the tree never reach the pool)."""
    if _is_qleaf(qcache):
        return (qcache["qv"].float() * qcache["qs"]).to(dtype)
    if isinstance(qcache, dict):
        return {k: dequantize_kv(v, dtype) for k, v in qcache.items()}
    if isinstance(qcache, (list, tuple)):
        return type(qcache)(dequantize_kv(v, dtype) for v in qcache)
    return qcache.clone()


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


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


def check_next_pos(next_pos: Any) -> int | None:
    """Validate a ``write_slot`` position against the validity-mask contract.

    The whole masking rule is ``valid(k) = pos[k] >= 0`` with -1 the one
    freed/empty sentinel, so any position below -1 (or a NaN/non-integral
    value smuggled in through a float) would create a slot state no reader
    is specified for.  Rejecting it here -- before the cache scatter --
    keeps a bad caller from mutating the pool and *then* failing.
    """
    if next_pos is None:
        return None
    f = float(next_pos)
    if f != f or f != int(f):  # NaN or non-integral
        raise ValueError(f"write_slot: next_pos must be an integer, got {next_pos!r}")
    p = int(f)
    if p < -1:
        raise ValueError(f"write_slot: next_pos must be >= -1 (-1 = empty sentinel), got {p}")
    return p


def _scatter_slot(pool: Any, one: Any, slot: int) -> Any:
    """Copy a batch-1 cache tree into slot ``slot`` of the pooled cache, in
    place (cast to the pool's dtypes); returns the pool."""
    if isinstance(pool, dict):
        for k, v in pool.items():
            _scatter_slot(v, one[k], slot)
    elif isinstance(pool, (list, tuple)):
        for p, o in zip(pool, one, strict=True):
            _scatter_slot(p, o, slot)
    else:
        pool[slot].copy_(one[0])
    return pool


def _gather_slot(pool: Any, slot: int) -> Any:
    """Batch-1 **copy** of slot ``slot`` of the pooled cache: the pool stays
    live, and a later decode step or ``write_slot`` changes the pool, never
    the copy."""
    if isinstance(pool, dict):
        return {k: _gather_slot(v, slot) for k, v in pool.items()}
    if isinstance(pool, (list, tuple)):
        return type(pool)(_gather_slot(v, slot) for v in pool)
    return pool[slot : slot + 1].clone()


class KVPool:
    """Fixed-size pool of KV cache slots shared by in-flight requests.

    ``device`` defaults to the card.  ``quantize_kv_cache=True`` keeps the
    resident pool in int8 with fp32 scales per head per slot (kv8): the
    ``cache`` property dequantizes on read and re-quantizes on assignment, so
    every consumer -- decode steps, slot gather/scatter, slot clearing --
    sees the usual fp tree while the pool holds about half the bytes of the
    bf16 form.  Only float tensors quantize; the integer ``pos`` masks stay
    exact.  An in-place write into the tree ``cache`` returns lands in that
    fresh copy, so every writer assigns the tree back (``pool.cache = ...``).
    """

    def __init__(self, model, n_slots: int, max_len: int, quantize_kv_cache: bool = False,
                 device: str | torch.device | None = None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.dtype = getattr(torch, model.cfg.dtype)
        self.quantize_kv = quantize_kv_cache
        self._qcache = None
        self._cache = None
        self.cache = model.init_cache(n_slots, max_len, self.dtype, self.device)
        self.positions = np.full((n_slots,), -1, np.int64)
        # LIFO free list: the most recently freed slot is reused first, which
        # keeps the active slots dense in low indices under light load.
        self._free = list(range(n_slots - 1, -1, -1))

    # -- resident storage ------------------------------------------------------

    @property
    def cache(self) -> Any:
        if self.quantize_kv:
            return _obs_profile.sample_call("kv.gather", lambda: dequantize_kv(self._qcache, self.dtype),
                                            pool="stripe", path="cache")
        return self._cache

    @cache.setter
    def cache(self, new: Any) -> None:
        if self.quantize_kv:
            self._qcache = _obs_profile.sample_call("kv.scatter", lambda: quantize_kv(new), pool="stripe",
                                                    path="cache")
        else:
            self._cache = new

    def _resident(self) -> Any:
        return self._qcache if self.quantize_kv else self._cache

    # -- bookkeeping -----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    def occupancy(self) -> float:
        return self.n_active / self.n_slots

    def bytes_resident(self) -> int:
        """Device bytes held by the pool's *resident* cache form: under kv8
        the int8 values, their fp32 scales and the int32 positions;
        otherwise the fp tree.  The pool is preallocated, so this is
        constant for its life: n_slots * max_len worth of state regardless
        of how many slots are live."""
        return _nbytes(self._resident())

    def bytes_report(self) -> dict:
        """{"reserved": preallocated bytes (== ``bytes_resident``), "live":
        bytes actually valid under the pos mask}.

        ``live`` counts, per slot, ``min(pos, seq_capacity)`` rows of every
        pos-masked attention cache (a slot with host ``pos = -1`` counts 0)
        and the full per-slot block of any maskless state.
        """
        pos = np.maximum(self.positions, 0)
        active_frac = self.n_active / self.n_slots
        live = 0.0

        def walk(node) -> None:
            nonlocal live
            if isinstance(node, dict) and "pos" in node and not isinstance(node["pos"], dict):
                cap = node["pos"].shape[1]  # (slots, seq); the reference's stacked (L, slots, seq) has it at 2
                frac = float(np.sum(np.minimum(pos, cap))) / float(cap * self.n_slots)
                live += _nbytes(node) * frac
            elif isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
            else:
                live += _nbytes(node) * active_frac

        walk(self._resident())
        return {"reserved": self.bytes_resident(), "live": int(round(live))}

    # -- slot lifecycle --------------------------------------------------------

    def alloc(self) -> int | None:
        """Claim a free slot (or None).  The slot stays masked (pos = -1)
        until ``write_prefill`` lands a request in it."""
        if not self._free:
            return None
        return self._free.pop()

    def free(self, slot: int) -> None:
        """Release a slot: mark every position -1 (old keys become
        unreachable under the masking rule) and zero the float state."""
        if slot in self._free or not 0 <= slot < self.n_slots:
            raise ValueError(f"free of invalid/already-free slot {slot}")
        self.positions[slot] = -1
        self.cache = clear_slots(self.cache, torch.arange(self.n_slots) == slot, self.n_slots)
        self._free.append(slot)

    def write_prefill(self, slot: int, cache_one: Any, n_tokens: int) -> None:
        """Scatter a batch-1 primed cache (from ``model.prefill`` at this
        pool's max_len) into ``slot``; its next write position becomes
        ``n_tokens`` (the prompt length)."""
        self.write_slot(slot, cache_one, next_pos=n_tokens)

    def gather_slot(self, slot: int) -> Any:
        """Batch-1 copy of ``slot``."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"gather of invalid slot {slot}")
        return _obs_profile.sample_call("kv.gather", lambda: _gather_slot(self.cache, slot),
                                        pool="stripe", path="slot")

    def write_slot(self, slot: int, cache_one: Any, next_pos: int | None) -> None:
        """Scatter a batch-1 cache back into ``slot``.

        ``next_pos`` set marks the slot live at that absolute position (end
        of prefill: the prompt length).  ``next_pos=None`` keeps the
        host-side position at -1: the rows are in the pool, but the decode
        step still sees the slot as empty.
        """
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"write of invalid slot {slot}")
        if any(t.shape[0] != 1 for t in _tensors(cache_one)):
            raise ValueError("write_slot expects a batch-1 cache")
        next_pos = check_next_pos(next_pos)

        def _scatter() -> Any:
            self.cache = _scatter_slot(self.cache, cache_one, slot)
            return self._resident()

        _obs_profile.sample_call("kv.scatter", _scatter, pool="stripe", path="slot")
        if next_pos is not None:
            self.positions[slot] = next_pos

    # -- decode-step interface -------------------------------------------------

    def pos_vector(self) -> torch.Tensor:
        """(n_slots,) int32 per-slot positions on the pool's device, for the
        vector-pos decode."""
        return torch.as_tensor(self.positions, dtype=torch.int32).to(self.device)

    def advance(self, slots) -> None:
        """One token decoded in each of ``slots``."""
        for s in slots:
            self.positions[s] += 1
