"""Utilization accounting: MFU and roofline-model attribution for GEMMs.

The port's copy of ``repro.obs.attribution``.  Every K1, K4 and K5 dispatch
(``kernels/systolic/ops.py``, ``kernels/grouped/ops.py``) records what it
runs -- shape, dtype, backend, where the tile came from -- and timed
windows (decode ticks) divide their measured seconds into the recorded work:

    MFU            = achieved FLOP/s / the card's datasheet peak for the dtype
                     (``core/hw.py``)
    model residual = measured seconds / roofline-predicted seconds

**Eager, not traced.**  The reference records at jax trace time, once per
compiled step, so a ``GemmTotals`` there holds one step's work.  The port
runs eagerly and records on every launch.  A component that owns a step
wraps it in ``collecting(totals)``; the serving engine keeps each totals
object at one call's work by filling it on the first call per shape and
collecting later calls into a scratch object (``serving/engine.py``).  The
registry's ``gemm.calls`` therefore counts executions here, traces in the
reference.

**Host cost.**  Decode launches ~170 K1 calls a step and is host-bound, so a
record is cheap: with telemetry off (``REPRO_OBS=0`` / ``disabled()``) it is
one boolean check; inside a ``collecting`` scope it adds one to a tally keyed
by the problem, and the tally goes into the scope's totals and the
registry's counters once, when the scope exits -- the same counts as one
increment per call.  Outside any scope (training steps, direct model calls)
a record adds one to a process-wide tally, which the default registry
brings in before every read and reset (``metrics.Registry.add_pending``).
A scope's totals are complete when it exits; the registry's counters
whenever they are read.

Counters recorded on the default registry:

  gemm.calls{backend,dtype}    launches (executions, not traces)
  gemm.flops{backend}          2*M*N*K summed over launches
  tune.plan.hit/miss{backend}  whether the plan cache supplied the tile
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import threading

from repro_torch.core import hw
from repro_torch.obs import metrics

# Plan provenance values (the reference's; None = no plan concept).
PLAN_SOURCES = ("tuned", "heuristic", "explicit")

# The port's dispatch sources (``tune.cache.plan_path``, ``kernel.launch_path``)
# as the reference's: the kernel's shape rule is the reference's heuristic,
# and a tuned plan the operands at hand refused ran the rule, so it is a
# miss too.
_SOURCE = {"tuned": "tuned", "heuristic": "heuristic", "explicit": "explicit", None: None,
           "rule": "heuristic", "tuned_refused": "heuristic"}

_COLLECT = contextvars.ContextVar("repro_torch_obs_gemm_collect", default=None)

# Records made outside any scope, keyed as a ``GemmTotals._tally``, not yet
# in the default registry (``_flush_pending``).
_PENDING: dict = {}
_PENDING_LOCK = threading.Lock()


@dataclasses.dataclass
class GemmTotals:
    """Accumulated GEMM work of one step (see module docstring)."""

    flops: float = 0.0
    predicted_s: float = 0.0  # roofline lower bound, summed over GEMMs
    calls: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    # (m, n, k, dtype, backend, plan source as recorded) -> launches recorded
    # in an open scope, not yet added (``collecting``)
    _tally: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def add(self, flops: float, predicted_s: float, plan_source: str | None, count: int = 1) -> None:
        self.flops += flops * count
        self.predicted_s += predicted_s * count
        self.calls += count
        if plan_source == "tuned":
            self.plan_hits += count
        elif plan_source == "heuristic":
            self.plan_misses += count


@contextlib.contextmanager
def collecting(totals: GemmTotals):
    """Route ``record_gemm`` calls inside the scope into ``totals`` (and the
    default registry), both brought up to date when the scope exits."""
    token = _COLLECT.set(totals)
    try:
        yield
    finally:
        _COLLECT.reset(token)
        _flush(totals)


def _flush(totals: GemmTotals) -> None:
    tally, totals._tally = totals._tally, {}
    _add_tally(tally, totals)


def _flush_pending() -> None:
    """Bring the records made outside any scope into the default registry."""
    global _PENDING
    if not _PENDING:
        return
    with _PENDING_LOCK:
        tally, _PENDING = _PENDING, {}
    _add_tally(tally)


def _add_tally(tally: dict, totals: GemmTotals | None = None) -> None:
    """Add a tally's launches to ``totals`` (if given) and the default registry."""
    by_label: dict = {}
    for key, count in tally.items():
        m, n, k, dtype, backend, source = key
        source = _SOURCE[source]
        flops = launch_flops(key)
        if totals is not None:
            totals.add(flops, roofline_seconds(m, n, k, dtype, hw.H100.name), source, count)
        calls, fl, hits, misses = by_label.get((backend, dtype), (0, 0.0, 0, 0))
        by_label[(backend, dtype)] = (calls + count, fl + flops * count, hits + count * (source == "tuned"),
                                      misses + count * (source == "heuristic"))
    for (backend, dtype), counts in by_label.items():
        _count(backend, dtype, *counts)


def launch_flops(key: tuple) -> float:
    """FLOPs of one launch recorded under a tally ``key`` (m, n, k, ...):
    2*M*N*K, what ``gemm.flops`` and the decode MFU count
    (``repro_torch.check.audit`` holds each kernel's record to it)."""
    m, n, k = key[:3]
    return 2.0 * m * n * k


def _inc(name: str, key: tuple, n: float) -> None:
    reg = metrics.get_registry()
    counter = reg._counters.get((name, key))
    if counter is None:
        counter = reg.counter(name, **dict(key))
    counter.inc(n)


def _count(backend: str, dtype: str, calls: int, flops: float, hits: int, misses: int) -> None:
    """Add launches of one (backend, dtype) to the default registry."""
    b = (("backend", backend),)
    _inc("gemm.calls", (("backend", backend), ("dtype", dtype)), calls)
    _inc("gemm.flops", b, flops)
    if hits:
        _inc("tune.plan.hit", b, hits)
    if misses:
        _inc("tune.plan.miss", b, misses)


@functools.lru_cache(maxsize=4096)
def roofline_seconds(m: int, n: int, k: int, dtype: str, chip_name: str = hw.H100.name) -> float:
    """Roofline-predicted seconds for an (M, N, K) GEMM of ``dtype`` operands.

    Uses the BlockPlan the balance equation picks on the card
    (``core.blocking.derive_block_plan``), so the predicted HBM traffic counts
    each block's re-reads, not the ideal single pass; shapes it cannot block
    fall back to the ideal-traffic roofline.  Cached: every scope's exit
    reads it.
    """
    from repro_torch.core.blocking import derive_block_plan

    chip = hw.get_chip(chip_name)
    try:
        plan = derive_block_plan(m, n, k, in_dtype=dtype, chip=chip)
        return max(plan.compute_seconds(chip), plan.memory_seconds(chip))
    except (ValueError, ZeroDivisionError):
        flops = 2.0 * m * n * k
        bytes_ = (m * k + k * n) * hw.dtype_bytes(dtype) + m * n * hw.dtype_bytes(dtype)
        return max(flops / chip.peak_flops(dtype), bytes_ / chip.hbm_bw)


def mfu(flops: float, seconds: float, dtype=None, gpu: hw.GPU = hw.H100) -> float:
    """Achieved fraction of the card's peak for ``dtype`` operands (default
    bf16, the served dtype)."""
    if seconds <= 0:
        return 0.0
    return (flops / seconds) / gpu.peak_flops(dtype)


def record_gemm(m: int, n: int, k: int, *, dtype, backend: str, plan_source: str | None = None) -> None:
    """One GEMM launch.  ``plan_source``: one of ``PLAN_SOURCES``, the
    port's "rule" or "tuned_refused" (both a miss), or None."""
    if not metrics._enabled:
        return
    if plan_source not in _SOURCE:
        raise ValueError(f"plan_source must be one of {PLAN_SOURCES}, 'rule', 'tuned_refused' or None, "
                         f"got {plan_source!r}")
    record_launch(m, n, k, dtype if type(dtype) is str else hw._dtype_name(dtype), backend, plan_source)


def record_launch(m: int, n: int, k: int, dtype: str, backend: str, source: str | None) -> None:
    """``record_gemm`` for the kernel wrappers, which call it where the path
    is settled, with telemetry on, a dtype name and a valid source: one
    increment of the scope's tally, or outside any scope of the process's
    (mapped to the reference's sources when the tally is added)."""
    key = (m, n, k, dtype, backend, source)
    totals = _COLLECT.get()
    if totals is not None:
        tally = totals._tally
        tally[key] = tally.get(key, 0) + 1
        return
    with _PENDING_LOCK:
        _PENDING[key] = _PENDING.get(key, 0) + 1


def plan_hit_rate(backend: str | None = None) -> float:
    """Fraction of plan-consulting launches served from the plan cache (over
    the default registry; 0.0 before any launch)."""
    snap = metrics.get_registry().snapshot()["counters"]

    def total(name: str) -> float:
        if backend is not None:
            return snap.get(f'{name}{{backend="{backend}"}}', 0.0)
        return sum(v for s, v in snap.items() if s.split("{")[0] == name)

    hits, misses = total("tune.plan.hit"), total("tune.plan.miss")
    return hits / (hits + misses) if hits + misses else 0.0


metrics.get_registry().add_pending(_flush_pending)
