"""Utilization accounting: the GEMM-work totals a timed step divides into.

The part of ``repro.obs.attribution`` that the serving engine and the
scheduler call: ``GemmTotals`` (one step's GEMM work), ``collecting`` (route
recorded GEMMs into a totals object) and ``mfu`` (achieved FLOP/s over the
card's datasheet peak for the dtype, ``core/hw.py``).

Nothing records GEMMs into the totals yet: the reference's ``record_gemm``
is called from its kernel dispatch, and the port's ``core.ops.matmul`` does
not call one.  So every totals object stays at zero flops, and the
scheduler, which records ``serve.decode_mfu`` only when ``flops > 0``,
records none.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

from repro_torch.core import hw

_COLLECT = contextvars.ContextVar("repro_torch_obs_gemm_collect", default=None)


@dataclasses.dataclass
class GemmTotals:
    """Accumulated GEMM work of one step (see module docstring)."""

    flops: float = 0.0
    predicted_s: float = 0.0  # roofline lower bound, summed over GEMMs
    calls: int = 0
    plan_hits: int = 0
    plan_misses: int = 0

    def add(self, flops: float, predicted_s: float, plan_source: str | None) -> None:
        self.flops += flops
        self.predicted_s += predicted_s
        self.calls += 1
        if plan_source == "tuned":
            self.plan_hits += 1
        elif plan_source == "heuristic":
            self.plan_misses += 1


@contextlib.contextmanager
def collecting(totals: GemmTotals):
    """Route GEMMs recorded inside the scope into ``totals``."""
    token = _COLLECT.set(totals)
    try:
        yield
    finally:
        _COLLECT.reset(token)


def mfu(flops: float, seconds: float, dtype=None, gpu: hw.GPU = hw.H100) -> float:
    """Achieved fraction of the card's peak for ``dtype`` operands (default
    bf16, the served dtype)."""
    if seconds <= 0:
        return 0.0
    return (flops / seconds) / gpu.peak_flops(dtype)
