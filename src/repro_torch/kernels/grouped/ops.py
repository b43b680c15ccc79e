"""Public wrapper of the grouped (per-expert) GEMM: checks and dispatch.

The counterpart of ``repro.kernels.grouped.ops.grouped_matmul``.  A CPU tensor
goes to the plain version; a CUDA tensor goes to the hand-written kernel,
which masks ragged edges itself, so nothing is padded.  Its tile comes in the
reference's order: an explicit ``plan``, then a tuned plan from the port's
plan cache (backend "cuda-grouped") for the per-expert (C, N, K) problem,
then the kernel's shape rule (``grouped_path``), as
``tune.cache.plan_path`` orders them; a cached path the operands cannot take
gives way to the rule, counted as "tuned_refused" (``kernel.launch_path``,
which settles the launch here, once, on the operands as launched).  Each
call records its launch (``obs.attribution.record_launch``, M = E * C) once
the path is settled and before the CPU branch, so the plain version records
what the kernel would.  The kernel has no backward: on the card it
is refused under grad, never cut from the graph; the plain version is
differentiable by autograd.
"""

from __future__ import annotations

import torch

from repro_torch.core.blocking import BlockPlan
from repro_torch.kernels.grouped import kernel as _kernel
from repro_torch.kernels.grouped.ref import grouped_matmul_ref
from repro_torch.kernels.systolic.ops import DTYPE_NAMES
from repro_torch.obs import attribution as _obs
from repro_torch.obs import metrics as _metrics
from repro_torch.tune import cache as _tune_cache

BACKEND = "cuda-grouped"  # the plan cache's key for K4


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, rows: torch.Tensor | None = None,
                   plan: BlockPlan | None = None) -> torch.Tensor:
    """y[e] = x[e] @ w[e] for all experts e, in x's dtype.

    x: (E, C, K) capacity-dispatched tokens; w: (E, K, N) expert weights;
    rows: None, or (E,) int32 on x's device, each expert's number of leading
    rows of x that can be nonzero (the rest are zero, as the dispatch leaves
    them).  On the card the kernel skips the tiles past it, which gives the
    same result; the plain version computes every row and ignores it.
    ``plan``: run the kernel's tile that its (bc, bn, bk) names.
    """
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"bad grouped shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.shape[2] != w.shape[1]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    e, c, k = x.shape
    n = w.shape[2]
    dtype = DTYPE_NAMES.get(x.dtype, "")
    cpu = x.device.type == "cpu"
    if not cpu and torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the grouped expert matmul (K4) has no backward yet, so MoE training runs on the "
                           "CPU only (its plain version is differentiable)")
    x, w = x.contiguous(), w.contiguous()
    if cpu and plan is not None:
        path, source = None, "explicit"  # the plain version takes any plan: not resolved to a path
    else:
        path, _, source = _tune_cache.plan_path(BACKEND, c, n, k, dtype, plan=plan)
        path, source = _kernel.launch_path(path, source, c, k, n, x.dtype, _kernel.aligned(x, w))
    if _metrics._enabled:
        # M = E * C: the grouped problem's FLOP count is 2 * (E * C) * N * K, as the reference records it
        _obs.record_launch(e * c, n, k, dtype, BACKEND, source)
    if cpu:
        return grouped_matmul_ref(x, w)
    return _kernel.grouped_matmul_call(x, w, rows, path=path, plan_source=source, settled=True)
