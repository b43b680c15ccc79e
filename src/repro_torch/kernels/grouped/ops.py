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
what the kernel would.

Under grad mode, with an operand that requires grad, ``grouped_matmul``
runs through ``_GroupedMatmul``, whose backward is two more grouped
products of the same dispatch: on the card dX = dY W^T and dW = X^T dY are
K4 launches, on the CPU the plain version, so the CPU tests run the
backward code the card runs.
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
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(x, w, rows, plan)
    return _grouped_matmul(x, w, rows, plan=plan)


def _grouped_matmul(x, w, rows=None, *, plan=None, record=True):
    """The dispatch: the tile's path settled as the card would settle it, the
    launch recorded (``obs.attribution``; ``record=False`` for the
    backward's products, as K1's), then the kernel, or on the CPU the plain
    version."""
    e, c, k = x.shape
    n = w.shape[2]
    dtype = DTYPE_NAMES.get(x.dtype, "")
    cpu = x.device.type == "cpu"
    x, w = x.contiguous(), w.contiguous()
    if cpu and plan is not None:
        path, source = None, "explicit"  # the plain version takes any plan: not resolved to a path
    else:
        path, _, source = _tune_cache.plan_path(BACKEND, c, n, k, dtype, plan=plan)
        path, source = _kernel.launch_path(path, source, c, k, n, x.dtype, _kernel.aligned(x, w))
    if record and _metrics._enabled:
        # M = E * C: the grouped problem's FLOP count is 2 * (E * C) * N * K, as the reference records it
        _obs.record_launch(e * c, n, k, dtype, BACKEND, source)
    if cpu:
        return grouped_matmul_ref(x, w)
    return _kernel.grouped_matmul_call(x, w, rows, path=path, plan_source=source, settled=True)


class _GroupedMatmul(torch.autograd.Function):
    """y[e] = x[e] @ w[e] with an fp32 accumulator, differentiable.  The
    backward's two products run through ``_grouped_matmul`` (K4 on the
    card), each with the operands' common dtype; a cotangent wider than the
    operands widens them, as ``_Matmul``'s does, and the gradients are cast
    to the operands' dtypes.  The backward's launches are not recorded in
    ``obs.attribution`` (the reference records no training GEMMs); the
    kernel's own launch counters count them.

    dX = dY W^T is one launch on (E, C, N) @ (E, N, K), W^T a row-major copy,
    with ``rows`` forwarded: dY's rows past an expert's count are zero (the
    MoE combine never reads those rows of y), so those rows of dX are zero
    too.  The kernel writes every row of dX: a tile wholly past the count as
    zeros without computing it, the others from dY's rows; the dispatch's
    backward reads only the kept rows of dX.
    dW = X^T dY is one launch on (E, K, C) @ (E, C, N), X^T a copy, every
    output row live, the contraction the capacity C (its ragged last k stage
    zero-filled by TMA, ``csrc/wgmma_gemm.cuh``)."""

    @staticmethod
    def forward(ctx, x, w, rows, plan):
        ctx.save_for_backward(x, w, rows)
        return _grouped_matmul(x, w, rows, plan=plan)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        dx = dw = None
        ct = torch.promote_types(dy.dtype, torch.promote_types(x.dtype, w.dtype))
        dy = dy.to(ct)
        if ctx.needs_input_grad[0]:
            dx = _grouped_matmul(dy, w.to(ct).transpose(1, 2).contiguous(), rows, record=False).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _grouped_matmul(x.to(ct).transpose(1, 2).contiguous(), dy, record=False).to(w.dtype)
        return dx, dw, None, None
