"""Public wrappers of the systolic GEMMs: checks, dtype policy and dispatch.

The counterpart of ``repro.kernels.systolic.ops``: ``matmul`` (fp path) and
``quant_matmul`` (block-scaled int8 / fp8).  A CPU tensor goes to the plain
version; a CUDA tensor goes to the hand-written kernel, which masks ragged
edges itself, so nothing is padded.  The kernel's tile comes in the
reference's order (``repro.kernels.systolic.ops.matmul``): an explicit
``plan``, then a plan the card timed from the port's plan cache
(``tune.cache.plan_path``, backend "cuda-systolic") for this exact (M, N, K,
dtype, activation), then the kernel's shape rule (``gemm_path`` /
``qgemm_path``).  A cached path that the operands at hand cannot take (an
unaligned view, a K-major B) is not used for that call: the rule decides,
and the launch is counted as "tuned_refused" (``kernel.launch_path`` /
``qlaunch_path``, which settle the launch here, once, on the operands as
launched).  An explicit plan the operands cannot take raises.  Each call records its launch
(``obs.attribution.record_launch``; K5 under the quantized dtype's name) once
the path is settled and before the CPU branch, so the plain version records
what the kernel would.

Under grad mode, with an operand that requires grad, ``matmul`` runs through
``_Matmul``, whose backward is two more GEMMs of the same dispatch: on the
card dA = dC B^T and dB = A^T dC are K1 launches, on the CPU the plain
version, so the CPU tests run the backward code the card runs.  The kernels'
bias / activation epilogue (K2) and the block-scaled GEMM (K5) have no
backward (the reference trains without them): on the card they are refused
under grad rather than silently cut from the graph; on the CPU their plain
versions are differentiable by autograd.
"""

from __future__ import annotations

import torch

from repro_torch.core.blocking import BlockPlan
from repro_torch.kernels.systolic import kernel as _kernel
from repro_torch.kernels.systolic.ref import ACTIVATIONS, matmul_ref, quant_systolic_matmul_ref
from repro_torch.obs import attribution as _obs
from repro_torch.obs import metrics as _metrics
from repro_torch.quant.qarray import QArray
from repro_torch.tune import cache as _tune_cache

BACKEND = "cuda-systolic"  # the plan cache's key for K1 and K5
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8",
               torch.float8_e4m3fn: "float8_e4m3fn"}


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    out_dtype: torch.dtype | None = None,
    activation: str = "none",
    plan: BlockPlan | None = None,
) -> torch.Tensor:
    """(M, K) @ (K, N) [+bias] [activation] with an fp32 accumulator.  A
    K-major b (the transpose of a contiguous (N, K) tensor) goes to the
    kernel as it is, with no copy.  ``plan``: run the kernel's tile that
    its (bm, bn, bk) names (module docstring); the plain version ignores it."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out_dtype = out_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        if bias is None and activation == "none":
            return _Matmul.apply(a, b, out_dtype, plan)
        if a.device.type != "cpu":
            raise RuntimeError("the systolic matmul has no backward for a bias or an activation epilogue (K2); "
                               "the training path runs bias-free projections without one")
    return _matmul(a, b, bias, out_dtype=out_dtype, activation=activation, plan=plan)


def _matmul(a, b, bias=None, *, out_dtype, activation="none", plan=None, record=True):
    """The dispatch: the tile's path settled as the card would settle it, the
    launch recorded (``obs.attribution``; ``record=False`` for the backward's
    products: the reference records no training GEMMs), then the kernel, or
    on the CPU the plain version."""
    m, k = a.shape
    n = b.shape[1]
    dtype = DTYPE_NAMES.get(a.dtype, "")
    cpu = a.device.type == "cpu"
    k_major = not b.is_contiguous() and _kernel.is_k_major(b)  # a (K, 1) or (1, N) B is both: row-major then
    a, b = a.contiguous(), b if k_major else b.contiguous()
    if cpu and plan is not None:
        path, k_chunk, source = None, 0, "explicit"  # the plain version takes any plan: not resolved to a path
    else:
        path, k_chunk, source = _tune_cache.plan_path(BACKEND, m, n, k, dtype, activation, plan)
        if path is not None and k_major:
            path += "_kmajor"
        path, k_chunk, source = _kernel.launch_path(path, k_chunk, source, m, n, k, a.dtype, _kernel.aligned(a, b),
                                                    k_major, _kernel.sm_count(a.device))
    if record and _metrics._enabled:
        _obs.record_launch(m, n, k, dtype, BACKEND, source)
    if cpu:
        return matmul_ref(a, b, bias, activation=activation, out_dtype=out_dtype)
    return _kernel.systolic_matmul_call(a, b, bias, out_dtype=out_dtype, activation=activation, path=path,
                                        k_chunk=k_chunk, plan_source=source, settled=True)


class _Matmul(torch.autograd.Function):
    """C = A @ B with an fp32 accumulator, differentiable.  The backward's
    products run through ``_matmul`` (K1 on the card), each with the
    operands' common dtype; a cotangent wider than the operands (an fp32
    output of bf16 operands) widens the other operand, as JAX's dot
    transpose promotes, and the gradients are cast to the operands' dtypes.
    dB reads A^T through one transposed copy of A (K1 reads A row-major).
    dA reads B^T through a row-major copy of it too: B^T is K-major as it
    lies, which only the WMMA tile reads in place, and the copy plus a
    wgmma tile took 0.56-0.67x the time of the in-place read at every
    training shape on the H100 (PERF.md)."""

    @staticmethod
    def forward(ctx, a, b, out_dtype, plan):
        ctx.save_for_backward(a, b)
        return _matmul(a, b, out_dtype=out_dtype, plan=plan)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        da = db = None
        ct = torch.promote_types(dc.dtype, a.dtype)
        dc = dc.to(ct)
        if ctx.needs_input_grad[0]:
            da = _matmul(dc, b.to(ct).t().contiguous(), out_dtype=a.dtype, record=False)
        if ctx.needs_input_grad[1]:
            db = _matmul(a.to(ct).t().contiguous(), dc, out_dtype=b.dtype, record=False)
        return da, db, None, None


# ---------------------------------------------------------------------------
# Quantized matmul: QArray operands through the block-scaled kernel.
# ---------------------------------------------------------------------------


def _row_scales(q: QArray, m: int, k: int) -> tuple[torch.Tensor, int]:
    """A-side scales expanded to per-row: (M, n_kblocks) fp32, plus the
    k-granularity (0 sentinel = one scale block spans all of K)."""
    qm, qk = q.block
    s = q.scales  # (ceil(M/qm), ceil(K/qk))
    if qm > 1:
        s = s.repeat_interleave(qm, dim=-2)[:m]
    return s.float().contiguous(), (0 if s.shape[-1] == 1 else qk)


def _col_scales(q: QArray, k: int, n: int) -> tuple[torch.Tensor, int]:
    """B-side scales expanded to per-column: (n_kblocks, N) fp32."""
    qk, qn = q.block
    s = q.scales  # (ceil(K/qk), ceil(N/qn))
    if qn > 1:
        s = s.repeat_interleave(qn, dim=-1)[..., :n]
    return s.float().contiguous(), (0 if s.shape[-2] == 1 else qk)


def quant_matmul(
    a: QArray,
    b: QArray,
    *,
    out_dtype: torch.dtype | None = None,
    activation: str = "none",
    plan: BlockPlan | None = None,
) -> torch.Tensor:
    """(M, K) @ (K, N) of two ``QArray``s through the block-scaled quantized
    GEMM (activations usually per row x per 128-k block, weights per 128-k
    block x per column).  The output dtype defaults to bf16.  ``plan`` and
    the plan cache (under the values' dtype) as for ``matmul``.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.values.dtype != b.values.dtype:
        raise ValueError(f"operand qdtypes differ: {a.values.dtype} vs {b.values.dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if (a.values.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for q in (a, b) for t in (q.values, q.scales))):
        raise RuntimeError("the block-scaled quantized matmul (K5) has no backward; the reference does not "
                           "train quantized")
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or torch.bfloat16
    a_s, qk_a = _row_scales(a, m, k)
    b_s, qk_b = _col_scales(b, k, n)
    av = a.values.contiguous()
    bv = b.values.t().contiguous().t()  # K-major, the kernel's one B layout; no copy if laid out so (quant.k_major)
    dtype = DTYPE_NAMES.get(av.dtype, "")
    cpu = av.device.type == "cpu"
    if cpu and plan is not None:
        path, source = None, "explicit"  # the plain version takes any plan: not resolved to a path
    else:
        path, _, source = _tune_cache.plan_path(BACKEND, m, n, k, dtype, activation, plan)
        path, source = _kernel.qlaunch_path(path, source, m, n, k, _kernel.launch_step(qk_a, qk_b, k), av.dtype,
                                            _kernel.aligned(av, bv))
    if _metrics._enabled:
        _obs.record_launch(m, n, k, dtype, BACKEND, source)  # under the values' dtype, as the reference's
    if cpu:
        return quant_systolic_matmul_ref(av, a_s, bv, b_s, qk_a=qk_a, qk_b=qk_b, out_dtype=out_dtype,
                                         activation=activation)
    return _kernel.quant_systolic_matmul_call(av, a_s, bv, b_s, qk_a=qk_a, qk_b=qk_b, out_dtype=out_dtype,
                                              activation=activation, path=path, plan_source=source, settled=True)
