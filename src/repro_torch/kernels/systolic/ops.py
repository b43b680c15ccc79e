"""Public wrappers of the systolic GEMMs: checks, dtype policy and dispatch.

The counterpart of ``repro.kernels.systolic.ops``: ``matmul`` (fp path) and
``quant_matmul`` (block-scaled int8 / fp8).  A CPU tensor goes to the plain
version; a CUDA tensor goes to the hand-written kernel, which masks ragged
edges itself, so nothing is padded and no block plan is chosen here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.systolic import kernel as _kernel
from repro_torch.kernels.systolic.ref import ACTIVATIONS, matmul_ref, quant_systolic_matmul_ref
from repro_torch.quant.qarray import QArray


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    out_dtype: torch.dtype | None = None,
    activation: str = "none",
) -> torch.Tensor:
    """(M, K) @ (K, N) [+bias] [activation] with an fp32 accumulator."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return matmul_ref(a, b, bias, activation=activation, out_dtype=out_dtype)
    return _kernel.systolic_matmul_call(
        a.contiguous(),
        b.contiguous(),
        bias,
        out_dtype=out_dtype,
        activation=activation,
    )


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
) -> torch.Tensor:
    """(M, K) @ (K, N) of two ``QArray``s through the block-scaled quantized
    GEMM (activations usually per row x per 128-k block, weights per 128-k
    block x per column).  The output dtype defaults to bf16.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"expected 2D operands, got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.values.dtype != b.values.dtype:
        raise ValueError(f"operand qdtypes differ: {a.values.dtype} vs {b.values.dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    m, k = a.shape
    n = b.shape[1]
    out_dtype = out_dtype or torch.bfloat16
    a_s, qk_a = _row_scales(a, m, k)
    b_s, qk_b = _col_scales(b, k, n)
    call = quant_systolic_matmul_ref if a.values.device.type == "cpu" else _kernel.quant_systolic_matmul_call
    return call(
        a.values.contiguous(),
        a_s,
        b.values.t().contiguous().t(),  # K-major, the kernel's one B layout; no copy if laid out so (quant.k_major)
        b_s,
        qk_a=qk_a,
        qk_b=qk_b,
        out_dtype=out_dtype,
        activation=activation,
    )
