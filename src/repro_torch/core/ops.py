"""The matmul every model projection goes through, and the fp32-accumulating einsum.

The counterpart of ``repro.core.ops``.  There is no backend switch: on the
card every projection *is* the hand-written systolic kernel, and on the CPU
its plain version.  The reference's quantized dispatch, grouped matmul, TP
hook and profiling belong to later parts of the port.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.systolic import ops as systolic_ops


def matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` with x of shape (..., K) and w of shape (K, N), fp32 accumulation."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    k = x.shape[-1]
    if w.shape[0] != k:
        raise ValueError(f"matmul shape mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    y2 = systolic_ops.matmul(x.reshape(-1, k), w, out_dtype=out_dtype)
    return y2.reshape(*lead, w.shape[1])


def einsum(spec: str, *args: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fp32-accumulating einsum: operands widened to fp32 (exact for bf16),
    the result cast to ``out_dtype`` (default: the first operand's dtype)."""
    out_dtype = out_dtype or args[0].dtype
    return torch.einsum(spec, *(a.float() for a in args)).to(out_dtype)
