"""Public wrapper of the systolic GEMM: checks, dtype policy and dispatch.

The counterpart of ``repro.kernels.systolic.ops.matmul`` (fp path).  A CPU
tensor goes to the plain version ``matmul_ref``; a CUDA tensor goes to the
hand-written kernel, which masks ragged edges itself, so nothing is padded
and no block plan is chosen here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.systolic import kernel as _kernel
from repro_torch.kernels.systolic.ref import ACTIVATIONS, matmul_ref


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
