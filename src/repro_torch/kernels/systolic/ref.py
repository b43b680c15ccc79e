"""Plain PyTorch version of the systolic GEMM (the CPU path and the kernel's oracle)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

# The reference's activations (repro/kernels/systolic/kernel.py ACTIVATIONS).
# jax.nn.gelu defaults to the tanh approximation; torch's F.gelu to the exact
# erf form, so the tanh form is asked for by name.
ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "none": lambda x: x,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}


def matmul_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    activation: str = "none",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(M, K) @ (K, N) [+ bias] [act] with fp32 accumulation.

    bf16 operands are widened to fp32 first: their products are exact in
    fp32, so this is the kernel's arithmetic up to summation order.
    """
    out_dtype = out_dtype or a.dtype
    y = torch.matmul(a.float(), b.float())
    if bias is not None:
        y = y + bias.float()
    return ACTIVATIONS[activation](y).to(out_dtype)
