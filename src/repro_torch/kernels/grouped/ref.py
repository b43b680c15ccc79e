"""Plain PyTorch version of the grouped (per-expert) GEMM: the CPU path and
the kernel's oracle."""

from __future__ import annotations

import torch


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) -> (E, C, N) in x's dtype, with fp32 accumulation.

    bf16 operands are widened to fp32 first: their products are exact in
    fp32, so this is the kernel's arithmetic up to summation order.  On the
    card the fp32 product must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32`` is False by default).
    """
    return torch.bmm(x.float(), w.float()).to(x.dtype)
