"""Plain PyTorch versions of the systolic GEMMs, fp and block-scaled (the CPU
path and the kernels' oracles)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.quant.qarray import QArray, canonical_qdtype

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


def quant_matmul_ref(
    qa: QArray,
    qb: QArray,
    *,
    activation: str = "none",
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dequantize-then-fp32-matmul: the plain version of the quantized
    kernel.  The kernel keeps the narrow dot and applies the scales per scale
    step; the two agree up to fp32 summation order (the quantized values are
    the same).  On the card the fp32 matmul must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32`` is False by default)."""
    y = torch.matmul(qa.dequantize(torch.float32), qb.dequantize(torch.float32))
    return ACTIVATIONS[activation](y).to(out_dtype)


def quant_systolic_matmul_ref(
    a: torch.Tensor,
    a_scales: torch.Tensor,
    b: torch.Tensor,
    b_scales: torch.Tensor,
    *,
    qk_a: int,
    qk_b: int,
    out_dtype: torch.dtype,
    activation: str = "none",
) -> torch.Tensor:
    """``quant_matmul_ref`` on the quantized kernel's arguments: per-row
    a_scales (M, ceil(K/qk_a)) and per-column b_scales (ceil(K/qk_b), N),
    a scale block of 0 spanning all of K."""
    k = a.shape[1]
    qd = canonical_qdtype(a.dtype)
    qa = QArray(values=a, scales=a_scales, block=(1, qk_a or k), qdtype=qd)
    qb = QArray(values=b, scales=b_scales, block=(qk_b or k, 1), qdtype=qd)
    return quant_matmul_ref(qa, qb, activation=activation, out_dtype=out_dtype)
