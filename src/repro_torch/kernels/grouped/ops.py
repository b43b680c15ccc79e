"""Public wrapper of the grouped (per-expert) GEMM: checks and dispatch.

The counterpart of ``repro.kernels.grouped.ops.grouped_matmul``.  A CPU tensor
goes to the plain version; a CUDA tensor goes to the hand-written kernel,
which masks ragged edges itself, so nothing is padded and no block plan is
chosen here (the reference's tuner lookup comes with the port's tuner).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.grouped import kernel as _kernel
from repro_torch.kernels.grouped.ref import grouped_matmul_ref


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, rows: torch.Tensor | None = None) -> torch.Tensor:
    """y[e] = x[e] @ w[e] for all experts e, in x's dtype.

    x: (E, C, K) capacity-dispatched tokens; w: (E, K, N) expert weights;
    rows: None, or (E,) int32 on x's device, each expert's number of leading
    rows of x that can be nonzero (the rest are zero, as the dispatch leaves
    them).  On the card the kernel skips the tiles past it, which gives the
    same result; the plain version computes every row and ignores it.
    """
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0]:
        raise ValueError(f"bad grouped shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.shape[2] != w.shape[1]:
        raise ValueError(f"contraction mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, w)
    return _kernel.grouped_matmul_call(x.contiguous(), w.contiguous(), rows)
