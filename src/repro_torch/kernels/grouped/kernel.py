"""ctypes binding of the hand-written CUDA grouped expert GEMM (``csrc/grouped_mmm.cu``).

The counterpart of ``repro.kernels.grouped.kernel.grouped_matmul_call``: one
launch computes ``y[e] = x[e] @ w[e]`` for every expert with an fp32
accumulator and no epilogue: the systolic GEMM batched over experts, loaded
through the same entry-point table.  The kernel masks ragged C, K and N
itself, so shapes need not divide any block.
"""

from __future__ import annotations

import collections

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.systolic.kernel import DTYPE_CODES, _entry

MAX_EXPERTS = 65535  # the grid's z extent

# Kernel launches made by this process, in all and by (E, C, K, N) (read and
# reset by chip_smoke.py).
launches = 0
launches_by_shape: collections.Counter = collections.Counter()


def grouped_matmul_call(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, K), w: (E, K, N) -> (E, C, N) on the card, in x's dtype.

    x and w are contiguous CUDA tensors of one dtype (bf16 or fp32).  Raises
    on anything the kernel does not take.
    """
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"grouped kernel needs both operands on one CUDA device, got {x.device}, {w.device}")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"grouped kernel takes bf16 or fp32 operands of one dtype, got {x.dtype}, {w.dtype}")
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"expected (E, C, K) @ (E, K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped kernel needs row-major contiguous operands")
    e, c, k = x.shape
    n = w.shape[2]
    if e > MAX_EXPERTS or max(c, k, n) >= 2**31:
        raise ValueError(f"grouped kernel takes at most {MAX_EXPERTS} experts and int32 dimensions, "
                         f"got {tuple(x.shape)} @ {tuple(w.shape)}")
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or n == 0:
        return out
    lib, fn = _entry("grouped_mmm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, n, DTYPE_CODES[x.dtype], stream)
    _build.check(lib, "grouped_mmm launch", code)
    launches += 1
    launches_by_shape[(e, c, k, n)] += 1
    return out
