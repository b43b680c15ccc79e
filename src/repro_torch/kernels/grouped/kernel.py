"""ctypes binding of the hand-written CUDA grouped expert GEMM (``csrc/grouped_mmm.cu``).

The counterpart of ``repro.kernels.grouped.kernel.grouped_matmul_call``: one
launch computes ``y[e] = x[e] @ w[e]`` for every expert with an fp32
accumulator and no epilogue, on the path that ``grouped_path`` picks by
shape, dtype and alignment.  ``rows`` may name each expert's leading rows
that can hold a token; the kernel then skips the tiles past them.  The
kernel masks ragged C, K and N itself, so shapes need not divide any block.
"""

from __future__ import annotations

import collections
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.systolic.kernel import DECODE_MAX_M, DTYPE_CODES, _entry

MAX_EXPERTS = 65535  # the grid's z extent

# The grouped GEMM's paths, numbered as in csrc/grouped_mmm.cu:
#   fma              fp32 operands, CUDA-core FMA (the reference's full fp32);
#   decode           bf16, C <= 16: the WMMA 16-row tile;
#   wmma             bf16 shapes TMA cannot take: the WMMA 128x128 tile;
#   wgmma_{64,128,192}x128  bf16 prefill: the systolic GEMM's TMA ring +
#                    wgmma tile batched over experts, one to three consumer
#                    warpgroups of 64 rows.
PATHS = ("fma", "decode", "wmma", "wgmma_64x128", "wgmma_128x128", "wgmma_192x128")
WGMMA_ROWS = {"wgmma_64x128": 64, "wgmma_128x128": 128, "wgmma_192x128": 192}

# Kernel launches made by this process, in all, by (E, C, K, N) and by path
# (read and reset by chip_smoke.py).
launches = 0
launches_by_shape: collections.Counter = collections.Counter()
launches_by_path: collections.Counter = collections.Counter()


def grouped_path(c: int, k: int, n: int, dtype: torch.dtype, aligned: bool) -> str:
    """The grouped GEMM's path for E (C, K) @ (K, N) products of ``dtype``
    operands whose bases are 16-byte aligned (``aligned``).  A choice by
    shape, as ``gemm_path`` makes it by M: TMA needs 16-byte rows (K and N
    multiples of 8) and aligned bases; of the wgmma tiles, the one with the
    fewest row tiles per expert (each reads the expert's weights again),
    then the fewest rows computed past C."""
    if dtype == torch.float32:
        return "fma"
    if c <= DECODE_MAX_M:
        return "decode"
    if k == 0 or k % 8 or n % 8 or not aligned:
        return "wmma"
    return min(WGMMA_ROWS, key=lambda p: (math.ceil(c / WGMMA_ROWS[p]), math.ceil(c / WGMMA_ROWS[p]) * WGMMA_ROWS[p]))


def grouped_matmul_call(x: torch.Tensor, w: torch.Tensor, rows: torch.Tensor | None = None) -> torch.Tensor:
    """x: (E, C, K), w: (E, K, N) -> (E, C, N) on the card, in x's dtype.

    x and w are contiguous CUDA tensors of one dtype (bf16 or fp32).
    ``rows``: None, or an (E,) int32 tensor on the same card holding the
    number of leading rows of each expert's x that can be nonzero (the rest
    must be zero); tiles wholly past it are not computed and come out zero,
    as the product of zero rows does.  Raises on anything the kernel does
    not take.
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
    if rows is not None and (rows.dtype != torch.int32 or tuple(rows.shape) != (e,) or rows.device != x.device
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous ({e},) int32 tensor on {x.device}, got "
                         f"{rows.dtype} {tuple(rows.shape)} on {rows.device}")
    if e > MAX_EXPERTS or max(c, k, n) >= 2**31:
        raise ValueError(f"grouped kernel takes at most {MAX_EXPERTS} experts and int32 dimensions, "
                         f"got {tuple(x.shape)} @ {tuple(w.shape)}")
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or n == 0:
        return out
    lib, fn = _entry("grouped_mmm")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    path = grouped_path(c, k, n, x.dtype, aligned)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, n, DTYPE_CODES[x.dtype],
              None if rows is None else rows.data_ptr(), PATHS.index(path), stream)
    _build.check(lib, "grouped_mmm launch", code)
    launches += 1
    launches_by_shape[(e, c, k, n)] += 1
    launches_by_path[path] += 1
    return out
