"""ctypes binding of the hand-written CUDA systolic GEMM (``csrc/systolic_mmm.cu``).

The counterpart of ``repro.kernels.systolic.kernel.systolic_matmul_call``:
one launch computes ``act(A @ B [+ bias])`` with an fp32 accumulator.  The
kernel masks ragged edges itself, so shapes need not divide any block.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.systolic.ref import ACTIVATIONS

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATION_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}

# Kernel launches made by this process, in all and by (M, K, N) (read and
# reset by chip_smoke.py).
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def _entry():
    """The loaded library and its C entry point (built on first call)."""
    lib = _build.library("systolic_mmm")
    fn = lib.systolic_mmm
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _LL, _P]
    fn.restype = _I
    lib.systolic_mmm_workspace.argtypes = [_I, _I, _I, _I]
    lib.systolic_mmm_workspace.restype = _LL
    return lib, fn


@functools.cache
def _workspace_bytes(m: int, n: int, k: int, dtype_code: int, device_index: int | None) -> int:
    """fp32 scratch bytes the kernel needs (its split-K partials); depends on
    the shape and the card's SM count, so it is asked once per shape and card."""
    return _entry()[0].systolic_mmm_workspace(m, n, k, dtype_code)


def systolic_matmul_call(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None,
    *,
    out_dtype: torch.dtype,
    activation: str = "none",
) -> torch.Tensor:
    """a: (M, K), b: (K, N), bias: (N,) or None -> (M, N) on the card.

    a and b are contiguous CUDA tensors of one dtype (bf16 or fp32); the
    output dtype is bf16 or fp32.  Raises on anything the kernel does not take.
    """
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"systolic kernel needs both operands on one CUDA device, got {a.device}, {b.device}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"systolic kernel takes bf16 or fp32 operands of one dtype, got {a.dtype}, {b.dtype}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"systolic kernel writes bf16 or fp32, not {out_dtype}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(a.shape)} @ {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("systolic kernel needs row-major contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None:
        if bias.shape != (n,) or bias.device != a.device:
            raise ValueError(f"bias must be ({n},) on {a.device}, got {tuple(bias.shape)} on {bias.device}")
        bias = bias.to(torch.float32).contiguous()
    if max(m, n, k) >= 2**31:
        raise ValueError("systolic kernel dimensions must fit in int32")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib, fn = _entry()
    nbytes = _workspace_bytes(m, n, k, DTYPE_CODES[a.dtype], a.device.index)
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=a.device) if nbytes else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = fn(
        a.data_ptr(), b.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), m, n, k, DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
        ACTIVATION_CODES[activation], None if ws is None else ws.data_ptr(), nbytes, stream,
    )
    _build.check(lib, "systolic_mmm launch", code)
    launches += 1
    launches_by_shape[(m, k, n)] += 1
    return out
