"""ctypes binding of the hand-written CUDA flash attention (``csrc/flash_attn.cu``).

The counterpart of ``repro.kernels.attention.kernel.flash_attention_call``:
forward attention over (BH, S, D) with KV heads equal to Q heads.  The kernel
masks the ragged sequence tail itself, so nothing is padded.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

# Kernel launches made by this process (read and reset by chip_smoke.py).
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _entry():
    """The loaded library and its C entry point (built on first call)."""
    lib = _build.library("flash_attn")
    fn = lib.flash_attn_fwd
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def flash_attention_call(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    causal: bool,
    window: int | None,
    kv_valid: int,
) -> torch.Tensor:
    """q: (BH, Sq, D), k/v: (BH, Skv, D), contiguous on one CUDA device, one
    dtype (bf16 or fp32), D <= 128 -> (BH, Sq, D) in q's dtype."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or fp32 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"expected q (BH, Sq, D), k/v (BH, Skv, D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head_dim 1..{MAX_HEAD_DIM}, got {d}")
    if bh > 65535:
        raise ValueError(f"flash kernel takes at most 65535 batch*heads, got {bh}")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq, skv, d,
        float(scale), int(causal), 0 if window is None else int(window), int(kv_valid),
        DTYPE_CODES[q.dtype], stream,
    )
    _build.check(lib, "flash_attn_fwd launch", code)
    launches += 1
    return out
