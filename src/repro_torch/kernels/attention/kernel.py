"""ctypes binding of the hand-written CUDA flash attention (``csrc/flash_attn.cu``).

The counterpart of ``repro.kernels.attention.kernel.flash_attention_call``:
forward attention over (B, S, H, D) queries and (B, S, Hkv, D) keys and
values, query head h reading KV head ``h // (H // Hkv)`` in place (the
reference repeats KV to every query head first).  Every operand is read
through its strides, so transposed views pass without a copy; the kernel
masks the ragged sequence tail itself, so nothing is padded.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_BATCH = 65535  # the grid's y extent

# Kernel launches made by this process, in all and by the (H, Hkv) head
# counts they were given (read and reset by chip_smoke.py).
launches = 0
launches_by_heads: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def _entry():
    """The loaded library and its C entry point (built on first call)."""
    lib = _build.library("flash_attn")
    fn = lib.flash_attn_fwd
    fn.argtypes = [_P, _P, _P, _P, *[_I] * 6, *[_LL] * 9, ctypes.c_float, _I, _I, _I, _I, _P]
    fn.restype = _I
    return lib, fn


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, sequence, head) element strides of a (B, S, H, D) operand; a
    dimension of size 1 gets the stride a contiguous tensor would have (its
    own may be anything, and the kernel never steps along it)."""
    b, s, h, d = t.shape
    natural = (s * h * d, h * d, d)
    return tuple(n if size == 1 else st for size, st, n in zip((b, s, h), t.stride()[:3], natural))


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
    """q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D) on one CUDA device, one dtype
    (bf16 or fp32), Hkv dividing H, D <= 128, the last dimension contiguous
    and every row 16-byte aligned -> (B, Sq, H, D) contiguous in q's dtype."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or fp32 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"expected q (B, Sq, H, D), k/v (B, Skv, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash kernel needs KV heads dividing the query heads, got H={h}, Hkv={hkv}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes head_dim 1..{MAX_HEAD_DIM}, got {d}")
    if b > MAX_BATCH:
        raise ValueError(f"flash kernel takes at most {MAX_BATCH} batch rows, got {b}")
    align = 16 // q.element_size()  # elements per 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.numel() and (t.stride(3) != 1 or d % align or any(st % align for st in _strides(t))
                          or t.data_ptr() % 16):
            raise ValueError(f"flash kernel needs {name}'s last dimension contiguous and its rows 16-byte "
                             f"aligned, got shape {tuple(t.shape)} strides {t.stride()}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or h == 0:
        return out
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, sq, skv, d,
        *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(causal), 0 if window is None else int(window), int(kv_valid),
        DTYPE_CODES[q.dtype], stream,
    )
    _build.check(lib, "flash_attn_fwd launch", code)
    launches += 1
    launches_by_heads[(h, hkv)] += 1
    return out
