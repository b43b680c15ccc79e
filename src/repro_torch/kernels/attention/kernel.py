"""ctypes binding of the hand-written CUDA flash attention (``csrc/flash_attn.cu``).

The counterpart of ``repro.kernels.attention.kernel.flash_attention_call``:
forward attention over (B, S, H, D) queries and (B, S, Hkv, D) keys and
values, query head h reading KV head ``h // (H // Hkv)`` in place (the
reference repeats KV to every query head first).  Every operand is read
through its strides, so transposed views pass without a copy; the kernel
masks the ragged sequence tail itself, so nothing is padded.  On request it
also writes each query row's logsumexp (fp32 (B, H, Sq)), the statistics
``models.attention.flash_mha``'s backward reads.
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

# Kernel launches made by this process, in all and by (B, Sq, Skv, H, Hkv,
# D, dtype name), what an audit of the launch needs (read and reset by
# chip_smoke.py).
launches = 0
launches_by_plan: collections.Counter = collections.Counter()


def launches_by_heads() -> collections.Counter:
    """``launches_by_plan`` summed by the (H, Hkv) head counts."""
    return _summed(lambda key: key[3:5])


def launches_by_shape() -> collections.Counter:
    """``launches_by_plan`` summed by (B, Sq, Skv)."""
    return _summed(lambda key: key[:3])


def _summed(part) -> collections.Counter:
    out: collections.Counter = collections.Counter()
    for key, count in launches_by_plan.items():
        out[part(key)] += count
    return out

# csrc/flash_attn.cu: bf16 blocks of W_BQ query rows and W_NT threads (two
# consumer warpgroups and a producer), K/V tiles of W_BKV keys in a
# W_STAGES ring; fp32 blocks of F_BQ rows and F_NT threads, K/V tiles of
# F_BKV keys.
W_BQ, W_BKV, W_STAGES, W_NT = 128, 128, 2, 384
F_BQ, F_BKV, F_NT = 64, 64, 128


def launch_of(b: int, h: int, sq: int, d: int, dtype: torch.dtype) -> _build.Launch:
    """The launch a flash call over (B, Sq, H, D) queries of ``dtype`` runs
    with: a block per (head, batch row, query tile), q tiles on z; dynamic
    shared memory for bf16 Q's two 64-row halves, the K/V ring of 128-byte
    panels (D padded to 64 or 128) and the barriers with 1024 bytes of
    alignment slack (``WgLayout``), for fp32 the Q, K, V, S and O tiles
    (``F32Layout``, D padded to 16, rows 4 floats longer).  The Python
    accounting that ``launch_query`` is held to."""
    if dtype == torch.bfloat16:
        panels = 64 if d <= 64 else 128
        q_half = panels // 64 * 64 * 128
        kv_tile = panels // 64 * W_BKV * 128
        smem = 2 * q_half + W_STAGES * 2 * kv_tile + (1 + 2 * W_STAGES) * 8 + 1024
        return _build.Launch((h, b, -(-sq // W_BQ)), W_NT, smem)
    row = 4 * (-(-d // 16) * 16 + 4)
    smem = F_BQ * row + 2 * F_BKV * row + 4 * F_BQ * F_BKV + F_BQ * row  # each a multiple of 128 bytes
    return _build.Launch((h, b, -(-sq // F_BQ)), F_NT, smem)


def launch_query(b: int, h: int, hkv: int, sq: int, skv: int, d: int,
                 dtype: torch.dtype) -> tuple[_build.Launch, _build.Compiled]:
    """What the binary launches at these sizes, and the compiled kernel's
    attributes (``flash_attn_query``; needs the card)."""
    return _build.query(_entry()[0], "flash_attn_query", b, h, hkv, sq, skv, d, DTYPE_CODES[dtype])

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


@functools.cache
def _entry():
    """The loaded library and its C entry point (built on first call)."""
    lib = _build.library("flash_attn")
    fn = lib.flash_attn_fwd
    fn.argtypes = [_P, _P, _P, _P, _P, *[_I] * 6, *[_LL] * 9, ctypes.c_float, _I, _I, _I, _I, _P]
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
    return_lse: bool = False,
):
    """q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D) on one CUDA device, one dtype
    (bf16 or fp32), Hkv dividing H, D <= 128, the last dimension contiguous
    and every row 16-byte aligned -> (B, Sq, H, D) contiguous in q's dtype;
    with ``return_lse``, (out, lse): lse fp32 (B, H, Sq), each row's
    logsumexp of its scaled, masked scores, +inf for a row with no key."""
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if b == 0 or sq == 0 or h == 0:
        return (out, lse) if return_lse else out
    lib, fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, h, hkv, sq, skv, d,
        *_strides(q), *_strides(k), *_strides(v),
        float(scale), int(causal), 0 if window is None else int(window), int(kv_valid),
        DTYPE_CODES[q.dtype], stream,
    )
    _build.check(lib, "flash_attn_fwd launch", code)
    launches += 1
    launches_by_plan[(b, sq, skv, h, hkv, d, str(q.dtype).removeprefix("torch."))] += 1
    return (out, lse) if return_lse else out
