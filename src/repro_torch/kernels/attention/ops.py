"""Public wrapper of flash attention over (B, H, S, D) tensors.

The counterpart of ``repro.kernels.attention.ops.flash_attention``, with the
same signature and semantics, and head-aware: keys and values may have Hkv
heads where Hkv divides H (query head h reads KV head ``h // (H // Hkv)``),
which equals the reference on KV repeated to H heads.  A CPU tensor goes to
the plain version, which repeats KV; a CUDA tensor goes to the hand-written
kernel, which reads q, k and v in place through their strides (transposed
views included) and returns a (B, H, S, D) view of its (B, S, H, D) output.
The kernel has no backward: on the card it is refused under grad (training
attention is ``models.attention.flash_mha``, whose backward is plain); the
plain version is differentiable by autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention.ref import flash_attention_call_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    kv_valid: int | None = None,
) -> torch.Tensor:
    """Attention over (B, H, Sq, D) queries and (B, Hkv, Skv, D) keys/values.

    ``kv_valid`` masks keys at that position and beyond (default: all Skv
    keys are valid), as the reference does for its padded tail.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, S, D), k/v (B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: same B and D, KV heads dividing H")
    scale = scale if scale is not None else d**-0.5
    kv_valid = skv if kv_valid is None else kv_valid
    if not 0 < kv_valid <= skv:
        raise ValueError(f"kv_valid must be in 1..{skv}, got {kv_valid}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type != "cpu" and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the flash attention kernel (K3) has no backward of its own; under grad the model "
                           "takes models.attention.flash_mha")
    call = flash_attention_call_ref if q.device.type == "cpu" else _kernel.flash_attention_call
    o = call(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             scale=scale, causal=causal, window=window, kv_valid=kv_valid)
    return o.transpose(1, 2)
