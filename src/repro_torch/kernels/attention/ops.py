"""Public wrapper of flash attention over (B, H, S, D) tensors.

The counterpart of ``repro.kernels.attention.ops.flash_attention``.  A CPU
tensor goes to the plain version ``attention_ref``; a CUDA tensor goes to the
hand-written kernel.  KV heads equal Q heads: GQA callers repeat KV first.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention.ref import attention_ref


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
    """Attention over (B, H, Sq, D) queries and (B, H, Skv, D) keys/values.

    ``kv_valid`` masks keys at that position and beyond (default: all Skv
    keys are valid), as the reference does for its padded tail.
    """
    if q.ndim != 4:
        raise ValueError(f"expected (B, H, S, D), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = scale if scale is not None else d**-0.5
    kv_valid = skv if kv_valid is None else kv_valid
    if not 0 < kv_valid <= skv:
        raise ValueError(f"kv_valid must be in 1..{skv}, got {kv_valid}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    qf = q.reshape(b * h, sq, d)
    kf = k.reshape(b * h, skv, d)
    vf = v.reshape(b * h, skv, d)
    if q.device.type == "cpu":
        o = attention_ref(qf, kf, vf, causal=causal, window=window, scale=scale, kv_valid=kv_valid)
    else:
        o = _kernel.flash_attention_call(
            qf.contiguous(), kf.contiguous(), vf.contiguous(),
            scale=scale, causal=causal, window=window, kv_valid=kv_valid,
        )
    return o.reshape(b, h, sq, d)
