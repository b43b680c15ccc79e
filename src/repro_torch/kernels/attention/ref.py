"""Plain PyTorch attention (the CPU path and the flash kernel's oracle)."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=None, scale=None, kv_valid=None):
    """q: (BH, Sq, D), k/v: (BH, Skv, D).  Standard softmax attention.

    Scores in fp32, masked to -1e30 (causal, sliding window, and keys at or
    past ``kv_valid``), probabilities cast to V's dtype for P @ V.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d**-0.5
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    sq, skv = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos < (skv if kv_valid is None else kv_valid)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None], s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_call_ref(q, k, v, *, scale, causal, window, kv_valid):
    """The flash kernel's function in plain PyTorch: q (B, Sq, H, D), k/v
    (B, Skv, Hkv, D) with Hkv dividing H -> (B, Sq, H, D).  KV is repeated
    to the query heads (head h reads KV head h // (H // Hkv)), as the
    reference's callers do, and each head is ``attention_ref``."""
    b, sq, h, d = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def fold(t):  # (B, S, H, D) -> (B * H, S, D)
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d)

    o = attention_ref(fold(q), fold(k), fold(v), causal=causal, window=window, scale=scale, kv_valid=kv_valid)
    return o.reshape(b, h, sq, d).transpose(1, 2)
