"""Attention: GQA (full and sliding-window) and MLA (multi-head latent
attention) -- prefill, KV cache, decode and chunked prefill.

The counterpart of ``repro.models.attention``.  Caches are dicts of tensors
per layer; every cache stores a per-slot absolute-position array ``pos``
(B, S_cache) so full caches, SWA ring buffers and MLA latent caches share
one masking rule:

    valid(b, k) = pos[b, k] >= 0  and  pos[b, k] <= q_pos[b]
                  and  pos[b, k] > q_pos[b] - window

A slot whose position is negative is empty: its cache row stays marked
``pos = -1``, so the rule blanks every key.

GQA prefill attention is the flash kernel on the card (its plain version on
the CPU); under grad (training) it is ``flash_mha``, the reference's
block-recomputing attention as a ``torch.autograd.Function``: its forward is
the same kernel with its logsumexp output on the card and ``chunked_mha`` on
the CPU, its backward the reference's plain block loop (``_blk_bwd``).
Decode attention has no kernel in the reference either and is plain torch
here.  MLA's attention is plain torch everywhere, as the
reference's default path computes it (it never reaches the reference's
flash kernel, and its query/key head (nope + rope) is wider than its value
head); its projections go through ``core.ops.matmul`` like every other.  The reference's "einsum" / "flash" / "chunked" switch is not
carried over.  JAX's functions return new caches; these update the cache
tensors in place (the reference donates them) and return the same dict.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import ops
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.attention import kernel as _flash_kernel
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def init_gqa(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": layers._dense_init(gen, d, cfg.n_heads * hd, dtype),
        "wk": layers._dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wv": layers._dense_init(gen, d, cfg.n_kv_heads * hd, dtype),
        "wo": layers._dense_init(gen, cfg.n_heads * hd, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(hd, gen.device)
        p["k_norm"] = layers.init_rmsnorm(hd, gen.device)
    return p


def _window(cfg: ArchConfig) -> int | None:
    return cfg.window if cfg.attention == "swa" else None


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int | None) -> torch.Tensor:
    """(S, T) causal (+ sliding-window) mask from absolute positions."""
    m = kpos[None, :] <= qpos[:, None]
    if window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _sdpa(q, k, v, mask, q_per_kv: int):
    """Plain attention.  q: (B,S,Hq,hd), k/v: (B,T,Hkv,hd), mask: (S,T) or
    (B,S,T) -> (B,S,Hq,hd).  KV is repeated to the Q heads."""
    hd = q.shape[-1]
    if q_per_kv > 1:
        k = k.repeat_interleave(q_per_kv, dim=2)
        v = v.repeat_interleave(q_per_kv, dim=2)
    scores = ops.einsum("bshd,bthd->bhst", q, k, out_dtype=torch.float32) * hd**-0.5
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return ops.einsum("bhst,bthd->bshd", w.to(v.dtype), v)


def _sdpa_flash(q, k, v, cfg: ArchConfig):
    """Prefill attention through the flash kernel.  q: (B,S,Hq,hd), k/v:
    (B,S,Hkv,hd) as the model holds them -> (B,S,Hq,hd).  The kernel reads
    each query head's KV head in place (the reference repeats KV first) and
    takes the transposed views without a copy; on the card its output is
    (B,S,Hq,hd) contiguous."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True, window=_window(cfg))
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# Memory-efficient attention and its block-recomputing backward (training).
# ---------------------------------------------------------------------------


def _blk_mask(q_lo, k_lo, bq, bkv, s, t, causal, window, device):
    qpos = q_lo + torch.arange(bq, device=device)[:, None]
    kpos = k_lo + torch.arange(bkv, device=device)[None, :]
    mask = (kpos < t) & (qpos < s)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _blk_needed(q_lo: int, k_lo: int, bq, bkv, causal, window) -> bool:
    """Static causal / window block skip."""
    if causal and k_lo > q_lo + bq - 1:
        return False
    if window is not None and k_lo + bkv - 1 < q_lo - window + 1:
        return False
    return True


def _blk_fwd(qblk, kblk, vblk, q_lo, k_lo, m_p, l_p, acc, *, scale, causal, window, s, t, bq, bkv):
    """One online-softmax update.  qblk (B,bq,H,hd), k/v (B,bkv,H,*).
    Stats (B,H,bq); acc (B,H,bq,hd_v)."""
    sc = torch.einsum("bqhd,bkhd->bhqk", qblk.float(), kblk.float()) * scale
    sc = torch.where(_blk_mask(q_lo, k_lo, bq, bkv, s, t, causal, window, sc.device), sc, -1e30)
    m_n = torch.maximum(m_p, sc.amax(dim=-1))
    p = torch.exp(sc - m_n[..., None])
    alpha = torch.exp(m_p - m_n)
    l_n = alpha * l_p + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vblk.dtype).float(), vblk.float())
    return m_n, l_n, acc * alpha[..., None] + pv


def _pad_seq(x: torch.Tensor, n: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 1 of x to n rows."""
    if x.shape[1] == n:
        return x
    pad = x.new_full((x.shape[0], n - x.shape[1], *x.shape[2:]), value)
    return torch.cat([x, pad], dim=1)


def chunked_mha(q, k, v, *, causal=True, window=None, scale=None, bq=512, bkv=1024, return_stats=False):
    """Online-softmax attention over blocks, O(bq * bkv) temporaries.

    q: (B, S, H, hd), k/v: (B, T, H, hd) -> (B, S, H, hd_v); with
    ``return_stats`` also each row's logsumexp, fp32 (B, H, S), +inf where a
    row saw no key.  The reference's Python-loop form (with its static
    causal / window block skip): a resident Q block against streamed K/V
    blocks, the flash kernel's math in plain PyTorch.
    """
    b, s, h, hd = q.shape
    t = k.shape[1]
    hd_v = v.shape[-1]
    scale = scale if scale is not None else hd**-0.5
    bq, bkv = min(bq, s), min(bkv, t)
    sp, tp = math.ceil(s / bq) * bq, math.ceil(t / bkv) * bkv
    qp, kp, vp = _pad_seq(q, sp), _pad_seq(k, tp), _pad_seq(v, tp)
    blk = dict(scale=scale, causal=causal, window=window, s=s, t=t, bq=bq, bkv=bkv)
    outs, lses = [], []
    for q_lo in range(0, sp, bq):
        qblk = qp[:, q_lo : q_lo + bq]
        m = q.new_full((b, h, bq), -1e30, dtype=torch.float32)
        l = q.new_zeros((b, h, bq), dtype=torch.float32)
        acc = q.new_zeros((b, h, bq, hd_v), dtype=torch.float32)
        for k_lo in range(0, tp, bkv):
            if _blk_needed(q_lo, k_lo, bq, bkv, causal, window):
                m, l, acc = _blk_fwd(qblk, kp[:, k_lo : k_lo + bkv], vp[:, k_lo : k_lo + bkv], q_lo, k_lo, m, l,
                                     acc, **blk)
        l_safe = torch.where(l > 0, l, 1.0)
        outs.append((acc / l_safe[..., None]).to(q.dtype).transpose(1, 2))
        lses.append(torch.where(l > 0, m + torch.log(l_safe), math.inf))
    o = torch.cat(outs, dim=1)[:, :s]
    return (o, torch.cat(lses, dim=-1)[..., :s]) if return_stats else o


def _blk_bwd(qblk, kblk, vblk, doblk, lseblk, dblk, q_lo, k_lo, *, scale, causal, window, s, t, bq, bkv):
    """Gradients of one block pair -> (dq_blk, dk_blk, dv_blk), fp32.
    lseblk / dblk: (B,H,bq) logsumexp rows and rowsum(do * o)."""
    sc = torch.einsum("bqhd,bkhd->bhqk", qblk.float(), kblk.float()) * scale
    sc = torch.where(_blk_mask(q_lo, k_lo, bq, bkv, s, t, causal, window, sc.device), sc, -1e30)
    p = torch.exp(sc - lseblk[..., None])  # rows with lse = +inf -> 0
    dp = torch.einsum("bqhd,bkhd->bhqk", doblk.float(), vblk.float())
    ds = p * (dp - dblk[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kblk.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qblk.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, doblk.float())
    return dq, dk, dv


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def _flash_bwd(q, k, v, o, lse, do, *, causal, window, scale, bq, bkv):
    """The reference's flash backward (kv blocks outer, q blocks inner, dq
    accumulated in fp32) with K/V at Hkv heads: they are repeated to the
    query heads, as the reference's callers repeat them before its
    ``flash_mha``, and dk / dv are summed back over each group (the
    repeat's gradient)."""
    b, s, h, hd = q.shape
    t, hkv, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    rep = h // hkv
    bq, bkv = min(bq, s), min(bkv, t)
    sp, tp = math.ceil(s / bq) * bq, math.ceil(t / bkv) * bkv
    qp, op, dop = _pad_seq(q, sp), _pad_seq(o, sp), _pad_seq(do, sp)
    kp, vp = _pad_seq(_repeat_kv(k, rep), tp), _pad_seq(_repeat_kv(v, rep), tp)
    dmat = (dop.float() * op.float()).sum(dim=-1).transpose(1, 2)  # (B, H, Sp)
    lsep = _pad_seq(lse.transpose(1, 2), sp, math.inf).transpose(1, 2)
    blk = dict(scale=scale, causal=causal, window=window, s=s, t=t, bq=bq, bkv=bkv)
    dq = q.new_zeros((b, sp, h, hd), dtype=torch.float32)
    dk = q.new_zeros((b, tp, h, hd), dtype=torch.float32)
    dv = q.new_zeros((b, tp, h, hd_v), dtype=torch.float32)
    for k_lo in range(0, tp, bkv):
        kblk, vblk = kp[:, k_lo : k_lo + bkv], vp[:, k_lo : k_lo + bkv]
        for q_lo in range(0, sp, bq):
            if not _blk_needed(q_lo, k_lo, bq, bkv, causal, window):
                continue
            dq_b, dk_b, dv_b = _blk_bwd(qp[:, q_lo : q_lo + bq], kblk, vblk, dop[:, q_lo : q_lo + bq],
                                        lsep[..., q_lo : q_lo + bq], dmat[..., q_lo : q_lo + bq], q_lo, k_lo, **blk)
            dq[:, q_lo : q_lo + bq] += dq_b
            dk[:, k_lo : k_lo + bkv] += dk_b
            dv[:, k_lo : k_lo + bkv] += dv_b
    dk = dk[:, :t].reshape(b, t, hkv, rep, hd).sum(dim=3)
    dv = dv[:, :t].reshape(b, t, hkv, rep, hd_v).sum(dim=3)
    return dq[:, :s].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashMHA(torch.autograd.Function):
    """Differentiable flash attention.  Forward: on the card the flash kernel
    (K/V read in place at their Hkv heads) with its logsumexp output, on the
    CPU ``chunked_mha(return_stats=True)`` over K/V repeated to the query
    heads; the output and the statistics are saved, never the (S, T)
    probabilities.  Backward: ``_flash_bwd``, plain PyTorch, as the
    reference's is plain JAX."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bq, bkv):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        if q.device.type == "cpu":
            rep = q.shape[2] // k.shape[2]
            o, lse = chunked_mha(q, _repeat_kv(k, rep), _repeat_kv(v, rep), causal=causal, window=window,
                                 scale=scale, bq=bq, bkv=bkv, return_stats=True)
        else:
            o, lse = _flash_kernel.flash_attention_call(q, k, v, scale=scale, causal=causal, window=window,
                                                        kv_valid=k.shape[1], return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale, bq=bq, bkv=bkv)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_flash_bwd(q, k, v, o, lse, do, **ctx.opts), None, None, None, None, None)


def flash_mha(q, k, v, *, causal=True, window=None, scale=None, bq=512, bkv=1024):
    """Differentiable flash attention (block-recomputing backward).  q: (B,
    S, H, hd), k/v: (B, T, Hkv, hd) with Hkv dividing H (query head h reads
    KV head h // (H // Hkv)) -> (B, S, H, hd)."""
    if q.shape[2] % k.shape[2] or k.shape != v.shape:
        raise ValueError(f"flash_mha needs k/v of one shape with KV heads dividing H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _FlashMHA.apply(q, k, v, causal, window, scale, bq, bkv)


def _qkv(params: dict, x: torch.Tensor, cfg: ArchConfig):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = ops.matmul(x, layers.wcast(params["wq"], x.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = ops.matmul(x, layers.wcast(params["wk"], x.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = ops.matmul(x, layers.wcast(params["wv"], x.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def gqa_fwd(params: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Full-sequence causal self attention.  x: (B, S, d), positions: (S,) =
    arange(S).  -> (y, (k, v)) with k/v (B, S, Hkv, hd) for the cache.  Under
    grad the attention is ``flash_mha`` (the reference's "flashvjp" form),
    else the flash kernel alone."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    o, k = gqa_attend(q, k, v, cfg, positions)
    y = ops.matmul(o.reshape(b, s, -1), layers.wcast(params["wo"], x.dtype))
    return y, (k, v)


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """``gqa_fwd`` between its projections: rope, then causal attention over
    q (B, S, H, hd) and k / v (B, S, Hkv, hd) at ``cfg``'s head counts ->
    (o (B, S, H, hd), the roped k).  The tensor-parallel layout calls it on
    a rank's own heads."""
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_mha(q, k, v, causal=True, window=_window(cfg)), k
    return _sdpa_flash(q, k, v, cfg), k


# -- KV cache ----------------------------------------------------------------


def init_gqa_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device) -> dict:
    """Cache for one layer.  SWA archs get a ring buffer of `window` slots."""
    size = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, size, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
    }


def gqa_prime_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, s: int) -> dict:
    """Fill a cache from prefill keys/values (keep the trailing window), in
    place.  Synchronized: every batch row is primed at the same length s."""
    size = cache["k"].shape[1]
    take = min(size, s)
    kk = k[:, s - take : s]
    vv = v[:, s - take : s]
    dev = cache["pos"].device
    if size >= s:
        cache["k"][:, :take] = kk
        cache["v"][:, :take] = vv
        cache["pos"].fill_(-1)
        cache["pos"][:, :take] = torch.arange(take, dtype=torch.int32, device=dev)
        return cache
    # ring: absolute position p lives at slot p % size
    abs_pos = torch.arange(s - take, s, dtype=torch.int32, device=dev)
    slot_of = (abs_pos % size).long()
    cache["k"][:, slot_of] = kk
    cache["v"][:, slot_of] = vv
    cache["pos"][:, slot_of] = abs_pos[None]
    return cache


def slot_positions(pos, b: int, device: torch.device) -> torch.Tensor:
    """A decode position as a (B,) int32 tensor: an int fills every slot (made
    on the device, so no host-to-device copy stalls the stream)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def _slot_update(cache_leaf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                 active: torch.Tensor) -> None:
    """Per-slot cache write, in place: leaf (B, T, ...), new (B, 1, ...),
    start (B,), active (B,) bool.  Inactive rows write back the entry already
    stored at ``start``, so an empty slot's step leaves its row untouched."""
    rows = torch.arange(cache_leaf.shape[0], device=cache_leaf.device)
    idx = start.long()
    old = cache_leaf[rows, idx]
    a = active.reshape((-1,) + (1,) * (old.ndim - 1))
    cache_leaf[rows, idx] = torch.where(a, new[:, 0], old)


def gqa_decode(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, pos):
    """One-token decode.  x: (B, 1, d); pos: int absolute position
    (synchronized batch) or (B,) int32 per-slot positions.  Slots with
    ``pos < 0`` are empty: their cache row is left untouched and their mask
    blanks every key.  Updates ``cache`` in place; -> (y, cache)."""
    b = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    o = gqa_decode_attend(q, k, v, cfg, cache, slot_positions(pos, b, x.device))
    y = ops.matmul(o, layers.wcast(params["wo"], x.dtype))
    return y, cache


def gqa_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ArchConfig, cache: dict,
                      pos: torch.Tensor) -> torch.Tensor:
    """``gqa_decode`` between its projections: rope at the (B,) per-slot
    positions, the cache write and the masked attention over the cache, at
    ``cfg``'s head counts -> o (B, 1, H * hd).  The tensor-parallel layout
    calls it on a rank's own heads and cache."""
    b, hd = q.shape[0], cfg.resolved_head_dim
    posq = pos[:, None]  # (B, 1) per-slot rope positions
    q = layers.apply_rope(q, posq, cfg.rope_theta)
    k = layers.apply_rope(k, posq, cfg.rope_theta)

    size = cache["k"].shape[1]
    active = pos >= 0
    slot = pos.clamp(min=0) % size
    _slot_update(cache["k"], k, slot, active)
    _slot_update(cache["v"], v, slot, active)
    _slot_update(cache["pos"], pos[:, None], slot, active)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]

    window = _window(cfg)
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if window is not None:
        valid = valid & (cpos > (pos - window)[:, None])

    qg = q.reshape(b, 1, cfg.n_kv_heads, cfg.q_per_kv, hd)
    scores = ops.einsum("bsgqd,btgd->bgqst", qg, ck, out_dtype=torch.float32) * hd**-0.5
    scores = torch.where(valid[:, None, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    o = ops.einsum("bgqst,btgd->bsgqd", w.to(cv.dtype), cv)
    return o.reshape(b, 1, cfg.n_heads * hd)


def gqa_prefill_chunk(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, offset: int, *,
                      wrapped: bool = False):
    """Prefill one chunk of a prompt against a partially primed cache.

    x: (B, L, d) hidden states of absolute prompt positions [offset,
    offset + L); cache rows for positions < offset are already primed.  The
    chunk's K/V land at their absolute positions (ring slot ``pos % size``,
    the rule decode uses) and its queries attend under the decode masking
    rule ``valid(k) = pos[k] >= 0 and pos[k] <= q_pos [and window]``, with
    plain attention over the whole cache, as the reference computes it
    outside any kernel.

    ``wrapped`` (a chunk of an SWA ring past the window) attends over
    [cache before this chunk's writes ‖ chunk]: the keys and positions are
    gathered *before* the in-place write, so within-chunk queries still see
    the ring entries the chunk overwrites.  Otherwise the chunk is written
    first and attends over the cache.  Updates ``cache`` in place; -> (y,
    cache).
    """
    b, l, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    positions = torch.arange(l, dtype=torch.int32, device=x.device) + offset  # made on the device
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot_of = (positions % size).long()
    posb = positions[None].expand(b, l)
    if wrapped:  # copies, taken before the writes below
        keys = torch.cat([cache["k"], k], dim=1)
        vals = torch.cat([cache["v"], v], dim=1)
        kpos = torch.cat([cache["pos"], posb], dim=1)
    cache["k"][:, slot_of] = k
    cache["v"][:, slot_of] = v
    cache["pos"][:, slot_of] = posb
    if not wrapped:
        keys, vals, kpos = cache["k"], cache["v"], cache["pos"]

    window = _window(cfg)
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= posb[:, :, None])
    if window is not None:
        valid = valid & (kpos[:, None, :] > (posb - window)[:, :, None])
    o = _sdpa(q, keys, vals, valid, cfg.q_per_kv)  # (B, L, Hq, hd)
    y = ops.matmul(o.reshape(b, l, -1), layers.wcast(params["wo"], x.dtype))
    return y, cache


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": layers._dense_init(gen, d, m.q_lora_rank, dtype),
        "q_norm": layers.init_rmsnorm(m.q_lora_rank, gen.device),
        "wq_b": layers._dense_init(gen, m.q_lora_rank, h * qk_head, dtype),
        "wkv_a": layers._dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        "kv_norm": layers.init_rmsnorm(m.kv_lora_rank, gen.device),
        "wkv_b": layers._dense_init(gen, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wo": layers._dense_init(gen, h * m.v_head_dim, d, dtype),
    }


def _mla_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """The shared projections -> (q_nope, q_rope, c_kv, k_rope): q (B, S, H,
    nope / rope), the normed latent c_kv (B, S, kv_lora) and the shared
    rotary key k_rope (B, S, rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    q_lat = layers.rmsnorm(params["q_norm"], ops.matmul(x, layers.wcast(params["wq_a"], x.dtype)), cfg.norm_eps)
    q = ops.matmul(q_lat, layers.wcast(params["wq_b"], x.dtype)).reshape(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim :]
    q_rope = layers.apply_rope(q_rope, positions, cfg.rope_theta)
    kv = ops.matmul(x, layers.wcast(params["wkv_a"], x.dtype))
    c_kv = layers.rmsnorm(params["kv_norm"], kv[..., : m.kv_lora_rank], cfg.norm_eps)
    k_rope = layers.apply_rope(kv[..., m.kv_lora_rank :][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expanded(params: dict, q_nope, q_rope, c_kv, k_rope, valid, cfg: ArchConfig, dtype: torch.dtype):
    """Attention in the expanded form: ``wkv_b`` applied to the latents
    (T rows) gives per-head K (nope, with the shared rope key appended) and
    V; fp32 scores, masked by ``valid`` ((S, T) or (B, S, T)), softmax.
    -> (B, S, H * v_head)."""
    m = cfg.mla
    b, s, h, _ = q_nope.shape
    t = c_kv.shape[1]
    kv = ops.matmul(c_kv, params["wkv_b"].to(dtype)).reshape(b, t, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., : m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim :]
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, t, h, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    scores = ops.einsum("bshd,bthd->bhst", q, k, out_dtype=torch.float32) * scale
    if valid.ndim == 2:
        valid = valid[None]
    scores = torch.where(valid[:, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return ops.einsum("bhst,bthd->bshd", w.to(v.dtype), v).reshape(b, s, -1)


def mla_fwd(params: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Full-sequence causal MLA (the expanded form).  x: (B, S, d),
    positions: (S,) = arange(S).  -> (y, (c_kv, k_rope)) for the cache."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, cfg, positions)
    o = _mla_expanded(params, q_nope, q_rope, c_kv, k_rope, _mask(positions, positions, None), cfg, x.dtype)
    y = ops.matmul(o, layers.wcast(params["wo"], x.dtype))
    return y, (c_kv, k_rope)


def init_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype, device: torch.device) -> dict:
    """Latent cache for one layer: always full length (no ring)."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def mla_prime_cache(cache: dict, c_kv: torch.Tensor, k_rope: torch.Tensor, s: int) -> dict:
    """Fill a latent cache from prefill latents, in place: every batch row at
    the same length s."""
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    cache["pos"].fill_(-1)
    cache["pos"][:, :s] = torch.arange(s, dtype=torch.int32, device=cache["pos"].device)
    return cache


def mla_decode(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, pos):
    """Absorbed-matrix decode: attention runs in the latent space, ``wkv_b``
    folded into the query and the output by plain einsums (no GEMM kernel).
    pos: int (synchronized batch) or (B,) int32 per-slot positions; a slot
    with ``pos < 0`` is empty (cache row untouched, every key blanked).
    Updates ``cache`` in place; -> (y, cache)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    pos = slot_positions(pos, b, x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, cfg, pos[:, None])

    active = pos >= 0
    slot = pos.clamp(min=0)  # full cache: the absolute position is the slot
    _slot_update(cache["c_kv"], c_kv_new, slot, active)
    _slot_update(cache["k_rope"], k_rope_new, slot, active)
    _slot_update(cache["pos"], pos[:, None], slot, active)
    ck, cr, cpos = cache["c_kv"], cache["k_rope"], cache["pos"]

    # Absorb W_uk into the query: q_eff[h] = q_nope[h] @ W_uk[h]^T.
    wkv_b = params["wkv_b"].to(x.dtype).reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_uk, w_uv = wkv_b[..., : m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim :]
    q_eff = ops.einsum("bshd,lhd->bshl", q_nope, w_uk)  # (B, 1, H, lora)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_lat = ops.einsum("bshl,btl->bhst", q_eff, ck, out_dtype=torch.float32)
    s_rope = ops.einsum("bshd,btd->bhst", q_rope, cr, out_dtype=torch.float32)
    scores = (s_lat + s_rope) * scale
    valid = (cpos >= 0) & (cpos <= pos[:, None])  # (B, T)
    scores = torch.where(valid[:, None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    ctx = ops.einsum("bhst,btl->bshl", w.to(ck.dtype), ck)  # the latent context
    o = ops.einsum("bshl,lhd->bshd", ctx, w_uv).reshape(b, 1, -1)
    y = ops.matmul(o, layers.wcast(params["wo"], x.dtype))
    return y, cache


def mla_prefill_chunk(params: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, offset: int, *,
                      wrapped: bool = False):
    """Prefill one chunk against a partially primed latent cache.

    The contract of ``gqa_prefill_chunk``: x covers absolute positions
    [offset, offset + L); the chunk's latents land at their absolute slots
    and the decode masking rule hides the rest.  Attention runs in the
    expanded form of ``mla_fwd`` over the whole cache (``wkv_b`` applied to
    every cached latent row, as the reference does).  The cache is full
    length, so ``wrapped`` never applies; it is taken for the signature's
    sake.  Updates ``cache`` in place; -> (y, cache)."""
    del wrapped
    b, l, _ = x.shape
    positions = torch.arange(l, dtype=torch.int32, device=x.device) + offset  # made on the device
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(params, x, cfg, positions)
    posb = positions[None].expand(b, l)
    cache["c_kv"][:, offset : offset + l] = c_kv_new
    cache["k_rope"][:, offset : offset + l] = k_rope_new
    cache["pos"][:, offset : offset + l] = posb
    cpos = cache["pos"]
    valid = (cpos[:, None, :] >= 0) & (cpos[:, None, :] <= posb[:, :, None])
    o = _mla_expanded(params, q_nope, q_rope, cache["c_kv"], cache["k_rope"], valid, cfg, x.dtype)
    y = ops.matmul(o, layers.wcast(params["wo"], x.dtype))
    return y, cache
