"""GQA attention (full and sliding-window): prefill, KV cache and decode.

The counterpart of the GQA part of ``repro.models.attention``.  Caches are
dicts of tensors per layer; every cache stores a per-slot absolute-position
array ``pos`` (B, S_cache) so full caches and SWA ring buffers share one
masking rule:

    valid(b, k) = pos[b, k] >= 0  and  pos[b, k] <= q_pos[b]
                  and  pos[b, k] > q_pos[b] - window

A slot whose position is negative is empty: its cache row stays marked
``pos = -1``, so the rule blanks every key.

Prefill attention is the flash kernel on the card (its plain version on the
CPU); decode attention has no kernel in the reference either and is plain
torch here.  The reference's "einsum" / "flash" / "chunked" switch is not
carried over.  JAX's functions return new caches; these update the cache
tensors in place (the reference donates them) and return the same dict.
"""

from __future__ import annotations

import torch

from repro_torch.core import ops
from repro_torch.kernels.attention import flash_attention
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
    arange(S).  -> (y, (k, v)) with k/v (B, S, Hkv, hd) for the cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    o = _sdpa_flash(q, k, v, cfg)
    y = ops.matmul(o.reshape(b, s, -1), layers.wcast(params["wo"], x.dtype))
    return y, (k, v)


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
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(params, x, cfg)
    pos = slot_positions(pos, b, x.device)
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
    o = o.reshape(b, 1, cfg.n_heads * hd)
    y = ops.matmul(o, layers.wcast(params["wo"], x.dtype))
    return y, cache


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
