"""Decoder assembly for the attention families: GQA / SWA / MLA attention
with a SwiGLU FFN (dense) or a mixture of experts (moe).

The counterpart of the dense and MoE families of ``repro.models.transformer``.
The reference stacks layer parameters on a leading axis and runs
``lax.scan``; here ``params["layers"]`` and ``cache["layers"]`` are lists,
one dict per layer, and a Python loop walks them.  SSM, hybrid and the
modality frontends belong to later parts of the port and raise here.

Entry points (functions over dicts of tensors):
  init_model(cfg, seed, device[, dtype, transform])
                                            -> params
  cast_params(params, dtype)                -> params, floating weights cast once
  forward(params, batch, cfg)               -> logits fp32
  init_cache(cfg, batch, max_len, dt, dev)  -> cache
  decode_step(params, tok, cfg, cache, pos) -> (logits, cache)   [cache updated in place]
  prefill(params, batch, cfg, max_len)      -> (last logits, primed cache)
  prefill_chunk(params, batch, cfg, cache, offset, wrapped)
                                            -> (last logits, cache)   [cache updated in place]
"""

from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.models.config import ArchConfig
from repro_torch.quant.qarray import QArray


def _cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for architectures this part of the port does not build yet."""
    cfg.validate()
    if cfg.family not in ("dense", "moe") or cfg.attention not in ("gqa", "swa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: the port builds dense and MoE GQA/SWA/MLA decoders only so far "
            f"(family={cfg.family!r}, attention={cfg.attention!r})"
        )
    if cfg.frontend is not None or cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: frontends and tied embeddings are not ported yet")


# ===========================================================================
# Attention blocks
# ===========================================================================


def init_attn_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    return {
        "attn_norm": layers.init_rmsnorm(cfg.d_model, gen.device),
        "ffn_norm": layers.init_rmsnorm(cfg.d_model, gen.device),
        "attn": attn.init_mla(gen, cfg, dtype) if cfg.attention == "mla" else attn.init_gqa(gen, cfg, dtype),
        "ffn": (moe.init_moe(gen, cfg, dtype) if cfg.moe is not None
                else layers.init_swiglu(gen, cfg.d_model, cfg.d_ff, dtype)),
    }


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """SwiGLU, or the MoE block with its aux loss dropped (the serve path
    drops it, as the reference's does)."""
    if cfg.moe is not None:
        return moe.moe_fwd(p, x, cfg)[0]
    return layers.swiglu(p, x)


def attn_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Pre-norm attn + residual, pre-norm FFN / MoE + residual -> (x, the
    cache's prefill entries: (k, v), or MLA's (c_kv, k_rope))."""
    xin = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    fwd = attn.mla_fwd if cfg.attention == "mla" else attn.gqa_fwd
    a, kv = fwd(p["attn"], xin, cfg, positions)
    x = x + a
    hin = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    return x + _ffn(p["ffn"], hin, cfg), kv


def attn_block_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, pos):
    xin = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    decode = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
    a, cache = decode(p["attn"], xin, cfg, cache, pos)
    x = x + a
    hin = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    return x + _ffn(p["ffn"], hin, cfg), cache


def attn_block_prefill_chunk(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, offset: int, *,
                             wrapped: bool = False):
    """One layer of a chunked prefill: like ``attn_block_fwd``, but the
    attention reads and writes a partially primed decode cache at
    ``offset`` (``attention.gqa_prefill_chunk`` / ``mla_prefill_chunk``); the
    FFN / MoE as in decode."""
    xin = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    chunk = attn.mla_prefill_chunk if cfg.attention == "mla" else attn.gqa_prefill_chunk
    a, cache = chunk(p["attn"], xin, cfg, cache, offset, wrapped=wrapped)
    x = x + a
    hin = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    return x + _ffn(p["ffn"], hin, cfg), cache


# ===========================================================================
# Model init
# ===========================================================================


def init_model(cfg: ArchConfig, seed: int = 0, device: str | torch.device | None = None,
               dtype: torch.dtype | None = None, transform=None) -> dict:
    """Random weights from ``seed`` (a torch Generator on ``device``; the
    reference's ``jax.random`` init gives other numbers -- use
    ``repro_torch.convert.params_from_jax`` to carry JAX weights over).

    Weights are drawn in fp32 and created in ``dtype`` (default: the
    config's compute dtype).  ``dtype=torch.float32`` keeps the fp32 masters,
    as the reference inits them, for ``quant.quantize_params``; then
    ``cast_params`` brings what stays wide to the compute dtype.  The same
    seed gives the same fp32 values in either case.

    ``transform`` (default: none) is applied to each top-level piece -- the
    final norm, the embedding, the head, then each layer, in the order they
    are drawn -- as soon as it is drawn, so a caller that quantizes holds
    one layer's fp32 masters at a time (``launch/serve.py::init_params``).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype or _cdtype(cfg)
    f = transform or (lambda piece: piece)
    return {
        "final_norm": f(layers.init_rmsnorm(cfg.d_model, dev)),
        "embed": f(layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt)),
        "lm_head": f(layers.init_dense(gen, cfg.d_model, cfg.vocab_size, dt)),
        "layers": [f(init_attn_block(gen, cfg, dt)) for _ in range(cfg.n_layers)],
    }


def cast_params(params, dtype: torch.dtype):
    """A copy of ``params`` with every floating weight in ``dtype``, once:
    RMSNorm ``scale`` vectors stay fp32 (as in the reference) and quantized
    ``QArray`` weights stay as they are."""
    if isinstance(params, dict):
        return {k: v if k == "scale" else cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


# ===========================================================================
# Embedding / head
# ===========================================================================


def _embed_input(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    return layers.embed(params["embed"], batch["tokens"], _cdtype(cfg))


def _head(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits.  The reference runs the head as an einsum outside any
    kernel, so it stays a library matmul here: bf16 operands, fp32 output.
    A quantized head dequantizes to ``x.dtype`` here, as in the reference,
    and never goes through the quantized kernel."""
    w = params["lm_head"]["w"]
    w = w.dequantize(x.dtype) if isinstance(w, QArray) else w.to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        y = torch.mm(x2, w, out_dtype=torch.float32)  # CUDA only: no fp32 copy of the head
    else:
        y = torch.mm(x2.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[1])


# ===========================================================================
# Forward / prefill / decode
# ===========================================================================


def forward(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward.  batch: {"tokens": (B, S) int}.  -> logits fp32
    at every position (``prefill`` gives the last position's alone)."""
    x = _embed_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for lp in params["layers"]:
        x, _ = attn_block_fwd(lp, x, cfg, positions)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    dtype = dtype or _cdtype(cfg)
    dev = resolve_device(device)
    init = attn.init_mla_cache if cfg.attention == "mla" else attn.init_gqa_cache
    return {"layers": [init(cfg, batch, max_len, dtype, dev) for _ in range(cfg.n_layers)]}


def decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict, pos):
    """tokens: (B, 1) int; pos: int absolute position (synchronized batch) or
    a (B,) int32 tensor of per-slot positions (negative = empty slot).
    -> (logits fp32 (B, 1, V), cache), the cache updated in place."""
    x = layers.embed(params["embed"], tokens, _cdtype(cfg))
    pos = attn.slot_positions(pos, x.shape[0], x.device)
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, _ = attn_block_decode(lp, x, cfg, lc, pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg), cache


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int):
    """Run the full prompt and prime a decode cache -> (last logits (B, 1, V), cache)."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, _cdtype(cfg), tokens.device)
    x = _embed_input(params, batch, cfg)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    prime = attn.mla_prime_cache if cfg.attention == "mla" else attn.gqa_prime_cache
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, kv = attn_block_fwd(lp, x, cfg, positions)
        prime(lc, *kv, s)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg), cache


def prefill_chunk(params: dict, batch: dict, cfg: ArchConfig, cache: dict, offset: int, *, wrapped: bool = False):
    """Advance a prefill by one chunk -> (last-position logits (B, 1, V), cache).

    batch: {"tokens": (B, L)} covering absolute prompt positions [offset,
    offset + L); ``cache`` is a decode cache (``init_cache``) whose rows
    below ``offset`` earlier chunks primed (a fresh cache at offset 0), and
    is updated in place.  Composing ``prefill_chunk`` over a split of the
    prompt gives what one ``prefill`` gives, up to the order of the
    attention's sums.  ``wrapped`` must be set when an SWA ring chunk
    extends past the window (``offset + L > cache size``).
    """
    if cfg.frontend == "vit":
        raise ValueError("chunked prefill does not support the vit frontend")
    x = layers.embed(params["embed"], batch["tokens"], _cdtype(cfg))
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, _ = attn_block_prefill_chunk(lp, x, cfg, lc, offset, wrapped=wrapped)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg), cache
