"""Decoder assembly: one module builds every family the port serves.

  dense / moe      [attn + SwiGLU / MoE] stack (GQA / SWA / MLA attention)
  audio / vlm      the same [attn + SwiGLU] stack behind a modality frontend
                   (``models/frontends.py``): parallel codebook streams,
                   embedded and summed, with one head per stream (audio); a
                   projected patch prefix before the text (vlm)
  ssm (xlstm)      repeating [mLSTM x (slstm_every - 1), sLSTM] groups
  hybrid (zamba2)  repeating [Mamba2 x attn_every, shared attn] groups, then
                   the trailing Mamba2 layers; the shared attn + SwiGLU
                   block's *weights* are shared across its applications,
                   its KV caches are per application.

The counterpart of ``repro.models.transformer``.  The reference stacks layer
parameters on a leading axis and runs ``lax.scan``; here ``params["layers"]``
(``["mlstm"]``, ``["slstm"]``, ``["mamba"]``) and the caches' lists hold one
dict per layer, and Python loops walk them.  The SSM and hybrid families
prefill, as the reference does, by a loop of ``decode_step`` over the prompt
(their state is sequential by nature).  With ``tie_embeddings`` the head is
the embedding table's transpose (``layers.unembed``), and there is no
``lm_head``.

Training keeps fp32 masters (``init_model(..., dtype=torch.float32)``) and
casts each GEMM weight at use (``layers.wcast``), as the reference does;
``remat`` recomputes each layer (each SSM / hybrid group) in the backward
(``torch.utils.checkpoint``, where the reference wraps its scan body in
``jax.checkpoint``).

Entry points (functions over dicts of tensors):
  init_model(cfg, seed, device[, dtype, transform])
                                            -> params
  cast_params(params, dtype)                -> params, floating weights cast once
  forward(params, batch, cfg[, remat, return_aux])
                                            -> logits fp32 [, the MoE aux loss]
  loss_fn(params, batch, cfg[, remat])      -> (loss, metrics)
  init_cache(cfg, batch, max_len, dt, dev)  -> cache
  decode_step(params, tok, cfg, cache, pos) -> (logits, cache)   [cache updated in place]
  prefill(params, batch, cfg, max_len)      -> (last logits, primed cache)
  prefill_chunk(params, batch, cfg, cache, offset, wrapped)
                                            -> (last logits, cache)   [cache updated in place]
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import frontends, layers, moe, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.quant.qarray import QArray


def _cdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for an architecture the port does not build: a family or an
    attention outside the reference's decoders."""
    cfg.validate()
    attention = ("none",) if cfg.family == "ssm" else ("gqa", "swa", "mla")
    if cfg.family not in (*ATTN_FAMILIES, "ssm", "hybrid") or cfg.attention not in attention:
        raise NotImplementedError(
            f"{cfg.name}: the port builds the dense, MoE, audio and vlm (GQA/SWA/MLA), SSM and hybrid decoders "
            f"(family={cfg.family!r}, attention={cfg.attention!r})"
        )


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


def _attn_block(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """``attn_block_fwd`` with the MoE block's aux loss -> (x, kv, aux),
    aux None for a SwiGLU block."""
    xin = layers.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    fwd = attn.mla_fwd if cfg.attention == "mla" else attn.gqa_fwd
    a, kv = fwd(p["attn"], xin, cfg, positions)
    x = x + a
    hin = layers.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe.moe_fwd(p["ffn"], hin, cfg)
        return x + y, kv, aux
    return x + layers.swiglu(p["ffn"], hin), kv, None


def attn_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """Pre-norm attn + residual, pre-norm FFN / MoE + residual -> (x, the
    cache's prefill entries: (k, v), or MLA's (c_kv, k_rope))."""
    x, kv, _ = _attn_block(p, x, cfg, positions)
    return x, kv


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
# SSM blocks (xlstm pairs, zamba2 Mamba2 layers)
# ===========================================================================


def init_mlstm_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    return {"norm": layers.init_rmsnorm(cfg.d_model, gen.device), "core": ssm.init_mlstm(gen, cfg, dtype)}


def init_slstm_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    return {"norm": layers.init_rmsnorm(cfg.d_model, gen.device), "core": ssm.init_slstm(gen, cfg, dtype)}


def init_mamba_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    return {"norm": layers.init_rmsnorm(cfg.d_model, gen.device), "core": ssm.init_mamba2(gen, cfg, dtype)}


def _ssm_block_fwd(p: dict, x: torch.Tensor, cfg: ArchConfig, fwd) -> torch.Tensor:
    return x + fwd(p["core"], layers.rmsnorm(p["norm"], x, cfg.norm_eps), cfg)


def _ssm_block_step(p: dict, x: torch.Tensor, cfg: ArchConfig, step, state: dict) -> torch.Tensor:
    """One token through a pre-norm recurrent block; ``state``'s entries are
    replaced by the new state (the dict is updated in place)."""
    y, new = step(p["core"], layers.rmsnorm(p["norm"], x, cfg.norm_eps), cfg, state)
    state.update(new)
    return x + y


def hybrid_counts(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_mamba, n_shared_apps, n_groups).  Each group = attn_every Mamba2
    layers + 1 shared-attn application; the remaining layers are trailing
    Mamba2 layers."""
    period = cfg.attn_every + 1
    n_apps = cfg.n_layers // period
    return cfg.n_layers - n_apps, n_apps, n_apps


def xlstm_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(n_groups, n_mlstm_per_group).  Group = (slstm_every - 1) mLSTM + 1 sLSTM."""
    s = cfg.ssm.slstm_every
    if cfg.n_layers % s:
        raise ValueError(f"{cfg.name}: n_layers must divide slstm_every={s}")
    return cfg.n_layers // s, s - 1


def _xlstm_groups(params_or_cache: dict, cfg: ArchConfig):
    """(mLSTM entries, sLSTM entry) of each group, in execution order: group
    g runs ``mlstm[g * n_m:(g + 1) * n_m]`` then ``slstm[g]``."""
    n_groups, n_m = xlstm_counts(cfg)
    mlstm = params_or_cache.get("mlstm", [])
    return [(mlstm[g * n_m : (g + 1) * n_m], params_or_cache["slstm"][g]) for g in range(n_groups)]


def _hybrid_split(mamba: list, cfg: ArchConfig):
    """(each group's Mamba2 entries, the trailing ones): group g runs
    ``mamba[g * attn_every:(g + 1) * attn_every]`` then the shared block."""
    _, _, n_groups = hybrid_counts(cfg)
    e = cfg.attn_every
    return [mamba[g * e : (g + 1) * e] for g in range(n_groups)], mamba[n_groups * e :]


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

    The leaves of ``layers.FP32_KEYS`` are fp32 in either case.

    ``transform`` (default: none) is applied to each top-level piece -- the
    final norm, the embedding (the codebook tables), the head unless tied
    (the codebook heads), the vit projector, then each layer (the hybrid's
    shared block after its Mamba2 layers), in the order they are drawn --
    as soon as it is drawn, so a caller that quantizes holds one layer's
    fp32 masters at a time (``launch/serve.py::init_params``).
    """
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype or _cdtype(cfg)
    f = transform or (lambda piece: piece)
    params = {"final_norm": f(layers.init_rmsnorm(cfg.d_model, dev))}
    if cfg.frontend == "audio_codec":
        params["embed"] = f(frontends.init_audio_embed(gen, cfg, dt))
        params["lm_head"] = f(frontends.init_audio_heads(gen, cfg, dt))
    else:
        params["embed"] = f(layers.init_embedding(gen, cfg.vocab_size, cfg.d_model, dt))
        if not cfg.tie_embeddings:
            params["lm_head"] = f(layers.init_dense(gen, cfg.d_model, cfg.vocab_size, dt))
    if cfg.frontend == "vit":
        params["projector"] = f(frontends.init_vit_projector(gen, cfg, dt))
    if cfg.family == "ssm":
        n_groups, n_m = xlstm_counts(cfg)
        if n_m:
            params["mlstm"] = [f(init_mlstm_block(gen, cfg, dt)) for _ in range(n_groups * n_m)]
        params["slstm"] = [f(init_slstm_block(gen, cfg, dt)) for _ in range(n_groups)]
    elif cfg.family == "hybrid":
        n_mamba, _, _ = hybrid_counts(cfg)
        params["mamba"] = [f(init_mamba_block(gen, cfg, dt)) for _ in range(n_mamba)]
        params["shared"] = f(init_attn_block(gen, cfg, dt))
    else:
        params["layers"] = [f(init_attn_block(gen, cfg, dt)) for _ in range(cfg.n_layers)]
    return params


def cast_params(params, dtype: torch.dtype):
    """A copy of ``params`` with every floating weight in ``dtype``, once:
    the leaves of ``layers.FP32_KEYS`` (RMSNorm scales, the recurrent
    blocks' fp32 parameters) stay fp32, as in the reference, and quantized
    ``QArray`` weights stay as they are."""
    if isinstance(params, dict):
        return {k: v if k in layers.FP32_KEYS else cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params


# ===========================================================================
# Embedding / head
# ===========================================================================


def _embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Token ids (B, S) -- (B, S, n_codebooks) for the audio codec -- -> (B, S, d)."""
    if cfg.frontend == "audio_codec":
        return frontends.audio_embed(params["embed"], tokens, _cdtype(cfg))
    return layers.embed(params["embed"], tokens, _cdtype(cfg))


def _embed_input(params: dict, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, int]:
    """-> (x, n_prefix): the vit frontend's projected patches go before the
    text, and n_prefix counts them (0 otherwise)."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend != "vit":
        return x, 0
    proj = frontends.vit_project(params["projector"], batch["patch_embeds"].to(x.dtype), cfg)
    return torch.cat([proj, x], dim=1), proj.shape[1]


def _head(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """fp32 logits: the codebook heads (B, S, n_codebooks, V), the tied
    ``layers.unembed`` -- a launch of the systolic kernel, as in the
    reference --, or the untied head.  The reference runs the untied head as
    an einsum outside any kernel, so it stays a library matmul here: bf16
    operands, fp32 output.  A quantized head dequantizes to ``x.dtype``
    here, as in the reference, and never goes through the quantized kernel."""
    if cfg.frontend == "audio_codec":
        return frontends.audio_logits(params["lm_head"], x)
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x)
    w = params["lm_head"]["w"]
    w = w.dequantize(x.dtype) if isinstance(w, QArray) else w.to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    return layers.matmul_f32_out(x2, w).reshape(*x.shape[:-1], w.shape[1])


# ===========================================================================
# Forward / prefill / decode
# ===========================================================================


def _remat(fn, remat: bool):
    """fn, or fn recomputed in the backward instead of keeping its
    activations (the reference's ``jax.checkpoint``)."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(params: dict, batch: dict, cfg: ArchConfig, *, remat: bool = False, return_aux: bool = False):
    """Full-sequence forward.  batch: {"tokens": (B, S[, n_codebooks]) int[,
    "patch_embeds": (B, P, vit_dim)]}.  -> logits fp32 at every position,
    the patch prefix's included (``prefill`` gives the last position's
    alone); with ``return_aux``, (logits, aux): the MoE blocks' summed
    load-balance loss (fp32 0 without MoE; the SSM and hybrid families have
    none).  ``remat`` recomputes each layer (each SSM / hybrid group; the
    trailing Mamba2 layers are not wrapped) in the backward."""
    x, _ = _embed_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        def group(h, mps, sp):
            for mp in mps:
                h = _ssm_block_fwd(mp, h, cfg, ssm.mlstm_auto)
            return _ssm_block_fwd(sp, h, cfg, ssm.slstm_fwd)

        group = _remat(group, remat)
        for mps, sp in _xlstm_groups(params, cfg):
            x = group(x, mps, sp)
    elif cfg.family == "hybrid":
        groups, tail = _hybrid_split(params["mamba"], cfg)

        def group(h, mps):
            for mp in mps:
                h = _ssm_block_fwd(mp, h, cfg, ssm.mamba2_fwd)
            return _attn_block(params["shared"], h, cfg, positions)[0]

        group = _remat(group, remat)
        for mps in groups:
            x = group(x, mps)
        for mp in tail:
            x = _ssm_block_fwd(mp, x, cfg, ssm.mamba2_fwd)
    else:
        def layer(h, lp):
            h, _, da = _attn_block(lp, h, cfg, positions)
            return h, da

        layer = _remat(layer, remat)
        for lp in params["layers"]:
            x, da = layer(x, lp)
            if da is not None:
                aux = aux + da
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _head(params, x, cfg)
    return (logits, aux) if return_aux else logits


# ===========================================================================
# Loss
# ===========================================================================


def _ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy.  logits fp32 (..., V), labels int (...).
    The gold logit is gathered with a one-hot contraction, as the reference
    gathers it (its numerics; the reference chose it so that the backward
    stays batch- and vocab-sharded)."""
    lse = torch.logsumexp(logits, dim=-1)
    onehot = torch.zeros_like(logits).scatter_(-1, labels.long()[..., None], 1.0)
    gold = torch.einsum("...v,...v->...", logits, onehot)
    nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, *, remat: bool = False):
    """-> (scalar loss, {"ce", "aux", "loss"}).  batch must hold "labels"
    aligned with the *text* positions of "tokens" (already shifted): the vit
    prefix's logits are dropped; audio takes the mean over codebooks too."""
    logits, aux = forward(params, batch, cfg, remat=remat, return_aux=True)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if cfg.frontend == "vit":
        logits = logits[:, logits.shape[1] - labels.shape[1] :]
    if cfg.frontend == "audio_codec" and mask is not None:
        mask = mask[..., None].expand(labels.shape)
    ce = _ce(logits, labels, mask)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def init_attn_block_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                          device: torch.device) -> dict:
    init = attn.init_mla_cache if cfg.attention == "mla" else attn.init_gqa_cache
    return init(cfg, batch, max_len, dtype, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Attention families: one KV cache per layer.  SSM: one recurrent state
    per mLSTM and sLSTM layer (no sequence axis: ``max_len`` is unused).
    Hybrid: one state per Mamba2 layer and one KV cache per application of
    the shared block."""
    dtype = dtype or _cdtype(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        n_groups, n_m = xlstm_counts(cfg)
        c = {"slstm": [ssm.init_slstm_state(cfg, batch, dtype, dev) for _ in range(n_groups)]}
        if n_m:
            c["mlstm"] = [ssm.init_mlstm_state(cfg, batch, dtype, dev) for _ in range(n_groups * n_m)]
        return c
    if cfg.family == "hybrid":
        n_mamba, n_apps, _ = hybrid_counts(cfg)
        return {
            "mamba": [ssm.init_mamba2_state(cfg, batch, dtype, dev) for _ in range(n_mamba)],
            "shared": [init_attn_block_cache(cfg, batch, max_len, dtype, dev) for _ in range(n_apps)],
        }
    return {"layers": [init_attn_block_cache(cfg, batch, max_len, dtype, dev) for _ in range(cfg.n_layers)]}


def decode_step(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict, pos):
    """tokens: (B, 1[, n_codebooks]) int; pos: int absolute position
    (synchronized batch) or a (B,) int32 tensor of per-slot positions
    (negative = empty slot).  -> (logits fp32 (B, 1[, n_codebooks], V),
    cache), the cache updated in place.

    The SSM and hybrid state updates ignore ``pos``, as in the reference: an
    empty slot's state advances on whatever token it is given, and the slot
    is overwritten when a request is admitted into it; ``pos`` only masks
    the hybrid's shared-attention caches."""
    x = _embed_tokens(params, tokens, cfg)
    if cfg.family != "ssm":
        pos = attn.slot_positions(pos, x.shape[0], x.device)
    if cfg.family == "ssm":
        for (mps, sp), (mcs, sc) in zip(_xlstm_groups(params, cfg), _xlstm_groups(cache, cfg)):
            for mp, mc in zip(mps, mcs):
                x = _ssm_block_step(mp, x, cfg, ssm.mlstm_step, mc)
            x = _ssm_block_step(sp, x, cfg, ssm.slstm_step, sc)
    elif cfg.family == "hybrid":
        groups, tail = _hybrid_split(params["mamba"], cfg)
        cgroups, ctail = _hybrid_split(cache["mamba"], cfg)
        for mps, mcs, ac in zip(groups, cgroups, cache["shared"]):
            for mp, mc in zip(mps, mcs):
                x = _ssm_block_step(mp, x, cfg, ssm.mamba2_step, mc)
            x, _ = attn_block_decode(params["shared"], x, cfg, ac, pos)
        for mp, mc in zip(tail, ctail):
            x = _ssm_block_step(mp, x, cfg, ssm.mamba2_step, mc)
    else:
        for lp, lc in zip(params["layers"], cache["layers"]):
            x, _ = attn_block_decode(lp, x, cfg, lc, pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg), cache


def _scan_prompt(params: dict, tokens: torch.Tensor, cfg: ArchConfig, cache: dict, offset: int):
    """The sequential families' prefill: ``decode_step`` over each prompt
    token from ``cache`` at absolute positions offset, offset + 1, ...,
    carrying only the newest logits.  -> (last logits (B, 1[, n_codebooks], V), cache)."""
    logits = None
    for si in range(tokens.shape[1]):
        logits, cache = decode_step(params, tokens[:, si : si + 1], cfg, cache, offset + si)
    return logits, cache


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_len: int):
    """Run the full prompt and prime a decode cache -> (last logits (B, 1[,
    n_codebooks], V), cache).

    Attention families prime their KV caches from the parallel forward, the
    vit frontend's patch prefix at positions 0 .. n_patches - 1 and the text
    after it; the SSM and hybrid families scan ``decode_step`` over the
    prompt's tokens, as the reference does."""
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, _cdtype(cfg), tokens.device)
    if cfg.family not in ATTN_FAMILIES:
        return _scan_prompt(params, tokens, cfg, cache, 0)
    x, _ = _embed_input(params, batch, cfg)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    prime = attn.mla_prime_cache if cfg.attention == "mla" else attn.gqa_prime_cache
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, kv = attn_block_fwd(lp, x, cfg, positions)
        prime(lc, *kv, s)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg), cache


def prefill_chunk(params: dict, batch: dict, cfg: ArchConfig, cache: dict, offset: int, *, wrapped: bool = False):
    """Advance a prefill by one chunk -> (last-position logits (B, 1[,
    n_codebooks], V), cache).

    batch: {"tokens": (B, L[, n_codebooks])} covering absolute prompt positions [offset,
    offset + L); ``cache`` is a decode cache (``init_cache``) whose rows
    below ``offset`` earlier chunks primed (a fresh cache at offset 0), and
    is updated in place.  Composing ``prefill_chunk`` over a split of the
    prompt gives what one ``prefill`` gives, up to the order of the
    attention's sums; for the SSM and hybrid families a chunk is the same
    ``decode_step`` loop from the carried state, exactly.  ``wrapped`` must
    be set when an SWA ring chunk extends past the window (``offset + L >
    cache size``).  The vit frontend is not chunkable (its patch prefix is
    glued to the first text positions): serving prefills it monolithically.
    """
    if cfg.frontend == "vit":
        raise ValueError("chunked prefill does not support the vit frontend")
    if cfg.family not in ATTN_FAMILIES:
        return _scan_prompt(params, batch["tokens"], cfg, cache, offset)
    x = _embed_tokens(params, batch["tokens"], cfg)
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, _ = attn_block_prefill_chunk(lp, x, cfg, lc, offset, wrapped=wrapped)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg), cache
