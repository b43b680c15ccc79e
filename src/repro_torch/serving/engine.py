"""Batched serving engine: synchronized prefill -> decode, plus the per-slot
primitives the continuous-batching scheduler drives.

The counterpart of ``repro.serving.engine``.  It runs eagerly: no
``torch.compile`` and no CUDA graph yet.  The reference jits its decode step
and donates the cache to it; here the decode step updates the cache tensors
it is given in place, which is the same reuse of memory without the
compiler.  Two serving modes share the model's functions:

  * **synchronized batched decode** (``generate``): every slot advances one
    token per step at a common depth;
  * **continuous batching** (``repro_torch.serving.scheduler`` +
    ``repro_torch.serving.kvpool``): ``prefill_request`` (batch-1 prefill
    that does NOT touch the resident synchronized cache), ``prefill_chunk``
    (advance one request's prefill by one bucketed chunk at its absolute
    offset, the primitive behind the scheduler's mixed prefill/decode
    ticks) and ``decode_slots`` (decode with a per-slot position *vector*
    over an externally owned cache).

Empty or cleared slots are marked ``pos = -1`` everywhere; the attention
masking rule ``valid(k) = pos[k] >= 0`` then blanks their cache rows.  The
SSM and hybrid families' recurrent state has no such mask: an empty slot's
state advances on whatever token it is given, as in the reference, and is
overwritten when a request is admitted into the slot.

Decode-shape plans: the per-step dense GEMMs of a decode token are all
``(batch, *) x (*, *)`` problems, so the batch geometry the scheduler picks
determines which kernel plans fire.  ``decode_plans`` consults the port's
plan cache (``repro_torch.tune``) for every such problem, so that launchers
report whether the serving batch runs on measured winners or on the
kernel's shape rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.registry import Model
from repro_torch.obs import attribution as _obs
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.serving.kvpool import _tensors, clear_slots
from repro_torch.tune import cache as _tune_cache


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int  # synchronized batch size == continuous-batching slot count
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


def chunk_schedule(n_tokens: int, chunk: int) -> list[tuple[int, int]]:
    """Split a prompt into schedulable prefill chunks: [(offset, length), ...].

    As many full ``chunk``-length pieces as fit, then the remainder split
    greedily into power-of-two buckets, so distinct chunk lengths stay
    bounded by log2(chunk) + 2 whatever the prompt lengths.  Nothing is
    padded (a padded tail would write phantom positions into the KV slot).
    """
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    out, off = [], 0
    while n_tokens - off >= chunk:
        out.append((off, chunk))
        off += chunk
    rem = n_tokens - off
    bucket = 1 << (chunk.bit_length() - 1)  # largest power of two <= chunk
    while rem:
        while bucket > rem:
            bucket >>= 1
        out.append((off, bucket))
        off += bucket
        rem -= bucket
    return out


# ---------------------------------------------------------------------------
# Decode-shape plan consultation (the repro_torch.tune cache)
# ---------------------------------------------------------------------------


def decode_gemm_problems(cfg, batch: int) -> list[tuple[str, int, int, int]]:
    """The per-token dense GEMM problems of one decode step: (name, M, N, K).

    M is the serving batch (slot count) -- the knob the scheduler owns; N/K
    come from the architecture.  MoE expert GEMMs route through the grouped
    kernel and are tuned under its own backend key, so only the dense
    projections are listed here.
    """
    d = cfg.d_model
    probs: list[tuple[str, int, int, int]] = []
    if cfg.attention == "mla":
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        probs += [
            ("wq_a", batch, m.q_lora_rank, d),
            ("wq_b", batch, cfg.n_heads * qk_head, m.q_lora_rank),
            ("wkv_a", batch, m.kv_lora_rank + m.qk_rope_head_dim, d),
            ("wo", batch, d, cfg.n_heads * m.v_head_dim),
        ]
    elif cfg.attention in ("gqa", "swa"):
        hd = cfg.resolved_head_dim
        probs += [
            ("wq", batch, cfg.n_heads * hd, d),
            ("wk", batch, cfg.n_kv_heads * hd, d),
            ("wv", batch, cfg.n_kv_heads * hd, d),
            ("wo", batch, d, cfg.n_heads * hd),
        ]
    if cfg.moe is None and cfg.d_ff:
        probs += [
            ("ffn_in", batch, cfg.d_ff, d),
            ("ffn_out", batch, d, cfg.d_ff),
        ]
    return probs


def consult_decode_plans(cfg, batch: int) -> dict:
    """Look every decode-step GEMM up in the table the K1 dispatch reads
    (``tune.cache.tuned_path``, backend "cuda-systolic").

    Returns ``{name: ((m, n, k), TunedPlan | None)}`` -- None means the
    kernel's shape rule will drive that projection.  Never raises: the
    autotuner is an accelerant, not a dependency.
    """
    out = {}
    for name, m, n, k in decode_gemm_problems(cfg, batch):
        hit = _tune_cache.tuned_path("cuda-systolic", m, n, k, cfg.dtype)
        out[name] = ((m, n, k), None if hit is None else hit.plan)
    return out


def _shapes(batch: dict) -> tuple:
    """A prompt batch's shape key: each tensor's name and shape."""
    return tuple((name, tuple(v.shape)) for name, v in sorted(batch.items()) if isinstance(v, torch.Tensor))


class ServeEngine:
    def __init__(self, model: Model, params: Any, scfg: ServeConfig,
                 device: str | torch.device | None = None):
        """``device`` defaults to the card; ``params`` must already live there."""
        self.device = resolve_device(device)
        for t in _tensors(params):
            if t.device.type != self.device.type:
                raise ValueError(f"params on {t.device}, engine on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.params = params
        self.cache = None
        self.pos = 0
        # Temperature sampling draws from this generator on the engine's
        # device (torch's RNG is not JAX's: sampled tokens cannot match the
        # reference's, greedy ones do).
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        # GEMM-work accounting (``obs.attribution``): each totals object holds
        # ONE call's GEMM work, as the reference's trace-time totals do:
        #   decode_totals    vector-pos decode_slots (one continuous tick)
        #   generate_totals  synchronized scalar-pos decode step
        #   prefill_totals   monolithic prefills, one call per distinct prompt
        #                    shape (the reference's one trace per shape)
        #   chunk totals     per (bucketed length, wrapped) prefill chunk
        # Chosen: fill a totals object on the first call per shape key (with
        # telemetry on) and collect later calls of that key into a scratch
        # object, which feeds only the registry's counters.  Resetting on
        # every call would also keep decode_totals at one tick, but would
        # leave prefill_totals at the last prompt's shape, where the
        # reference's sums one trace per shape.  The scheduler divides each
        # measured tick into decode_totals; executions are counted by
        # ``engine.steps{phase}``, so total FLOPs(phase) = totals.flops *
        # engine.steps{phase} for a single-shape phase.
        self.decode_totals = _obs.GemmTotals()
        self.generate_totals = _obs.GemmTotals()
        self.prefill_totals = _obs.GemmTotals()
        self._chunk_totals: dict[tuple[int, bool], _obs.GemmTotals] = {}
        self._filled: set = set()  # the shape keys whose call filled its totals
        self._decode_plans: dict | None = None

    def _collecting(self, totals: _obs.GemmTotals, key) -> Any:
        """``collecting(totals)`` on the first call of shape ``key`` made with
        telemetry on; a scratch totals object (the counters only) after it."""
        if key in self._filled or not _obs_metrics.enabled():
            return _obs.collecting(_obs.GemmTotals())
        self._filled.add(key)
        return _obs.collecting(totals)

    # -- tune-cache consultation ------------------------------------------------

    @property
    def decode_plans(self) -> dict:
        """Tune-cache consultation for this engine's decode batch geometry
        (lazy; see ``consult_decode_plans``)."""
        if self._decode_plans is None:
            self._decode_plans = consult_decode_plans(self.cfg, self.scfg.batch)
        return self._decode_plans

    def decode_plan_report(self) -> str:
        """One-line summary: how many decode GEMMs run on tuned plans."""
        plans = self.decode_plans
        hits = sum(1 for _, p in plans.values() if p is not None)
        return f"decode plans: {hits}/{len(plans)} tuned (batch={self.scfg.batch})"

    # -- sampling --------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits: (B, 1[, n_codebooks], V) -> tokens (B, 1[, n_codebooks])
        int32: argmax at temperature 0,
        else a draw from softmax(logits / temperature) with the engine's
        generator."""
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=self._gen)
        return tok.reshape(logits.shape[:-1]).to(torch.int32)

    # -- synchronized serving --------------------------------------------------

    @torch.no_grad()
    def prefill(self, batch: dict) -> torch.Tensor:
        """Prime the resident cache from a synchronized prompt batch; returns
        the first sampled continuation token (prefill emits last-position
        logits)."""
        _obs_metrics.inc("engine.steps", phase="prefill")
        with self._collecting(self.prefill_totals, ("prefill", _shapes(batch))):
            logits, self.cache = self.model.prefill(self.params, batch, max_len=self.scfg.max_len)
        self.pos = self.prompt_positions(batch)
        return self._sample(logits)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Generate n_steps tokens.  tokens: (B, 1[, n_codebooks]) seed tokens
        -> (B, n_steps[, n_codebooks])."""
        if self.cache is None:
            raise RuntimeError("prefill() first")
        outs = []
        tok = tokens
        _obs_metrics.inc("engine.steps", n_steps, phase="decode_sync")
        for _ in range(n_steps):
            with self._collecting(self.generate_totals, ("decode_sync", tuple(tok.shape))):
                logits, self.cache = self.model.decode_step(self.params, tok, cache=self.cache, pos=self.pos)
            tok = self._sample(logits)
            outs.append(tok)
            self.pos += 1
        return torch.cat(outs, dim=1)

    def generate(self, batch: dict, n_steps: int) -> torch.Tensor:
        first = self.prefill(batch)
        if n_steps <= 1:
            return first
        return torch.cat([first, self.decode(first, n_steps - 1)], dim=1)

    @torch.no_grad()
    def reset_slots(self, slot_mask: torch.Tensor) -> None:
        """Clear finished slots: zero their cache state and set their position
        arrays to -1 so the freed slot's old keys are masked out of every
        later step (``pos = 0`` is a valid position -- see ``clear_slots``)."""
        if self.cache is None:
            return
        self.cache = clear_slots(self.cache, torch.as_tensor(slot_mask), self.scfg.batch)

    # -- continuous-batching primitives ----------------------------------------

    def prompt_positions(self, batch: dict) -> int:
        """Positions a prompt occupies in the cache: its tokens, and the vit
        frontend's patch prefix before them."""
        n = batch["tokens"].shape[1]
        if self.cfg.frontend == "vit":
            n += self.cfg.n_patches
        return n

    @torch.no_grad()
    def prefill_request(self, batch: dict):
        """Prefill one admission unit WITHOUT touching the resident cache.

        batch is a batch-1 prompt dict on the engine's device; returns (first
        sampled token (1, 1[, n_codebooks]), primed batch-1 cache at this
        engine's max_len)
        for the KV pool to scatter into the assigned slot.
        """
        tokens = batch["tokens"]
        if tokens.device.type != self.device.type:
            raise ValueError(f"prompt on {tokens.device}, engine on {self.device}")
        _obs_metrics.inc("engine.steps", phase="prefill_request")
        with self._collecting(self.prefill_totals, ("prefill", _shapes(batch))), \
                _obs_trace.span("engine.prefill_request", cat="engine", prompt_len=tokens.shape[1]):
            logits, cache = self.model.prefill(self.params, batch, max_len=self.scfg.max_len)
        return self._sample(logits), cache

    # -- chunked prefill -------------------------------------------------------

    @property
    def supports_chunked_prefill(self) -> bool:
        """Every family except the vit frontend (its patch prefix is glued to
        the first text positions); the scheduler falls back to monolithic
        ``prefill_request`` when False."""
        return self.cfg.frontend != "vit"

    @property
    def chunk_prefill_staged(self) -> bool:
        """True when mid-prefill chunks must carry a request-private staging
        cache instead of round-tripping through the KV pool: the SSM and
        hybrid families' state has no ``pos`` mask, so a co-scheduled decode
        step would advance it (the scheduler writes their cache into the
        slot once, after the last chunk).  The attention families' masked
        rows no decode step touches."""
        return self.cfg.family in ("ssm", "hybrid")

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, cache_one: Any, offset: int, *, last: bool):
        """Advance one request's prefill by one chunk.

        tokens: (1, L[, n_codebooks]) slice of the prompt at absolute offset
        ``offset``; cache_one: the request's batch-1 slot cache, updated in
        place.  Returns (first sampled token (1, 1[, n_codebooks]) when
        ``last`` else None, cache).
        A chunk past the end of the SWA ring takes the ``wrapped`` variant
        (see ``attention.gqa_prefill_chunk``).
        """
        if tokens.device.type != self.device.type:
            raise ValueError(f"prompt on {tokens.device}, engine on {self.device}")
        length = tokens.shape[1]
        wrapped = offset + length > self.attn_cache_len()
        totals = self._chunk_totals.setdefault((length, wrapped), _obs.GemmTotals())
        _obs_metrics.inc("engine.steps", phase="prefill_chunk")
        with self._collecting(totals, ("chunk", length, wrapped)), \
                _obs_trace.span("engine.prefill_chunk", cat="engine", offset=offset, length=length, wrapped=wrapped):
            logits, cache_one = self.model.prefill_chunk(self.params, {"tokens": tokens}, cache=cache_one,
                                                         offset=offset, wrapped=wrapped)
        return (self._sample(logits) if last else None), cache_one

    def attn_cache_len(self) -> int:
        """Sequence capacity of the per-layer attention cache: ``max_len``,
        except the SWA ring which only keeps ``window`` slots."""
        if self.cfg.attention == "swa":
            return min(self.scfg.max_len, self.cfg.window)
        return self.scfg.max_len

    @torch.no_grad()
    def decode_slots(self, tokens: torch.Tensor, cache: Any, pos: torch.Tensor):
        """One continuous-batching decode step over an external cache.

        tokens: (B, 1[, n_codebooks]) last token per slot (garbage for empty
        slots); pos: (B,) int32 per-slot absolute positions, -1 for empty
        slots, on the engine's device.  Returns (sampled tokens (B, 1[,
        n_codebooks]), cache); the cache
        is updated in place and returned, as the synchronized decode does.
        """
        _obs_metrics.inc("engine.steps", phase="decode")
        with self._collecting(self.decode_totals, ("decode", tuple(tokens.shape))), _obs_trace.span(
            "engine.decode_slots", cat="engine", batch=tokens.shape[0]
        ):
            logits, cache = self.model.decode_step(self.params, tokens, cache=cache, pos=pos)
        return self._sample(logits), cache
