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
    that does NOT touch the resident synchronized cache) and
    ``decode_slots`` (decode with a per-slot position *vector* over an
    externally owned cache).

Empty or cleared slots are marked ``pos = -1`` everywhere; the attention
masking rule ``valid(k) = pos[k] >= 0`` then blanks their cache rows.

Chunked prefill (``prefill_chunk``, ``chunk_schedule``) and the tune-plan
report belong to later parts of the port.
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


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int  # synchronized batch size == continuous-batching slot count
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


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
        # The continuous decode step's GEMM work, which the scheduler divides
        # its measured step into (nothing records into it yet: see
        # ``obs.attribution``).  Executions are counted by the
        # ``engine.steps{phase}`` counter of each continuous primitive.
        self.decode_totals = _obs.GemmTotals()

    # -- sampling --------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits: (B, 1, V) -> tokens (B, 1) int32: argmax at temperature 0,
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
        logits, self.cache = self.model.prefill(self.params, batch, max_len=self.scfg.max_len)
        self.pos = self.prompt_positions(batch)
        return self._sample(logits)

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Generate n_steps tokens.  tokens: (B, 1) seed tokens -> (B, n_steps)."""
        if self.cache is None:
            raise RuntimeError("prefill() first")
        outs = []
        tok = tokens
        for _ in range(n_steps):
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
        """Positions a prompt occupies in the cache."""
        return batch["tokens"].shape[1]

    @torch.no_grad()
    def prefill_request(self, batch: dict):
        """Prefill one admission unit WITHOUT touching the resident cache.

        batch is a batch-1 prompt dict on the engine's device; returns (first
        sampled token (1, 1), primed batch-1 cache at this engine's max_len)
        for the KV pool to scatter into the assigned slot.
        """
        tokens = batch["tokens"]
        if tokens.device.type != self.device.type:
            raise ValueError(f"prompt on {tokens.device}, engine on {self.device}")
        _obs_metrics.inc("engine.steps", phase="prefill_request")
        with _obs_trace.span("engine.prefill_request", cat="engine", prompt_len=tokens.shape[1]):
            logits, cache = self.model.prefill(self.params, batch, max_len=self.scfg.max_len)
        return self._sample(logits), cache

    def attn_cache_len(self) -> int:
        """Sequence capacity of the per-layer attention cache: ``max_len``,
        except the SWA ring which only keeps ``window`` slots."""
        if self.cfg.attention == "swa":
            return min(self.scfg.max_len, self.cfg.window)
        return self.scfg.max_len

    @torch.no_grad()
    def decode_slots(self, tokens: torch.Tensor, cache: Any, pos: torch.Tensor):
        """One continuous-batching decode step over an external cache.

        tokens: (B, 1) last token per slot (garbage for empty slots); pos:
        (B,) int32 per-slot absolute positions, -1 for empty slots, on the
        engine's device.  Returns (sampled tokens (B, 1), cache); the cache
        is updated in place and returned, as the synchronized decode does.
        """
        _obs_metrics.inc("engine.steps", phase="decode")
        with _obs.collecting(self.decode_totals), _obs_trace.span(
            "engine.decode_slots", cat="engine", batch=tokens.shape[0]
        ):
            logits, cache = self.model.decode_step(self.params, tokens, cache=cache, pos=pos)
        return self._sample(logits), cache
