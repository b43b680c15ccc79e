"""Batched serving engine: synchronized prefill -> greedy decode.

The counterpart of the synchronized half of ``repro.serving.engine``.  It
runs eagerly: no ``torch.compile`` and no CUDA graph yet.  The reference
jits its decode step and donates the cache to it (``engine.py:187-195``);
here the decode step updates the resident cache tensors in place, which is
the same reuse of memory without the compiler.

The continuous-batching primitives (``prefill_request``, ``prefill_chunk``,
``decode_slots``), the tune-plan report and the metrics hooks belong to
later parts of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.registry import Model
from repro_torch.serving.kvpool import clear_slots


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    batch: int  # synchronized batch size


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


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

    # -- sampling --------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits: (B, 1, V) -> tokens (B, 1) int32, greedy (argmax).
        Temperature sampling comes with the continuous-serving part of the
        port, whose launcher sets it."""
        return torch.argmax(logits, dim=-1).to(torch.int32)

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

    def prompt_positions(self, batch: dict) -> int:
        """Positions a prompt occupies in the cache."""
        return batch["tokens"].shape[1]
