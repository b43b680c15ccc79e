"""Synthetic batches and request traces with deterministic numpy data.

The counterpart of ``repro.data.synthetic``'s ``make_batch``, ``make_prompt``
and ``make_request_trace``: the reference draws with numpy, and so does this
module, from the same generators in the same order, so one seed gives the
same tokens, arrivals and lengths here.  The tensors are then placed on
``device`` (default: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ArchConfig


def _token_shape(cfg: ArchConfig, batch: int, seq: int) -> tuple[int, ...]:
    if cfg.frontend == "audio_codec":
        return (batch, seq, cfg.n_codebooks)
    return (batch, seq)


def _text_len(cfg: ArchConfig, seq: int) -> int:
    """vlm: n_patches image positions + text fill the assigned seq_len."""
    if cfg.frontend == "vit":
        return seq - cfg.n_patches
    return seq


def make_batch(
    cfg: ArchConfig,
    *,
    batch: int,
    seq: int,
    kind: str = "train",
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Concrete random batch: {"tokens"[, "patch_embeds"][, "labels"]}."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    st = _text_len(cfg, seq) if kind != "decode" else 1
    toks = rng.integers(0, cfg.vocab_size, _token_shape(cfg, batch, st), dtype=np.int32)
    out: dict = {"tokens": torch.from_numpy(toks).to(dev)}
    if cfg.frontend == "vit" and kind != "decode":
        pe = rng.standard_normal((batch, cfg.n_patches, cfg.vit_dim))
        out["patch_embeds"] = torch.from_numpy(pe).to(dev, getattr(torch, cfg.dtype))
    if kind == "train":
        labels = rng.integers(0, cfg.vocab_size, _token_shape(cfg, batch, st), dtype=np.int32)
        out["labels"] = torch.from_numpy(labels).to(dev)
    return out


def make_prompt(cfg: ArchConfig, *, seq: int, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """Batch-1 prefill batch: the continuous-batching admission unit."""
    return make_batch(cfg, batch=1, seq=seq, kind="prefill", seed=seed, device=device)


def make_request_trace(
    cfg: ArchConfig,
    *,
    n_requests: int,
    mean_prompt: int = 24,
    mean_gen: int = 12,
    rate: float = 0.5,
    seed: int = 0,
    min_prompt: int = 4,
    max_prompt: int | None = None,
    min_gen: int = 1,
    max_gen: int | None = None,
    device: str | torch.device | None = None,
) -> list[dict]:
    """Poisson-arrival ragged request trace for the continuous scheduler.

    Arrivals are a Poisson process of intensity ``rate`` (requests per
    scheduler tick, i.e. per decode step); prompt and generation lengths are
    geometric around their means, clipped to [min, max].  Entries are
    ``{"rid", "arrival", "prompt", "max_new_tokens"}`` with ``prompt`` a
    batch-1 prefill batch on ``device``
    (``serving.scheduler.requests_from_trace`` adapts them to Requests).
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n_requests))
    max_prompt = max_prompt or 4 * mean_prompt
    max_gen = max_gen or 4 * mean_gen

    def _ragged(mean: int, lo: int, hi: int) -> int:
        return int(np.clip(rng.geometric(1.0 / max(mean, 1)), lo, hi))

    trace = []
    for i in range(n_requests):
        p = _ragged(mean_prompt, min_prompt, max_prompt)
        g = _ragged(mean_gen, min_gen, max_gen)
        trace.append(
            {
                "rid": i,
                "arrival": float(arrivals[i]),
                "prompt": make_prompt(cfg, seq=p, seed=seed + 1 + i, device=dev),
                "max_new_tokens": g,
            }
        )
    return trace
