"""Synthetic batches and request traces with deterministic numpy data.

The counterpart of ``repro.data.synthetic``'s ``make_batch``, ``make_prompt``,
``make_request_trace``, ``make_adversarial_trace`` and ``make_shared_prefix_trace``: the reference draws with
numpy, and so does this module, from the same generators in the same order, so one seed gives the
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


def make_adversarial_trace(
    cfg: ArchConfig,
    *,
    n_short: int,
    short_prompt: int = 8,
    short_gen: int = 24,
    long_prompt: int = 96,
    long_gen: int = 4,
    long_arrival: float = 2.0,
    n_long: int = 1,
    shared_prefix: int = 0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> list[dict]:
    """The long-prompt worst case for monolithic prefill.

    ``n_short`` short requests arrive at tick 0 and decode steadily;
    ``n_long`` requests with ``long_prompt``-token prompts arrive in a burst
    at ``long_arrival`` while they are mid-generation.  Under monolithic
    prefill a long admission stalls every decoding slot for a whole prompt
    forward (one tick's latency spikes by the whole prefill); under chunked
    prefill the prompt trickles in one bounded chunk per tick.
    ``shared_prefix`` makes the first that many tokens identical across the
    long prompts.  Same entry layout as ``make_request_trace``.
    """
    if n_short < 1:
        raise ValueError("n_short must be >= 1")
    if n_long < 1:
        raise ValueError("n_long must be >= 1")
    if shared_prefix > long_prompt:
        raise ValueError("shared_prefix cannot exceed long_prompt")
    dev = resolve_device(device)
    trace = [
        {
            "rid": i,
            "arrival": 0.0,
            "prompt": make_prompt(cfg, seq=short_prompt, seed=seed + 1 + i, device=dev),
            "max_new_tokens": short_gen,
        }
        for i in range(n_short)
    ]
    rng = np.random.default_rng(seed + 100)
    prefix = rng.integers(0, cfg.vocab_size, _token_shape(cfg, 1, shared_prefix), dtype=np.int32)
    for j in range(n_long):
        prompt = make_prompt(cfg, seq=long_prompt, seed=seed + 101 + j, device=dev)
        if shared_prefix:
            prompt["tokens"][:, :shared_prefix] = torch.from_numpy(prefix).to(dev)
        trace.append(
            {
                "rid": n_short + j,
                "arrival": float(long_arrival),
                "prompt": prompt,
                "max_new_tokens": long_gen,
            }
        )
    return trace


def make_shared_prefix_trace(
    cfg: ArchConfig,
    *,
    n_requests: int,
    prefix_len: int,
    suffix_len: int = 4,
    gen: int = 4,
    n_groups: int = 1,
    rate: float = 1.0,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> list[dict]:
    """Requests sharing ``n_groups`` distinct ``prefix_len``-token prompt
    prefixes (round-robin group assignment) with per-request random
    suffixes: the system-prompt workload the prefix cache deduplicates.  The
    first request of each group prefills the full prompt and registers its
    pages; every later request in the group should hit ``prefix_len -
    (prefix_len % page_size)`` cached tokens and prefill only its suffix.
    Poisson arrivals of intensity ``rate`` per tick.  Same entry layout as
    ``make_request_trace``.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if prefix_len < 1 or suffix_len < 1:
        raise ValueError("prefix_len and suffix_len must be >= 1")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, cfg.vocab_size, _token_shape(cfg, 1, prefix_len), dtype=np.int32)
                for _ in range(max(1, n_groups))]
    arrivals = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), n_requests))
    trace = []
    for i in range(n_requests):
        suffix = rng.integers(0, cfg.vocab_size, _token_shape(cfg, 1, suffix_len), dtype=np.int32)
        toks = np.concatenate([prefixes[i % max(1, n_groups)], suffix], axis=1)
        prompt: dict = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.frontend == "vit":
            pe = rng.standard_normal((1, cfg.n_patches, cfg.vit_dim))
            prompt["patch_embeds"] = torch.from_numpy(pe).to(dev, getattr(torch, cfg.dtype))
        trace.append({"rid": i, "arrival": float(arrivals[i]), "prompt": prompt, "max_new_tokens": gen})
    return trace
