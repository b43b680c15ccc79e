"""Synthetic batches with deterministic numpy data.

The counterpart of ``repro.data.synthetic.make_batch``: the reference draws
its tokens with numpy, so the same seed gives the same tokens here.  The
tensors are then placed on ``device`` (default: the card).
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
