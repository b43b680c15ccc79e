"""Global-norm gradient clipping (the counterpart of ``repro.optim.clip``)."""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-6)): the factor the clip scales by."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by ``clip_scale`` in their own dtypes, the norm
    before clipping)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
