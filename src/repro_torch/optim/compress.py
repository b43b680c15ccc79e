"""int8 gradient compression with error feedback: the counterpart of
``repro.optim.compress``.

Gradients are quantized to int8 with one fp32 scale per tensor before a
data-parallel all-reduce over a slow link; the quantization residual is kept
and added back at the next step (error feedback), which preserves
convergence to first order.  The port's data-parallel paths are a later
part of the port; these functions are its building blocks.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map


def compress_int8(g: torch.Tensor, residual: torch.Tensor | None = None):
    """-> (q int8, scale fp32, new_residual fp32)."""
    g32 = g.float()
    if residual is not None:
        g32 = g32 + residual
    amax = g32.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.float() * scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compress_tree(grads, residuals=None):
    """Tree-wise int8 + error feedback.  ``residuals`` may be None (first
    step).  -> (q tree, scale tree, residual tree)."""
    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
    out = tree_map(compress_int8, grads, residuals)
    return tuple(tree_map(lambda t: t[i], out) for i in range(3))
