"""Weight-only quantization of the port's parameter trees.

The counterpart of ``repro.quant.params``.  ``quantize_params`` replaces
dense projection weights with block-scaled ``QArray``s; the layers pass them
through ``layers.wcast`` into ``core.ops.matmul``, which dequantizes them at
the GEMM (w8a16) or runs the quantized kernel (w8a8).  The port keeps one
dict per layer in a list where the reference stacks layers on a leading
axis, so the walk goes through lists as well as dicts.

Never quantized, as in the reference: norms / biases / 1-D leaves, the
embedding ``table`` (a gather), MLA's ``wkv_b`` (an einsum), any subtree
holding a ``router`` (MoE experts), and a ``w`` that is not 2-D.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.quant.qarray import DEFAULT_BLOCK_K, QArray, quantize_weight

# Dense projection keys across all families (the reference's WEIGHT_KEYS).
WEIGHT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "w_gate", "w_up", "w_down", "w_if", "w"}
)


def _quantizable(key: str, leaf: Any) -> bool:
    if not (key in WEIGHT_KEYS and isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
        return False
    # "w" is the generic dense key: the 2-D lm_head quantizes, the audio
    # frontend's stacked (ncb, d, V) head stays wide.
    if key == "w":
        return leaf.ndim == 2
    return leaf.ndim in (2, 3)


def quantize_params(params: Any, qdtype: str = "int8", *, block_k: int = DEFAULT_BLOCK_K) -> Any:
    """Replace dense projection weights with QArrays (weight-only quant)."""

    def walk(node):
        if isinstance(node, dict):
            if "router" in node:  # MoE expert block: grouped kernel, skip
                return node
            return {
                k: quantize_weight(v, qdtype, block_k=block_k) if _quantizable(k, v) else walk(v)
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def count_quantized(params: Any) -> tuple[int, int]:
    """(n_quantized_leaves, quantized_value_bytes) -- for logging.  One leaf
    per layer's weight here, where the reference counts a stacked leaf once."""
    n = 0
    nbytes = 0

    def walk(node):
        nonlocal n, nbytes
        if isinstance(node, QArray):
            n += 1
            nbytes += node.values.numel() * node.values.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return n, nbytes


def k_major(params: Any) -> Any:
    """Lay every 2-D quantized projection weight out K-major, once: its
    ``values`` stay the same (K, N) tensor of the same values, as a view with
    strides (1, K) over (N, K) row-major storage; ``scales`` are untouched.
    The block-scaled kernel's prefill tile reads 8-bit weights only K-major
    (Hopper's 8-bit ``wgmma`` has no transpose), so the w8a8 weights are laid
    out so when they are quantized for the card; one copy is kept.  The
    ``lm_head`` stays row-major: it is dequantized, never a kernel operand.
    w8a16, which dequantizes every weight, keeps them row-major too."""

    def walk(node):
        if isinstance(node, QArray):
            return dataclasses.replace(node, values=node.values.t().contiguous().t()) if node.ndim == 2 else node
        if isinstance(node, dict):
            return {k: v if k == "lm_head" else walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
