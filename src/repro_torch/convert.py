"""Carry a parameter tree of the JAX package over to the port.

The reference stacks per-layer parameters on a leading axis (for
``lax.scan``); the port keeps a list with one dict per layer.  The tree comes
in as numpy arrays (``jax.tree.map(np.asarray, params)``), so this module
imports no JAX.  Quantized leaves (the reference's ``QArray``, recognised by
its ``values`` / ``scales`` / ``block`` / ``qdtype`` fields) become the port's
``QArray`` with their storage dtype kept: int8 stays int8, and fp8 crosses as
its ``uint8`` bit pattern (numpy's ``ml_dtypes`` fp8 has no ``torch.from_numpy``
counterpart) viewed back as ``torch.float8_e4m3fn``.  A MoE layer's
``ffn`` (``router`` (L, d, E), ``w_gate`` / ``w_up`` (L, E, d, ff), ``w_down``
(L, E, ff, d), an optional ``shared`` SwiGLU) crosses like any other stacked
weight, and the qk-norm scales like every RMSNorm scale.  So does an MLA
layer's ``attn`` (``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``,
``wkv_b``, ``wo``), its projections as ``QArray``s where the reference
quantized them (every one but ``wkv_b``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import check_supported
from repro_torch.quant.qarray import QArray, canonical_qdtype, qdtype_info

_QARRAY_FIELDS = ("values", "scales", "block", "qdtype")


def _is_qarray(node) -> bool:
    return all(hasattr(node, f) for f in _QARRAY_FIELDS)


def _qarray(node, layer: int | None, dev: torch.device) -> QArray:
    qdtype = canonical_qdtype(node.qdtype)
    storage, _ = qdtype_info(qdtype)
    values = np.asarray(node.values)
    scales = np.asarray(node.scales, dtype=np.float32)
    if layer is not None:
        values, scales = values[layer], scales[layer]
    # np.array copies: the tensors must not alias the (read-only) source arrays.
    if storage == torch.int8:
        v = torch.from_numpy(np.array(values, dtype=np.int8))
    else:
        v = torch.from_numpy(np.array(values).view(np.uint8)).view(storage)
    return QArray(
        values=v.to(dev),
        scales=torch.from_numpy(np.array(scales)).to(dev),
        block=tuple(int(b) for b in node.block),
        qdtype=qdtype,
    )


def params_from_jax(
    np_params: dict,
    cfg: ArchConfig,
    device: str | torch.device | None = None,
    dtype: torch.dtype | None = None,
) -> dict:
    """numpy parameter tree of ``repro`` -> the port's parameters on ``device``
    (default: the card).  Projection weights and the embedding are cast once
    to ``dtype`` (default: the config's compute dtype) -- the reference casts
    them on every call to the same values; RMSNorm ``scale`` vectors stay
    fp32, as in the reference; quantized weights keep their storage dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)

    def convert(node, layer: int | None = None):
        if _is_qarray(node):
            return _qarray(node, layer, dev)
        if isinstance(node, dict):
            return {
                k: (_leaf(v, layer, torch.float32) if k == "scale" else convert(v, layer))
                for k, v in node.items()
            }
        return _leaf(node, layer, dt)

    def _leaf(arr, layer, to_dtype):
        a = np.asarray(arr)
        if layer is not None:
            a = a[layer]
        # widen first: numpy has no bf16, and bf16 -> fp32 is exact
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(dev, to_dtype)

    stacked = np_params["layers"]
    n = np.asarray(stacked["attn_norm"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"{cfg.name}: tree has {n} stacked layers, config says {cfg.n_layers}")
    return {
        "final_norm": convert(np_params["final_norm"]),
        "embed": convert(np_params["embed"]),
        "lm_head": convert(np_params["lm_head"]),
        "layers": [convert(stacked, i) for i in range(n)],
    }
