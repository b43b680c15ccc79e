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
quantized them (every one but ``wkv_b``).  The SSM family's ``mlstm`` and
``slstm`` stacks and the hybrid's ``mamba`` stack cross the same way, each
a list of per-layer blocks, and the hybrid's ``shared`` attention block as
one block.  The frontends' leaves cross whole: the audio codec's
``embed.tables`` (n_codebooks, V, d) and stacked ``lm_head.w``
(n_codebooks, d, V), the vit ``projector`` (``norm``, ``w1``, ``w2``); a
tied model has no ``lm_head``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import FP32_KEYS
from repro_torch.models.transformer import check_supported, hybrid_counts, xlstm_counts
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
    them on every call to the same values; the leaves of
    ``layers.FP32_KEYS`` (RMSNorm ``scale`` vectors, the recurrent blocks'
    fp32 parameters) stay fp32, as in the reference; quantized weights keep
    their storage dtype.  The stacks (``layers``; ``mlstm`` and ``slstm``;
    ``mamba``) become lists in stack order, their lengths checked against
    the config; the hybrid's ``shared`` block crosses as one block."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)

    def convert(node, layer: int | None = None):
        if _is_qarray(node):
            return _qarray(node, layer, dev)
        if isinstance(node, dict):
            return {
                k: (_leaf(v, layer, torch.float32) if k in FP32_KEYS else convert(v, layer))
                for k, v in node.items()
            }
        return _leaf(node, layer, dt)

    def _leaf(arr, layer, to_dtype):
        a = np.asarray(arr)
        if layer is not None:
            a = a[layer]
        # widen first: numpy has no bf16, and bf16 -> fp32 is exact
        return torch.tensor(np.asarray(a, dtype=np.float32)).to(dev, to_dtype)

    def stack(key: str, want: int) -> list:
        """A stacked (N, ...) subtree -> N per-layer dicts, in stack order."""
        tree = np_params[key]
        n = np.asarray(tree["norm" if key != "layers" else "attn_norm"]["scale"]).shape[0]
        if n != want:
            raise ValueError(f"{cfg.name}: tree has {n} stacked {key!r} layers, config says {want}")
        return [convert(tree, i) for i in range(n)]

    out = {"final_norm": convert(np_params["final_norm"]), "embed": convert(np_params["embed"])}
    for key in ("lm_head", "projector"):  # no lm_head when tied; a projector for vit only
        if key in np_params:
            out[key] = convert(np_params[key])
    if cfg.family == "ssm":
        n_groups, n_m = xlstm_counts(cfg)
        if n_m:
            out["mlstm"] = stack("mlstm", n_groups * n_m)
        out["slstm"] = stack("slstm", n_groups)
    elif cfg.family == "hybrid":
        out["mamba"] = stack("mamba", hybrid_counts(cfg)[0])
        out["shared"] = convert(np_params["shared"])
    else:
        out["layers"] = stack("layers", cfg.n_layers)
    return out
