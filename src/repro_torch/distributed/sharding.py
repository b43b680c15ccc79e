"""Sharding rules: the paper's balance equations at the mesh level.

The counterpart of ``repro.distributed.sharding``: the same name rules
give each leaf a spec, a tuple with one entry per dimension -- None, a mesh
axis name, or a tuple of axis names -- equal, leaf for leaf, to the
reference's ``PartitionSpec`` on the same tree.  How each tensor family
splits over ("pod", "data", "model"):

  batch / activations   ("pod", "data")   pure DP across pods
  weights, column dim   "model"           TP: up-projections column-sharded,
                                          down/out-projections row-sharded
  MoE experts, E dim    "model"           EP, plus FSDP "data" unless the
                                          ``moe-tp-expert`` option is set
  KV caches             heads -> "model"  or sequence -> "model" when the
                                          arch has fewer KV heads than TP

A dimension that does not divide its axes is left unsharded.  The reference
hands the specs to GSPMD; the port cuts each rank's contiguous shard out of
the full tensors (``shard_params``) and writes the layout out
(``distributed.tp_layout``).

The port's trees keep one dict per layer in a list where the reference
stacks the layers on a leading axis.  A leaf held in such a list gets the
reference's spec of the stacked leaf: its first entry is the layer axis
(the list), None but where ZeRO-1 shards the layers over "data".
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core import hw
from repro_torch.launch.mesh import Mesh, batch_axes

# Column-parallel (output dim -> "model").
_COL = {
    "wq", "w_gate", "w_up", "wq_a", "wq_b", "wkv_a", "wkv_b",
    "w1", "in_proj", "w_x", "w_if",
}
# Row-parallel (input dim -> "model").
_ROW = {"wo", "w_down", "w2", "out_proj"}
# KV projections: replicated (GQA head counts rarely divide TP).
_REPL = {"wk", "wv"}


def _expert_spec() -> tuple:
    """MoE expert stacks (E, D, F) / (E, F, D): EP over "model" always; the
    FSDP "data" dim is dropped under the ``moe-tp-expert`` option."""
    from repro_torch.models.modelflags import opt

    if opt("moe-tp-expert"):
        return ("model", None, None)
    return ("model", "data", None)


def _axis_size(mesh: Mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(mesh.shape[a] for a in ax)
    return mesh.shape[ax]


def _entry(axes: tuple[str, ...]):
    """A spec entry for several axes: the name alone when there is one (as a
    ``PartitionSpec`` normalizes it), None when there is none."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _drop_indivisible(spec: tuple, shape: tuple[int, ...], mesh: Mesh) -> tuple:
    """Leave a dim unsharded when it does not divide its axis product."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        out.append(ax if ax is not None and dim % _axis_size(mesh, ax) == 0 else None)
    return tuple(out)


def _map_with_path(fn, tree, prefix: str = "", layers: int | None = None):
    """``fn(path, leaf, layers)`` over a tree of dicts and lists -> a tree of
    that structure; ``path`` joins the keys and indices with "/", and
    ``layers`` is the length of the list of layers that holds the leaf (the
    reference's stacked axis), None outside one."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k), layers) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i), len(tree)) for i, v in enumerate(tree)]
    return fn(prefix, tree, layers)


def _shape(leaf, layers: int | None = None) -> tuple[int, ...]:
    """The leaf's shape, as the reference stacks it when a list of
    ``layers`` holds it."""
    return tuple(leaf.shape) if layers is None else (layers, *leaf.shape)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param_rule(path: str, shape: tuple[int, ...]) -> tuple:
    """Base spec for the *unstacked* parameter shape: weights TP-sharded over
    "model" only (the "data" axis holds optimizer state, ZeRO-1), but the MoE
    expert stacks, which keep an FSDP "data" dim."""
    name = path.split("/")[-1]
    nd = len(shape)

    if name == "table":  # embedding (V, D): vocab-parallel
        return ("model", None)
    if name == "tables":  # audio (ncb, V, D)
        return (None, "model", None)
    if name == "router":  # (D, E): small, feeds a top-k -> replicate
        return (None, None)
    if name == "conv_w":  # (K, C): channel-shard
        return (None, "model")
    if name == "r_h":  # sLSTM recurrent (nh, hd, 4hd)
        return ("model", None, None)
    if name in _REPL:
        return (None,) * nd
    if name in _COL:
        if nd == 3:  # MoE expert stack (E, D, F)
            return _expert_spec()
        return (None, "model")
    if name in _ROW:
        if nd == 3:  # (E, F, D)
            return _expert_spec()
        return ("model", None)
    if name == "w":  # generic dense: lm_head (D, V) / audio heads (ncb, D, V): vocab-parallel only
        if nd == 3:
            return (None, None, "model")
        return (None, "model")
    # 1D (norm scales, biases, gates) and anything unknown: replicate.
    return (None,) * nd


def param_specs(params: Any, mesh: Mesh) -> Any:
    """Same-structure tree of specs for a parameter tree (leaves with a
    ``shape``: tensors, or anything shaped like one)."""

    def rule(path, leaf, layers):
        base = _param_rule(path, tuple(leaf.shape))
        return _drop_indivisible(base if layers is None else (None, *base), _shape(leaf, layers), mesh)

    return _map_with_path(rule, params)


def zero1_specs(params: Any, mesh: Mesh) -> Any:
    """ZeRO-1 optimizer-state specs: the parameter spec plus a "data" shard
    on the first free divisible dim, the layer axis included (a leaf already
    data-sharded, as the MoE experts are, keeps its spec)."""
    baxes = batch_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in baxes) or 1
    specs = param_specs(params, mesh)

    def add_data(path, leaf, layers):
        shape = _shape(leaf, layers)
        spec = _get(specs, path)
        dims = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for ax in dims:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        if used & set(baxes):
            return tuple(dims)
        for i, ax in enumerate(dims):
            if ax is None and shape[i] % dsize == 0 and dsize > 1:
                dims[i] = _entry(baxes)
                break
        return tuple(dims)

    return _map_with_path(add_data, params)


def _get(tree, path: str):
    for part in path.split("/") if path else ():
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def batch_specs(batch: Any, mesh: Mesh) -> Any:
    """Shard the leading (global batch) dim over ("pod", "data")."""
    baxes = _entry(batch_axes(mesh))
    return _map_with_path(
        lambda path, leaf, _: _drop_indivisible((baxes, *([None] * (leaf.ndim - 1))), tuple(leaf.shape), mesh),
        batch)


# ---------------------------------------------------------------------------
# Decode caches / recurrent states
# ---------------------------------------------------------------------------


def _cache_rule(name: str, shape: tuple[int, ...], mesh: Mesh, baxes) -> tuple:
    """Base spec for one layer's cache leaf (first dim the batch B except
    ``pos``'s, which is replicated).  KV heads over "model" when they
    divide, else the sequence (SP-decode)."""
    nd = len(shape)
    tp = mesh.shape.get("model", 1)
    if name == "pos":
        return (None,) * nd
    b = shape[0]
    b_ok = b % _axis_size(mesh, baxes) == 0 if baxes else False
    bspec = baxes if b_ok else None

    if name in ("k", "v") and nd == 4:  # (B, T, H, hd)
        t, h = shape[1], shape[2]
        if h % tp == 0:
            return (bspec, None, "model", None)
        if t % tp == 0:
            return (bspec, "model", None, None)
        return (bspec, None, None, None)
    if name in ("c_kv", "k_rope") and nd == 3:  # MLA latents (B, T, r)
        t = shape[1]
        return (bspec, "model" if t % tp == 0 else None, None)
    if name == "ssm" and nd == 4:  # mamba2 (B, nh, P, N)
        return (bspec, "model", None, None)
    if name == "C" and nd == 4:  # mLSTM matrix memory (B, nh, hd, hd)
        return (bspec, "model", None, None)
    if name == "conv" and nd == 3:  # (B, K-1, C)
        return (bspec, None, "model")
    if name in ("c", "n", "m", "h"):
        if nd == 2:  # sLSTM scalars (B, d)
            return (bspec, "model")
        if nd == 3:  # mLSTM n (B, nh, hd)
            return (bspec, "model", None)
        return (bspec,) + (None,) * (nd - 1)
    return (bspec,) + (None,) * (nd - 1)


def cache_specs(cache: Any, mesh: Mesh) -> Any:
    """Cache trees from ``transformer.init_cache`` (one dict per layer)."""
    baxes = _entry(batch_axes(mesh))

    def rule(path, leaf, layers):
        base = _cache_rule(path.split("/")[-1], tuple(leaf.shape), mesh, baxes)
        return _drop_indivisible(base if layers is None else (None, *base), _shape(leaf, layers), mesh)

    return _map_with_path(rule, cache)


# ---------------------------------------------------------------------------
# Each rank's shard
# ---------------------------------------------------------------------------


def block_of(full: torch.Tensor, spec: tuple, mesh: Mesh, rank: int) -> torch.Tensor:
    """``rank``'s block of ``full`` under ``spec``, a view: each sharded
    dimension cut into equal blocks along its axes (several axes: row-major
    over them)."""
    coords = mesh.coords(rank)
    out = full
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        size = full.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def shard_of(full: torch.Tensor, spec: tuple, mesh: Mesh, rank: int) -> torch.Tensor:
    """``rank``'s contiguous shard of ``full`` under ``spec`` (``block_of``),
    materialized row-major, the layout the unsharded weight has on the
    kernel's path (a column block of a (K, N) weight would otherwise be a
    strided view)."""
    out = block_of(full, spec, mesh, rank)
    return out.contiguous() if out is full else out.clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, specs: Any, mesh: Mesh, rank: int) -> Any:
    """A tree of ``params``' structure holding ``rank``'s shard of each leaf
    (``shard_of``; a replicated leaf is the full tensor, not a copy).  A
    leaf of a list of layers is cut by its spec past the layer axis, which
    must be unsharded (ZeRO-1's specs shard it: optimizer state, not
    served weights)."""
    from repro_torch.quant.qarray import QArray

    def cut(path, leaf, layers):
        if isinstance(leaf, QArray):
            raise NotImplementedError(f"{path}: tensor-parallel serving takes fp weights; a quantized leaf has no "
                                      f"shard rule")
        spec = _get(specs, path)
        if layers is not None:
            if spec[0] is not None:
                raise ValueError(f"{path}: spec {spec} shards the layer axis")
            spec = spec[1:]
        return leaf if all(a is None for a in spec) else shard_of(leaf, spec, mesh, rank)

    return _map_with_path(cut, params)


# ---------------------------------------------------------------------------
# Mesh-level balance report (the eq.-14 argument at the NVLink level)
# ---------------------------------------------------------------------------


def mesh_balance_report(n_params: int, global_batch: int, seq: int, mesh: Mesh, chip: hw.GPU | str | None = None):
    """Per-step gradient all-reduce bytes per card against the 6ND compute
    per card on the H100: the paper's stall-free condition for the
    data-parallel axis, over one NVLink link as the reference prices one ICI
    link."""
    chip = hw.get_chip(chip)
    dp = math.prod(mesh.shape[a] for a in batch_axes(mesh)) or 1
    tp = mesh.shape.get("model", 1)
    tokens = global_batch * seq
    flops_per_chip = 6 * n_params * tokens / (dp * tp)
    grad_bytes = 2 * n_params / tp  # bf16 grads, TP-sharded
    ar_bytes = 2 * grad_bytes * (dp - 1) / dp  # ring all-reduce over dp
    t_compute = flops_per_chip / chip.peak_flops()
    t_coll = ar_bytes / chip.nvlink_bw_per_link
    return {
        "t_compute_s": t_compute,
        "t_allreduce_s": t_coll,
        "ratio": t_coll / t_compute if t_compute else float("inf"),
        "balanced": t_coll <= t_compute,
    }
