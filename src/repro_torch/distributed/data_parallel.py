"""Data-parallel training with ZeRO-1 optimizer state, one process a rank.

The reference trains over a ("data", "model") mesh by handing GSPMD the
shardings: the batch over ("pod", "data"), the fp32 masters TP-sharded over
"model" and replicated over "data", the fp32 AdamW moments sharded over
both (``zero1_specs``).  GSPMD then derives the exchange.  This module
writes it out, one process a rank:

  the batch     rank r of dp takes rows [r B/dp, (r+1) B/dp) of the global
                batch (``sharding.batch_specs``); a batch that does not
                divide raises, no row is padded.  The ranks of a "model"
                line take the same rows.
  the model     at model > 1 (and for a MoE model on any mesh) each rank
                holds its ``TPLayout.shard_train`` shards and computes the
                loss laid out over its line (``distributed.tp_layout``).  A leaf sharded over "model"
                gets its whole gradient on its rank; a leaf replicated over
                it gets a partial one (the norms see the rank's token rows,
                wk / wv its query heads' use of its KV columns, an
                indivisible head or table its rows), all-reduced over the
                line in fp32 before the exchange.
  the gradient  each leaf that ``zero1_specs`` shards over "data" is
                reduce-scattered over the rank's data group into this rank's
                block of its shard, each leaf it leaves replicated
                (indivisible) is all-reduced there; both in fp32.  Each of
                the rank's microbatches is weighted by its loss tokens over
                those of the global microbatch it lies in
                (``microbatch_weights``), so the sum over the ranks is the
                one-process step's mean of per-microbatch masked means: the
                reference's ``_ce`` over the whole batch with one microbatch.
  the clip      the global norm: each element's square counted once over
                both axes (a block sharded over "data" summed over the data
                group, a leaf sharded over "model" over the line).
  AdamW         each rank steps its blocks of the masters with its moment
                blocks, the weight decay decided by the *whole* tree's leaf
                ranks (``optim.adamw.reference_ndims``); a replicated leaf is
                stepped alike on every rank.
  the gather    the updated blocks are all-gathered over the data group into
                every rank's masters, so after a step the ranks of a data
                group hold bitwise equal shards and a leaf replicated over
                "model" is bitwise equal on every rank.

Where a leaf sits in a list of layers (the reference's stacked axis), its
block is cut from the leaf with that axis put back (``leaf.unsqueeze(0)``,
spec the stacked one): the rank owning a layer holds a (1, ...) block of
it, the others a (0, ...) block, so the blocks of a path concatenated over
its layers are the rank's slice of the stacked leaf.  Every rank owns the
same number of elements, so the sharded leaves travel as one flat fp32
buffer of ``dp x shard_numel``: one reduce-scatter and one all-gather a
step.  NCCL moves card tensors; on Gloo (the CPU, or two ranks sharing one
card) a card tensor goes through host memory, and the reduce-scatter is an
fp32 all-reduce of the whole buffer (``collective_matmul.reduce_scatter_rows``).

A MoE model trains through ``TPLayout`` at any mesh of more than one rank
(at model = 1 too): its aux loss is a product of batch means and its expert
capacity is counted over a dispatch group of the global batch, so the
layout pools the ranks' routing (``distributed.expert_parallel``) and every
rank holds the batch's aux.  Its gradient reaches each rank's own tokens,
so the aux enters each rank's objective once, not weighted by the rank's
share of the loss tokens (``train.loop.make_grad_fn``'s ``aux_once``), and
the data group's sum is the whole gradient.  With microbatches the ranks
step through the global microbatches together: rank r's k-th microbatch is
global microbatch k's r-th part (``ZeroLayout.rows``), so each microbatch's
routing is pooled over its own rows.  At model > 1 whatever ``TPLayout``
does not lay out is refused.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core.tree import _children, leaves, unflatten
from repro_torch.distributed.collective_matmul import all_gather_rows, all_reduce_, reduce_scatter_rows
from repro_torch.distributed.sharding import batch_specs, shard_of, zero1_specs
from repro_torch.distributed.tp_layout import TPLayout
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.optim.adamw import AdamWState, reference_ndims


def data_size(mesh: Mesh) -> int:
    """The number of data-parallel ranks: the product of the batch axes."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def data_index(mesh: Mesh, rank: int) -> int:
    """``rank``'s place on the batch axes (row-major over them)."""
    coords = mesh.coords(rank)
    idx = 0
    for a in batch_axes(mesh):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def check_trainable(cfg, mesh: Mesh) -> None:
    """Raise for what this module does not train: at a "model" axis above 1,
    and for a MoE model on more than one rank, what ``TPLayout`` does not
    lay out (its message)."""
    if mesh.shape.get("model", 1) > 1 or (cfg.moe is not None and mesh.size > 1):
        TPLayout(cfg, mesh)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch(batch: dict, mesh: Mesh, rank: int | None = None) -> dict:
    """``rank``'s rows of the global ``batch`` (this process's by default):
    each leaf cut on dim 0 as ``sharding.batch_specs`` shards it.  Raises
    when the batch does not divide over the data ranks."""
    dp = data_size(mesh)
    if dp == 1:
        return batch
    rank = _rank() if rank is None else rank
    specs = batch_specs(batch, mesh)
    for k, v in batch.items():
        if specs[k][0] is None:
            raise ValueError(f"batch leaf {k!r} of {v.shape[0]} rows does not divide over {dp} data ranks (rows are "
                             f"never padded): make the global batch a multiple of {dp}")
    return {k: shard_of(v, specs[k], mesh, rank) for k, v in batch.items()}


def microbatch_weights(batch: dict, cfg, dp: int, microbatches: int) -> torch.Tensor:
    """(dp, microbatches) float64 weights, on the labels' device, of each
    data rank's microbatches of the global ``batch``: a microbatch's loss
    tokens (every label, or the loss mask's sum, broadcast over the codebooks
    of an audio model) over those of the global microbatch holding its rows.
    Global microbatch m is rows [m B/n, (m+1) B/n), as the one-process step
    splits it; rank r's k-th microbatch is part (r n + k) of B / (dp n) rows,
    which lies in global microbatch (r n + k) // dp.  The weighted sum of
    the ranks' microbatch means is then the one-process step's mean over the
    microbatches of each one's masked mean."""
    labels, mask = batch["labels"], batch.get("loss_mask")
    parts = dp * microbatches
    if labels.shape[0] % parts:
        raise ValueError(f"batch {labels.shape[0]} not divisible by {dp} data ranks x {microbatches} microbatches")
    if mask is None:
        tokens = torch.full((parts,), labels.numel() / parts, dtype=torch.float64, device=labels.device)
    else:
        if cfg.frontend == "audio_codec":
            mask = mask[..., None].expand(labels.shape)
        tokens = mask.reshape(parts, -1).double().sum(1)
    per_global = tokens.view(microbatches, dp).sum(1).clamp_min(1.0).repeat_interleave(dp)
    return (tokens / (microbatches * per_global)).view(dp, microbatches)


@dataclasses.dataclass(frozen=True)
class _Place:
    stacked: bool  # held in a list of layers: blocks carry the layer axis
    dim: int | None  # the data-sharded dimension of the (stacked) view; None: replicated
    blocks: tuple[tuple[int, int], ...]  # (start, length) along ``dim``, per data rank


def _placed(tree, layers: int | None = None, index: int = 0):
    """(leaf, layers, index) of every leaf in ``core.tree`` order: the length
    of the innermost list of layers holding it and its index there."""
    if isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _placed(v, len(tree), i)
        return
    kids = _children(tree)
    if kids is None:
        yield tree, layers, index
        return
    for _, v in kids:
        yield from _placed(v, layers, index)


def _axes(entry) -> set:
    return set(entry if isinstance(entry, tuple) else (entry,))


class ZeroLayout:
    """Where each parameter leaf's optimizer state lives on a (data, model)
    mesh, and the exchange of one step.  ``params`` gives the structure and
    this rank's shapes (at model > 1 its ``TPLayout.shard_train`` shards,
    and ``whole`` the whole leaves' shapes, ``TPLayout.whole_shapes``);
    ``rank`` is this process's (``dist.get_rank()`` by default)."""

    def __init__(self, params: Any, mesh: Mesh, rank: int | None = None, whole: Any = None):
        self.mesh, self.dp, self.tp = mesh, data_size(mesh), mesh.shape.get("model", 1)
        self.whole = whole
        self.rank = _rank() if rank is None else rank
        self.idx = data_index(mesh, self.rank)
        self.data_ranks = mesh.axis_ranks(batch_axes(mesh), self.rank)  # data index -> process rank, this line
        self.ndims = reference_ndims(params)
        baxes = set(batch_axes(mesh))
        self.places: list[_Place] = []
        self.model_sharded: list[bool] = []  # the leaf is cut over "model" (its gradient whole on this rank)
        for (leaf, layers, index), spec in zip(_placed(params), leaves(zero1_specs(params if whole is None else whole,
                                                                                   mesh)), strict=True):
            self.model_sharded.append(self.tp > 1 and any("model" in _axes(ax) for ax in spec))
            shape = (1, *leaf.shape) if layers is not None else tuple(leaf.shape)
            dims = [d for d, ax in enumerate(spec) if _axes(ax) & baxes]
            if not dims or self.dp == 1:
                self.places.append(_Place(layers is not None, None, ()))
                continue
            (d,) = dims
            if layers is not None and d == 0:  # whole layers to each rank: this one to its owner
                owner = index // (layers // self.dp)
                blocks = tuple((0, 1 if j == owner else 0) for j in range(self.dp))
            else:
                size = shape[d] // self.dp
                blocks = tuple((j * size, size) for j in range(self.dp))
            self.places.append(_Place(layers is not None, d, blocks))
        # the flat exchange buffer: rank j's chunk holds its blocks of the sharded leaves, in leaf order
        self.parts: list[list[tuple[int, int, int]]] = []  # per rank: (leaf, offset, numel)
        for j in range(self.dp):
            off, part = 0, []
            for i, (leaf, _, _) in enumerate(_placed(params)):
                p = self.places[i]
                if p.dim is None:
                    continue
                n = math.prod(self._view(i, leaf).narrow(p.dim, *p.blocks[j]).shape)
                part.append((i, off, n))
                off += n
            self.parts.append(part)
        sizes = {sum(n for _, _, n in part) for part in self.parts}
        if len(sizes) > 1:  # zero1_specs shards a dim only where it divides: never taken
            raise RuntimeError(f"ZeRO-1 blocks of unequal sizes {sizes} over {self.dp} data ranks")
        self.shard_numel = sizes.pop() if sizes else 0
        self.replicated = [i for i, p in enumerate(self.places) if p.dim is None]
        self.model_replicated = [i for i, m in enumerate(self.model_sharded) if self.tp > 1 and not m]
        self._marks: dict[str, object] = {}  # CUDA events on the card, host-clock seconds on the CPU

    # -- blocks -------------------------------------------------------------

    def _view(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        return leaf.unsqueeze(0) if self.places[i].stacked else leaf

    def block(self, i: int, leaf: torch.Tensor, j: int | None = None) -> torch.Tensor:
        """Data rank ``j``'s block of leaf ``i`` (this rank's by default): a
        view, the whole (stacked) view for a replicated leaf."""
        p = self.places[i]
        v = self._view(i, leaf)
        return v if p.dim is None else v.narrow(p.dim, *p.blocks[self.idx if j is None else j])

    def local(self, tree: Any) -> list[torch.Tensor]:
        """This rank's block of every leaf of a tree of the params'
        structure, in leaf order (views)."""
        return [self.block(i, leaf) for i, leaf in enumerate(leaves(tree))]

    def zeros(self, params: Any) -> Any:
        """A tree of the params' structure holding fp32 zeros of this rank's
        blocks: its ZeRO-1 moments."""
        return unflatten(params, [torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                                  for b in self.local(params)])

    def cut(self, i: int, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i`` cut from its whole value (a copy)."""
        return self.block(i, whole).clone()

    def shardings(self, params: Any) -> Any:
        """A tree of the params' structure whose leaves cut this rank's block
        out of a whole leaf: ``restore_checkpoint(shardings=...)`` for a
        moment tree."""
        return unflatten(params, [lambda whole, i=i: self.cut(i, whole) for i in range(len(self.places))])

    def zero_state(self, params: Any) -> AdamWState:
        """AdamW's initial state with this rank's moment blocks."""
        step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
        return AdamWState(step=step, mu=self.zeros(params), nu=self.zeros(params))

    def rows(self, batch: dict, cfg, microbatches: int = 1) -> tuple[dict, torch.Tensor]:
        """This rank's rows of the global ``batch`` and the weight of each of
        its ``microbatches`` (``microbatch_weights``).  A MoE model's ranks
        take their microbatches interleaved: rank r's k-th is part (k dp + r)
        of dp x microbatches, the r-th part of global microbatch k."""
        weights = microbatch_weights(batch, cfg, self.dp, microbatches)
        if cfg.moe is None or microbatches <= 1 or self.dp == 1:
            return local_batch(batch, self.mesh, self.rank), weights[self.idx]
        n = microbatches
        return ({k: v.reshape(n, self.dp, -1, *v.shape[1:])[:, self.idx].reshape(-1, *v.shape[1:])
                 for k, v in batch.items()}, weights.reshape(n, self.dp)[:, self.idx])

    # -- collectives --------------------------------------------------------

    def _group(self):
        """The rank's data group (the world at model = 1)."""
        if not dist.is_initialized() or dist.get_world_size() != self.mesh.size:
            raise RuntimeError(f"{self.mesh!r}: one process a rank, {self.mesh.size} of them, under "
                               f"torch.distributed (torchrun --nproc-per-node {self.mesh.size} ...)")
        return self.mesh.group(batch_axes(self.mesh))

    def _all_reduce(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum ``x`` in place over the rank's data group (``axis`` "model":
        its "model" line); a no-op on a line of one rank."""
        if axis == "model":
            return x if self.tp == 1 else all_reduce_(x, self.mesh.group("model"))
        return x if self.dp == 1 else all_reduce_(x, self._group())

    def _mark(self, name: str, device: torch.device) -> None:
        if device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._marks[name] = e
        else:
            self._marks[name] = time.perf_counter()

    def exchange_ms(self) -> dict[str, float]:
        """The last step's reduce (metrics, reduce-scatter, all-reduce) and
        all-gather, in ms: CUDA events on the card (this waits for them), the
        host clock on the CPU."""
        out = {}
        for name in ("reduce", "all_gather"):
            a, b = self._marks.get(f"{name}0"), self._marks.get(f"{name}1")
            if a is None or b is None:
                continue
            if isinstance(a, torch.cuda.Event):
                b.synchronize()
                out[name] = a.elapsed_time(b)
            else:
                out[name] = (b - a) * 1e3
        return out

    def reduce(self, grads: Any, metrics: dict, weight: torch.Tensor | float) -> tuple[list[torch.Tensor], dict]:
        """This rank's gradients (a tree) and metrics on its rows of the
        batch, each to be scaled by ``weight`` (its share of the global
        batch, ``microbatch_weights``) -> (the global batch's gradient at
        this rank's blocks, fp32, in leaf order; its metrics)."""
        g = leaves(grads)
        dev = g[0].device
        self._mark("reduce0", dev)
        if self.model_replicated:  # partial on each rank of the "model" line: summed there first
            flat = self._all_reduce(torch.cat([g[i].float().reshape(-1) for i in self.model_replicated]), "model")
            off = 0
            for i in self.model_replicated:
                g[i] = flat[off:off + g[i].numel()].view(g[i].shape)
                off += g[i].numel()
        weight = torch.as_tensor(weight, dtype=torch.float64, device=dev)
        stats = torch.stack([weight * metrics[k].double() for k in ("ce", "aux", "loss")])
        self._all_reduce(stats)
        out = dict(metrics, **{k: stats[n].float() for n, k in enumerate(("ce", "aux", "loss"))})
        weight = weight.float()
        s = self.shard_numel
        send = torch.empty(self.dp * s, dtype=torch.float32, device=dev)
        for j, part in enumerate(self.parts):
            for i, off, n in part:
                b = self.block(i, g[i], j)
                send[j * s + off:j * s + off + n].view(b.shape).copy_(b)
        send.mul_(weight)
        mine = send if self.dp == 1 else reduce_scatter_rows(send, self._group(), self.dp, self.idx)
        del send
        local: list[torch.Tensor | None] = [None] * len(g)
        for i, off, n in self.parts[self.idx]:
            local[i] = mine[off:off + n].view(self.block(i, g[i]).shape)
        if self.replicated:
            flat = torch.cat([g[i].float().reshape(-1) for i in self.replicated]).mul_(weight)
            self._all_reduce(flat)
            off = 0
            for i in self.replicated:
                shape = self._view(i, g[i]).shape
                local[i] = flat[off:off + math.prod(shape)].view(shape)
                off += math.prod(shape)
        self._mark("reduce1", dev)
        return local, out

    def global_norm(self, local: list[torch.Tensor]) -> torch.Tensor:
        """sqrt of the global gradient's sum of squares, each element once: a
        block sharded over "data" summed over the data group, a leaf sharded
        over "model" over the line, a leaf replicated over both (alike on
        every rank) taken as it is."""
        dev = local[0].device
        sq = torch.zeros(4, dtype=torch.float32, device=dev)  # over data: model-sharded, replicated; not over data
        for i, _, _ in self.parts[self.idx]:
            sq[0 if self.model_sharded[i] else 1] += local[i].square().sum()
        for i in self.replicated:
            sq[2 if self.model_sharded[i] else 3] += local[i].square().sum()
        self._all_reduce(sq[:2])
        if self.tp > 1:
            both = torch.stack([sq[0], sq[2]])
            self._all_reduce(both, "model")
            sq[0], sq[2] = both[0], both[1]
        return torch.sqrt(sq.sum())

    def all_gather_(self, params: Any) -> Any:
        """Every rank's updated blocks into this rank's masters, in place."""
        p = leaves(params)
        s = self.shard_numel
        if s == 0:
            return params
        dev = p[0].device
        self._mark("all_gather0", dev)
        mine = torch.empty(s, dtype=torch.float32, device=dev)
        for i, off, n in self.parts[self.idx]:
            b = self.block(i, p[i])
            mine[off:off + n].view(b.shape).copy_(b)
        got = mine if self.dp == 1 else all_gather_rows(mine, self._group(), self.dp)
        del mine
        for j, part in enumerate(self.parts):
            if j == self.idx:
                continue
            for i, off, n in part:
                b = self.block(i, p[i], j)
                b.copy_(got[j * s + off:j * s + off + n].view(b.shape))
        self._mark("all_gather1", dev)
        return params

    def gather(self, local_tree: Any, params: Any, device: str | torch.device = "cpu") -> Any | None:
        """A tree of per-rank blocks (a moment tree) -> its whole leaves on
        ``device`` on data rank 0, None on the others.  Every rank calls it:
        each sends its blocks to rank 0 as one flat fp32 buffer, which rank 0
        receives one rank at a time into a buffer of that size, so no rank
        holds more than its own share beside the whole leaves rank 0 builds,
        and rank 0 returns only once every rank has reached the call."""
        loc = leaves(local_tree)
        s = self.shard_numel
        mine = torch.empty(s, dtype=torch.float32, device=loc[0].device)
        for i, off, n in self.parts[self.idx]:
            mine[off:off + n].copy_(loc[i].reshape(-1))
        group = self._group()
        host = mine.is_cuda and dist.get_backend(group) == dist.Backend.GLOO  # Gloo moves host tensors only
        if host:
            mine = mine.cpu()
        if self.idx != 0:
            if s:
                dist.send(mine, self.data_ranks[0], group=group)
            return None
        p = leaves(params)
        whole = [torch.empty(t.shape, dtype=b.dtype, device=device) for t, b in zip(p, loc)]
        for i in self.replicated:
            self._view(i, whole[i]).copy_(loc[i])
        buf = torch.empty_like(mine) if s else None
        for j, part in enumerate(self.parts):
            if not s:
                break
            if j == 0:
                got = mine
            else:
                dist.recv(buf, self.data_ranks[j], group=group)
                got = buf
            got = got.to(device)
            for i, off, n in part:
                b = self.block(i, whole[i], j)
                b.copy_(got[off:off + n].view(b.shape))
        return unflatten(params, whole)

    def moment_bytes(self, state) -> int:
        """The bytes of this rank's moments."""
        return sum(t.numel() * t.element_size() for t in leaves(state.mu) + leaves(state.nu))
