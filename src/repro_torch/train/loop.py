"""Training loop: the train step and the fault-tolerant Trainer.

The counterpart of ``repro.train.loop``.  A train step is
  microbatch gradient accumulation (fp32, averaged)
  -> global-norm clip -> the cosine schedule -> AdamW -> metrics
(ce, aux, loss, grad_norm, lr).  Remat (``torch.utils.checkpoint`` around
each layer) is a config flag; the schedule is a pure function of the step,
so a resume needs no LR state.  Gradients come from ``torch.autograd.grad``
over the parameter leaves: on the card every projection's forward and both
of its backward GEMMs are launches of the systolic kernel, and attention is
``models.attention.flash_mha`` (the flash kernel forward, a plain
block-recomputing backward).

The Trainer is the fault-tolerance harness: resume from the newest complete
checkpoint, asynchronous checkpoint writes, stateless data resume
(``batch_at(step)``), and a retry of a step that failed with a transient
error.  The reference retries any runtime error of its runtime; here only
the classes in ``TRANSIENT_ERRORS`` are retried, each retry is counted
(``Trainer.retries``) and printed, and no retry changes what runs.  Only
the gradient computation is retried: it reads the state and writes none of
it.  The update writes the parameters and moments in place, leaf by leaf,
so an error inside it is raised at once.

With a ``mesh`` (one process a rank under ``torch.distributed``) a step is
data-parallel: each rank computes the gradient of its rows of the global
batch, and ``apply_update`` runs the ZeRO-1 exchange of
``distributed.data_parallel`` between the gradient and AdamW (reduce-scatter
into this rank's moment blocks, the global clip, AdamW on the blocks, the
all-gather into every rank's masters).  The retry stays on the gradient
computation, which is this rank's alone; a collective is never retried on
one rank.  Each rank's microbatches are weighted by their loss tokens, so a
masked batch gives the one-process step.  Rank 0 alone logs and writes
checkpoints; a checkpoint holds the whole moments (every rank's blocks sent
to rank 0), so it resumes on any data-parallel mesh, one rank included.

With a "model" axis above 1 (and for a MoE model on any mesh of more than
one rank) the parameters a step takes are this rank's
``TPLayout.shard_train`` shards (``TPLayout.init_shards`` draws them), the
loss is ``TPLayout.loss_fn`` over them, and the exchange runs over the
rank's data group after the leaves replicated over "model" are summed over
its line (``distributed.data_parallel``).  A MoE model's aux loss is the
whole batch's on every rank and enters each rank's objective once
(``make_grad_fn``'s ``aux_once``).  A checkpoint holds whole leaves,
reassembled on rank 0 from the TP shards and the ZeRO blocks, and restores
on any mesh (``TPLayout.cutters``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import torch
from torch.profiler import record_function

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.distributed import data_parallel
from repro_torch.distributed.tp_layout import TPLayout
from repro_torch.launch.mesh import Mesh
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.clip import clip_scale
from repro_torch.optim.schedule import cosine_with_warmup

# Errors after which a step is tried again as it was: the card's allocator
# running out, which a released cache can cure.
TRANSIENT_ERRORS: tuple[type[BaseException], ...] = (torch.cuda.OutOfMemoryError,)
METRICS = ("ce", "aux", "loss")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    clip_norm: float = 1.0
    weight_decay: float = 0.1
    microbatches: int = 1
    remat: bool = False
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    max_step_retries: int = 2


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def r(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return x.reshape(n, b // n, *x.shape[1:])

    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def make_grad_fn(model: Model, tcfg: TrainConfig, loss_fn: Callable | None = None, aux_once: bool = False) -> Callable:
    """-> grads_of(params, batch, weights=None) -> (grads, metrics): the
    gradient of ``loss_fn`` (``model.loss_fn`` by default; a
    ``TPLayout.loss_fn`` on a rank's shards) w.r.t. every floating leaf of
    ``params`` (a tree of the params' structure, each gradient in its leaf's
    dtype, or, over ``tcfg.microbatches``, fp32 and averaged, or summed with
    the float64 ``weights`` of the microbatches), and the loss metrics
    alike.  ``aux_once``: the loss's aux term is the whole batch's, the same
    on every rank, with each rank's gradient of it reaching only its own
    tokens (expert parallelism); with ``weights`` each microbatch's
    objective is then its ce times its weight plus its aux over the
    microbatches, so the ranks' sum is the one-process step's, and the
    gradients come back unweighted (the metrics weighted)."""
    loss_fn = loss_fn or model.loss_fn
    n_micro = max(1, tcfg.microbatches)

    def one(params, batch, weight=None):
        flat = leaves(params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
        with torch.enable_grad():
            with record_function("train_forward"):  # the forward's span in a profiler trace
                loss, metrics = loss_fn(unflatten(params, live), batch, remat=tcfg.remat)
                if weight is not None:
                    loss = metrics["ce"] * weight + metrics["aux"] / n_micro
            wrt = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = [None if not p.requires_grad else next(got) for p in live]
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        return unflatten(params, grads), {k: metrics[k].detach() for k in METRICS}

    def grads_of(params, batch, weights=None):
        inside = aux_once and weights is not None  # the weight enters the objective
        if tcfg.microbatches <= 1 and not inside:
            return one(params, batch)
        g_acc = m_acc = None
        for i, mb in enumerate(_split_microbatches(batch, n_micro)):
            w = None if weights is None else weights[i].to(torch.float32)
            g, m = one(params, mb, w if inside else None)
            if w is not None:
                if not inside:
                    g = tree_map(lambda x: x.float().mul_(w), g)
                m = {k: m[k] * w for k in METRICS}
            if g_acc is None:
                g_acc, m_acc = tree_map(lambda x: x.float(), g), m
            else:
                g_acc = tree_map(lambda a, x: a.add_(x.float()), g_acc, g)
                m_acc = {k: m_acc[k] + m[k] for k in METRICS}
            del g
        if weights is not None:
            return g_acc, m_acc
        inv = 1.0 / tcfg.microbatches
        return tree_map(lambda x: x.mul_(inv), g_acc), {k: v * inv for k, v in m_acc.items()}

    return grads_of


def apply_update(tcfg: TrainConfig, params, opt_state, grads, metrics: dict, step,
                 layout: data_parallel.ZeroLayout | None = None,
                 weight: torch.Tensor | float | None = None) -> tuple[Any, Any, dict]:
    """Clip, the cosine schedule at ``step``, then AdamW, which writes the
    new parameters and moments into ``params`` and ``opt_state``.
    -> (params, opt_state, metrics with grad_norm and lr).  With a
    data-parallel ``layout``, ``grads`` and ``metrics`` are this rank's on its
    rows, to be scaled by ``weight`` (``rank_grads``): the exchange makes
    them the global batch's, and ``opt_state`` holds this rank's moment
    blocks."""
    lr = cosine_with_warmup(step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
                            total_steps=tcfg.total_steps)
    if layout is None:
        grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr, weight_decay=tcfg.weight_decay)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)
    local, metrics = layout.reduce(grads, metrics, weight)
    del grads
    gnorm = layout.global_norm(local)
    scale = clip_scale(gnorm, tcfg.clip_norm)
    for g in local:
        g.mul_(scale)
    adamw_update(local, opt_state, layout.local(params), lr=lr, weight_decay=tcfg.weight_decay, ndims=layout.ndims)
    layout.all_gather_(params)
    return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)


def rank_grads(grads_of: Callable, layout: data_parallel.ZeroLayout | None, model: Model, tcfg: TrainConfig,
               params, batch: dict) -> tuple[Any, dict, torch.Tensor | float | None]:
    """-> (grads, metrics, the weight ``apply_update`` scales them by) on
    ``batch``: without a layout, the whole batch's (weight None); with one,
    this rank's rows of the global batch, each microbatch weighted by its
    loss tokens (``data_parallel.microbatch_weights``; one microbatch's
    weight is left to the exchange, which applies it in fp32)."""
    if layout is None:
        return (*grads_of(params, batch), None)
    local, w = layout.rows(batch, model.cfg, tcfg.microbatches)
    if tcfg.microbatches <= 1 and model.cfg.moe is None:
        return (*grads_of(params, local), w[0])
    return (*grads_of(params, local, w), 1.0)  # a MoE model's weights enter its objective (``aux_once``)


def _mesh_layouts(model: Model, mesh: Mesh | None,
                  params) -> tuple[data_parallel.ZeroLayout | None, TPLayout | None]:
    """(the ZeRO-1 layout, the tensor-parallel layout) of ``mesh``: (None,
    None) without a mesh or on one rank; raises for what is not trained on
    a mesh.  At model > 1 ``params`` are this rank's shards."""
    if mesh is None or mesh.size == 1:
        return None, None
    data_parallel.check_trainable(model.cfg, mesh)
    tp = TPLayout(model.cfg, mesh) if mesh.shape.get("model", 1) > 1 or model.cfg.moe is not None else None
    return data_parallel.ZeroLayout(params, mesh, whole=None if tp is None else tp.whole_shapes(params)), tp


def _layout_grad_fn(model: Model, tcfg: TrainConfig, tp: TPLayout | None) -> Callable:
    """``make_grad_fn`` of the model's loss, or of ``tp``'s (a MoE model's
    aux once a rank)."""
    if tp is None:
        return make_grad_fn(model, tcfg)
    return make_grad_fn(model, tcfg, tp.loss_fn, aux_once=model.cfg.moe is not None)


def make_train_step(model: Model, tcfg: TrainConfig, mesh: Mesh | None = None) -> Callable:
    """-> train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics).  ``step`` drives the LR schedule; the new parameters and
    moments are written into the old tensors.  With a ``mesh``, ``batch`` is
    the global batch, of which this rank computes its rows, and
    ``opt_state`` holds this rank's moment blocks
    (``ZeroLayout(params, mesh).zero_state(params)``); at model > 1
    ``params`` are this rank's ``TPLayout.shard_train`` shards, and the
    layout is given their whole shapes (``whole=TPLayout.whole_shapes``)."""
    made: list = []

    def train_step(params, opt_state, batch, step):
        if not made:
            layout, tp = _mesh_layouts(model, mesh, params)
            made.append((layout, _layout_grad_fn(model, tcfg, tp)))
        layout, grads_of = made[0]
        grads, metrics, weight = rank_grads(grads_of, layout, model, tcfg, params, batch)
        return apply_update(tcfg, params, opt_state, grads, metrics, step, layout, weight)

    return train_step


class Trainer:
    """Single-controller training harness with restart semantics; with a
    ``mesh``, one rank of a (data, model) job (every rank builds one, on the
    same parameters: at model > 1 its ``TPLayout.shard_train`` shards of
    them)."""

    def __init__(self, model: Model, tcfg: TrainConfig, params: Any, mesh: Mesh | None = None):
        self.model = model
        self.tcfg = tcfg
        self.params = params
        self.layout, self.tp = _mesh_layouts(model, mesh, params)  # the ZeRO-1 layout; the tensor-parallel one
        self.whole = None if self.tp is None else self.layout.whole  # the whole leaves' shapes (meta tensors)
        self.leader = self.layout is None or self.layout.rank == 0  # logs and writes checkpoints
        self.opt_state = adamw_init(params) if self.layout is None else self.layout.zero_state(params)
        self.step = 0
        self.retries = 0
        self._grads_of = _layout_grad_fn(model, tcfg, self.tp)
        self._ckpt = AsyncCheckpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir and self.leader else None

    # -- fault tolerance ----------------------------------------------------

    def try_resume(self) -> bool:
        """Restore the newest complete checkpoint if one exists; on a mesh
        each rank cuts its shards and moment blocks out of the whole leaves,
        whatever mesh wrote them."""
        if not self.tcfg.ckpt_dir:
            return False
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        shardings = None
        if self.layout is not None:
            tp_cut = [None] * len(leaves(self.params)) if self.tp is None else leaves(self.tp.cutters(self.whole))
            cut = unflatten(self.params, [
                lambda whole, i=i, first=first: self.layout.cut(i, whole if first is None else first(whole))
                for i, first in enumerate(tp_cut)])
            shardings = {"params": None if self.tp is None else self.tp.cutters(self.whole),
                         "opt": AdamWState(step=None, mu=cut, nu=cut)}
        state, step = restore_checkpoint(self.tcfg.ckpt_dir, state, step=step, shardings=shardings)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    def state(self) -> dict | None:
        """The whole training state a checkpoint holds: the parameters and the
        moments.  On a mesh every rank calls it (each sends its moment blocks
        to its data group's rank 0, and at model > 1 those send their shards
        to rank 0): the whole state on rank 0, None on the others."""
        opt = self.opt_state
        if self.layout is None:
            return {"params": self.params, "opt": opt}
        dev = "cpu" if self.tp is None else leaves(self.params)[0].device  # the TP gather's ranks send from there
        mu, nu = self.layout.gather(opt.mu, self.params, dev), self.layout.gather(opt.nu, self.params, dev)
        params = self.params
        if self.tp is not None:
            if self.layout.idx != 0:
                return None
            params, mu, nu = (self.tp.gather(t, self.whole) for t in (self.params, mu, nu))
        if not self.leader:
            return None
        return {"params": params, "opt": AdamWState(step=opt.step, mu=mu, nu=nu)}

    def _checkpoint(self) -> None:
        if not self.tcfg.ckpt_dir:
            return
        # rank 0 has every rank's blocks, so every rank has reached the save, before it writes (and marks it DONE)
        state = self.state()
        if self._ckpt is not None:
            self._ckpt.save(self.step, state)

    # -- the loop -------------------------------------------------------------

    def run(self, batches: Iterable[dict], n_steps: int, log_every: int = 10) -> dict:
        """Run n_steps on the (global) batches.  A gradient computation that
        fails with a transient error is tried again (up to
        ``max_step_retries`` times, each counted); a persistent failure, or
        any failure of the update, re-raises after the checkpoint writer is
        flushed."""
        it = iter(batches)
        metrics: dict = {}
        t0 = time.perf_counter()
        try:
            for _ in range(n_steps):
                batch = next(it)
                for attempt in range(self.tcfg.max_step_retries + 1):
                    try:
                        grads, metrics, weight = rank_grads(self._grads_of, self.layout, self.model, self.tcfg,
                                                            self.params, batch)
                        break
                    except TRANSIENT_ERRORS as e:
                        if attempt == self.tcfg.max_step_retries:
                            raise
                        self.retries += 1
                        print(f"step {self.step}: retry {attempt + 1} after {type(e).__name__}: {e}")
                        torch.cuda.empty_cache()
                self.params, self.opt_state, metrics = apply_update(
                    self.tcfg, self.params, self.opt_state, grads, metrics, self.step, self.layout, weight
                )
                del grads
                self.step += 1
                if self.tcfg.ckpt_dir and self.step % self.tcfg.ckpt_every == 0:
                    self._checkpoint()
                if log_every and self.step % log_every == 0:
                    dt = (time.perf_counter() - t0) / log_every
                    t0 = time.perf_counter()
                    if self.leader:
                        print(f"step {self.step:6d}  loss {float(metrics['loss']):8.4f}  "
                              f"lr {float(metrics['lr']):.2e}  {dt * 1e3:7.1f} ms/step")
        except BaseException:
            if self._ckpt:
                self._ckpt.wait()
            raise
        if self.tcfg.ckpt_dir:
            self._checkpoint()
        if self._ckpt:
            self._ckpt.wait()
        return metrics
