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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import torch
from torch.profiler import record_function

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models.registry import Model
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
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


def make_grad_fn(model: Model, tcfg: TrainConfig) -> Callable:
    """-> grads_of(params, batch) -> (grads, metrics): the gradient of
    ``model.loss_fn`` w.r.t. every floating leaf of ``params`` (a tree of
    the params' structure, each gradient in its leaf's dtype, or fp32
    averaged over ``tcfg.microbatches``), and the loss metrics."""

    def one(params, batch):
        flat = leaves(params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in flat]
        with torch.enable_grad():
            with record_function("train_forward"):  # the forward's span in a profiler trace
                loss, metrics = model.loss_fn(unflatten(params, live), batch, remat=tcfg.remat)
            wrt = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = [None if not p.requires_grad else next(got) for p in live]
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
        return unflatten(params, grads), {k: metrics[k].detach() for k in METRICS}

    def grads_of(params, batch):
        if tcfg.microbatches <= 1:
            return one(params, batch)
        g_acc = m_acc = None
        for mb in _split_microbatches(batch, tcfg.microbatches):
            g, m = one(params, mb)
            if g_acc is None:
                g_acc, m_acc = tree_map(lambda x: x.float(), g), m
            else:
                g_acc = tree_map(lambda a, x: a.add_(x.float()), g_acc, g)
                m_acc = {k: m_acc[k] + m[k] for k in METRICS}
            del g
        inv = 1.0 / tcfg.microbatches
        return tree_map(lambda x: x.mul_(inv), g_acc), {k: v * inv for k, v in m_acc.items()}

    return grads_of


def apply_update(tcfg: TrainConfig, params, opt_state, grads, metrics: dict, step) -> tuple[Any, Any, dict]:
    """Clip, the cosine schedule at ``step``, then AdamW, which writes the
    new parameters and moments into ``params`` and ``opt_state``.
    -> (params, opt_state, metrics with grad_norm and lr)."""
    grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
    lr = cosine_with_warmup(step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
                            total_steps=tcfg.total_steps)
    params, opt_state = adamw_update(grads, opt_state, params, lr=lr, weight_decay=tcfg.weight_decay)
    return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """-> train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics).  ``step`` drives the LR schedule; the new parameters and
    moments are written into the old tensors."""
    grads_of = make_grad_fn(model, tcfg)

    def train_step(params, opt_state, batch, step):
        grads, metrics = grads_of(params, batch)
        return apply_update(tcfg, params, opt_state, grads, metrics, step)

    return train_step


class Trainer:
    """Single-controller training harness with restart semantics."""

    def __init__(self, model: Model, tcfg: TrainConfig, params: Any):
        self.model = model
        self.tcfg = tcfg
        self.params = params
        self.opt_state = adamw_init(params)
        self.step = 0
        self.retries = 0
        self._grads_of = make_grad_fn(model, tcfg)
        self._ckpt = AsyncCheckpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None

    # -- fault tolerance ----------------------------------------------------

    def try_resume(self) -> bool:
        """Restore the newest complete checkpoint if one exists."""
        if not self.tcfg.ckpt_dir:
            return False
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        state, step = restore_checkpoint(self.tcfg.ckpt_dir, state, step=step)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    def _checkpoint(self) -> None:
        if self._ckpt is not None:
            self._ckpt.save(self.step, {"params": self.params, "opt": self.opt_state})

    # -- the loop -------------------------------------------------------------

    def run(self, batches: Iterable[dict], n_steps: int, log_every: int = 10) -> dict:
        """Run n_steps.  A gradient computation that fails with a transient
        error is tried again (up to ``max_step_retries`` times, each
        counted); a persistent failure, or any failure of the update,
        re-raises after the checkpoint writer is flushed."""
        it = iter(batches)
        metrics: dict = {}
        t0 = time.perf_counter()
        try:
            for _ in range(n_steps):
                batch = next(it)
                for attempt in range(self.tcfg.max_step_retries + 1):
                    try:
                        grads, metrics = self._grads_of(self.params, batch)
                        break
                    except TRANSIENT_ERRORS as e:
                        if attempt == self.tcfg.max_step_retries:
                            raise
                        self.retries += 1
                        print(f"step {self.step}: retry {attempt + 1} after {type(e).__name__}: {e}")
                        torch.cuda.empty_cache()
                self.params, self.opt_state, metrics = apply_update(
                    self.tcfg, self.params, self.opt_state, grads, metrics, self.step
                )
                del grads
                self.step += 1
                if self.tcfg.ckpt_dir and self.step % self.tcfg.ckpt_every == 0:
                    self._checkpoint()
                if log_every and self.step % log_every == 0:
                    dt = (time.perf_counter() - t0) / log_every
                    t0 = time.perf_counter()
                    print(f"step {self.step:6d}  loss {float(metrics['loss']):8.4f}  "
                          f"lr {float(metrics['lr']):.2e}  {dt * 1e3:7.1f} ms/step")
        except BaseException:
            if self._ckpt:
                self._ckpt.wait()
            raise
        if self._ckpt:
            self._checkpoint()
            self._ckpt.wait()
        return metrics
