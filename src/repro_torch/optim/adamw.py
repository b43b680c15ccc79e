"""AdamW over the port's parameter trees.

The counterpart of ``repro.optim.adamw``: moments are fp32 whatever the
parameters' dtype, bias-corrected, and the weight decay is decoupled and
applied to tensors of two or more dimensions only (norm scales and biases
are exempt).  The reference's ``adamw_update`` is functional and its
trainer donates the old state to the jitted step; here ``adamw_update``
writes the new parameters and moments into the old tensors, leaf by leaf,
so a full-width model never holds two copies of its state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar, on the parameters' device
    mu: Any  # first moment, fp32
    nu: Any  # second moment, fp32


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _step_leaf(g, m, v, p, *, lr, b1, b2, eps, b1c, b2c, weight_decay) -> None:
    g32 = g.float()
    m.mul_(b1).add_(g32, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
    wd = weight_decay if p.ndim >= 2 else 0.0
    delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: AdamWState,
    params: Any,
    *,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> tuple[Any, AdamWState]:
    """Steps ``params`` and ``state`` in place and returns them.  ``lr`` may
    be a scalar tensor (the schedule's).  The leaves are stepped one after
    another and the step count last: an error part way leaves some leaves
    stepped, so a caller must not run the update again on that state."""
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    for g, m, v, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params), strict=True):
        _step_leaf(g, m, v, p, lr=lr, b1=b1, b2=b2, eps=eps, b1c=b1c, b2c=b2c, weight_decay=weight_decay)
    state.step.copy_(step)
    return params, state
