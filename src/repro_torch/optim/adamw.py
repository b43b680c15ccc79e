"""AdamW over the port's parameter trees.

The counterpart of ``repro.optim.adamw``: moments are fp32 whatever the
parameters' dtype, bias-corrected, and the weight decay is decoupled and
applied to the leaves whose counterpart in the reference's tree has two or
more dimensions.  The reference stacks each layer's leaves on a leading axis
where the port keeps a list of layers (``convert.params_from_jax``), so a
leaf under a list has one dimension more there: a layer's norm scale is
(L, d) in the reference, which its AdamW decays, and is decayed here too;
the final norm's scale is 1-D in both and exempt.  The reference's ``adamw_update`` is functional and its
trainer donates the old state to the jitted step; here ``adamw_update``
writes the new parameters and moments into the old tensors, leaf by leaf,
so a full-width model never holds two copies of its state.

On a data-parallel mesh each rank holds only its ZeRO-1 blocks of the
moments (``distributed.data_parallel``) and steps its blocks of the masters
with them; the weight decay then still follows the whole tree's leaves
(``ndims=``), never the blocks' shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import _children, leaves, tree_map


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor  # int32 scalar, on the parameters' device
    mu: Any  # first moment, fp32
    nu: Any  # second moment, fp32


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def reference_ndims(params: Any, stacked: int = 0) -> list[int]:
    """Per leaf of ``params``, in leaf order, the number of dimensions of its
    counterpart in the reference's tree: its own, plus one for each list on
    its path (a list of layers is one stacked axis there)."""
    kids = _children(params)
    if kids is None:
        return [params.ndim + stacked]
    inner = stacked + isinstance(params, list)
    return [n for _, v in kids for n in reference_ndims(v, inner)]


def _step_leaf(g, m, v, p, *, lr, b1, b2, eps, b1c, b2c, weight_decay, ref_ndim) -> None:
    g32 = g.float()
    m.mul_(b1).add_(g32, alpha=1.0 - b1)
    v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
    wd = weight_decay if ref_ndim >= 2 else 0.0
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
    ndims: list[int] | None = None,
) -> tuple[Any, AdamWState]:
    """Steps ``params`` and ``state`` in place and returns them.  ``lr`` may
    be a scalar tensor (the schedule's).  ``ndims``: each leaf's rank in the
    reference's tree, which decides its weight decay (default
    ``reference_ndims(params)``; a caller stepping blocks of the leaves
    passes the whole tree's).  The leaves are stepped one after
    another and the step count last: an error part way leaves some leaves
    stepped, so a caller must not run the update again on that state."""
    step = state.step + 1
    b1c = 1.0 - b1 ** step.float()
    b2c = 1.0 - b2 ** step.float()
    for g, m, v, p, nd in zip(leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params),
                              reference_ndims(params) if ndims is None else ndims, strict=True):
        _step_leaf(g, m, v, p, lr=lr, b1=b1, b2=b2, eps=eps, b1c=b1c, b2c=b2c, weight_decay=weight_decay,
                   ref_ndim=nd)
    state.step.copy_(step)
    return params, state
