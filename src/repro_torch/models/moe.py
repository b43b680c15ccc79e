"""Mixture-of-Experts: top-k router + sort-based capacity dispatch + grouped GEMM.

The counterpart of ``repro.models.moe``.  Dispatch is the sort-based
"dropping" formulation: flatten the (token, choice) slots, sort them by
expert (stably), number each slot within its expert, copy the tokens into a
dense (G, E, C, d) buffer, run the three expert GEMMs through
``core.ops.grouped_matmul`` (on the card the hand-written grouped kernel),
and combine each token's slots weighted by its router probabilities.

Tokens fall into ``dispatch_groups`` independent groups, each with its own
capacity, as in the reference; the reference vmaps the per-group functions,
here they take the group axis as their leading dimension.  A slot past its
expert's capacity is dropped: JAX's scatter drops it through
``mode="drop"``, torch has no such mode, so dispatch sends it to a spare row
that is cut off and combine masks it to zero.  The reference's sharding
constraints have no counterpart on one card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": layers._dense_init(gen, d, e, dtype),
        "w_gate": layers._dense_init(gen, d, ff, dtype, lead=(e,)),
        "w_up": layers._dense_init(gen, d, ff, dtype, lead=(e,)),
        "w_down": layers._dense_init(gen, ff, d, dtype, lead=(e,)),
    }
    if m.n_shared_experts:
        p["shared"] = layers.init_swiglu(gen, d, ff * m.n_shared_experts, dtype)
    return p


def _round_up(x: int, q: int) -> int:
    """Smallest multiple of q >= x (a copy of ``repro.core.blocking.round_up``)."""
    return (x + q - 1) // q * q


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    """Per-expert slot budget: ceil(T*k/E * cf), rounded up to a multiple of
    8, at least 8.  Ceiled before the round-up, as in the reference."""
    m = cfg.moe
    c = math.ceil(tokens_per_group * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, _round_up(c, 8))


def _sort_slots(flat_e: torch.Tensor, e: int):
    """The dispatch's sort of G groups' slots.  flat_e: (G, n) int64, each
    slot's expert in flat (token, choice) order.  -> (order, se, pos, counts):
    order, se and pos are (G, n) in expert-sorted slot order (the sort is
    stable, as ``jnp.argsort``): the slot's index in the flat order, its
    expert, its place within the expert; counts (G, E) int32 each expert's
    slots."""
    g, n = flat_e.shape
    dev = flat_e.device
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    # Place within the expert: rank minus the expert's first rank; the
    # expert's count: the next expert's first rank minus its own.
    bounds = torch.searchsorted(se, torch.arange(e + 1, device=dev).expand(g, e + 1).contiguous(), out_int32=True)
    pos = torch.arange(n, device=dev) - bounds[:, :-1].gather(-1, se)
    return order, se, pos, bounds.diff(dim=-1)


def _dispatch_group(xf: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor, cap: int, cfg: ArchConfig):
    """Sort-based dispatch of G groups at once.  xf: (G, T, d); top_e, top_w:
    (G, T, k).  -> (xdisp (G, E, C, d), se, pos, order, sw, rows): se, pos,
    order and sw are (G, T*k) in expert-sorted slot order: the slot's expert,
    its place within the expert, its index in the flat (token, choice) order
    (so its token is ``order // k``), and its router weight in ``xf.dtype``;
    rows (G, E) int32 is min(count, C), each expert's number of leading
    capacity rows that hold a token (the rest of xdisp is zeros), which lets
    the grouped kernel skip empty rows."""
    m = cfg.moe
    g, t, d = xf.shape
    k, e = m.top_k, m.n_experts
    dev = xf.device
    flat_w = top_w.reshape(g, t * k).to(xf.dtype)
    order, se, pos, counts = _sort_slots(top_e.reshape(g, t * k).long(), e)
    rows = counts.clamp_(max=cap)

    # Kept slots go to row (group, expert, pos) of a flat buffer, dropped ones
    # all to one spare last row, which is cut off (its value is not defined).
    groups = torch.arange(g, device=dev)[:, None]
    dest = torch.where(pos < cap, (groups * e + se) * cap + pos, g * e * cap)
    src = xf.reshape(g * t, d)[(groups * t + order // k).reshape(-1)]
    buf = xf.new_zeros((g * e * cap + 1, d))
    buf.index_copy_(0, dest.reshape(-1), src)
    xdisp = buf[:-1].view(g, e, cap, d)
    return xdisp, se, pos, order, flat_w.gather(-1, order), rows


def _combine_group(out: torch.Tensor, se: torch.Tensor, pos: torch.Tensor, order: torch.Tensor,
                   sw: torch.Tensor, t: int, cap: int, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of dispatch.  out: (G, E, C, d) expert outputs -> (G, T, d).

    The sort is inverted, so each token's k slots sit side by side in choice
    order; each slot's output (zero if it was dropped) is weighted in
    ``dtype``, as in the reference, and the k of them are summed in fp32 by
    one reduction over the choice axis, then cast to ``dtype``.  No atomics
    (the reference's scatter-add would be ``index_add_``, which adds in
    ``dtype`` in a run-dependent order on the card), so the sum is the same
    on every run.
    """
    g, n = order.shape
    k, d = n // t, out.shape[-1]
    inv = torch.empty_like(order).scatter_(-1, order, torch.arange(n, device=order.device).expand(g, n))
    e_f, p_f, w_f = se.gather(-1, inv), pos.gather(-1, inv), sw.gather(-1, inv)
    keep = (p_f < cap).to(dtype)
    groups = torch.arange(g, device=out.device)[:, None]
    slot_y = out[groups, e_f, p_f.clamp(max=cap - 1)] * keep[..., None]  # (G, T*k, d)
    slot_y = slot_y * w_f[..., None]
    return slot_y.reshape(g, t, k, d).sum(dim=2, dtype=torch.float32).to(dtype)


def _topk_shardable(probs: torch.Tensor, k: int):
    """Top-k as the reference computes it: k rounds of (max, argmax), each
    masking its winner to zero.  Ties go to the lowest index (``torch.max``
    over a dimension returns the first maximal index, as ``jnp.argmax``
    does).  -> (weights (..., k), experts (..., k) int64)."""
    rest = probs.clone()
    ws, es = [], []
    for _ in range(k):
        w, e = torch.max(rest, dim=-1)
        ws.append(w)
        es.append(e)
        rest.scatter_(-1, e[..., None], 0.0)
    return torch.stack(ws, dim=-1), torch.stack(es, dim=-1)


def moe_fwd(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """x: (B, S, d) -> (y, aux_loss).  Capacity-dropping top-k MoE."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    g = m.dispatch_groups
    if t % g:
        raise ValueError(f"tokens {t} not divisible by dispatch_groups {g}")
    tg = t // g
    xf = x.reshape(t, d)

    # --- route (fp32 for numerics) -----------------------------------------
    logits = ops.matmul(xf, layers.wcast(params["router"], xf.dtype), out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    top_w, top_e = _topk_shardable(probs, m.top_k)  # (T, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # --- aux load-balance loss (Switch eq. 4-6) -----------------------------
    experts = torch.arange(m.n_experts, device=x.device)
    frac_tokens = (top_e[:, :1] == experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = m.aux_loss_weight * m.n_experts * (frac_tokens * frac_probs).sum()

    # --- grouped sort-based dispatch ----------------------------------------
    cap = capacity(tg, cfg)
    xdisp, se, pos, order, sw, rows = _dispatch_group(
        xf.reshape(g, tg, d), top_e.reshape(g, tg, m.top_k), top_w.reshape(g, tg, m.top_k), cap, cfg
    )

    # --- expert compute: grouped GEMMs --------------------------------------
    # Rows past an expert's count are zero in xdisp, so in gate and up, and
    # silu(0) * 0 = 0 keeps them zero in h: all three products may skip them.
    wdt = x.dtype
    gate = ops.grouped_matmul(xdisp, params["w_gate"].to(wdt), rows=rows)
    up = ops.grouped_matmul(xdisp, params["w_up"].to(wdt), rows=rows)
    h = F.silu(gate.float()).to(wdt) * up
    out = ops.grouped_matmul(h, params["w_down"].to(wdt), rows=rows)  # (G, E, C, d)

    # --- combine --------------------------------------------------------------
    y = _combine_group(out, se, pos, order, sw, tg, cap, x.dtype).reshape(t, d)
    if m.n_shared_experts:
        y = y + layers.swiglu(params["shared"], xf)
    return y.reshape(b, s, d), aux
