"""Expert parallelism for the MoE decoder, written out.

The reference cuts the expert stacks (E, ., .) over "model" and places two
``constrain``s around the grouped GEMMs (``repro.models.moe.moe_fwd``):
GSPMD then builds the (G, E, C, d) dispatch buffer batch-sharded and turns
it into an all-to-all onto the experts' ranks, and back.  The port has no
such compiler, so this module writes that exchange out, one process a rank,
for a layer's MoE block on the rows the tensor-parallel layout
(``distributed.tp_layout``) holds:

  routing    each rank routes its own stream rows: the router is one K1
             launch with fp32 out, then the softmax and the reference's
             top-k (``moe._topk_shardable``)
  the sort   the (T, k) expert ids are all-gathered over the ranks whose rows
             make up the batch (the whole mesh when its data lines hold
             different rows, as in training; the "model" line when every line
             serves the same batch), and every rank runs the one-device sort
             (``moe._sort_slots``) on the whole routing: so each rank knows
             every slot's (group, expert, position), whether it is kept
             (position < ``capacity(T / G)``, decided over the global batch as
             the reference decides it) and every split size of the exchange,
             and no counts are traded
  exchange   each kept slot's row goes to the "model" rank of its line that
             owns its expert (rank i owns experts [i E/tp, (i+1) E/tp); the
             experts are replicated over "data"), one ``all_to_all_single``
             with split sizes; its backward is the reverse exchange
             (``_Exchange``)
  experts    the owner packs each of its experts' received rows first into
             an (E/tp, C', d) buffer -- C' = capacity x the dispatch groups
             the line's tokens touch, so no expert overflows it -- and runs
             the three K4 launches (``core.ops.grouped_matmul``) with ``rows``
             its counts; the reverse exchange returns the outputs
  combine    the token's rank weights each kept slot's output by its router
             weight in the compute dtype and sums its k slots in fp32, as
             ``moe._combine_group`` does; a dropped slot adds zero
  aux        the one-hot of each token's first choice and its router
             probabilities are summed over the ranks and divided by the global
             T (``collective_matmul.sum_over_ranks``: its gradient reaches
             each rank's own tokens unreduced), so every rank holds the
             reference's aux loss

Everything but the exchange is index arithmetic on the gathered routing,
the same on every rank (``plan``).  Gloo moves host memory only: a card
tensor's exchange goes through a host copy, as the rings' hops do.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.distributed import collective_matmul as cm
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers, moe
from repro_torch.models.config import ArchConfig


class ExchangeLog:
    """What each MoE block's exchange moved, when ``on``: one entry a block,
    {"kept", "dropped" (the global routing's slots), "send_rows",
    "recv_rows", "rows" (each local expert's received rows), "cap" (C'),
    "bytes" (this rank's rows sent and received, both exchanges), "ms" (the
    two exchanges: CUDA events on the card, which ``entries`` waits for; the
    host clock elsewhere)}."""

    def __init__(self):
        self.on = False
        self._entries: list[dict] = []

    def clear(self) -> None:
        self._entries = []

    def add(self, entry: dict) -> None:
        if self.on:
            self._entries.append(entry)

    def entries(self) -> list[dict]:
        out = []
        for e in self._entries:
            e = dict(e)
            marks = e.pop("marks", [])
            ms = 0.0
            for a, b in marks:
                if isinstance(a, torch.cuda.Event):
                    b.synchronize()
                    ms += a.elapsed_time(b)
                else:
                    ms += (b - a) * 1e3
            out.append(dict(e, ms=ms))
        return out


LOG = ExchangeLog()


def _mark(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _all_to_all(x: torch.Tensor, group, send: list[int], recv: list[int]) -> torch.Tensor:
    """Rows ``send[j]`` of ``x`` (in order) to rank j of ``group``, ``recv[j]``
    rows from it -> the received rows, by source rank.  Gloo: a card tensor
    through a host copy."""
    if dist.get_backend(group) == dist.Backend.GLOO and x.is_cuda:
        out = torch.empty((sum(recv), *x.shape[1:]), dtype=x.dtype)
        dist.all_to_all_single(out, x.cpu(), output_split_sizes=recv, input_split_sizes=send, group=group)
        return out.to(x.device)
    out = x.new_empty((sum(recv), *x.shape[1:]))
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv, input_split_sizes=send, group=group)
    return out


class _Exchange(torch.autograd.Function):
    """The exchange under autograd: its transpose is the reverse exchange,
    each row's gradient sent back to the rank it came from."""

    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, send, recv
        return _all_to_all(x, group, send, recv)

    @staticmethod
    def backward(ctx, dy):
        return _all_to_all(dy, ctx.group, ctx.recv, ctx.send), None, None, None


def exchange(x: torch.Tensor, group, send: list[int], recv: list[int]) -> torch.Tensor:
    """``_all_to_all``, differentiable (``_Exchange``) when ``x`` wants a
    gradient; the identity on a group of one rank."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Exchange.apply(x, group, send, recv)
    return _all_to_all(x, group, send, recv)


@dataclasses.dataclass
class Plan:
    """One rank's part of one MoE block's exchange (``plan``)."""
    send_rows: torch.Tensor  # (n_send,) the rank's stream rows, in send order
    send_slots: torch.Tensor  # (n_send,) their slot (row * k + choice) on this rank, for the combine
    send: list[int]  # rows to each "model" rank of the line
    recv: list[int]  # rows from each
    recv_dest: torch.Tensor  # (n_recv,) each received row's place in the packed (E/tp * C', d) buffer
    rows: torch.Tensor  # (E/tp,) int32: each local expert's received rows (its leading rows of the buffer)
    cap: int  # C', the packed buffer's rows an expert
    kept: int  # the global routing's kept slots
    dropped: int  # and dropped ones


def plan(top_e: torch.Tensor, cfg: ArchConfig, *, line0: int, m_line: int, r: int, tp: int, idx: int) -> Plan:
    """Rank ``idx`` of a "model" line's exchange for one MoE block, from the
    global routing ``top_e`` (T, k) (every token of the batch, in order).
    The line's tokens are [line0, line0 + m_line), rank j holding its rows
    [j r, (j+1) r); the experts are cut into tp blocks.  Runs the one-device
    sort on the whole routing, so a slot is kept exactly when
    ``moe._dispatch_group`` keeps it on one card.  Every slot the line keeps
    goes from its token's rank to its expert's, in (expert, group, position)
    order; the owner packs each expert's rows in that order.  Pure index
    arithmetic, the same on every rank of the line but for ``idx``; one host
    read (the split sizes)."""
    m = cfg.moe
    e, k, g = m.n_experts, m.top_k, m.dispatch_groups
    t = top_e.shape[0]
    if t % g:
        raise ValueError(f"tokens {t} not divisible by dispatch_groups {g}")
    if e % tp:
        raise ValueError(f"{cfg.name}: {e} experts do not divide over tp={tp}")
    tg, el = t // g, e // tp
    cap = moe.capacity(tg, cfg)
    dev = top_e.device
    order, _, pos, _ = moe._sort_slots(top_e.reshape(g, tg * k).long(), e)
    pos = torch.empty_like(pos).scatter_(-1, order, pos).reshape(t * k)  # each slot's place, flat order
    kept = pos < cap
    lo, hi = line0 * k, (line0 + m_line) * k  # the line's slots
    slot = torch.arange(lo, hi, device=dev)
    ex, sel = top_e.reshape(-1)[lo:hi].long(), kept[lo:hi].nonzero().squeeze(1)
    key = (ex[sel] * g + (slot[sel] // k) // tg) * (tg * k) + pos[lo:hi][sel]
    sel = sel[torch.argsort(key)]  # the line's kept slots in (expert, group, position) order
    ex = ex[sel]
    q = torch.arange(sel.numel(), device=dev) - torch.searchsorted(ex, ex)  # place among its expert's rows
    owner, src = ex // el, sel // k // r
    mine = src == idx
    send = sel[mine]
    theirs = (owner == idx).nonzero().squeeze(1)
    theirs = theirs[torch.argsort(src[theirs], stable=True)]  # by source rank, each source's in its send order
    counts = torch.cat([torch.bincount(owner[mine], minlength=tp), torch.bincount(src[theirs], minlength=tp),
                        kept.sum().view(1)]).tolist()
    groups = (line0 + m_line - 1) // tg - line0 // tg + 1  # the dispatch groups the line's tokens touch
    c = groups * cap
    return Plan(send_rows=send // k - idx * r, send_slots=send - idx * r * k, send=counts[:tp],
                recv=counts[tp:2 * tp], recv_dest=(ex[theirs] - idx * el) * c + q[theirs],
                rows=torch.bincount(ex, minlength=e)[idx * el:(idx + 1) * el].to(torch.int32),
                cap=c, kept=counts[-1], dropped=t * k - counts[-1])


class ExpertParallel:
    """One rank's side of the MoE blocks over a mesh: its experts, the
    "model" line it exchanges with, and the ranks whose routing it pools."""

    def __init__(self, cfg: ArchConfig, mesh: Mesh, axis: str = "model"):
        m = cfg.moe
        if m is None:
            raise ValueError(f"{cfg.name}: no MoE block")
        if mesh.axis_names[-1] != axis:
            raise ValueError(f"{mesh!r}: expert parallelism takes {axis!r} as the mesh's last axis")
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.tp = mesh.shape[axis]
        if m.n_experts % self.tp:
            raise ValueError(f"{cfg.name}: {m.n_experts} experts do not divide over tp={self.tp}")
        if m.n_shared_experts:
            raise NotImplementedError(f"{cfg.name}: shared experts are not laid out over a mesh (no config of the "
                                      f"zoo has one)")
        self.idx = mesh.axis_index(axis)
        self.el = m.n_experts // self.tp

    def _pool(self, whole_mesh: bool):
        """(group, ranks in it, this rank's line among them) whose routing a
        block pools: the mesh (its lines hold different rows) or the line."""
        if whole_mesh and self.mesh.size > 1:
            return self.mesh.group(tuple(self.mesh.axis_names)), self.mesh.size, dist.get_rank() // self.tp
        return (self.mesh.group(self.axis) if self.tp > 1 else None), self.tp, 0

    def block(self, p: dict, x: torch.Tensor, m_line: int, *, train: bool):
        """The MoE block on this rank's (R, d) stream rows, with ``p`` its
        shards (the rank's E/tp experts, the whole router), of which the
        line's first ``m_line`` rows in rank order are tokens (the rest pad,
        which routes nowhere and gets zero) -> (y (R, d), the aux loss, None
        when serving).  ``train``: the mesh's lines hold different rows of
        the batch, whose routing is pooled, and the aux loss is computed;
        serving, every line serves the same batch.  Every rank of the pool
        calls it in the same order."""
        m = self.cfg.moe
        r, d = x.shape
        k, dt = m.top_k, x.dtype
        if p["w_gate"].shape[0] != self.el:
            raise ValueError(f"expert stacks of {p['w_gate'].shape[0]} experts; this rank holds {self.el}")
        group, n, line = self._pool(train)
        logits = ops.matmul(x, layers.wcast(p["router"], dt), out_dtype=torch.float32)
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = moe._topk_shardable(probs, k)
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        valid = max(0, min(r, m_line - self.idx * r))
        t = m_line * (n // self.tp)
        out_aux = None
        if train:
            stats = torch.stack([F.one_hot(top_e[:valid, 0], m.n_experts).float().sum(0), probs[:valid].sum(0)])
            if group is not None:
                stats = cm.sum_over_ranks(stats, group)
            out_aux = m.aux_loss_weight * m.n_experts * ((stats[0] / t) * (stats[1] / t)).sum()
        routing = top_e.to(torch.int32)
        if group is not None:
            routing = cm.all_gather_rows(routing, group, n)
            j = torch.arange(n, device=x.device)[:, None]
            at = torch.arange(r, device=x.device)[None]
            routing = routing[(j * r + at)[at < (m_line - (j % self.tp) * r).clamp(0, r)]]
        pl = plan(routing, self.cfg, line0=line * m_line, m_line=m_line, r=r, tp=self.tp, idx=self.idx)
        lg = self.mesh.group(self.axis) if self.tp > 1 else None
        marks = []
        t0 = _mark(x.device) if LOG.on else None
        recv = exchange(x[pl.send_rows], lg, pl.send, pl.recv)
        if LOG.on:
            marks.append((t0, _mark(x.device)))
        buf = x.new_zeros((self.el * pl.cap, d)).index_copy(0, pl.recv_dest, recv).view(self.el, pl.cap, d)
        gate = ops.grouped_matmul(buf, p["w_gate"].to(dt), rows=pl.rows)
        up = ops.grouped_matmul(buf, p["w_up"].to(dt), rows=pl.rows)
        h = F.silu(gate.float()).to(dt) * up
        out = ops.grouped_matmul(h, p["w_down"].to(dt), rows=pl.rows)
        t0 = _mark(x.device) if LOG.on else None
        back = exchange(out.reshape(-1, d)[pl.recv_dest], lg, pl.recv, pl.send)
        if LOG.on:
            marks.append((t0, _mark(x.device)))
            LOG.add({"kept": pl.kept, "dropped": pl.dropped, "send_rows": sum(pl.send), "recv_rows": sum(pl.recv),
                     "rows": pl.rows.tolist(), "cap": pl.cap,
                     "bytes": 2 * (sum(pl.send) + sum(pl.recv)) * d * x.element_size(), "marks": marks})
        slot_y = x.new_zeros((r * k, d)).index_copy(0, pl.send_slots, back) * top_w.to(dt).reshape(-1, 1)
        return slot_y.reshape(r, k, d).sum(dim=1, dtype=torch.float32).to(dt), out_aux
