"""Mesh-level systolic GEMM: tensor parallelism with overlapped collectives.

The counterpart of ``repro.distributed.collective_matmul``.  The paper's
third array dimension replicates dot-product layers until the chip is
busy; this module is the same replication argument one level up: the
per-card systolic kernel (K1) is replicated across the "model" axis of a
mesh, and each copy stays busy because the inter-card traffic hides under
its block products.  Two sharded GEMM forms cover the transformer's
projections, each taking and returning *local* shards, one process a rank
(``torch.distributed``):

  ``all_gather_matmul``      A row-sharded (M/tp, K), B column-sharded
                             (K, N/tp) -> Y column-sharded (M, N/tp).
  ``reduce_scatter_matmul``  A column-sharded (M, K/tp), B row-sharded
                             (K/tp, N) -> Y row-sharded (M/tp, N).

Each runs ``tp`` ring steps, and every step is one K1 launch
(``kernels/systolic/ops.matmul``).  At each step the next hop is issued
first -- one ``batch_isend_irecv`` holding the send to the ring successor
and the receive from the predecessor -- then the block product is launched,
and only then is the hop waited on.  On NCCL the hop runs on NCCL's own
stream, which waits for the work queued before it, and ``wait`` makes the
current stream wait for the hop, so the product queued in between runs
under the transfer; a host ``synchronize`` or a wait placed before the
launch would remove the overlap without an error.  A buffer being sent is
never the one being received into: the all-gather ring alternates two
receive buffers (the caller's A is only ever sent), the reduce-scatter ring
swaps its carry with a spare once the carry's send has completed.
``overlap=False`` is the unoverlapped baseline: an all-gather then one K1
launch, or one fp32 K1 launch then a reduce-scatter.

Transport.  NCCL carries card tensors between cards, one card a rank.  Gloo
carries host memory only: on a Gloo group a card tensor's hop and
collectives go through a host copy (``_Ring``, ``all_gather_rows``,
``reduce_scatter_rows``), one explicit branch chosen by the group's backend,
never on failure; it serves the one-card check in which two ranks share a
card.  On the CPU (the tests) Gloo moves the tensors themselves.

Numerics: each ring step accumulates in fp32 as the single-card kernel does;
``reduce_scatter_matmul`` carries its cross-shard partial sums in fp32 and
casts once at the end, as the reference does.

Block plans: the ring step's problem is (M/tp, N/tp, K) or (M/tp, N, K/tp),
so the plan cache keys the *global* problem with ``tp`` (schema v2) and
clamps a hit to the step's problem (``tune.cache.tuned_block``).  Order per
call: explicit ``block`` > tp-keyed cache entry > the kernel's shape rule.

``tensor_parallel(mesh)`` is the opt-in context under which
``core.ops.matmul`` routes eligible projections through ``maybe_tp_matmul``
(replicated operands in, the replicated product out).  Served tensor
parallelism lays its shards out itself (``distributed.tp_layout``).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.distributed as dist

from repro_torch.core import hw
from repro_torch.core.blocking import BlockPlan
from repro_torch.kernels.systolic import ops as systolic_ops
from repro_torch.launch.mesh import Mesh
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import profile as _obs_profile
from repro_torch.obs import trace as _obs_trace

DIRECTIONS = ("plus", "minus")
MODES = ("allgather", "reducescatter")


def _hop_step_model(tp: int, m: int, n: int, k: int, dtype, hop_bytes: int) -> tuple[float, float]:
    """(t_hop, t_step) under the card model: one ring hop's transfer over
    every NVLink link of the card (the NVSwitch fabric reaches the ring
    successor through all of them) and one ring step's shard-GEMM time at
    the operands' tensor-core peak."""
    chip = hw.get_chip(None)
    t_hop = hop_bytes / (chip.nvlink_bw_per_link * chip.nvlink_links)
    step_flops = 2.0 * (m // tp) * n * k / tp  # one ring step's shard GEMM
    t_step = step_flops / chip.peak_flops(dtype)
    return t_hop, t_step


def _record_dispatch(mode: str, tp: int, m: int, n: int, k: int, dtype, overlap: bool, hop_bytes: int) -> None:
    """Telemetry for one sharded-GEMM dispatch: calls, ring hops and hop
    bytes, and the modeled overlap ratio t_hop / t_step (< 1: each hop
    hides under its block product), ``kind="modeled"``."""
    if not _obs_metrics.enabled():
        return
    hops = tp - 1 if overlap else 0
    _obs_metrics.inc("collective.calls", mode=mode)
    _obs_metrics.inc("collective.hops", hops, mode=mode)
    _obs_metrics.inc("collective.hop_bytes", hop_bytes * hops, mode=mode)
    t_hop, t_step = _hop_step_model(tp, m, n, k, dtype, hop_bytes)
    ratio = t_hop / t_step if t_step > 0 else float("inf")
    _obs_metrics.set_gauge("collective.overlap_ratio", ratio, mode=mode, kind="modeled")


def _record_measured(mode: str, tp: int, m: int, n: int, k: int, dtype, hop_bytes: int, wall_s: float) -> None:
    """The measured counterpart of the modeled gauge, from a sampled window
    around the whole sharded GEMM (host clock to the card's finishing it):
    whatever the wall shows beyond ``tp`` modeled ring steps is exposed
    communication, so the ratio is exposed / hops / t_step, comparable to
    the modeled t_hop / t_step."""
    if not _obs_metrics.enabled():
        return
    hops = tp - 1
    if hops <= 0:
        return
    _, t_step = _hop_step_model(tp, m, n, k, dtype, hop_bytes)
    if t_step <= 0:
        return
    exposed_per_hop = max(0.0, wall_s - tp * t_step) / hops
    _obs_metrics.set_gauge("collective.overlap_ratio", exposed_per_hop / t_step, mode=mode, kind="measured")
    _obs_metrics.observe("collective.wall_us", wall_s * 1e6, mode=mode, tp=tp)


# ---------------------------------------------------------------------------
# Tensor-parallel context (consulted by core.ops.matmul)
# ---------------------------------------------------------------------------

_TP = contextvars.ContextVar("repro_torch_tensor_parallel", default=None)


@contextlib.contextmanager
def tensor_parallel(mesh: Mesh, axis: str = "model"):
    """Route eligible ``core.ops.matmul`` calls through ``maybe_tp_matmul``.

    Inside this context every projection whose shapes divide the ``axis``
    size runs as an overlapped ``all_gather_matmul`` over ``mesh``;
    everything else falls through to the single-card kernel unchanged."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {axis!r}")
    token = _TP.set((mesh, axis))
    try:
        yield
    finally:
        _TP.reset(token)


def current_tensor_parallel() -> tuple[Mesh, str] | None:
    """The active (mesh, axis) pair, or None outside ``tensor_parallel``."""
    return _TP.get()


# ---------------------------------------------------------------------------
# Transport: the ring hop and the unoverlapped collectives
# ---------------------------------------------------------------------------


def transport(mesh: Mesh, axis: str = "model", device: str | torch.device = "cuda") -> str:
    """How the ``axis`` ring moves tensors on ``device``: "nccl", "gloo" or
    "gloo-host" (card tensors through host copies)."""
    backend = str(dist.get_backend(mesh.group(axis)))
    return "gloo-host" if backend == "gloo" and torch.device(device).type == "cuda" else backend


@functools.cache
def _ring(mesh: Mesh, axis: str, direction: str) -> "_Ring":
    """The ring of ``axis`` in ``direction``, made once a mesh (its process
    group and peers do not change)."""
    return _Ring(mesh, axis, direction)


class _Ring:
    """This rank's place on the ring of ``axis``: its index, the successor
    it sends to and the predecessor it receives from (``_ring_perm``'s
    direction), as global ranks, and whether its hops go through the host."""

    def __init__(self, mesh: Mesh, axis: str, direction: str):
        self.tp = mesh.shape[axis]
        self.direction = direction
        self.idx = mesh.axis_index(axis)
        self.group = mesh.group(axis) if self.tp > 1 else None
        self.gloo = self.tp > 1 and dist.get_backend(self.group) == dist.Backend.GLOO
        if self.tp > 1:
            ranks = mesh.axis_ranks(axis, dist.get_rank())
            perm = dict(_ring_perm(self.tp, direction))
            self.send_to = ranks[perm[self.idx]]
            self.recv_from = ranks[next(i for i, j in perm.items() if j == self.idx)]

    def start(self, send: torch.Tensor, recv: torch.Tensor):
        """Issue one hop: ``send`` to the successor, the predecessor's chunk
        into ``recv``.  -> a handle for ``wait``.  Gloo moves host memory
        only: a card tensor goes through a host copy."""
        host = self.gloo and send.is_cuda
        s, r = (send.cpu(), torch.empty(recv.shape, dtype=recv.dtype)) if host else (send, recv)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, s, self.send_to, self.group),
                                        dist.P2POp(dist.irecv, r, self.recv_from, self.group)])
        return works, (r if host else None), recv

    @staticmethod
    def wait(handle) -> None:
        works, host_recv, recv = handle
        for w in works:
            w.wait()
        if host_recv is not None:
            recv.copy_(host_recv)


def _all_gather_rows(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    if tp == 1:
        return x
    if dist.get_backend(group) == dist.Backend.GLOO:
        src = x.cpu() if x.is_cuda else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(tp)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(x.device)
    out = x.new_empty((tp * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce_scatter_rows(x: torch.Tensor, group, tp: int, idx: int) -> torch.Tensor:
    if tp == 1:
        return x
    r = x.shape[0] // tp
    if dist.get_backend(group) == dist.Backend.GLOO:
        buf = x.to(device="cpu", dtype=torch.float32, copy=True)
        dist.all_reduce(buf, group=group)
        return buf[idx * r:(idx + 1) * r].to(device=x.device, dtype=x.dtype)
    out = x.new_empty((r, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _wants_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _AllGatherRows(torch.autograd.Function):
    """The gather's transpose is the reduce-scatter: each rank's gradient of
    the gathered rows is partial (its own columns' products), and the
    ranks' sum lands on the rows each one sent."""

    @staticmethod
    def forward(ctx, x, group, tp):
        ctx.group, ctx.tp = group, tp
        return _all_gather_rows(x, group, tp)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter_rows(dy, ctx.group, ctx.tp, dist.get_rank(ctx.group)), None, None


class _ReduceScatterRows(torch.autograd.Function):
    """The reduce-scatter's transpose is the gather: every rank's summand
    receives the gradient of the block it was summed into."""

    @staticmethod
    def forward(ctx, x, group, tp, idx):
        ctx.group, ctx.tp = group, tp
        return _reduce_scatter_rows(x, group, tp, idx)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather_rows(dy, ctx.group, ctx.tp), None, None, None


def all_gather_rows(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    """The ranks' (R, ...) row blocks stacked in rank order -> (tp * R, ...).
    Differentiable: the backward reduce-scatters the gradient."""
    if tp > 1 and _wants_grad(x):
        return _AllGatherRows.apply(x, group, tp)
    return _all_gather_rows(x, group, tp)


def reduce_scatter_rows(x: torch.Tensor, group, tp: int, idx: int) -> torch.Tensor:
    """The ranks' (tp * R, ...) tensors summed, this rank's ``idx``-th row
    block kept -> (R, ...).  On Gloo (whose reduce-scatter and bf16 sums are
    not in every PyTorch build) an fp32 all-reduce, then the block.
    Differentiable: the backward all-gathers the gradient."""
    if tp > 1 and _wants_grad(x):
        return _ReduceScatterRows.apply(x, group, tp, idx)
    return _reduce_scatter_rows(x, group, tp, idx)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``group`` in place (Gloo: a card tensor through a
    host copy); not differentiable."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        buf = x.cpu()
        dist.all_reduce(buf, op=op, group=group)
        x.copy_(buf)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


class _SumOverRanks(torch.autograd.Function):
    """The ranks' values summed, for a quantity every rank then uses alike
    (the vocab-parallel loss's sums): each rank's loss is the same function
    of the sum, so the gradient of its summand is the sum's, unreduced."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def sum_over_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (a new tensor); its gradient
    passes to each rank's summand unreduced (``_SumOverRanks``)."""
    return _SumOverRanks.apply(x, group)


# ---------------------------------------------------------------------------
# Per-shard kernel call + plan resolution
# ---------------------------------------------------------------------------


def _tp_tuned_block(m, n, k, dtype, tp, shard_shape: tuple[int, int, int]) -> tuple[int, int, int] | None:
    """The plan cache's tp-keyed entry for the *global* problem, clamped to
    the ring step's problem ``shard_shape`` (None: the kernel's shape rule
    decides).  Never raises."""
    from repro_torch.tune import cache as tune_cache

    return tune_cache.tuned_block(systolic_ops.BACKEND, m, n, k, systolic_ops.DTYPE_NAMES.get(dtype, str(dtype)),
                                  tp=tp, clamp_to=shard_shape)


def _local_matmul(x: torch.Tensor, w: torch.Tensor, *, out_dtype, block, record: bool = True) -> torch.Tensor:
    """One ring step: one launch of the systolic kernel (K1).  ``record``
    False for the backward's products, which ``obs.attribution`` does not
    record (as ``kernels/systolic/ops.py``'s ``_Matmul`` backward)."""
    plan = None
    if block is not None:
        plan = BlockPlan(x.shape[0], w.shape[1], x.shape[1], *block,
                         in_dtype=systolic_ops.DTYPE_NAMES.get(x.dtype, "bfloat16"))
    return systolic_ops._matmul(x, w, out_dtype=out_dtype, plan=plan, record=record)


def _ring_perm(tp: int, direction: str) -> list[tuple[int, int]]:
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got {direction!r}")
    step = 1 if direction == "plus" else -1
    return [(i, (i + step) % tp) for i in range(tp)]


def _check_divisible(name: str, dim: int, tp: int) -> None:
    if dim % tp:
        raise ValueError(f"{name}={dim} does not divide over tp={tp}; pad the problem or drop to the single-card path")


def _hop_span(mode: str, hop: int, nbytes: int, modeled_s: float):
    return _obs_trace.span("tp.ring_hop", cat="trace", mode=mode, hop=hop, bytes=nbytes, modeled_s=modeled_s)


# ---------------------------------------------------------------------------
# All-gather matmul (column-parallel): A (M/tp, K) x B (K, N/tp) -> (M, N/tp)
# ---------------------------------------------------------------------------


def _ag_shard(a, b, ring: _Ring, *, overlap, out_dtype, block, t_hop, keep=False, record=True):
    """-> (A's gathered rows times B, the gathered A when ``keep`` else
    None).  With ``keep`` each hop receives straight into the gathered
    buffer's block of the chunk's origin (never the block being sent), so
    the backward reads the whole A without a second ring."""
    tp = ring.tp
    if tp == 1:
        return _local_matmul(a, b, out_dtype=out_dtype, block=block, record=record), (a if keep else None)
    if not overlap:
        whole = _all_gather_rows(a, ring.group, tp)
        return _local_matmul(whole, b, out_dtype=out_dtype, block=block, record=record), (whole if keep else None)
    m_sh = a.shape[0]
    out = torch.empty((m_sh * tp, b.shape[1]), dtype=out_dtype, device=a.device)
    # With the ring i -> i+1 the chunk held after s hops originated at idx - s;
    # the opposite direction negates the offset.
    sign = -1 if ring.direction == "plus" else 1
    if keep:
        gathered = torch.empty((m_sh * tp, a.shape[1]), dtype=a.dtype, device=a.device)
        gathered[ring.idx * m_sh:(ring.idx + 1) * m_sh] = a
    else:
        spare = (torch.empty_like(a), torch.empty_like(a))
    cur = a
    for s in range(tp):
        src = (ring.idx + sign * s) % tp
        rows = slice(src * m_sh, (src + 1) * m_sh)
        if s == tp - 1:  # the last chunk needs no hop
            out[rows] = _local_matmul(cur, b, out_dtype=out_dtype, block=block, record=record)
            break
        if keep:
            nsrc = (ring.idx + sign * (s + 1)) % tp
            nxt = gathered[nsrc * m_sh:(nsrc + 1) * m_sh]
        else:
            nxt = spare[s % 2]
        with _hop_span("allgather", s, a.numel() * a.element_size(), t_hop):
            hop = ring.start(cur, nxt)  # the hop first ...
            out[rows] = _local_matmul(cur, b, out_dtype=out_dtype, block=block, record=record)  # ... then K1
            ring.wait(hop)  # only once the launch is queued
        cur = nxt
    return out, (gathered if keep else None)


def _t(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x^T in ``dtype``, copied row-major: K1 reads its A row-major, and a
    B^T read K-major takes the slower tile (``kernels/systolic/ops.py``'s
    ``_Matmul``)."""
    return x.to(dtype).t().contiguous()


class _AllGatherMatmul(torch.autograd.Function):
    """Y = AG(A) B, differentiable.  The backward is the other ring:
    dA = RS(dY B^T) (fp32 carries, cast once to A's dtype), and
    dB = AG(A)^T dY, one K1 launch on the gathered A the forward kept.  A
    cotangent wider than the operands widens them, as ``_Matmul`` does."""

    @staticmethod
    def forward(ctx, a, b, ring, overlap, out_dtype, block, t_hop):
        keep = ctx.needs_input_grad[1]
        out, gathered = _ag_shard(a, b, ring, overlap=overlap, out_dtype=out_dtype, block=block, t_hop=t_hop,
                                  keep=keep)
        ctx.save_for_backward(gathered if keep else None, b if ctx.needs_input_grad[0] else None)
        ctx.ring, ctx.overlap, ctx.t_hop, ctx.dtypes = ring, overlap, t_hop, (a.dtype, b.dtype)
        return out

    @staticmethod
    def backward(ctx, dy):
        gathered, b = ctx.saved_tensors
        a_dtype, b_dtype = ctx.dtypes
        ct = torch.promote_types(dy.dtype, a_dtype)
        dy = dy.to(ct)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _rs_shard(dy, _t(b, ct), ctx.ring, overlap=ctx.overlap, out_dtype=a_dtype, block=None,
                           t_hop=ctx.t_hop, record=False)
        if ctx.needs_input_grad[1]:
            db = _local_matmul(_t(gathered, ct), dy, out_dtype=b_dtype, block=None, record=False)
        return da, db, None, None, None, None, None


def all_gather_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh: Mesh, axis: str = "model",
                      out_dtype: torch.dtype | None = None, direction: str = "plus", overlap: bool = True,
                      block: tuple[int, int, int] | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) with A row-sharded and B column-sharded over ``axis``:
    ``a`` is this rank's (M/tp, K) rows, ``b`` its (K, N/tp) columns; returns
    its (M, N/tp) columns of the product (the reference's ``P(None, axis)``).
    The all-gather of A is ``tp - 1`` ring hops, each issued before the
    block product it hides under.  Under grad (an operand requiring it) the
    product is ``_AllGatherMatmul``, whose backward runs the reduce-scatter
    ring; every rank must then run its backward too."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    tp = mesh.shape[axis]
    m, k, n = a.shape[0] * tp, a.shape[1], b.shape[1] * tp
    out_dtype = out_dtype or a.dtype
    hop_bytes = (m // tp) * k * a.element_size()  # each hop moves one (M/tp, K) chunk of A
    _record_dispatch("allgather", tp, m, n, k, a.dtype, overlap, hop_bytes)
    if block is None:
        block = _tp_tuned_block(m, n, k, a.dtype, tp, (m // tp, n // tp, k))
    ring = _ring(mesh, axis, direction)
    t_hop = _hop_step_model(tp, m, n, k, a.dtype, hop_bytes)[0]

    def run():
        if _wants_grad(a, b):
            return _AllGatherMatmul.apply(a, b, ring, overlap, out_dtype, block, t_hop)
        return _ag_shard(a, b, ring, overlap=overlap, out_dtype=out_dtype, block=block, t_hop=t_hop)[0]

    if overlap:
        out, wall = _obs_profile.get_profiler().timed("collective", run, mode="allgather", tp=tp)
        if wall is not None:
            _record_measured("allgather", tp, m, n, k, a.dtype, hop_bytes, wall)
        return out
    return run()


# ---------------------------------------------------------------------------
# Reduce-scatter matmul (row-parallel): A (M, K/tp) x B (K/tp, N) -> (M/tp, N)
# ---------------------------------------------------------------------------


def _rs_shard(a, b, ring: _Ring, *, overlap, out_dtype, block, t_hop, record=True):
    tp = ring.tp
    if tp == 1:
        return _local_matmul(a, b, out_dtype=torch.float32, block=block, record=record).to(out_dtype)
    if not overlap:
        partial = _local_matmul(a, b, out_dtype=torch.float32, block=block, record=record)
        return _reduce_scatter_rows(partial, ring.group, tp, ring.idx).to(out_dtype)
    m_sh = a.shape[0] // tp
    # Carry continuity (the carry moves i -> i+1): at step s rank idx adds its
    # partial for output chunk idx - s - 1, so after tp steps the carry that
    # arrives holds every rank's partial for this rank's own chunk.
    sign = -1 if ring.direction == "plus" else 1

    def partial(s):  # fp32 partials: the cross-shard sum continues K1's fp32 accumulation
        c = (ring.idx + sign * (s + 1)) % tp
        return _local_matmul(a[c * m_sh:(c + 1) * m_sh], b, out_dtype=torch.float32, block=block, record=record)

    acc = partial(0)
    spare = torch.empty_like(acc)
    for s in range(1, tp):
        with _hop_span("reducescatter", s - 1, acc.numel() * 4, t_hop):
            hop = ring.start(acc, spare)  # the carry's hop first ...
            p = partial(s)  # ... then K1
            ring.wait(hop)
        acc, spare = spare, acc  # the received carry; the one sent is free again
        acc.add_(p)
    return acc.to(out_dtype)


class _ReduceScatterMatmul(torch.autograd.Function):
    """Y = RS(A B), differentiable.  The backward is the other ring:
    dA = AG(dY) B^T, whose ring keeps the gathered dY, and dB = A^T AG(dY),
    one K1 launch on it."""

    @staticmethod
    def forward(ctx, a, b, ring, overlap, out_dtype, block, t_hop):
        ctx.save_for_backward(a if ctx.needs_input_grad[1] else None, b if ctx.needs_input_grad[0] else None)
        ctx.ring, ctx.overlap, ctx.t_hop, ctx.dtypes = ring, overlap, t_hop, (a.dtype, b.dtype)
        return _rs_shard(a, b, ring, overlap=overlap, out_dtype=out_dtype, block=block, t_hop=t_hop)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        a_dtype, b_dtype = ctx.dtypes
        ct = torch.promote_types(dy.dtype, a_dtype)
        dy = dy.to(ct)
        da = db = None
        if ctx.needs_input_grad[0]:
            da, gathered = _ag_shard(dy, _t(b, ct), ctx.ring, overlap=ctx.overlap, out_dtype=a_dtype, block=None,
                                     t_hop=ctx.t_hop, keep=ctx.needs_input_grad[1], record=False)
        elif ctx.needs_input_grad[1]:
            gathered = _all_gather_rows(dy, ctx.ring.group, ctx.ring.tp)
        if ctx.needs_input_grad[1]:
            db = _local_matmul(_t(a, ct), gathered, out_dtype=b_dtype, block=None, record=False)
        return da, db, None, None, None, None, None


def reduce_scatter_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh: Mesh, axis: str = "model",
                          out_dtype: torch.dtype | None = None, direction: str = "plus", overlap: bool = True,
                          block: tuple[int, int, int] | None = None) -> torch.Tensor:
    """(M, K) @ (K, N) with A column-sharded and B row-sharded over ``axis``:
    ``a`` is this rank's (M, K/tp) columns, ``b`` its (K/tp, N) rows; returns
    its (M/tp, N) rows of the product (the reference's ``P(axis, None)``).
    Each rank's partial products over its K slice are reduced along a ring of
    fp32 carries, one hop issued before each (M/tp, K/tp) x (K/tp, N) block
    product it hides under.  Under grad the product is
    ``_ReduceScatterMatmul``, whose backward runs the all-gather ring."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    tp = mesh.shape[axis]
    m, k, n = a.shape[0], a.shape[1] * tp, b.shape[1]
    _check_divisible("M", m, tp)
    out_dtype = out_dtype or a.dtype
    hop_bytes = (m // tp) * n * 4  # each hop moves one (M/tp, N) fp32 carry
    _record_dispatch("reducescatter", tp, m, n, k, a.dtype, overlap, hop_bytes)
    if block is None:
        block = _tp_tuned_block(m, n, k, a.dtype, tp, (m // tp, n, k // tp))
    ring = _ring(mesh, axis, direction)
    t_hop = _hop_step_model(tp, m, n, k, a.dtype, hop_bytes)[0]

    def run():
        if _wants_grad(a, b):
            return _ReduceScatterMatmul.apply(a, b, ring, overlap, out_dtype, block, t_hop)
        return _rs_shard(a, b, ring, overlap=overlap, out_dtype=out_dtype, block=block, t_hop=t_hop)

    if overlap:
        out, wall = _obs_profile.get_profiler().timed("collective", run, mode="reducescatter", tp=tp)
        if wall is not None:
            _record_measured("reducescatter", tp, m, n, k, a.dtype, hop_bytes, wall)
        return out
    return run()


# ---------------------------------------------------------------------------
# Dispatch helpers
# ---------------------------------------------------------------------------


def tp_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh: Mesh, mode: str = "allgather", **kw) -> torch.Tensor:
    """Mode-switched entry point (benchmarks / launchers)."""
    if mode == "allgather":
        return all_gather_matmul(a, b, mesh=mesh, **kw)
    if mode == "reducescatter":
        return reduce_scatter_matmul(a, b, mesh=mesh, **kw)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def maybe_tp_matmul(x2: torch.Tensor, w: torch.Tensor, *, out_dtype: torch.dtype) -> torch.Tensor | None:
    """The ``core.ops.matmul`` hook: the sharded product, or None.

    None (the caller runs its single-card kernel) unless a
    ``tensor_parallel`` context is active with tp > 1 and the flattened
    (M, K) x (K, N) problem divides the mesh axis; M >= tp keeps decode
    GEMMs of fewer rows than ranks on the replicated path.  Operands are
    replicated on every rank, and so is the result: each rank runs the ring
    on its row block of ``x2`` and its column block of ``w``, and the
    ranks' column blocks are gathered."""
    active = _TP.get()
    if active is None:
        return None
    mesh, axis = active
    tp = mesh.shape[axis]
    m, n = x2.shape[0], w.shape[1]
    if tp < 2 or m < tp or m % tp or n % tp:
        return None
    idx = mesh.axis_index(axis)
    a = x2[idx * (m // tp):(idx + 1) * (m // tp)]
    b = w[:, idx * (n // tp):(idx + 1) * (n // tp)].contiguous()
    y = all_gather_matmul(a, b, mesh=mesh, axis=axis, out_dtype=out_dtype)  # (M, N/tp)
    cols = all_gather_rows(y, mesh.group(axis), tp)  # (tp * M, N/tp), rank blocks in axis order
    return cols.reshape(tp, m, n // tp).permute(1, 0, 2).reshape(m, n)
