"""Continuous-batching request scheduler.

The counterpart of ``repro.serving.scheduler``.  Request lifecycle (one
state machine per request)::

    QUEUED ──admission──> PREFILLING ──KV scatter──> DECODING ──EOS /
      │   (free slot and    (monolithic, or one      │  max_new_tokens
      │    arrival <= now)   chunk per tick)         │
      submit()                                       └──> FINISHED (slot freed)

Admission policies:

  * ``"continuous"`` (default): a free slot is refilled the moment any queued
    request has arrived.  One long request no longer pins the whole batch,
    so the matmul units stay fed under ragged traffic -- the serving analogue
    of the paper's third array dimension keeping ~99% of the DSPs busy.
  * ``"gang"``: new requests are admitted only when the pool is completely
    empty -- synchronized batching, the baseline (finished slots idle until
    the longest request in the gang drains).

The scheduler advances in virtual *ticks*: one batched decode step per tick,
request arrival times measured in ticks (Poisson in the synthetic traces).
Each tick ends with the sampled tokens read back to the host, which waits
for the card, so the step and tick latencies cover the device's work.

**Chunked prefill** (``chunked_prefill=True``): each admitted prompt is split
by ``engine.chunk_schedule`` into bucketed chunks and the PREFILLING state
carries progress: every tick runs at most ``chunk_budget`` prefill chunks
and then the regular decode step, so a decoding request waits for at most
that many chunks between its tokens, not for a whole prompt.  Mid-prefill
slots stay ``pos = -1`` in the pool -- masked out of the co-scheduled decode
steps -- until their final chunk lands.  **kv8** (``quantize_kv=True``) keeps
the resident pool in int8 (``KVPool(quantize_kv_cache=True)``).

Per-request greedy outputs equal running each request alone through
``ServeEngine.generate`` (fp32; ``tests/test_torch_continuous.py``,
``tests/test_torch_chunked.py``).  The paged pool and the prefix cache
(ROADMAP item 5) are not ported: their options raise.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.obs import attribution as _obs_attr
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import slo as _obs_slo
from repro_torch.obs import trace as _obs_trace
from repro_torch.serving.engine import ServeEngine, chunk_schedule
from repro_torch.serving.kvpool import KVPool, clear_slots

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request; ``prompt`` is a batch-1 prefill batch dict
    ({"tokens": (1, S)}) on the engine's device."""

    rid: int
    prompt: dict
    max_new_tokens: int
    arrival: float = 0.0  # tick time
    eos_id: int | None = None

    state: str = QUEUED
    slot: int = -1
    out: list = dataclasses.field(default_factory=list)
    admitted_tick: int = -1
    finished_tick: int = -1
    first_token_s: float = -1.0  # wall seconds from run start to first token
    admitted_s: float = -1.0  # wall seconds from run start to admission
    last_token_s: float = -1.0  # wall time of the latest token (ITL basis)
    eligible_s: float = -1.0  # wall time the arrival tick was reached
    # (queue-wait = admitted_s - eligible_s: time spent waiting for a slot,
    # not time spent not-yet-arrived)
    # chunked prefill progress: the (offset, length) schedule and how many
    # chunks have landed in the KV slot so far (PREFILLING-with-progress)
    chunks: list = dataclasses.field(default_factory=list)
    chunk_idx: int = 0
    staging: Any = None  # the batch-1 working cache carried across chunks

    @property
    def prompt_len(self) -> int:
        return self.prompt["tokens"].shape[1]

    def tokens(self) -> np.ndarray:
        """Generated tokens: (n,) int32."""
        return np.stack(self.out) if self.out else np.zeros((0,), np.int32)


def requests_from_trace(trace: list[dict]) -> list[Request]:
    """Adapt ``data.synthetic.make_request_trace`` entries to Requests."""
    return [
        Request(
            rid=t.get("rid", i),
            prompt=t["prompt"],
            max_new_tokens=t["max_new_tokens"],
            arrival=t.get("arrival", 0.0),
            eos_id=t.get("eos_id"),
        )
        for i, t in enumerate(trace)
    ]


class SchedulerStats:
    """Aggregates the serving analogue of the paper's utilisation column.

    Backed by a **private** ``obs`` metrics Registry: every number here is a
    counter/gauge/histogram series, so two schedulers in one process
    (gang-vs-continuous comparisons) never mix samples, and ``summary()`` is
    a read of the registry rather than parallel dict bookkeeping.

    The raw instruments are used directly (not the registry's gated
    convenience wrappers): scheduling correctness bookkeeping -- token
    counts, occupancy, latencies -- must not vanish under ``REPRO_OBS=0``;
    only the derived-telemetry extras (MFU, residual, spans) are gated.

    Percentiles come from ``obs.metrics.Histogram.quantile`` -- nearest-rank,
    clamped, so p99 over fewer than 100 samples reports the max.
    """

    def __init__(self):
        self.registry = _obs_metrics.Registry()
        r = self.registry
        self._ticks = r.counter("sched.ticks")
        self._decode_steps = r.counter("sched.decode_steps")
        self._idle_ticks = r.counter("sched.idle_ticks")
        self._tokens_out = r.counter("sched.tokens_out")
        self._prefill_s = r.counter("sched.prefill_s")
        self._decode_s = r.counter("sched.decode_s")
        self._tick_s = r.counter("sched.tick_s")
        # run() wall clock + on_tick callback time, so tick_s + callback_s
        # can be held against the whole run
        self._callback_s = r.counter("sched.callback_s")
        self._run_wall = r.gauge("sched.run_wall_s")
        self._admitted = r.counter("sched.admitted")
        self._evicted = r.counter("sched.evicted")
        self._occupancy_sum = r.counter("sched.occupancy_sum")
        self._step_lat = r.histogram("sched.step_latency_s")
        self._tick_lat = r.histogram("sched.tick_latency_s")
        self._ttft = r.histogram("serve.ttft_s")
        self._itl = r.histogram("serve.itl_s")
        self._queue_wait = r.histogram("serve.queue_wait_s")
        self._goodput = r.counter("serve.goodput_toks")
        self._conformant = r.counter("serve.requests_conformant")
        self._mfu = r.histogram("serve.decode_mfu")
        self._residual = r.histogram("serve.model_residual")
        self._queue_depth = r.gauge("sched.queue_depth")
        self._slot_occupancy = r.gauge("sched.slot_occupancy")
        self._kv_bytes = r.gauge("serve.kv_bytes_resident")
        self._prefill_chunks = r.counter("sched.prefill_chunks")
        # paged-pool series (not ported: they stay at 0)
        self._prefix_hits = r.counter("serve.prefix_hits")
        self._prefix_hit_tokens = r.counter("serve.prefix_hit_tokens")
        self._preempted = r.counter("sched.preempted")
        self._page_occupancy = r.gauge("sched.page_occupancy")
        self._kv_bytes_live = r.gauge("serve.kv_bytes_live")

    # -- recording (called by the scheduler) -----------------------------------

    def count_tick(self, wall_s: float) -> None:
        self._ticks.inc()
        self._tick_s.inc(wall_s)

    def count_idle_tick(self) -> None:
        self._idle_ticks.inc()

    def count_callback(self, wall_s: float) -> None:
        self._callback_s.inc(wall_s)

    def set_run_wall(self, wall_s: float) -> None:
        self._run_wall.set(wall_s)

    def count_admitted(self, queue_wait_s: float | None = None) -> None:
        self._admitted.inc()
        if queue_wait_s is not None:
            self._queue_wait.observe(queue_wait_s)

    def count_evicted(self) -> None:
        self._evicted.inc()

    def count_goodput(self, n_tokens: int, conformant: bool) -> None:
        """One finished request's SLO verdict (goodput = conformant tokens
        only; vacuously conformant when no SLO is configured)."""
        if conformant:
            self._goodput.inc(n_tokens)
            self._conformant.inc()

    def count_violation(self, kind: str) -> None:
        self.registry.counter("serve.slo.violations", kind=kind).inc()

    def count_token(self, ttft_s: float | None, itl_s: float | None) -> None:
        self._tokens_out.inc()
        if ttft_s is not None:
            self._ttft.observe(ttft_s)
        if itl_s is not None:
            self._itl.observe(itl_s)

    def add_prefill(self, wall_s: float, *, chunk: bool = False) -> None:
        self._prefill_s.inc(wall_s)
        if chunk:
            self._prefill_chunks.inc()

    def record_decode_step(self, wall_s: float, occupancy: float) -> None:
        self._decode_s.inc(wall_s)
        self._decode_steps.inc()
        self._step_lat.observe(wall_s)
        self._occupancy_sum.inc(occupancy)

    def record_tick_latency(self, wall_s: float) -> None:
        self._tick_lat.observe(wall_s)

    def record_utilization(self, mfu: float, residual: float) -> None:
        self._mfu.observe(mfu)
        self._residual.observe(residual)

    def set_gauges(
        self,
        queue_depth: int,
        occupancy: float,
        kv_bytes: int | None = None,
        kv_bytes_live: int | None = None,
        page_occupancy: float | None = None,
    ) -> None:
        self._queue_depth.set(queue_depth)
        self._slot_occupancy.set(occupancy)
        if kv_bytes is not None:
            self._kv_bytes.set(kv_bytes)
        if kv_bytes_live is not None:
            self._kv_bytes_live.set(kv_bytes_live)
        if page_occupancy is not None:
            self._page_occupancy.set(page_occupancy)

    # -- reads -----------------------------------------------------------------

    @property
    def ticks(self) -> int:
        return int(self._ticks.value)

    @property
    def decode_steps(self) -> int:
        return int(self._decode_steps.value)

    @property
    def idle_ticks(self) -> int:
        return int(self._idle_ticks.value)

    @property
    def tokens_out(self) -> int:
        return int(self._tokens_out.value)

    @property
    def prefill_s(self) -> float:
        return self._prefill_s.value

    @property
    def decode_s(self) -> float:
        return self._decode_s.value

    @property
    def prefill_chunks(self) -> int:
        return int(self._prefill_chunks.value)

    @property
    def step_latency_s(self) -> list:
        return self._step_lat.values()

    @property
    def tick_latency_s(self) -> list:
        return self._tick_lat.values()

    def mean_occupancy(self) -> float:
        steps = self.decode_steps
        return self._occupancy_sum.value / steps if steps else 0.0

    def latency_percentiles(self) -> tuple[float, float]:
        """(p50, p99) bare decode-step latency in seconds (the step and its
        readback only; see ``tick_latency_s`` for what requests experience)."""
        return self._step_lat.quantile(0.5), self._step_lat.quantile(0.99)

    def tick_percentiles(self) -> tuple[float, float]:
        """(p50, p99) decode-tick latency in seconds (decode step + any
        prefill work sharing the tick)."""
        return self._tick_lat.quantile(0.5), self._tick_lat.quantile(0.99)

    def slo_violations(self) -> int:
        """Total budget misses across kinds (the labelled counter series)."""
        snap = self.registry.snapshot()["counters"]
        return int(sum(v for series, v in snap.items() if series.split("{")[0] == "serve.slo.violations"))

    def summary(self) -> dict:
        p50, p99 = self.latency_percentiles()
        tp50, tp99 = self.tick_percentiles()
        wall = self.prefill_s + self.decode_s
        overhead = max(0.0, self._tick_s.value - wall)
        return {
            "ticks": self.ticks,
            "decode_steps": self.decode_steps,
            "idle_ticks": self.idle_ticks,
            "tokens_out": self.tokens_out,
            "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4),
            "sched_overhead_s": round(overhead, 4),
            "callback_s": round(self._callback_s.value, 4),
            "run_wall_s": round(self._run_wall.value, 4),
            "prefill_chunks": self.prefill_chunks,
            "tok_per_s": round(self.tokens_out / wall, 2) if wall > 0 else 0.0,
            "p50_step_ms": round(p50 * 1e3, 3),
            "p99_step_ms": round(p99 * 1e3, 3),
            "p50_tick_ms": round(tp50 * 1e3, 3),
            "p99_tick_ms": round(tp99 * 1e3, 3),
            "mean_occupancy": round(self.mean_occupancy(), 4),
            "ttft_p50_ms": round(self._ttft.quantile(0.5) * 1e3, 3),
            "ttft_p99_ms": round(self._ttft.quantile(0.99) * 1e3, 3),
            "itl_p50_ms": round(self._itl.quantile(0.5) * 1e3, 3),
            "itl_p99_ms": round(self._itl.quantile(0.99) * 1e3, 3),
            "decode_mfu": round(self._mfu.mean(), 6),
            "model_residual": round(self._residual.mean(), 4),
            "kv_bytes_resident": int(self._kv_bytes.value),
            "kv_bytes_live": int(self._kv_bytes_live.value),
            "prefix_hits": int(self._prefix_hits.value),
            "prefix_hit_tokens": int(self._prefix_hit_tokens.value),
            "preempted": int(self._preempted.value),
            "page_occupancy": round(self._page_occupancy.value, 4),
            # SLO accounting: goodput counts only tokens from requests that
            # finished within every budget; with no SLO configured every
            # finished request is vacuously conformant, so goodput_tok_per_s
            # == tok_per_s for fully drained runs.
            "goodput_toks": int(self._goodput.value),
            "goodput_tok_per_s": round(self._goodput.value / wall, 2) if wall > 0 else 0.0,
            "requests_finished": int(self._evicted.value),
            "requests_conformant": int(self._conformant.value),
            "slo_violations": self.slo_violations(),
            "queue_wait_p99_ms": round(self._queue_wait.quantile(0.99) * 1e3, 3),
        }


class ContinuousScheduler:
    """Drives a ServeEngine's per-slot primitives over a KVPool."""

    POLICIES = ("continuous", "gang")

    def __init__(
        self,
        engine: ServeEngine,
        *,
        policy: str = "continuous",
        chunked_prefill: bool = False,
        chunk_size: int = 128,
        chunk_budget: int = 1,
        quantize_kv: bool = False,
        paged: bool = False,
        prefix_cache: bool = False,
        slo=None,
        flight_recorder=None,
    ):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, got {policy!r}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if chunk_budget < 1:
            raise ValueError(f"chunk_budget must be >= 1, got {chunk_budget}")
        for on, what in ((paged, "the paged KV pool"), (prefix_cache, "the prefix cache")):
            if on:
                raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md Queue 1 item 5")
        if chunked_prefill and not engine.supports_chunked_prefill:
            warnings.warn(f"{engine.cfg.name}: frontend {engine.cfg.frontend!r} is not chunkable; "
                          "falling back to monolithic prefill")
            chunked_prefill = False
        if quantize_kv and engine.cfg.family not in ("dense", "moe", "audio", "vlm"):
            # SSM/hybrid state tensors are running accumulators with no pos
            # mask; re-quantizing them every step compounds error, so kv8
            # covers the attention families only.
            warnings.warn(f"{engine.cfg.name}: family {engine.cfg.family!r} has unmasked state caches; "
                          "kv8 disabled for this run")
            quantize_kv = False
        self.engine = engine
        self.policy = policy
        self.chunked_prefill = chunked_prefill
        # A chunk longer than the SWA ring would write one slot twice.
        self.chunk_size = min(chunk_size, engine.attn_cache_len())
        self.chunk_budget = chunk_budget
        self.quantize_kv = quantize_kv
        self.pool = KVPool(engine.model, engine.scfg.batch, engine.scfg.max_len, quantize_kv_cache=quantize_kv,
                           device=engine.device)
        self._slot_tok = np.zeros((self.pool.n_slots, 1), np.int32)
        self._slot_req: dict[int, Request] = {}
        self._prefilling: collections.deque[Request] = collections.deque()
        self.queue: collections.deque[Request] = collections.deque()
        self.tick = 0
        self.stats = SchedulerStats()
        self._t0 = time.perf_counter()
        self._gang_forming = False
        self._warmed = False
        # SLO conformance + flight recorder.  ``slo`` is an ``obs.SLOSpec``;
        # ``flight_recorder`` an ``obs.FlightRecorder`` -- a public attribute,
        # so a launcher that builds the recorder from the scheduler's own
        # registry can attach it after construction.
        self.slo = slo
        self._conformance = _obs_slo.ConformanceTracker(slo) if slo is not None and slo.active() else None
        self.flight_recorder = flight_recorder

    # -- submission ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        budget = req.prompt_len + req.max_new_tokens
        if budget > self.pool.max_len:
            raise ValueError(f"request {req.rid}: prompt+gen {budget} exceeds max_len {self.pool.max_len}")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        req.state = QUEUED
        self.queue.append(req)

    # -- internals -------------------------------------------------------------

    def _slo_check(self, req: Request, kind: str, value_s: float) -> None:
        """Feed one latency sample to the conformance tracker; on a budget
        miss, count it, mark the trace, and -- on the request's *first*
        violation -- dump a flight-recorder bundle."""
        if self._conformance is None:
            return
        was_conformant = self._conformance.conformant(req.rid)
        v = self._conformance.check(req.rid, kind, value_s)
        if v is None:
            return
        self.stats.count_violation(kind)
        _obs_trace.instant("slo.violation", cat="slo", rid=req.rid, kind=kind,
                           value_ms=round(value_s * 1e3, 3), budget_ms=round(v.budget_s * 1e3, 3))
        if was_conformant and self.flight_recorder is not None:
            self.flight_recorder.dump(f"slo-{kind}", rid=req.rid, detail=v.to_dict())

    def _finish(self, req: Request) -> None:
        req.state = FINISHED
        req.finished_tick = self.tick
        self.stats.count_evicted()
        n_tokens = len(req.out)
        conformant = self._conformance.on_finish(req.rid, n_tokens) if self._conformance is not None else True
        self.stats.count_goodput(n_tokens, conformant)
        _obs_trace.instant("serve.evict", cat="serve", rid=req.rid, tick=self.tick, n_tokens=n_tokens,
                           conformant=conformant)
        if req.slot >= 0:
            self.pool.free(req.slot)
            del self._slot_req[req.slot]
            req.slot = -1

    def _token_done(self, req: Request, tok: np.ndarray) -> bool:
        """Record one generated token; True when the request is finished.

        TTFT is measured admission-to-first-token (what the request waited
        once a slot was granted); ITL is the wall gap between a request's
        consecutive tokens.
        """
        req.out.append(tok)
        now = time.perf_counter() - self._t0
        ttft = itl = None
        if req.first_token_s < 0:
            req.first_token_s = now
            if req.admitted_s >= 0:
                ttft = now - req.admitted_s
                self._slo_check(req, "ttft", ttft)
            _obs_trace.instant("serve.first_token", cat="serve", rid=req.rid, tick=self.tick,
                               ttft_s=round(ttft, 6) if ttft is not None else -1.0)
        elif req.last_token_s >= 0:
            itl = now - req.last_token_s
            self._slo_check(req, "itl", itl)
        req.last_token_s = now
        self.stats.count_token(ttft, itl)
        if req.eos_id is not None and tok.ndim == 0 and int(tok) == req.eos_id:
            return True
        return len(req.out) >= req.max_new_tokens

    def _admissible(self) -> bool:
        if not self.queue or self.queue[0].arrival > self.tick:
            return False
        if self.pool.n_free == 0:
            return False
        if self.policy == "gang":
            # A gang only forms on an empty pool; once slots are occupied,
            # admission waits for the whole batch to drain.
            return self.pool.n_active == 0 or self._gang_forming
        return True

    def _admit(self) -> None:
        # Queue-wait starts when the arrival tick is *reached* (the request
        # became eligible for a slot), not when it was submitted.
        now = time.perf_counter() - self._t0
        for r in self.queue:
            if r.eligible_s < 0 and r.arrival <= self.tick:
                r.eligible_s = now
        self._gang_forming = self.policy == "gang" and self.pool.n_active == 0
        while self._admissible():
            req = self.queue.popleft()
            slot = self.pool.alloc()
            assert slot is not None
            req.state = PREFILLING
            req.slot = slot
            req.admitted_tick = self.tick
            req.admitted_s = time.perf_counter() - self._t0
            wait = max(0.0, req.admitted_s - req.eligible_s) if req.eligible_s >= 0 else 0.0
            self.stats.count_admitted(wait)
            _obs_trace.instant("serve.admit", cat="serve", rid=req.rid, slot=slot, tick=self.tick,
                               queue_wait_s=round(wait, 6), prompt_len=req.prompt_len)
            self._slo_check(req, "queue_wait", wait)
            if self.chunked_prefill:
                # PREFILLING-with-progress: the slot is claimed (pos = -1,
                # masked out of decode) and the prompt trickles in one
                # bucketed chunk per tick via _prefill_chunk_once.
                req.chunks = chunk_schedule(req.prompt_len, self.chunk_size)
                req.chunk_idx = 0
                self._prefilling.append(req)
                continue
            n_pos = self.engine.prompt_positions(req.prompt)
            t0 = time.perf_counter()
            with _obs_trace.request_scope(req.rid), _obs_trace.span(
                "serve.prefill", rid=req.rid, prompt_len=req.prompt_len, prefix_hit=0
            ):
                first, cache_one = self.engine.prefill_request(req.prompt)
                tok = first.cpu().numpy()[0]  # (1,); the readback waits for the card
                self.pool.write_prefill(slot, cache_one, n_pos)
            self.stats.add_prefill(time.perf_counter() - t0)
            self._start_decoding(req, tok)

    def _start_decoding(self, req: Request, tok: np.ndarray) -> None:
        """Prefill complete: seed the slot's token and flip to DECODING."""
        self._slot_tok[req.slot] = tok
        self._slot_req[req.slot] = req
        req.state = DECODING
        if self._token_done(req, tok[0]):
            self._finish(req)

    def _wait_for_device(self) -> None:
        """Wait for the engine's card (a no-op on the CPU), so a timed
        window that reads nothing back covers the device's work."""
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _prefill_chunk_once(self) -> None:
        """Run up to ``chunk_budget`` prefill chunks (FIFO over PREFILLING
        requests), each written into the request's KV slot at its absolute
        offset.  The final chunk emits the prompt's last-position logits and
        promotes the request to DECODING."""
        staged = self.engine.chunk_prefill_staged
        budget = self.chunk_budget
        while budget > 0 and self._prefilling:
            req = self._prefilling[0]
            off, length = req.chunks[req.chunk_idx]
            last = req.chunk_idx == len(req.chunks) - 1
            t0 = time.perf_counter()
            with _obs_trace.request_scope(req.rid), _obs_trace.span(
                "serve.prefill_chunk", rid=req.rid, offset=off, length=length, last=last
            ):
                tokens = req.prompt["tokens"][:, off : off + length]
                # The working batch-1 cache is carried across chunks on the
                # request (one gather at the first chunk, not one per chunk);
                # co-scheduled decode steps cannot touch a pos = -1 slot's
                # rows, so the carried copy never goes stale.
                if req.chunk_idx:
                    cache_one = req.staging
                elif staged:
                    cache_one = self.pool.model.init_cache(1, self.pool.max_len, self.pool.dtype, self.pool.device)
                else:
                    cache_one = self.pool.gather_slot(req.slot)
                tok, cache_one = self.engine.prefill_chunk(tokens, cache_one, off, last=last)
                if last:
                    tok_np = tok.cpu().numpy()[0]  # (1,); the readback waits for the card
                else:
                    self._wait_for_device()
                if staged and not last:
                    req.staging = cache_one
                else:
                    # Attention families scatter every chunk, so the pool
                    # holds the chunk's K/V at its absolute offset as soon as
                    # it lands; staged families write once, on the final chunk.
                    next_pos = self.engine.prompt_positions(req.prompt) if last else None
                    self.pool.write_slot(req.slot, cache_one, next_pos)
                    req.staging = None if last else cache_one
            self.stats.add_prefill(time.perf_counter() - t0, chunk=True)
            req.chunk_idx += 1
            budget -= 1
            if last:
                self._prefilling.popleft()
                self._start_decoding(req, tok_np)

    def _decode_once(self) -> bool:
        """One vector-pos decode step; False when no slot was decoding."""
        active = sorted(self._slot_req)
        if not active:
            return False
        t0 = time.perf_counter()
        with _obs_trace.span("serve.decode_tick", tick=self.tick, active=len(active),
                             rids=[self._slot_req[s].rid for s in active]):
            # One host-to-device copy of every slot's token, one readback of
            # every slot's next token.
            tokens = torch.from_numpy(self._slot_tok).to(self.engine.device)
            nxt, self.pool.cache = self.engine.decode_slots(tokens, self.pool.cache, self.pool.pos_vector())
            nxt_np = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.record_decode_step(dt, len(active) / self.pool.n_slots)
        if _obs_metrics.enabled():
            # Utilization attribution: the measured step divided into the
            # GEMM work the engine's decode step recorded (none yet: see
            # ``obs.attribution``).
            totals = self.engine.decode_totals
            if totals.flops > 0 and dt > 0:
                self.stats.record_utilization(
                    _obs_attr.mfu(totals.flops, dt, dtype=self.engine.cfg.dtype),
                    dt / totals.predicted_s if totals.predicted_s > 0 else 0.0,
                )
        self.pool.advance(active)
        for slot in active:
            req = self._slot_req[slot]
            tok = nxt_np[slot]  # (1,)
            self._slot_tok[slot] = tok
            if self._token_done(req, tok[0]):
                self._finish(req)
        return True

    # -- driving ---------------------------------------------------------------

    def warmup(self) -> None:
        """Absorb one-off costs outside the stats window.

        Always runs one vector-pos decode with every slot marked empty
        (pos = -1): the same work as a live step, and -- because empty slots
        leave their cache rows untouched -- a no-op on pool state; then the
        prefill work of everything already queued, against throwaway caches:
        one prefill per distinct prompt shape, or under chunked prefill one
        dummy chunk per distinct (chunk length, wrapped).  Eagerly
        nothing compiles, but the first launches of each kernel path (the
        kernels' build, ``cudaFuncSetAttribute``, library handles) land here
        instead of in the p50/p99 tick histograms.  Sampling state is left
        as it was.

        ``step`` invokes this automatically on its first call if the driver
        never did.
        """
        self._warmed = True
        with _obs_trace.span("serve.warmup"):
            self._warmup_impl()
        self._set_gauges()

    def _set_gauges(self) -> None:
        rep = self.pool.bytes_report()
        self.stats.set_gauges(len(self.queue), self.pool.occupancy(), kv_bytes=rep["reserved"],
                              kv_bytes_live=rep["live"])

    def _warmup_impl(self) -> None:
        gen_state = self.engine._gen.get_state()  # warmup must not advance sampling
        try:
            dev = self.engine.device
            tok = torch.zeros(self._slot_tok.shape, dtype=torch.int32, device=dev)
            pos = torch.full((self.pool.n_slots,), -1, dtype=torch.int32, device=dev)
            out, self.pool.cache = self.engine.decode_slots(tok, self.pool.cache, pos)
            out.cpu()
            # The pool's slot ops, as bit-exact no-ops: round-trip slot 0
            # through gather + scatter and clear an empty slot mask.
            self.pool.write_slot(0, self.pool.gather_slot(0), next_pos=None)
            self.pool.cache = clear_slots(self.pool.cache, torch.zeros(self.pool.n_slots, dtype=torch.bool),
                                          self.pool.n_slots)
            if not self.chunked_prefill:
                seen: set = set()
                for req in self.queue:
                    key = tuple((k, tuple(v.shape)) for k, v in sorted(req.prompt.items()))
                    if key in seen:
                        continue
                    seen.add(key)
                    first, _ = self.engine.prefill_request(req.prompt)
                    first.cpu()
                return
            done: set = set()
            for req in self.queue:
                for off, length in chunk_schedule(req.prompt_len, self.chunk_size):
                    wrapped = off + length > self.engine.attn_cache_len()
                    if (length, wrapped) in done:
                        continue
                    done.add((length, wrapped))
                    dummy = torch.zeros((1, length), dtype=torch.int32, device=dev)
                    self.engine.prefill_chunk(dummy, self.pool.gather_slot(0), off, last=False)
                    self._wait_for_device()
        finally:
            self.engine._gen.set_state(gen_state)

    def pending(self) -> bool:
        return bool(self.queue or self._prefilling or self._slot_req)

    def step(self) -> bool:
        """One scheduler tick: admit arrived requests (prefilling each, or
        queueing their chunks), run at most ``chunk_budget`` prefill chunks
        (chunked mode), then one batched decode step over whatever is
        decoding.  Returns ``pending()``.

        Ticks in which at least one slot decoded are timed end to end into
        ``stats.tick_latency_s`` -- the latency a decoding request actually
        experiences, prefill work included.
        """
        if not self._warmed:
            self.warmup()
        t0 = time.perf_counter()
        try:
            self._admit()
            chunks_before = self.stats.prefill_chunks
            if self.chunked_prefill:
                self._prefill_chunk_once()
            decoded = self._decode_once()
        except Exception as e:
            # Capture the flight recording before the stack unwinds past the
            # scheduler (the ring buffer still holds the spans leading up to
            # the failure).
            if self.flight_recorder is not None:
                self.flight_recorder.dump("exception", detail={"tick": self.tick, "error": repr(e)})
            raise
        dt = time.perf_counter() - t0
        if decoded:
            self.stats.record_tick_latency(dt)
        elif self.stats.prefill_chunks == chunks_before:
            # truly idle: no decode ran and no prefill chunk landed
            self.stats.count_idle_tick()
        self.tick += 1
        self.stats.count_tick(dt)
        self._set_gauges()
        return self.pending()

    def run(self, requests: list[Request] | None = None, *, max_ticks: int | None = None,
            on_tick=None) -> dict[int, np.ndarray]:
        """Drive to completion; returns {rid: generated tokens}.

        ``on_tick(scheduler)``, if given, is called after every tick; its
        cost is the caller's: it runs outside the tick's latency window but
        inside the run.
        """
        done: list[Request] = []
        if requests:
            for r in sorted(requests, key=lambda r: r.arrival):
                self.submit(r)
                done.append(r)
        self.warmup()
        self._t0 = time.perf_counter()
        limit = max_ticks if max_ticks is not None else 1_000_000
        while self.pending():
            if self.tick >= limit:
                raise RuntimeError(f"scheduler did not drain in {limit} ticks")
            self.step()
            if on_tick is not None:
                t_cb = time.perf_counter()
                on_tick(self)
                self.stats.count_callback(time.perf_counter() - t_cb)
        self.stats.set_run_wall(time.perf_counter() - self._t0)
        return {r.rid: r.tokens() for r in done}
