"""Span tracer: wall-time events in a ring buffer, exported as Chrome
``trace_event`` JSON (loadable in Perfetto / chrome://tracing).

The port's copy of ``repro.obs.trace``; its documents pass the reference's
validators (``tests/test_torch_obs.py``).

The paper reasons about utilisation with pipeline timelines (Section V's
overlapped Read/Compute/Write phases); this is the host-side equivalent for
the serving stack: every scheduler tick, prefill chunk, decode step, autotune
measurement, and collective dispatch opens a span, and the exported timeline
shows where wall time actually went -- the overlap (or bubble) is visible
instead of inferred.

Scope of honesty: spans time **host-side dispatch**, not device execution.
CUDA launches return before the device finishes, so a span bounds the
device's work only where the code inside it waits for a result (the
scheduler reads each tick's sampled tokens back to the host inside its
spans, so steady-state decode spans do bound the device step).

The buffer is a bounded deque: a long-running server keeps the most recent
``capacity`` events and drops the oldest -- export never grows without
bound, matching the metrics registry's sliding-window histograms.

**Request-scoped tracing** (DESIGN.md §12): serving code wraps per-request
work in ``request_scope(rid)``; every span/instant recorded inside the scope
is tagged ``args.rid`` automatically (an explicit ``rid=`` argument wins).
Batched work touching several requests at once tags ``args.rids`` instead
(the decode tick's per-slot attribution).  ``request_timeline`` filters an
exported trace back down to one request's events and
``validate_request_timeline`` checks the admission -> first-token ->
eviction chain the scheduler is contracted to emit.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import os
import threading
import time
from collections import deque
from typing import Any

from repro_torch.obs import metrics as _metrics

# ---------------------------------------------------------------------------
# Request scope: which request the current (host) control flow serves.
# ---------------------------------------------------------------------------

_REQUEST: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "repro_obs_request", default=None
)


def current_request() -> int | None:
    """The rid bound by the innermost ``request_scope`` (None outside)."""
    return _REQUEST.get()


@contextlib.contextmanager
def request_scope(rid: int):
    """Attribute every span/instant in the scope to request ``rid``.

    A contextvar, so it nests (inner request wins) and is safe under the
    router-layer threading the metrics registry already anticipates.
    """
    token = _REQUEST.set(rid)
    try:
        yield
    finally:
        _REQUEST.reset(token)


class Tracer:
    """Ring buffer of completed spans + instants."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._events: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._dropped = 0

    # -- recording -----------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self._dropped += 1
            self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **args):
        """Record a complete ("ph": "X") event around the enclosed block.

        The span is recorded even if the block raises (with an ``error``
        arg), so a crashed tick still shows up in the timeline.
        """
        if not _metrics.enabled():
            yield
            return
        start = self._now_us()
        err = None
        try:
            yield
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            ev = {
                "name": name,
                "cat": cat or "span",
                "ph": "X",
                "ts": start,
                "dur": self._now_us() - start,
                "pid": os.getpid(),
                "tid": threading.get_ident() & 0xFFFF,
            }
            payload = {k: v for k, v in args.items() if v is not None}
            if err is not None:
                payload["error"] = err
            if "rid" not in payload and "rids" not in payload:
                rid = _REQUEST.get()
                if rid is not None:
                    payload["rid"] = rid
            if payload:
                ev["args"] = payload
            self._push(ev)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record a zero-duration ("ph": "i") marker."""
        if not _metrics.enabled():
            return
        ev = {
            "name": name,
            "cat": cat or "instant",
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": self._now_us(),
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
        }
        payload = dict(args)
        if "rid" not in payload and "rids" not in payload:
            rid = _REQUEST.get()
            if rid is not None:
                payload["rid"] = rid
        if payload:
            ev["args"] = payload
        self._push(ev)

    def instrument(self, name: str | None = None, cat: str = ""):
        """Decorator form of ``span`` (span name defaults to the function's
        qualified name)."""

        def deco(fn):
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(span_name, cat=cat):
                    return fn(*a, **kw)

            return wrapper

        return deco

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._t0 = time.perf_counter()

    def export_chrome(self, path=None) -> dict:
        """The Chrome ``trace_event`` document ({"traceEvents": [...]}).

        ``path`` set writes it as JSON (atomic enough for our use: written
        once at the end of a run).  Spans dropped by the ring buffer are
        reported in ``otherData`` so a truncated timeline is labelled as
        such instead of silently looking complete.
        """
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped, "capacity": self.capacity},
        }
        if path is not None:
            path = os.fspath(path)
            parent = os.path.dirname(path) or "."
            os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def validate_chrome_trace(doc: Any) -> list[str]:
    """Structural check of a trace document; returns problems ([] = ok)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"trace must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"traceEvents[{i}] must be an object")
            continue
        for field, types in (
            ("name", str), ("ph", str), ("ts", (int, float)),
            ("pid", int), ("tid", int),
        ):
            if not isinstance(ev.get(field), types):
                errs.append(f"traceEvents[{i}].{field} missing or mistyped")
        if ev.get("ph") == "X" and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"traceEvents[{i}]: complete event without dur")
    return errs


# ---------------------------------------------------------------------------
# Request timelines (reconstructed from rid/rids tagging).
# ---------------------------------------------------------------------------


def _event_list(doc_or_events: Any) -> list[dict]:
    if isinstance(doc_or_events, dict):
        return list(doc_or_events.get("traceEvents", []))
    return list(doc_or_events)


def request_timeline(doc_or_events: Any, rid: int) -> list[dict]:
    """Events attributed to request ``rid``, in timestamp order.

    Accepts either an exported Chrome trace document or a raw event list.
    An event belongs to the timeline when ``args.rid == rid`` or when
    ``rid`` appears in a batched ``args.rids`` list (decode ticks).
    """
    out = []
    for ev in _event_list(doc_or_events):
        args = ev.get("args") or {}
        if args.get("rid") == rid or rid in (args.get("rids") or ()):
            out.append(ev)
    return sorted(out, key=lambda e: e.get("ts", 0.0))


def trace_rids(doc_or_events: Any) -> set[int]:
    """Every rid mentioned anywhere in the trace (rid or rids tagging)."""
    rids: set[int] = set()
    for ev in _event_list(doc_or_events):
        args = ev.get("args") or {}
        if args.get("rid") is not None:
            rids.add(args["rid"])
        rids.update(args.get("rids") or ())
    return rids


def validate_request_timeline(doc_or_events: Any, rid: int) -> list[str]:
    """Check one request's span chain; returns problems ([] = ok).

    The scheduler contract (DESIGN.md §12): a served request's trace holds
    a ``serve.admit`` instant, at least one prefill span (``serve.prefill``
    or ``serve.prefill_chunk``), a ``serve.first_token`` instant, and a
    ``serve.evict`` instant, in that timestamp order, with every prefill
    span between admission and first token.  A ``serve.preempt`` instant
    (paged pool under page pressure, DESIGN.md §13) ends an admission
    episode: the request is re-queued and re-admitted from scratch, so
    each episode is checked independently and only the final one must run
    through first token to eviction.  Only meaningful while the whole
    request fits in the tracer ring buffer (a dropped prefix is the
    ring's documented behaviour, not a scheduler bug).
    """
    tl = request_timeline(doc_or_events, rid)
    errs: list[str] = []

    # split at preempt instants: each segment is one admission episode,
    # with the preempt event closing the episode it interrupted
    episodes: list[list[dict]] = [[]]
    for ev in tl:
        episodes[-1].append(ev)
        if ev["name"] == "serve.preempt":
            episodes.append([])
    episodes = [ep for ep in episodes if ep]

    def check_episode(ep: list[dict], final: bool) -> None:
        def first_ts(name: str) -> float | None:
            for ev in ep:
                if ev["name"] == name:
                    return ev["ts"]
            return None

        admit = first_ts("serve.admit")
        first_tok = first_ts("serve.first_token")
        evict = first_ts("serve.evict")
        prefills = [
            ev
            for ev in ep
            if ev["name"] in ("serve.prefill", "serve.prefill_chunk")
        ]
        required = [("serve.admit", admit)]
        if final:
            required += [
                ("serve.first_token", first_tok),
                ("serve.evict", evict),
            ]
            if not prefills:
                errs.append(f"rid {rid}: no prefill span")
        missing = False
        for name, ts in required:
            if ts is None:
                errs.append(f"rid {rid}: missing {name}")
                missing = True
        if missing:
            return
        if final and not admit <= first_tok <= evict:
            errs.append(
                f"rid {rid}: admit/first_token/evict out of order "
                f"({admit:.1f}, {first_tok:.1f}, {evict:.1f})"
            )
        hi = first_tok if first_tok is not None else float("inf")
        for ev in prefills:
            if not admit <= ev["ts"] <= hi:
                errs.append(
                    f"rid {rid}: prefill span at ts={ev['ts']:.1f} outside "
                    f"[admit={admit:.1f}, first_token={hi:.1f}]"
                )

    if not episodes:
        return [
            f"rid {rid}: missing serve.admit",
            f"rid {rid}: missing serve.first_token",
            f"rid {rid}: missing serve.evict",
            f"rid {rid}: no prefill span",
        ]
    for i, ep in enumerate(episodes):
        check_episode(ep, final=i == len(episodes) - 1)
    return errs


# ---------------------------------------------------------------------------
# Process-wide default tracer.
# ---------------------------------------------------------------------------

_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, cat: str = "", **args):
    return _TRACER.span(name, cat=cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    _TRACER.instant(name, cat=cat, **args)


def instrument(name: str | None = None, cat: str = ""):
    return _TRACER.instrument(name, cat=cat)
