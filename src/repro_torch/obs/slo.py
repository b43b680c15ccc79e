"""SLO conformance, goodput accounting, and the flight recorder.

The port's copy of ``repro.obs.slo``; its bundles pass the reference's
``validate_postmortem`` (``tests/test_torch_obs.py``).

Utilization accounting answers "what fraction of peak are we getting?";
this module answers the question a serving operator actually poses:
**did each request get served within its latency budget, and how many of
our tokens were worth producing?**  Raw tok/s
rewards a scheduler that starves one request to feed the rest; *goodput*
-- tokens from requests that met every budget -- does not (DESIGN.md §12).

Three pieces:

  * ``SLOSpec``            -- declarative per-request budgets: TTFT
                              (admission -> first token), ITL (wall gap
                              between a request's consecutive tokens, the
                              co-scheduled prefill stall included -- that IS
                              what the request experienced), and queue wait
                              (eligible -> slot granted);
  * ``ConformanceTracker`` -- the scheduler feeds it per-request samples;
                              it records violations and classifies each
                              finished request conformant or not.  A request
                              is conformant iff it finished with zero
                              violations; goodput counts its tokens only
                              then (a request that blew its TTFT does not
                              become "good" by streaming fast afterwards);
  * ``FlightRecorder``     -- on SLO violation or engine exception, dumps a
                              postmortem bundle to the metrics dir: the
                              tracer ring-buffer tail, the merged registry
                              snapshot, and the offending request's
                              rid-tagged timeline.  Bounded (``max_bundles``)
                              so a pathological run cannot fill the disk;
                              ``validate_postmortem`` checks the bundle
                              schema.

Everything here is host-side bookkeeping on numbers the scheduler already
measures -- nothing touches the model's step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Any

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# The per-request budget kinds a spec can constrain (seconds internally,
# milliseconds at the API surface -- serving budgets are human-milliseconds).
SLO_KINDS = ("ttft", "itl", "queue_wait")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Declarative per-request latency budgets (None = unconstrained)."""

    ttft_ms: float | None = None
    itl_ms: float | None = None
    queue_wait_ms: float | None = None

    def __post_init__(self):
        for kind in SLO_KINDS:
            v = getattr(self, f"{kind}_ms")
            if v is not None and v <= 0:
                raise ValueError(f"{kind}_ms must be > 0, got {v}")

    def active(self) -> bool:
        return any(getattr(self, f"{k}_ms") is not None for k in SLO_KINDS)

    def budget_s(self, kind: str) -> float | None:
        if kind not in SLO_KINDS:
            raise ValueError(f"kind must be one of {SLO_KINDS}, got {kind!r}")
        ms = getattr(self, f"{kind}_ms")
        return None if ms is None else ms / 1e3

    def describe(self) -> dict:
        return {f"{k}_ms": getattr(self, f"{k}_ms") for k in SLO_KINDS}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One budget miss: request ``rid`` observed ``value_s`` against
    ``budget_s`` for ``kind``."""

    rid: int
    kind: str
    value_s: float
    budget_s: float

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "kind": self.kind,
            "value_ms": round(self.value_s * 1e3, 3),
            "budget_ms": round(self.budget_s * 1e3, 3),
        }


class ConformanceTracker:
    """Per-request SLO bookkeeping driven by the scheduler.

    The scheduler calls ``check(rid, kind, value_s)`` for every measured
    sample and ``on_finish(rid, n_tokens)`` at eviction; the tracker owns
    which requests stayed conformant and the resulting goodput token count.
    """

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self._violations: dict[int, list[Violation]] = {}
        self._finished: dict[int, bool] = {}  # rid -> conformant
        self.goodput_toks = 0

    def check(self, rid: int, kind: str, value_s: float) -> Violation | None:
        """Record one sample; returns the Violation when over budget."""
        budget = self.spec.budget_s(kind)
        if budget is None or value_s <= budget:
            return None
        v = Violation(rid, kind, value_s, budget)
        self._violations.setdefault(rid, []).append(v)
        return v

    def violations(self, rid: int | None = None) -> list[Violation]:
        if rid is not None:
            return list(self._violations.get(rid, []))
        return [v for vs in self._violations.values() for v in vs]

    def conformant(self, rid: int) -> bool:
        return not self._violations.get(rid)

    def on_finish(self, rid: int, n_tokens: int) -> bool:
        """Classify a finished request; conformant tokens count as goodput."""
        ok = self.conformant(rid)
        self._finished[rid] = ok
        if ok:
            self.goodput_toks += n_tokens
        return ok

    def summary(self) -> dict:
        by_kind = {k: 0 for k in SLO_KINDS}
        for v in self.violations():
            by_kind[v.kind] += 1
        return {
            "slo": self.spec.describe(),
            "requests_finished": len(self._finished),
            "requests_conformant": sum(self._finished.values()),
            "violations": by_kind,
            "goodput_toks": self.goodput_toks,
        }


# ---------------------------------------------------------------------------
# Flight recorder: postmortem bundles on violation / exception.
# ---------------------------------------------------------------------------

POSTMORTEM_SCHEMA_VERSION = 1


class FlightRecorder:
    """Dump a bounded postmortem bundle when something misses its budget.

    One bundle = one JSON file ``postmortem-<seq>-<reason>.json`` in
    ``out_dir``: the last ``tail`` tracer events (the flight recording), the
    offending request's rid-tagged timeline, and a merged snapshot of the
    given registries -- everything needed to answer "which request missed,
    and what was the system doing at the time" without re-running.

    ``max_bundles`` bounds disk use; suppressed dumps are counted
    (``suppressed``) so a storm of violations is visible in the last bundle
    that did land, not silently discarded.
    """

    def __init__(
        self,
        out_dir,
        *,
        tracer: _trace.Tracer | None = None,
        registries: tuple = (),
        tail: int = 512,
        max_bundles: int = 8,
    ):
        if tail < 1:
            raise ValueError(f"tail must be >= 1, got {tail}")
        if max_bundles < 1:
            raise ValueError(f"max_bundles must be >= 1, got {max_bundles}")
        self.out_dir = os.fspath(out_dir)
        self.tracer = tracer if tracer is not None else _trace.get_tracer()
        self.registries = tuple(registries)
        self.tail = tail
        self.max_bundles = max_bundles
        self.suppressed = 0
        self.paths: list[str] = []

    def dump(
        self, reason: str, *, rid: int | None = None, detail: dict | None = None
    ) -> str | None:
        """Write one bundle; returns its path (None once over the bound)."""
        if len(self.paths) >= self.max_bundles:
            self.suppressed += 1
            return None
        events = self.tracer.events()
        doc = {
            "schema": POSTMORTEM_SCHEMA_VERSION,
            "kind": "postmortem",
            "unix_time": time.time(),
            "reason": str(reason),
            "rid": rid,
            "detail": dict(detail or {}),
            "trace_tail": events[-self.tail :],
            "request_timeline": (
                _trace.request_timeline(events, rid) if rid is not None else []
            ),
            "snapshot": (
                _metrics.snapshot_doc(*self.registries) if self.registries else None
            ),
            "suppressed_dumps": self.suppressed,
        }
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "-", str(reason)) or "unknown"
        path = os.path.join(
            self.out_dir, f"postmortem-{len(self.paths):03d}-{slug}.json"
        )
        os.makedirs(self.out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.out_dir, prefix="postmortem-")
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)
        self.paths.append(path)
        return path


def validate_postmortem(doc: Any) -> list[str]:
    """Structural check of a flight-recorder bundle; returns problems
    ([] = ok).  Zero-dep, like the snapshot/trace validators."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"postmortem must be an object, got {type(doc).__name__}"]
    if doc.get("kind") != "postmortem":
        errs.append(f'kind must be "postmortem", got {doc.get("kind")!r}')
    if doc.get("schema") != POSTMORTEM_SCHEMA_VERSION:
        errs.append(
            f"schema must be {POSTMORTEM_SCHEMA_VERSION}, got {doc.get('schema')!r}"
        )
    if not isinstance(doc.get("unix_time"), (int, float)):
        errs.append("unix_time must be a number")
    if not isinstance(doc.get("reason"), str) or not doc.get("reason"):
        errs.append("reason must be a non-empty string")
    if doc.get("rid") is not None and not isinstance(doc.get("rid"), int):
        errs.append("rid must be an integer or null")
    if not isinstance(doc.get("detail"), dict):
        errs.append("detail must be an object")
    for field in ("trace_tail", "request_timeline"):
        events = doc.get(field)
        if not isinstance(events, list):
            errs.append(f"{field} must be a list")
            continue
        errs += [
            f"{field}: {e}"
            for e in _trace.validate_chrome_trace({"traceEvents": events})
        ]
    snap = doc.get("snapshot")
    if snap is not None:
        errs += [f"snapshot: {e}" for e in _metrics.validate_snapshot(snap)]
    return errs
