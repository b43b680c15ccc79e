"""Zero-dependency metrics registry: counters, gauges, histograms with labels.

The port's copy of ``repro.obs.metrics`` (pure Python, kept equal to it:
``tests/test_torch_obs.py`` holds the two against each other).

The paper's headline result is an *accounting* claim -- 99% of the DSPs busy,
>3 TFLOPS achieved out of a known peak -- and Table I is essentially a metrics
snapshot.  This module is the serving-time analogue: every layer of the stack
(kernel dispatch, autotuner, collectives, scheduler) records into a registry
whose snapshot answers the same question continuously: what fraction of the
machine's capability did we actually use, and where did the rest go?

Design constraints:

  * **hot-path cheap**: recording is a dict lookup + a float add under one
    lock; no string formatting, no allocation beyond the first call for a
    given (name, labels) pair.  A process-wide enable flag (``REPRO_OBS=0``
    or ``disabled()``) turns every record call into a single boolean check
    -- the ``obs`` benchmark asserts the *enabled* overhead stays <3% on the
    serving hot path, so the disabled path is strictly cheaper than that;
  * **zero-dep**: snapshots are plain dicts, the text form is
    Prometheus-style exposition, persistence is stdlib ``json`` -- nothing
    the container doesn't already have;
  * **thread-safe**: the scheduler is single-threaded today but the metrics
    must not constrain tomorrow's router layer (ROADMAP: disaggregated
    serving); every registry mutation takes the registry lock.

Two kinds of registries coexist deliberately:

  * the process-wide **default registry** (``get_registry()``) collects
    dispatch-level telemetry -- GEMM calls, plan-cache hits, autotuner
    measurements, collective hops -- which is naturally global;
  * per-run components (``ContinuousScheduler``) own a **private Registry**
    so two scheduler runs in one process (e.g. the gang-vs-continuous
    benchmark) never mix their latency histograms.

``Histogram.quantile`` is the one percentile implementation serving code is
allowed to use (DESIGN.md §11): nearest-rank on the sorted sample, which
*clamps* to the extremes instead of indexing past the tail -- p99 of 10
samples is the max, not an interpolation artefact or an IndexError.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import tempfile
import threading
import time
from typing import Any, Iterable

# ---------------------------------------------------------------------------
# Process-wide enable flag.
# ---------------------------------------------------------------------------

_TRUTHY = ("1", "true", "yes", "on")

_enabled = os.environ.get("REPRO_OBS", "1").strip().lower() in _TRUTHY or (
    os.environ.get("REPRO_OBS", "1").strip() == ""
)


def enabled() -> bool:
    """Whether instrumentation records anything (``REPRO_OBS=0`` disables)."""
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def disabled():
    """Scope with all obs recording (metrics AND tracer) off -- the
    benchmark's control arm."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


# ---------------------------------------------------------------------------
# Instruments.
# ---------------------------------------------------------------------------


def _label_key(labels: dict[str, Any]) -> tuple[tuple[str, str], ...]:
    """Canonical hashable identity of a label set."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_series(name: str, key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_series(series: str) -> tuple[str, dict[str, str]]:
    """Inverse of ``_format_series``: ``'a.b{x="1",y="z"}'`` ->
    ``("a.b", {"x": "1", "y": "z"})``.

    Snapshot documents key counters/gauges/histograms by formatted series
    name; offline readers (the drift watchdog, ``obs doctor``) use this to
    recover the label set.  Label values never contain a double quote in
    our emitters (``_format_series`` does not escape), so the simple regex
    split is exact for every series this package writes.
    """
    if "{" not in series:
        return series, {}
    name, _, rest = series.partition("{")
    return name, dict(_LABEL_RE.findall(rest.rstrip("}")))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition-format label-value escaping: backslash, double
    quote, and line feed are the three characters the format reserves."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_series(name: str, key: tuple[tuple[str, str], ...], suffix: str = "") -> str:
    base = name.replace(".", "_") + suffix
    if not key:
        return base
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return f"{base}{{{inner}}}"


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up; inc({n})")
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Raw-sample histogram: keeps every observation (bounded by
    ``maxlen``), so quantiles are exact over the retained window.

    The serving workloads this instruments observe thousands of samples per
    run, not millions; exact samples beat bucket boundaries for the p99
    comparisons the benchmarks assert.  Past ``maxlen`` the histogram
    degrades to a sliding window (oldest samples dropped) while ``count``
    and ``sum`` stay exact lifetime totals.
    """

    __slots__ = ("_values", "count", "sum", "maxlen", "_lock")

    def __init__(self, maxlen: int = 100_000):
        self._values: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.maxlen = maxlen
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self._values.append(v)
            if len(self._values) > self.maxlen:
                del self._values[: len(self._values) - self.maxlen]

    def values(self) -> list[float]:
        with self._lock:
            return list(self._values)

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile of the retained samples, clamped to the
        extremes (the one percentile implementation -- DESIGN.md §11).

        ``q`` in [0, 1].  With n samples the nearest-rank index is
        ``ceil(q * n) - 1`` clamped into [0, n-1]: p99 of fewer than 100
        samples is the **max** (the old sorted-list indexing could round to
        an interior element, or past the tail entirely), p0 is the min, and
        an empty histogram reports 0.0 rather than raising.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        with self._lock:
            if not self._values:
                return 0.0
            ordered = sorted(self._values)
        idx = max(0, min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1))
        return ordered[idx]

    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            vals = list(self._values)
            count, total = self.count, self.sum
        out = {
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "min": min(vals) if vals else 0.0,
            "max": max(vals) if vals else 0.0,
        }
        ordered = sorted(vals)
        for q in (0.5, 0.9, 0.99):
            if ordered:
                idx = max(0, min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1))
                out[f"p{int(q * 100)}"] = ordered[idx]
            else:
                out[f"p{int(q * 100)}"] = 0.0
        return out


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------


class Registry:
    """Get-or-create instrument store keyed by (name, label set)."""

    def __init__(self):
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._hists: dict[tuple, Histogram] = {}
        self._lock = threading.Lock()
        self._pending: list = []  # ``add_pending``'s flushes

    def add_pending(self, flush) -> None:
        """Call ``flush()`` before every read and reset of this registry: a
        writer that keeps its records back (``obs.attribution``'s GEMM records
        made outside a scope) brings them in then, so a read sees every
        record made before it."""
        self._pending.append(flush)

    def _sync(self) -> None:
        for flush in self._pending:
            flush()

    def _get(self, store: dict, cls, name: str, labels: dict) -> Any:
        key = (name, _label_key(labels))
        inst = store.get(key)
        if inst is None:
            with self._lock:
                inst = store.setdefault(key, cls())
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._hists, Histogram, name, labels)

    # -- convenience recorders (no-ops while disabled) -----------------------

    def inc(self, name: str, n: float = 1.0, **labels) -> None:
        if _enabled:
            self.counter(name, **labels).inc(n)

    def set(self, name: str, v: float, **labels) -> None:
        if _enabled:
            self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        if _enabled:
            self.histogram(name, **labels).observe(v)

    # -- introspection -------------------------------------------------------

    def series(self) -> Iterable[str]:
        self._sync()
        with self._lock:
            keys = (
                list(self._counters) + list(self._gauges) + list(self._hists)
            )
        return sorted(_format_series(n, k) for n, k in keys)

    def counter_value(self, name: str, **labels) -> float:
        """Current value without creating the series (0.0 if absent)."""
        self._sync()
        inst = self._counters.get((name, _label_key(labels)))
        return inst.value if inst is not None else 0.0

    def snapshot(self) -> dict:
        """Plain-dict view: {"counters": {series: v}, "gauges": {...},
        "histograms": {series: {count, sum, mean, min, max, p50, p90, p99}}}.
        """
        self._sync()
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {
                _format_series(n, k): c.value for (n, k), c in sorted(counters.items())
            },
            "gauges": {
                _format_series(n, k): g.value for (n, k), g in sorted(gauges.items())
            },
            "histograms": {
                _format_series(n, k): h.snapshot() for (n, k), h in sorted(hists.items())
            },
        }

    def to_prometheus(self) -> str:
        """Prometheus-style text exposition (counters as ``_total``,
        histogram quantiles as pre-aggregated gauge series).

        Rendered from the raw instruments, not ``snapshot()``'s formatted
        series keys, so label values get exposition-format escaping
        (``\\``, ``"``, and newlines -- a label carrying an error message
        or a file path must not be able to break the line format).
        """
        self._sync()
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        lines: list[str] = []
        for (name, key), c in counters:
            lines.append(f"{_prom_series(name, key, '_total')} {c.value:g}")
        for (name, key), g in gauges:
            lines.append(f"{_prom_series(name, key)} {g.value:g}")
        for (name, key), h in hists:
            snap = h.snapshot()
            lines.append(f"{_prom_series(name, key, '_count')} {snap['count']:g}")
            lines.append(f"{_prom_series(name, key, '_sum')} {snap['sum']:g}")
            for q in ("p50", "p90", "p99"):
                lines.append(f"{_prom_series(name, key, '_' + q)} {snap[q]:g}")
        return "\n".join(lines) + "\n"

    def write_json(self, path, extra: dict | None = None) -> dict:
        """Atomically persist ``snapshot_doc`` (schema below) to ``path``."""
        doc = snapshot_doc(self, extra=extra)
        path = os.fspath(path)
        parent = os.path.dirname(path) or "."
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=parent, prefix=os.path.basename(path))
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return doc

    def reset(self) -> None:
        self._sync()  # records kept back are dropped with the rest
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# ---------------------------------------------------------------------------
# Snapshot document (what --metrics-dir writes; CI validates this shape).
# ---------------------------------------------------------------------------

SNAPSHOT_SCHEMA_VERSION = 1


def snapshot_doc(*registries: Registry, extra: dict | None = None) -> dict:
    """Merge one or more registries into the on-disk snapshot document.

    Later registries win on (exact) series collisions -- in practice the
    process registry and a scheduler's private registry have disjoint
    namespaces (``gemm.*``/``tune.*``/``collective.*`` vs ``serve.*``).
    """
    merged = {"counters": {}, "gauges": {}, "histograms": {}}
    for reg in registries:
        snap = reg.snapshot()
        for kind in merged:
            merged[kind].update(snap[kind])
    doc = {
        "schema": SNAPSHOT_SCHEMA_VERSION,
        "unix_time": time.time(),
        **merged,
    }
    if extra:
        doc["extra"] = extra
    return doc


def validate_snapshot(doc: Any) -> list[str]:
    """Structural check of a snapshot document; returns problems ([] = ok).

    Deliberately implemented without jsonschema (zero-dep constraint); the
    CI smoke feeds the --metrics-dir output through this.
    """
    errs: list[str] = []
    if not isinstance(doc, dict):
        return [f"snapshot must be an object, got {type(doc).__name__}"]
    if doc.get("schema") != SNAPSHOT_SCHEMA_VERSION:
        errs.append(f"schema must be {SNAPSHOT_SCHEMA_VERSION}, got {doc.get('schema')!r}")
    if not isinstance(doc.get("unix_time"), (int, float)):
        errs.append("unix_time must be a number")
    for kind in ("counters", "gauges"):
        sect = doc.get(kind)
        if not isinstance(sect, dict):
            errs.append(f"{kind} must be an object")
            continue
        for series, v in sect.items():
            if not isinstance(v, (int, float)):
                errs.append(f"{kind}[{series!r}] must be a number, got {v!r}")
    hists = doc.get("histograms")
    if not isinstance(hists, dict):
        errs.append("histograms must be an object")
    else:
        required = ("count", "sum", "mean", "min", "max", "p50", "p90", "p99")
        for series, h in hists.items():
            if not isinstance(h, dict):
                errs.append(f"histograms[{series!r}] must be an object")
                continue
            for field in required:
                if not isinstance(h.get(field), (int, float)):
                    errs.append(f"histograms[{series!r}].{field} must be a number")
    return errs


# ---------------------------------------------------------------------------
# Process-wide default registry (dispatch-level telemetry).
# ---------------------------------------------------------------------------

_REGISTRY = Registry()


def get_registry() -> Registry:
    return _REGISTRY


def reset() -> None:
    """Clear the default registry (tests isolate themselves with this)."""
    _REGISTRY.reset()


def inc(name: str, n: float = 1.0, **labels) -> None:
    _REGISTRY.inc(name, n, **labels)


def set_gauge(name: str, v: float, **labels) -> None:
    _REGISTRY.set(name, v, **labels)


def observe(name: str, v: float, **labels) -> None:
    _REGISTRY.observe(name, v, **labels)
