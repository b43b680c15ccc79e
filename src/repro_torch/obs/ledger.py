"""Append-only benchmark ledger: every BENCH JSON becomes a regression gate.

The port's copy of ``repro.obs.ledger`` (pure Python; ``tests/test_torch_ledger.py``
runs the reference's cases against both).  Entries are keyed by (git sha,
benchmark, variant, chip, dtype), and ``python -m repro_torch.obs ledger
compare`` diffs each key's latest entry against the previous one, failing on
relative regressions beyond a threshold.

Schema (one JSON object per line; the file is append-only, so history is
the file)::

    {"schema": 1, "unix_time": ..., "git_sha": "...",
     "bench": "serve", "variant": "continuous",
     "chip": "h100", "dtype": "bfloat16",
     "metrics": {"tok_per_s": 412.3, "p99_tick_ms": 18.2, ...},
     "meta": {...}}                                         # optional

Corrupted or unknown-schema lines are *skipped and counted*, never fatal:
an interrupted append must not take the whole history down.  ``git_sha``
reads "unknown" outside a repository (a ``git archive`` of the tree).

Regression direction is inferred from the metric name (``metric_direction``)
-- throughput-like metrics regress downward, latency/time-like metrics
regress upward, anything unclassifiable is informational only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import time
from typing import Any, Iterable

LEDGER_SCHEMA_VERSION = 1

# Name fragments that classify a metric's good direction.  Checked in this
# order: throughput-ish fragments win (``tok_per_s`` must not fall through
# to the ``_s`` time suffix), then time/latency suffixes and fragments.
_HIGHER_BETTER = (
    "tok_per_s", "gflops", "tflops", "goodput", "mfu", "occupancy",
    "hit_rate", "gain", "speedup", "conformant",
)
_LOWER_BETTER_SUFFIX = ("_ms", "_s", "_us")
_LOWER_BETTER = (
    "latency", "ttft", "itl", "residual", "overhead", "bytes", "violations",
)


def metric_direction(name: str) -> int:
    """+1 = higher is better, -1 = lower is better, 0 = informational."""
    low = name.lower()
    if any(frag in low for frag in _HIGHER_BETTER):
        return 1
    if low.endswith(_LOWER_BETTER_SUFFIX) or any(f in low for f in _LOWER_BETTER):
        return -1
    return 0


def git_sha(cwd: str | None = None) -> str:
    """Current commit sha ("unknown" outside a repo -- the ledger still
    records, it just cannot attribute the entry to a commit)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd,
            capture_output=True,
            text=True,
            timeout=10,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else "unknown"


# Fields a BENCH JSON may carry that discriminate rows within one benchmark
# (the serve benchmark emits one row per policy, quant one per mode/dtype).
_VARIANT_FIELDS = ("bench", "policy", "mode", "problem", "algorithm", "arm")


def derive_variant(metrics: dict) -> str:
    """Stable sub-key for one BENCH row within a benchmark entry."""
    parts = [
        str(metrics[f]) for f in _VARIANT_FIELDS if metrics.get(f) is not None
    ]
    return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class LedgerKey:
    bench: str
    variant: str = ""
    chip: str = ""
    dtype: str = ""

    def ident(self) -> str:
        return "/".join(p for p in (self.bench, self.variant, self.chip, self.dtype) if p)


def entry_key(entry: dict) -> LedgerKey:
    return LedgerKey(
        bench=str(entry.get("bench", "")),
        variant=str(entry.get("variant", "")),
        chip=str(entry.get("chip", "")),
        dtype=str(entry.get("dtype", "")),
    )


class Ledger:
    """One JSONL file of benchmark entries (see module docstring)."""

    def __init__(self, path):
        self.path = os.fspath(path)

    def record(
        self,
        bench: str,
        metrics: dict,
        *,
        variant: str | None = None,
        chip: str | None = None,
        dtype: str | None = None,
        sha: str | None = None,
        meta: dict | None = None,
    ) -> dict:
        """Append one entry; returns the recorded document."""
        if not bench:
            raise ValueError("bench name must be non-empty")
        if chip is None:
            from repro_torch.core import hw

            chip = hw.get_chip(None).name
        entry = {
            "schema": LEDGER_SCHEMA_VERSION,
            "unix_time": time.time(),
            "git_sha": sha if sha is not None else git_sha(),
            "bench": str(bench),
            "variant": derive_variant(metrics) if variant is None else str(variant),
            "chip": str(chip),
            "dtype": str(dtype if dtype is not None else metrics.get("dtype", "")),
            "metrics": dict(metrics),
        }
        if meta:
            entry["meta"] = dict(meta)
        parent = os.path.dirname(self.path) or "."
        os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry, sort_keys=True) + "\n")
        return entry

    def entries(self) -> tuple[list[dict], int]:
        """(valid entries in file order, corrupted/unknown line count)."""
        if not os.path.exists(self.path):
            return [], 0
        out: list[dict] = []
        bad = 0
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                if (
                    not isinstance(entry, dict)
                    or entry.get("schema") != LEDGER_SCHEMA_VERSION
                    or not entry.get("bench")
                    or not isinstance(entry.get("metrics"), dict)
                ):
                    bad += 1
                    continue
                out.append(entry)
        return out, bad

    def by_key(self) -> dict[LedgerKey, list[dict]]:
        grouped: dict[LedgerKey, list[dict]] = {}
        for entry in self.entries()[0]:
            grouped.setdefault(entry_key(entry), []).append(entry)
        return grouped

    def __len__(self) -> int:
        return len(self.entries()[0])


# ---------------------------------------------------------------------------
# Comparison: latest entry vs its baseline, per key.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricDelta:
    name: str
    baseline: float
    current: float
    rel: float  # (current - baseline) / |baseline|
    direction: int
    regression: bool


@dataclasses.dataclass(frozen=True)
class CompareResult:
    key: LedgerKey
    baseline_sha: str
    current_sha: str
    deltas: tuple[MetricDelta, ...]
    threshold: float

    @property
    def regressions(self) -> tuple[MetricDelta, ...]:
        return tuple(d for d in self.deltas if d.regression)

    @property
    def ok(self) -> bool:
        return not self.regressions


def compare_entries(
    current: dict, baseline: dict, *, threshold: float = 0.05,
    skip: str | None = None,
) -> CompareResult:
    """Relative metric deltas of ``current`` vs ``baseline``.

    A delta is a regression when it moves against the metric's direction by
    more than ``threshold`` (relative).  Non-numeric metrics, booleans, and
    metrics absent from either entry are skipped; direction-0 metrics are
    reported but never regress.  ``skip`` is a regex searched against each
    metric name -- matches are excluded entirely.  CI smoke runs use it to
    drop tail percentiles (a p99 over ~20 CPU samples is the max of a noisy
    handful and swings severalfold between identical runs); a relative
    threshold cannot make such a metric gateable at smoke scale.
    """
    if threshold < 0:
        raise ValueError(f"threshold must be >= 0, got {threshold}")
    skip_re = re.compile(skip) if skip else None
    deltas: list[MetricDelta] = []
    cur_m, base_m = current.get("metrics", {}), baseline.get("metrics", {})
    for name in sorted(set(cur_m) & set(base_m)):
        if skip_re is not None and skip_re.search(name):
            continue
        cv, bv = cur_m[name], base_m[name]
        if isinstance(cv, bool) or isinstance(bv, bool):
            continue
        if not isinstance(cv, (int, float)) or not isinstance(bv, (int, float)):
            continue
        if bv == 0:
            continue  # no relative scale to judge against
        rel = (cv - bv) / abs(bv)
        direction = metric_direction(name)
        regression = (direction > 0 and rel < -threshold) or (
            direction < 0 and rel > threshold
        )
        deltas.append(MetricDelta(name, float(bv), float(cv), rel, direction, regression))
    return CompareResult(
        key=entry_key(current),
        baseline_sha=str(baseline.get("git_sha", "unknown")),
        current_sha=str(current.get("git_sha", "unknown")),
        deltas=tuple(deltas),
        threshold=threshold,
    )


def compare_latest(
    ledger: Ledger, *, threshold: float = 0.05, bench: str | None = None,
    skip: str | None = None,
) -> list[CompareResult]:
    """Per key: latest entry vs the one before it (the "latest baseline").

    Keys with fewer than two entries have no baseline yet and are skipped --
    a fresh ledger passes the gate vacuously and starts gating from its
    second recording.
    """
    results = []
    for key, entries in sorted(ledger.by_key().items(), key=lambda kv: kv[0].ident()):
        if bench is not None and key.bench != bench:
            continue
        if len(entries) < 2:
            continue
        results.append(
            compare_entries(
                entries[-1], entries[-2], threshold=threshold, skip=skip
            )
        )
    return results


# ---------------------------------------------------------------------------
# BENCH-row ingestion (a benchmark's printed rows).
# ---------------------------------------------------------------------------


def record_bench_rows(
    ledger: Ledger, bench: str, rows: Iterable[Any], **kwargs
) -> int:
    """Record every ``BENCH {json}`` line of a benchmark's output rows;
    returns how many entries landed.  Unparseable BENCH lines are skipped
    (the benchmark already printed them; the ledger only ingests clean
    ones)."""
    n = 0
    for row in rows:
        if not isinstance(row, str) or not row.startswith("BENCH "):
            continue
        try:
            metrics = json.loads(row[len("BENCH ") :])
        except ValueError:
            continue
        if not isinstance(metrics, dict):
            continue
        ledger.record(bench, metrics, **kwargs)
        n += 1
    return n


def format_compare(results: list[CompareResult], *, verbose: bool = False) -> list[str]:
    """Human-readable compare report (one line per key + regressions)."""
    lines: list[str] = []
    if not results:
        return ["ledger compare: no keys with a baseline yet (need >= 2 entries)"]
    for res in results:
        verdict = "OK" if res.ok else "REGRESSION"
        lines.append(
            f"{res.key.ident()}: {verdict} "
            f"({len(res.deltas)} metrics vs baseline {res.baseline_sha[:12]}, "
            f"threshold {res.threshold:.0%})"
        )
        shown = res.deltas if verbose else res.regressions
        for d in shown:
            arrow = "+" if d.rel >= 0 else ""
            tag = "REGRESSION" if d.regression else "ok"
            lines.append(
                f"  {d.name}: {d.baseline:g} -> {d.current:g} "
                f"({arrow}{d.rel:.1%}) [{tag}]"
            )
    return lines
