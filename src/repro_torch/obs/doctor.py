"""``obs doctor`` — ranked diagnosis of a serve run from its metrics dir.

The port's copy of ``repro.obs.doctor``.  Given the directory a serve run
wrote with ``--metrics-dir`` (final ``snapshot.json``, optional
``trace.json``), doctor answers the questions a perf investigation starts
with:

* where did the wall time go? — measured per-phase breakdown (prefill,
  decode, scheduling gap, telemetry callbacks) against the run's measured
  wall clock, with a coverage figure so truncated accounting is visible;
* where do measurement and model disagree? — serve-step model residual,
  modeled vs measured collective overlap, and per-GEMM sampled time vs
  the roofline on the card;
* which tuned plans went stale? — the drift watchdog (``obs.drift``) run
  over the snapshot's ``profile.gemm_us`` samples against the plan cache;
* which phase caused each SLO violation? — every ``slo.violation`` trace
  instant is attributed to the phase whose spans dominate its lookback
  window.

The report is a schema-versioned document (``kind: "doctor"``) rendered as
text or ``--json``; ``python -m repro_torch.obs <report.json>`` validates it
like every other obs artifact.  Exit codes: 0 healthy, 1 stale plans found,
2 unreadable or invalid inputs.
"""

from __future__ import annotations

import json
import os
from typing import Any

from repro_torch.obs import drift as _drift
from repro_torch.obs import metrics as _metrics

__all__ = [
    "DOCTOR_SCHEMA_VERSION",
    "build_report",
    "render_text",
    "validate_doctor_report",
]

DOCTOR_SCHEMA_VERSION = 1

# Phase attribution for SLO correlation: trace span name -> phase.
_PHASE_SPANS = {
    "serve.prefill": "prefill",
    "serve.prefill_chunk": "prefill",
    "serve.decode_tick": "decode",
    "serve.warmup": "warmup",
}


def _counter(snapshot: dict, name: str) -> float:
    return float(snapshot.get("counters", {}).get(name, 0.0))


def _gauge(snapshot: dict, name: str) -> float:
    return float(snapshot.get("gauges", {}).get(name, 0.0))


def _phases(snapshot: dict) -> tuple[list[dict], float, str, float]:
    """(ranked phases, wall_s, wall_basis, coverage).

    Phases are *measured*: prefill and decode are scheduler windows timed
    on the host's clock up to the card's finishing them, the scheduling gap
    is tick time not covered by either, telemetry is the on_tick callback
    time.  Coverage holds their
    sum against the run's measured wall clock (``sched.run_wall_s``); on
    snapshots predating that gauge the tick clock is the best basis
    available and coverage degenerates to ~1 by construction.
    """
    prefill_s = _counter(snapshot, "sched.prefill_s")
    decode_s = _counter(snapshot, "sched.decode_s")
    tick_s = _counter(snapshot, "sched.tick_s")
    cb_s = _counter(snapshot, "sched.callback_s")
    gap_s = max(0.0, tick_s - prefill_s - decode_s)
    run_wall = _gauge(snapshot, "sched.run_wall_s")
    if run_wall > 0:
        wall, basis = run_wall, "sched.run_wall_s"
    else:
        wall, basis = tick_s + cb_s, "sched.tick_s+sched.callback_s"
    phases = [
        {"name": "prefill", "seconds": prefill_s},
        {"name": "decode", "seconds": decode_s},
        {"name": "sched_gap", "seconds": gap_s},
        {"name": "telemetry", "seconds": cb_s},
    ]
    for p in phases:
        p["share"] = p["seconds"] / wall if wall > 0 else 0.0
    phases.sort(key=lambda p: -p["seconds"])
    covered = tick_s + cb_s
    coverage = covered / wall if wall > 0 else 0.0
    return phases, wall, basis, coverage


def _kv_rows(snapshot: dict) -> list[dict]:
    """Extrapolated KV gather/scatter totals from sampled timing series."""
    rows = []
    counters = snapshot.get("counters", {})
    for series, calls in sorted(counters.items()):
        base, labels = _metrics.parse_series(series)
        if base not in ("kv.gather.calls", "kv.scatter.calls"):
            continue
        op = base.split(".")[1]
        sampled = counters.get(
            _metrics._format_series(
                f"kv.{op}.sampled", _metrics._label_key(labels)
            ),
            0.0,
        )
        sampled_us = counters.get(
            _metrics._format_series(
                f"kv.{op}.sampled_us", _metrics._label_key(labels)
            ),
            0.0,
        )
        mean_us = sampled_us / sampled if sampled else 0.0
        rows.append(
            {
                "op": op,
                "pool": labels.get("pool", ""),
                "path": labels.get("path", ""),
                "calls": int(calls),
                "sampled": int(sampled),
                "mean_us": mean_us,
                # rate-limited sampling extrapolation (see obs.profile)
                "est_total_s": mean_us * calls / 1e6,
            }
        )
    rows.sort(key=lambda r: -r["est_total_s"])
    return rows


def _collective_rows(snapshot: dict) -> list[dict]:
    """Pair modeled and measured overlap ratios per collective mode."""
    by_mode: dict[str, dict] = {}
    for series, v in sorted(snapshot.get("gauges", {}).items()):
        base, labels = _metrics.parse_series(series)
        if base != "collective.overlap_ratio":
            continue
        mode = labels.get("mode", "")
        kind = labels.get("kind", "modeled")
        by_mode.setdefault(mode, {"mode": mode, "modeled": None, "measured": None})
        by_mode[mode][kind] = float(v)
    rows = []
    for mode, r in sorted(by_mode.items()):
        if r["modeled"] and r["measured"] is not None:
            r["residual"] = r["measured"] - r["modeled"]
        else:
            r["residual"] = None
        rows.append(r)
    return rows


def _slo_correlation(trace: dict | None) -> dict:
    """Attribute each ``slo.violation`` instant to the phase whose spans
    dominate its lookback window ``[ts - value_ms, ts]``."""
    out: dict[str, Any] = {"violations": 0, "correlated": []}
    if not trace:
        return out
    events = trace.get("traceEvents", [])
    spans = [
        e
        for e in events
        if e.get("ph") == "X" and e.get("name") in _PHASE_SPANS
    ]
    for ev in events:
        if ev.get("ph") != "i" or ev.get("name") != "slo.violation":
            continue
        out["violations"] += 1
        args = ev.get("args", {})
        ts = float(ev.get("ts", 0.0))
        lookback_us = max(float(args.get("value_ms", 0.0)) * 1e3, 1.0)
        lo = ts - lookback_us
        overlap: dict[str, float] = {}
        for sp in spans:
            s0 = float(sp["ts"])
            s1 = s0 + float(sp.get("dur", 0.0))
            ov = min(s1, ts) - max(s0, lo)
            if ov > 0:
                phase = _PHASE_SPANS[sp["name"]]
                overlap[phase] = overlap.get(phase, 0.0) + ov
        phase = max(overlap, key=overlap.get) if overlap else "unknown"
        out["correlated"].append(
            {
                "rid": args.get("rid"),
                "kind": args.get("kind"),
                "value_ms": args.get("value_ms"),
                "budget_ms": args.get("budget_ms"),
                "phase": phase,
            }
        )
    return out


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def build_report(
    metrics_dir: str,
    *,
    threshold: float = _drift.DEFAULT_DRIFT_THRESHOLD,
    tune_cache=None,
    chip=None,
    snapshot_name: str = "snapshot.json",
    trace_name: str = "trace.json",
) -> dict:
    """Assemble the doctor document from a serve run's metrics directory.

    Raises OSError / ValueError on unreadable or invalid inputs (the CLI
    maps those to exit code 2).
    """
    snap_path = os.path.join(metrics_dir, snapshot_name)
    snapshot = _read_json(snap_path)
    errs = _metrics.validate_snapshot(snapshot)
    if errs:
        raise ValueError(f"invalid snapshot {snap_path}: {errs[:3]}")

    trace = None
    trace_path = os.path.join(metrics_dir, trace_name)
    if os.path.exists(trace_path):
        trace = _read_json(trace_path)

    phases, wall, basis, coverage = _phases(snapshot)
    kv = _kv_rows(snapshot)
    findings = _drift.check_drift(
        snapshot, cache=tune_cache, chip=chip, threshold=threshold
    )
    resid_h = snapshot.get("histograms", {}).get("serve.model_residual")

    top: list[dict] = [
        {"component": f"phase:{p['name']}", "seconds": p["seconds"]}
        for p in phases
    ]
    top += [
        {
            "component": f"kv:{r['op']}{{pool={r['pool']},path={r['path']}}}",
            "seconds": r["est_total_s"],
        }
        for r in kv
    ]
    top.sort(key=lambda r: -r["seconds"])

    return {
        "kind": "doctor",
        "schema": DOCTOR_SCHEMA_VERSION,
        "metrics_dir": os.path.abspath(metrics_dir),
        "wall_s": wall,
        "wall_basis": basis,
        "coverage": coverage,
        "phases": phases,
        "top_sinks": top[:10],
        "kv": kv,
        "residuals": {
            "serve_model_residual_mean": (
                float(resid_h["mean"]) if resid_h and resid_h.get("count") else None
            ),
            "collective": _collective_rows(snapshot),
            "gemms": [f.to_json() for f in findings],
        },
        "stale_plans": [f.to_json() for f in findings if f.stale],
        "drift_threshold": threshold,
        "slo": _slo_correlation(trace),
    }


def render_text(report: dict) -> str:
    """Human-readable rendering of a doctor document."""
    L: list[str] = []
    L.append(f"obs doctor — {report['metrics_dir']}")
    L.append(
        f"wall {report['wall_s']:.3f}s ({report['wall_basis']}), "
        f"measured phase coverage {report['coverage'] * 100:.1f}%"
    )
    L.append("")
    L.append("time sinks (measured, ranked):")
    for r in report["top_sinks"]:
        if r["seconds"] <= 0:
            continue
        share = r["seconds"] / report["wall_s"] if report["wall_s"] > 0 else 0.0
        L.append(f"  {r['component']:<44s} {r['seconds']:>9.4f}s  {share * 100:5.1f}%")
    res = report["residuals"]
    L.append("")
    L.append("measured vs modeled:")
    if res["serve_model_residual_mean"] is not None:
        L.append(
            "  serve step wall/modeled ratio (mean):     "
            f"{res['serve_model_residual_mean']:.2f}x"
        )
    for c in res["collective"]:
        measured = (
            f"{c['measured']:.3f}" if c["measured"] is not None else "  (none)"
        )
        L.append(
            f"  collective.overlap_ratio{{{c['mode']}}}: modeled "
            f"{c['modeled']:.3f} measured {measured}"
        )
    for g in res["gemms"]:
        L.append(
            f"  gemm {g['problem']:<18s} sampled {g['sampled_us']:>10.1f}us  "
            f"model {g['model_us']:>8.1f}us  ({g['model_ratio']:.0f}x, "
            f"method={g['method']})"
        )
    L.append("")
    stale = report["stale_plans"]
    if stale:
        L.append(f"STALE PLANS ({len(stale)}):")
        for f in stale:
            L.append(f"  {f['key']}: {f['recommendation']}")
    else:
        L.append("stale plans: none")
    slo = report["slo"]
    L.append("")
    L.append(f"slo violations: {slo['violations']}")
    for v in slo["correlated"]:
        L.append(
            f"  rid={v['rid']} {v['kind']} {v['value_ms']}ms "
            f"(budget {v['budget_ms']}ms) <- phase: {v['phase']}"
        )
    return "\n".join(L)


def validate_doctor_report(doc: Any) -> list[str]:
    """Schema check for a doctor document; [] when valid."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["doctor report must be a JSON object"]
    if doc.get("kind") != "doctor":
        errs.append(f"kind must be 'doctor', got {doc.get('kind')!r}")
    if doc.get("schema") != DOCTOR_SCHEMA_VERSION:
        errs.append(f"schema must be {DOCTOR_SCHEMA_VERSION}, got {doc.get('schema')!r}")
    for field, typ in (
        ("metrics_dir", str),
        ("wall_s", (int, float)),
        ("wall_basis", str),
        ("coverage", (int, float)),
        ("phases", list),
        ("top_sinks", list),
        ("kv", list),
        ("residuals", dict),
        ("stale_plans", list),
        ("slo", dict),
    ):
        if not isinstance(doc.get(field), typ):
            errs.append(f"field {field!r} must be {typ}, got {type(doc.get(field))}")
    if errs:
        return errs
    for i, p in enumerate(doc["phases"]):
        if not isinstance(p, dict) or not isinstance(p.get("name"), str):
            errs.append(f"phases[{i}] malformed")
            continue
        for f in ("seconds", "share"):
            if not isinstance(p.get(f), (int, float)):
                errs.append(f"phases[{i}].{f} must be a number")
    for i, f in enumerate(doc["stale_plans"]):
        if not isinstance(f, dict) or not f.get("stale"):
            errs.append(f"stale_plans[{i}] must be a stale finding")
    slo = doc["slo"]
    if not isinstance(slo.get("violations"), int):
        errs.append("slo.violations must be an int")
    if not isinstance(slo.get("correlated"), list):
        errs.append("slo.correlated must be a list")
    return errs
