"""Obs artefact validation, the benchmark-ledger CLI and ``obs doctor``.

The port's copy of the reference's ``obs`` CLI.  Validate artefacts (exit
0 = all valid, problems printed one per line)::

    PYTHONPATH=src python -m repro_torch.obs snapshot.json trace.json postmortem-*.json

Files containing a ``traceEvents`` key validate against the Chrome
``trace_event`` structure, ``kind == "postmortem"`` against the
flight-recorder bundle schema, ``kind == "doctor"`` against the doctor
report's, everything else against the metrics snapshot schema.

Ledger subcommands::

    python -m repro_torch.obs ledger show    --ledger PATH
    python -m repro_torch.obs ledger record  --ledger PATH --bench NAME --json '{...}'
    python -m repro_torch.obs ledger compare --ledger PATH [--threshold 0.05]
                                             [--bench NAME] [--verbose]

``compare`` diffs each (bench, variant, chip, dtype) key's latest entry
against the previous one and exits 1 when any metric regresses past the
threshold.

Doctor::

    python -m repro_torch.obs doctor METRICS_DIR [--json] [--out PATH]
                                     [--drift-threshold F] [--tune-cache PATH]
                                     [--ledger PATH]

Ranked diagnosis of a serve run from its ``--metrics-dir`` artefacts:
measured per-phase breakdown, measured-vs-modeled residuals, stale tuned
plans (drift watchdog), SLO violations attributed to the causing phase.
Exit 0 healthy, 1 when stale plans are found, 2 on unreadable inputs.
``--ledger`` defaults to ``$REPRO_TORCH_LEDGER`` (the port's own variable).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.obs.metrics import validate_snapshot
from repro_torch.obs.slo import validate_postmortem
from repro_torch.obs.trace import validate_chrome_trace


def validate_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"unreadable JSON: {e}"]
    if isinstance(doc, dict) and "traceEvents" in doc:
        return validate_chrome_trace(doc)
    if isinstance(doc, dict) and doc.get("kind") == "postmortem":
        return validate_postmortem(doc)
    if isinstance(doc, dict) and doc.get("kind") == "doctor":
        from repro_torch.obs.doctor import validate_doctor_report

        return validate_doctor_report(doc)
    return validate_snapshot(doc)


def _validate_main(paths: list[str]) -> int:
    failed = False
    for path in paths:
        errs = validate_file(path)
        if errs:
            failed = True
            for e in errs:
                print(f"{path}: {e}")
        else:
            print(f"{path}: OK")
    return 1 if failed else 0


def ledger_main(argv: list[str]) -> int:
    from repro_torch.obs import ledger as _ledger

    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs ledger")
    sub = ap.add_subparsers(dest="cmd", required=True)

    show = sub.add_parser("show", help="list ledger entries")
    show.add_argument("--ledger", required=True, help="JSONL ledger path")

    rec = sub.add_parser("record", help="append one entry (CI injection / manual)")
    rec.add_argument("--ledger", required=True)
    rec.add_argument("--bench", required=True)
    rec.add_argument("--json", required=True, help="metrics as a JSON object")
    rec.add_argument("--variant", default=None)
    rec.add_argument("--chip", default=None)
    rec.add_argument("--dtype", default=None)
    rec.add_argument("--sha", default=None)

    cmp_ = sub.add_parser("compare", help="latest vs baseline per key; exit 1 on regression")
    cmp_.add_argument("--ledger", required=True)
    cmp_.add_argument("--threshold", type=float, default=0.05,
                      help="relative regression tolerance (default 5%%)")
    cmp_.add_argument("--bench", default=None, help="restrict to one benchmark")
    cmp_.add_argument("--skip", default=None, metavar="REGEX",
                      help="exclude metrics whose name matches (smoke-run "
                      "tail percentiles are noise, not signal)")
    cmp_.add_argument("--verbose", action="store_true",
                      help="print every metric delta, not just regressions")

    args = ap.parse_args(argv)
    ledger = _ledger.Ledger(args.ledger)

    if args.cmd == "show":
        entries, bad = ledger.entries()
        for e in entries:
            print(
                f"{e['git_sha'][:12]} {_ledger.entry_key(e).ident()} "
                f"({len(e['metrics'])} metrics)"
            )
        print(f"{len(entries)} entries" + (f", {bad} corrupted lines skipped" if bad else ""))
        return 0

    if args.cmd == "record":
        try:
            metrics = json.loads(args.json)
        except ValueError as e:
            print(f"--json is not valid JSON: {e}")
            return 2
        if not isinstance(metrics, dict):
            print("--json must be a JSON object")
            return 2
        entry = ledger.record(
            args.bench, metrics, variant=args.variant, chip=args.chip,
            dtype=args.dtype, sha=args.sha,
        )
        print(f"recorded {_ledger.entry_key(entry).ident()} -> {ledger.path}")
        return 0

    # compare
    entries, bad = ledger.entries()
    if bad:
        print(f"note: {bad} corrupted ledger lines skipped")
    results = _ledger.compare_latest(
        ledger, threshold=args.threshold, bench=args.bench, skip=args.skip
    )
    for line in _ledger.format_compare(results, verbose=args.verbose):
        print(line)
    return 1 if any(not r.ok for r in results) else 0


def doctor_main(argv: list[str]) -> int:
    from repro_torch.obs import doctor as _doctor
    from repro_torch.obs import drift as _drift

    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs doctor")
    ap.add_argument("metrics_dir", help="directory a serve run wrote with --metrics-dir")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the report document instead of text")
    ap.add_argument("--out", default=None,
                    help="also write the report document to this path")
    ap.add_argument("--drift-threshold", type=float,
                    default=_drift.DEFAULT_DRIFT_THRESHOLD,
                    help="relative stale-plan tolerance (default %(default)s: "
                    "flag plans >1.5x off their sampled time)")
    ap.add_argument("--tune-cache", default=None,
                    help="plan cache path (default: REPRO_TORCH_TUNE_CACHE / the "
                    "default cache)")
    ap.add_argument("--ledger", default=None,
                    help="record stale-plan findings into this regression "
                    "ledger (default: $REPRO_TORCH_LEDGER when set)")
    args = ap.parse_args(argv)

    cache = None
    if args.tune_cache is not None:
        from repro_torch.tune.cache import PlanCache

        cache = PlanCache(args.tune_cache)
    try:
        report = _doctor.build_report(
            args.metrics_dir, threshold=args.drift_threshold, tune_cache=cache
        )
    except (OSError, ValueError) as e:
        print(f"doctor: cannot read {args.metrics_dir}: {e}", file=sys.stderr)
        return 2
    errs = _doctor.validate_doctor_report(report)
    if errs:  # pragma: no cover - internal invariant
        for e in errs:
            print(f"doctor: invalid report: {e}", file=sys.stderr)
        return 2

    ledger_path = args.ledger or os.environ.get("REPRO_TORCH_LEDGER")
    if ledger_path and report["stale_plans"]:
        from repro_torch.obs.drift import DriftFinding
        from repro_torch.obs.ledger import Ledger

        findings = [DriftFinding(**f) for f in report["stale_plans"]]
        _drift.record_findings(findings, ledger=Ledger(ledger_path))

    doc = json.dumps(report, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(doc + "\n")
    print(doc if args.as_json else _doctor.render_text(report))
    return 1 if report["stale_plans"] else 0


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    if argv[0] == "ledger":
        return ledger_main(argv[1:])
    if argv[0] == "doctor":
        return doctor_main(argv[1:])
    return _validate_main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
