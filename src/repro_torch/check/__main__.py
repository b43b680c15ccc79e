"""``python -m repro_torch.check [paths]`` -- run both engines, gate on baseline.

The counterpart of ``python -m repro.check``, with the reference's flags plus
``--device``: the auditor runs on the card by default and raises on a host
without one; ``--device cpu`` runs its static part, ``--no-audit`` (lint
only) needs no device.  Exit codes: 0 = no findings beyond the baseline; 1 =
new findings; 2 = usage error.  ``--json`` emits the machine-readable
document.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.check import audit as audit_mod
from repro_torch.check import baseline as baseline_mod
from repro_torch.check import lint as lint_mod
from repro_torch.check.findings import Finding, to_json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-torch-check",
        description="kernel contract auditor + invariant linter of the PyTorch/CUDA port",
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files/directories/globs to lint (default: src/repro_torch tests/test_torch_*.py)",
    )
    p.add_argument("--json", action="store_true", help="emit JSON findings")
    p.add_argument(
        "--baseline",
        default=None,
        help=f"suppression baseline (default: {baseline_mod.DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept current findings into the baseline and exit 0",
    )
    p.add_argument("--no-lint", action="store_true", help="skip the linter")
    p.add_argument("--no-audit", action="store_true", help="skip the contract auditor")
    p.add_argument(
        "--no-sweep",
        action="store_true",
        help="audit dispatch paths only; skip the paper candidate sweep",
    )
    p.add_argument(
        "--plans",
        default=None,
        help="JSON file of plan specs to audit (the injection gate; see "
        "repro_torch.check.audit.audit_plan_spec for the format)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the auditor runs: 'cuda' (default) adds each binary's own "
        "report of its launches and raises without a card; 'cpu' is the "
        "static part",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    findings: list[Finding] = []
    stats: dict = {}

    if not args.no_lint:
        lint_findings = lint_mod.lint_paths(args.paths or lint_mod.DEFAULT_PATHS)
        stats["lint_findings"] = len(lint_findings)
        findings.extend(lint_findings)

    if not args.no_audit:
        audit_findings, audit_stats = audit_mod.run_audit(
            device=args.device,
            plans_file=args.plans,
            sweep=not args.no_sweep,
        )
        stats["audit_findings"] = len(audit_findings)
        stats.update(audit_stats)
        findings.extend(audit_findings)

    if args.write_baseline:
        path = baseline_mod.write(findings, args.baseline)
        print(f"wrote {len(findings)} finding(s) to {path}", file=sys.stderr)
        return 0

    known = baseline_mod.load(args.baseline)
    new, suppressed = baseline_mod.partition(findings, known)
    stats["suppressed"] = len(suppressed)
    stats["new"] = len(new)

    if args.json:
        print(to_json(new, stats=stats, suppressed=len(suppressed)))
    else:
        for f in new:
            print(f.render())
        summary = {k: v for k, v in stats.items() if k in ("lint_findings", "audit_findings", "plans_audited",
                                                            "device")}
        print(f"repro_torch.check: {len(new)} new finding(s), {len(suppressed)} baseline-suppressed "
              f"({json.dumps(summary)})", file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
