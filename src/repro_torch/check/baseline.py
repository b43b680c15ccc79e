"""Suppression baseline: the gate fails on *new* findings only.

The port's copy of ``repro.check.baseline``, with its own ``baseline.json``
beside it.  Same pattern as the benchmark ledger: a checked-in JSON file
records the fingerprints of known findings; the CI gate compares the current run against
it and fails only on fingerprints not present in the baseline.  The shipped
baseline is empty -- every finding the port's first run surfaced was fixed
in the code -- and it stays empty: a finding is fixed, not baselined; the
file exists so that an emergency can land with a recorded, reviewable debt
instead of a disabled check.

Fingerprints exclude line numbers (see ``findings.Finding.fingerprint``), so
a baseline survives unrelated edits; a finding whose *message* changes (the
mismatch got worse) counts as new and fails the gate again.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable

from repro_torch.check.findings import Finding

DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


def load(path: str | Path | None = None) -> set[str]:
    """Fingerprints recorded in the baseline file (empty set if absent)."""
    p = Path(path) if path else DEFAULT_BASELINE
    if not p.exists():
        return set()
    doc = json.loads(p.read_text())
    return {entry["fingerprint"] for entry in doc.get("findings", [])}


def write(findings: Iterable[Finding], path: str | Path | None = None) -> Path:
    """Record the given findings as the new accepted baseline."""
    p = Path(path) if path else DEFAULT_BASELINE
    doc = {
        "version": 1,
        "findings": sorted(
            (
                {
                    "fingerprint": f.fingerprint,
                    "rule": f.rule,
                    "path": f.path,
                    "message": f.message,
                }
                for f in findings
            ),
            key=lambda e: e["fingerprint"],
        ),
    }
    p.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    return p


def partition(
    findings: Iterable[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding]]:
    """Split findings into (new, suppressed-by-baseline)."""
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
