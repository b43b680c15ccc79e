"""Finding model shared by both repro_torch.check engines.

The port's copy of ``repro.check.findings``; a test holds its fingerprints
and JSON equal to the reference's for the same fields.  A finding is one
violated contract: a lint rule hit at a source location, or an auditor
mismatch between a plan's claims and the launch the kernel makes.  The
fingerprint deliberately excludes the line number -- baselines must survive
unrelated edits above a suppressed finding -- and includes the message, so a
finding that *changes* (say the mismatch grows) counts as new.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Iterable

# Engine names (the `engine` field of every finding).
LINT = "lint"
AUDIT = "audit"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated contract.

    ``path`` is a repo-relative posix path for lint findings and a pseudo
    path (``<plan:512x512x512/128x128x64@bfloat16>``) for audit findings;
    ``symbol`` is the enclosing function/class qualname (lint) or the check
    name (audit); ``line`` is 0 for location-free findings.
    """

    engine: str
    rule: str
    path: str
    line: int
    symbol: str
    message: str

    @property
    def fingerprint(self) -> str:
        ident = "|".join((self.engine, self.rule, self.path, self.symbol, self.message))
        return hashlib.sha1(ident.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.engine}/{self.rule}] {self.symbol}: {self.message}"


def to_json(findings: Iterable[Finding], **extra: Any) -> str:
    doc = {
        "version": 1,
        "findings": [f.to_dict() for f in findings],
    }
    doc.update(extra)
    return json.dumps(doc, indent=2, sort_keys=True)
