"""Cross-module model flags (kept tiny to avoid import cycles).

The counterpart of ``repro.models.modelflags``, copied whole (a test holds
the copy to the original):

  unroll_layers  the reference's dry-run cost probes unroll its layer scans
                 under it; the port's layers are Python loops already, so
                 nothing reads it here yet.
  opt(name)      perf-iteration toggles, comma-list in $REPRO_OPTS:
                   attn-cp        context-parallel chunked attention
                   moe-tp-expert  TP-only expert weights (no FSDP dim;
                                  ``distributed.sharding`` reads it)
"""

from __future__ import annotations

import contextlib
import contextvars
import os

LAYER_UNROLL = contextvars.ContextVar("repro_layer_unroll", default=False)


@contextlib.contextmanager
def unroll_layers():
    token = LAYER_UNROLL.set(True)
    try:
        yield
    finally:
        LAYER_UNROLL.reset(token)


def opt(name: str) -> bool:
    return name in os.environ.get("REPRO_OPTS", "").split(",")
