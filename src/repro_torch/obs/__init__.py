"""Telemetry for the port's serving stack: the counterpart of ``repro.obs``.

  * ``metrics``      -- counters/gauges/histograms with labels (a copy of the
                        reference's);
  * ``trace``        -- span tracer exported as Chrome ``trace_event`` JSON,
                        with request-scoped tagging (a copy);
  * ``slo``          -- per-request latency budgets, conformance, goodput and
                        the flight recorder (a copy);
  * ``attribution``  -- ``GemmTotals``, ``collecting`` and ``mfu`` only;
  * ``profile``      -- sampled timing windows (``sample_call``) only.

``REPRO_OBS=0`` (env) or ``disabled()`` (scope) turns recording off.
"""

from repro_torch.obs.attribution import GemmTotals, collecting, mfu  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    disabled,
    enable,
    enabled,
    get_registry,
    inc,
    observe,
    parse_series,
    reset,
    set_gauge,
    snapshot_doc,
    validate_snapshot,
)
from repro_torch.obs.profile import Profiler, get_profiler, sample_call, sampling  # noqa: F401
from repro_torch.obs.slo import (  # noqa: F401
    ConformanceTracker,
    FlightRecorder,
    SLOSpec,
    validate_postmortem,
)
from repro_torch.obs.trace import (  # noqa: F401
    Tracer,
    current_request,
    get_tracer,
    instant,
    instrument,
    request_scope,
    request_timeline,
    span,
    trace_rids,
    validate_chrome_trace,
    validate_request_timeline,
)
