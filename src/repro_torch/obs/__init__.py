"""Telemetry for the port: the counterpart of ``repro.obs``.

  * ``metrics``      -- counters/gauges/histograms with labels (a copy of the
                        reference's);
  * ``trace``        -- span tracer exported as Chrome ``trace_event`` JSON,
                        with request-scoped tagging (a copy);
  * ``attribution``  -- per-launch GEMM accounting of K1, K4 and K5: MFU over
                        the card's datasheet peak, measured-vs-roofline model
                        residual, plan-cache hits (eager: recorded on every
                        launch, tallied per scope);
  * ``slo``          -- per-request latency budgets, conformance, goodput and
                        the flight recorder (a copy);
  * ``ledger``       -- append-only JSONL benchmark ledger (a copy);
  * ``profile``      -- sampled measured timing windows (host clock to the
                        card's finishing the call) around K1 and the KV pool;
  * ``drift``        -- the drift watchdog: the decode GEMMs re-measured with
                        CUDA events against the roofline and the plan cache;
  * ``doctor``       -- ``python -m repro_torch.obs doctor <metrics-dir>``:
                        ranked diagnosis of a serve run.

``REPRO_OBS=0`` (env) or ``disabled()`` (scope) turns every record call into
one boolean check.
"""

from repro_torch.obs.doctor import (  # noqa: F401
    build_report,
    render_text,
    validate_doctor_report,
)
from repro_torch.obs.drift import (  # noqa: F401
    DriftFinding,
    check_drift,
    probe_decode_plans,
    record_findings,
)
from repro_torch.obs.profile import (  # noqa: F401
    Profiler,
    get_profiler,
    record_gemm_sample,
    sample_call,
    sampling,
)
from repro_torch.obs.attribution import (  # noqa: F401
    GemmTotals,
    collecting,
    mfu,
    plan_hit_rate,
    record_gemm,
    roofline_seconds,
)
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
from repro_torch.obs.ledger import (  # noqa: F401
    Ledger,
    compare_entries,
    compare_latest,
    metric_direction,
    record_bench_rows,
)
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

__all__ = [
    "ConformanceTracker",
    "Counter",
    "DriftFinding",
    "FlightRecorder",
    "Gauge",
    "GemmTotals",
    "Histogram",
    "Ledger",
    "Profiler",
    "Registry",
    "SLOSpec",
    "Tracer",
    "build_report",
    "check_drift",
    "collecting",
    "compare_entries",
    "compare_latest",
    "current_request",
    "disabled",
    "enable",
    "enabled",
    "get_profiler",
    "get_registry",
    "get_tracer",
    "inc",
    "instant",
    "instrument",
    "metric_direction",
    "mfu",
    "observe",
    "parse_series",
    "plan_hit_rate",
    "probe_decode_plans",
    "record_bench_rows",
    "record_findings",
    "record_gemm",
    "record_gemm_sample",
    "render_text",
    "request_scope",
    "request_timeline",
    "reset",
    "roofline_seconds",
    "sample_call",
    "sampling",
    "set_gauge",
    "snapshot_doc",
    "span",
    "trace_rids",
    "validate_chrome_trace",
    "validate_doctor_report",
    "validate_postmortem",
    "validate_request_timeline",
    "validate_snapshot",
]
