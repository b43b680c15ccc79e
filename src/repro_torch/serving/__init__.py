"""Serving: batched prefill/decode engine, slot-pooled KV cache, and the
continuous-batching request scheduler."""

from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: F401
from repro_torch.serving.kvpool import KVPool, clear_slots  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousScheduler,
    Request,
    SchedulerStats,
    requests_from_trace,
)
