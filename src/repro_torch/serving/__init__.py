"""Serving: batched prefill/decode engine, slot-pooled and paged KV caches,
and the continuous-batching request scheduler."""

from repro_torch.serving.engine import (  # noqa: F401
    ServeConfig,
    ServeEngine,
    consult_decode_plans,
    decode_gemm_problems,
)
from repro_torch.serving.kvpool import KVPool, clear_slots  # noqa: F401
from repro_torch.serving.paged import PagedKVPool, PageExhausted, PrefixCache  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    ContinuousScheduler,
    Request,
    SchedulerStats,
    requests_from_trace,
)
