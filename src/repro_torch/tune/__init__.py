"""repro_torch.tune -- the measured autotuner that closes the DSE loop.

The counterpart of ``repro.tune``.  The paper's methodology is: enumerate
geometries, reject the ones the fitter cannot place, *measure* the
survivors, and ship the winner (Table I).  The analytical half of that loop
lives in ``repro_torch.core.dse``; this package adds the measurement half and
the persistence that makes it pay off:

  candidates  fitter-pruned, analytically ranked geometries (the kernel's tiles)
  measure     CUDA-event timing on the card (a CPU proxy when asked for the CPU)
  cache       versioned JSON store keyed by (backend, chip, M, N, K, dtype,
              activation), consulted by the kernel dispatchers
  autotune    the loop: generate -> measure -> persist -> serve

CLI: ``python -m repro_torch.tune --m 2048 --n 2048 --k 2048``.
"""

from repro_torch.tune.autotune import TuneResult, autotune
from repro_torch.tune.cache import (
    CacheKey,
    PlanCache,
    TunedPlan,
    default_cache,
    default_cache_path,
    plan_path,
    reset_default_cache,
    tuned_path,
)
from repro_torch.tune.candidates import Candidate, generate
from repro_torch.tune.measure import Measurement, measure_matmul

__all__ = [
    "autotune",
    "TuneResult",
    "CacheKey",
    "PlanCache",
    "TunedPlan",
    "default_cache",
    "default_cache_path",
    "plan_path",
    "reset_default_cache",
    "tuned_path",
    "Candidate",
    "generate",
    "Measurement",
    "measure_matmul",
]
