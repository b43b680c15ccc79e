"""The closed DSE loop: generate -> fit -> measure -> persist -> serve.

The counterpart of ``repro.tune.autotune``.  ``autotune`` is the Table I
pipeline end to end: the analytical model plays the fitter (pruning), the
measurement stage plays Quartus' f_max report, and the winner lands in the
JSON plan cache that the kernel dispatchers (``kernels/*/ops.py``) consult
on every call.  A second invocation for the same problem is a pure cache
hit -- no launch, no timing.

``measure_fn`` is injectable (record -> Measurement) so tests can close the
loop deterministically without the card or clocks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core import dse, hw
from repro_torch.core.device import resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.tune import candidates as cand_mod
from repro_torch.tune import measure as measure_mod
from repro_torch.tune.cache import CacheKey, PlanCache, TunedPlan, default_cache

MeasureFn = Callable[[dse.DSERecord], measure_mod.Measurement]


@dataclasses.dataclass(frozen=True)
class TuneResult:
    key: CacheKey
    winner: TunedPlan
    cache_hit: bool
    # Measured records (empty on a cache hit), best-first.
    records: tuple[dse.DSERecord, ...] = ()

    @property
    def block(self) -> tuple[int, int, int]:
        return (self.winner.bm, self.winner.bn, self.winner.bk)


def canonical_dtype(dtype: str | torch.dtype) -> str:
    """The cache key's dtype name: "bfloat16", "float32", "int8" or
    "float8_e4m3fn" ("fp8" is e4m3, the port's fp8 storage)."""
    name = str(dtype).removeprefix("torch.")
    name = "float8_e4m3fn" if name == "fp8" else name
    if name not in hw.DTYPE_BYTES or name == "int32":
        raise ValueError(f"cannot tune {dtype!r} operands")
    return name


def autotune(
    m: int,
    n: int,
    k: int,
    *,
    dtype: str | torch.dtype = "bfloat16",
    activation: str = "none",
    backend: str = "cuda-systolic",
    chip: hw.GPU | str | None = None,
    top_k: int | None = 8,
    repeats: int = 3,
    warmup: int = 1,
    method: str = "auto",
    cache: PlanCache | None = None,
    measure_fn: MeasureFn | None = None,
    force: bool = False,
    device: str | torch.device | None = None,
) -> TuneResult:
    """Tune one (M, N, K, dtype, activation) problem and persist the winner.

    Deterministic given a deterministic ``measure_fn``: candidates come out
    of ``dse.explore`` in a fixed order, ties in measured time break on the
    analytical bound and then on the geometry itself.  The built-in
    measurement (``measure.measure_matmul``) runs on the card unless
    ``device="cpu"``; with neither it raises, cache hit or not.  The
    kernel dispatchers serve only plans timed on the card (method
    "cuda-events"); any other method's winner is stored for inspection.
    """
    chip = hw.get_chip(chip)
    cache = cache or default_cache()
    dtype = canonical_dtype(dtype)
    if measure_fn is None:
        if backend not in measure_mod.MEASURABLE_BACKENDS:
            raise ValueError(
                f"no built-in measurement for backend {backend!r}; supported: "
                f"{measure_mod.MEASURABLE_BACKENDS} (or pass measure_fn=...)"
            )
        device = resolve_device(device)
    key = CacheKey(
        backend=backend,
        chip=chip.name,
        m=int(m),
        n=int(n),
        k=int(k),
        dtype=dtype,
        activation=activation,
    )

    if not force:
        hit = cache.lookup(key)
        if hit is not None:
            _metrics.inc("tune.autotune.cache_hit", backend=backend)
            return TuneResult(key=key, winner=hit, cache_hit=True)
    _metrics.inc("tune.autotune.cache_miss", backend=backend)

    cands = cand_mod.generate(m, n, k, dtype=dtype, chip=chip, top_k=top_k, backend=backend)

    if measure_fn is None:

        def measure_fn(rec: dse.DSERecord) -> measure_mod.Measurement | None:
            if backend == "reference" and (m % rec.bm or n % rec.bn or k % rec.bk):
                return None  # the reference cannot pad; skip this geometry
            return measure_mod.measure_matmul(
                m, n, k, rec.bm, rec.bn, rec.bk,
                dtype=dtype, activation=activation, backend=backend,
                method=method, repeats=repeats, warmup=warmup, device=device,
            )

    measured: list[tuple[dse.DSERecord, measure_mod.Measurement]] = []
    with _trace.span(
        "tune.autotune", m=int(m), n=int(n), k=int(k),
        dtype=dtype, backend=backend,
    ):
        for c in cands:
            ms = measure_fn(c.record)
            if ms is None:
                continue
            measured.append((c.record.with_measurement(ms.best_us), ms))
    _metrics.inc("tune.autotune.measurements", len(measured), backend=backend)
    if not measured:
        raise ValueError(f"no measurable candidate for ({m},{n},{k}) on backend {backend!r}")

    # Ties on measured time break on the analytical bound, then geometry, so
    # a stubbed constant-time measurement still yields one fixed winner.
    measured.sort(
        key=lambda rm: (
            rm[0].measured_us,
            rm[0].analytical_us,
            rm[0].bm,
            rm[0].bn,
            rm[0].bk,
        )
    )
    best_rec, best_ms = measured[0]
    winner = TunedPlan(
        bm=best_rec.bm,
        bn=best_rec.bn,
        bk=best_rec.bk,
        mean_us=best_ms.mean_us,
        best_us=best_ms.best_us,
        method=best_ms.method,
        repeats=best_ms.repeats,
        tuned_at=time.time(),
    )
    cache.store(key, winner)
    return TuneResult(
        key=key,
        winner=winner,
        cache_hit=False,
        records=tuple(rec for rec, _ in measured),
    )
