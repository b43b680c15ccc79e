"""Perf-model drift watchdog: sampled timings vs model vs plan cache.

The port's copy of ``repro.obs.drift``.  A plan cache entry is a measurement
frozen in time: ``mean_us`` was true on the card the day the tuner ran.
This module closes the loop in three steps:

1. ``probe_decode_plans(engine)`` re-measures every decode-step GEMM of a
   serve config through ``tune.measure.measure_matmul`` -- on the card with
   CUDA events (method ``cuda-events``) -- at the cached plan's path when the
   cache has one, else at the path the dispatch runs, the kernel's shape rule
   (``kernel.gemm_path``; the balance equation's geometry names no tile the
   kernel runs at M = 4-16), and records ``profile.gemm_us{backend,dtype,
   problem,method}`` samples.  The serve launcher runs it once at the end
   of a run with ``--profile-sample-rate`` > 0, off the serving path.
2. ``check_drift(snapshot)`` holds each sampled GEMM series against (a) the
   plan cache's stored ``mean_us`` -- only when the sample's method matches
   the plan's, so an ``eager-wall`` window is never held against a plan the
   card timed with CUDA events -- and (b) the roofline model
   (``attribution.roofline_seconds``), giving ``DriftFinding`` rows.
3. ``record_findings`` turns stale findings into ``tune.plan.stale{key}``
   counters and regression-ledger rows.

Staleness is symmetric: a plan that claims 2x the sampled time is as stale
as one that claims half of it (``ratio = max(a, b) / min(a, b)``, stale when
``ratio > 1 + threshold``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.obs import metrics as _metrics

__all__ = [
    "DriftFinding",
    "DEFAULT_DRIFT_THRESHOLD",
    "probe_decode_plans",
    "check_drift",
    "record_findings",
]

# A plan is stale when measured and stored mean disagree by more than
# 1 + threshold in either direction: 0.5 flags anything >= 1.5x off.
DEFAULT_DRIFT_THRESHOLD = 0.5


@dataclasses.dataclass(frozen=True)
class DriftFinding:
    """One sampled GEMM series held against the model and the cache."""

    problem: str  # "MxNxK"
    backend: str
    dtype: str
    method: str  # measurement method of the sample
    sampled_us: float  # mean of the sampled windows
    samples: int
    model_us: float  # roofline prediction on the card
    model_ratio: float  # sampled / model (>1: slower than modeled)
    cached_us: float | None  # plan cache's stored mean_us (None: no entry)
    cache_ratio: float | None  # max/min disagreement vs cache, symmetric
    threshold: float
    stale: bool
    key: str | None  # cache key string, when an entry exists
    recommendation: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _problem_mnk(problem: str) -> tuple[int, int, int] | None:
    try:
        m, n, k = (int(x) for x in problem.split("x"))
        return m, n, k
    except (ValueError, AttributeError):
        return None


def probe_decode_plans(engine, *, method: str = "auto", repeats: int = 2, warmup: int = 1,
                       registry: _metrics.Registry | None = None) -> list[dict]:
    """Re-measure each decode GEMM problem on the engine's device; record
    ``profile.gemm`` samples.

    At the cached plan's geometry when the plan cache has an entry for the
    problem (like for like with its stored ``mean_us``), else at the shape
    rule's path and geometry (``kernel.gemm_path`` / ``block_of``: what the
    dispatch runs).  ``method`` "auto" is CUDA events on the card, the CPU
    proxy for an engine on the CPU.  Returns a summary row per problem; a
    problem that fails to measure gives a row with its ``error``, and the
    probe goes on.
    """
    import torch

    from repro_torch.core import dse, hw
    from repro_torch.kernels.systolic import kernel as mm_kernel
    from repro_torch.obs import profile as _profile
    from repro_torch.obs.attribution import roofline_seconds
    from repro_torch.tune import measure as tune_measure

    backend = "cuda-systolic"
    dev = engine.device
    sms = mm_kernel.sm_count(dev)
    dtype = str(engine.cfg.dtype)
    rows: list[dict] = []
    for name, ((m, n, k), plan) in sorted(engine.decode_plans.items()):
        if plan is not None:
            bm, bn, bk = plan.bm, plan.bn, plan.bk
        else:
            path = mm_kernel.gemm_path(m, n, k, getattr(torch, dtype), True, sms)
            bm, bn, bk = mm_kernel.block_of(path, m, n, k, sms)
        path = dse.block_path(bm, bn, bk, dtype, backend)[0]
        try:
            ms = tune_measure.measure_matmul(m, n, k, bm, bn, bk, dtype=dtype, backend=backend, method=method,
                                             repeats=repeats, warmup=warmup, device=dev)
        except Exception as e:  # a probe never takes the serve process down; the row says why
            rows.append({"name": name, "problem": f"{m}x{n}x{k}", "error": str(e)})
            continue
        _profile.record_gemm_sample(m, n, k, backend=backend, dtype=dtype, wall_s=ms.mean_us / 1e6,
                                    method=ms.method, registry=registry)
        rows.append({
            "name": name,
            "problem": f"{m}x{n}x{k}",
            "blocks": [bm, bn, bk],
            "path": path,
            "mean_us": ms.mean_us,
            "best_us": ms.best_us,
            "model_us": roofline_seconds(m, n, k, dtype, hw.H100.name) * 1e6,
            "method": ms.method,
            "cached": plan is not None,
        })
    return rows


def check_drift(snapshot: dict, *, cache=None, chip=None,
                threshold: float = DEFAULT_DRIFT_THRESHOLD) -> list[DriftFinding]:
    """Hold every ``profile.gemm_us`` series in ``snapshot`` against the
    roofline model and the plan cache.  Offline: works from a snapshot
    document alone (the ``obs doctor`` path) or a live registry snapshot.
    """
    from repro_torch.core import hw
    from repro_torch.obs.attribution import roofline_seconds
    from repro_torch.tune import cache as tune_cache

    chip = hw.get_chip(chip)
    if cache is None:
        cache = tune_cache.default_cache()
    findings: list[DriftFinding] = []
    for series, h in sorted(snapshot.get("histograms", {}).items()):
        base, labels = _metrics.parse_series(series)
        if base != "profile.gemm_us" or not h.get("count"):
            continue
        mnk = _problem_mnk(labels.get("problem", ""))
        if mnk is None:
            continue
        m, n, k = mnk
        backend = labels.get("backend", "cuda-systolic")
        dtype = labels.get("dtype", "float32")
        method = labels.get("method", "unknown")
        sampled_us = float(h["mean"])
        model_us = roofline_seconds(m, n, k, dtype, chip.name) * 1e6
        model_ratio = sampled_us / model_us if model_us > 0 else float("inf")

        key = tune_cache.CacheKey(backend, chip.name, m, n, k, dtype, "none", 1)
        plan = cache.lookup(key)
        cached_us = cache_ratio = None
        stale = False
        recommendation = "ok"
        key_str: str | None = None
        if plan is not None:
            key_str = key.encode()
            if plan.method == method and plan.mean_us > 0 and sampled_us > 0:
                cached_us = float(plan.mean_us)
                hi, lo = max(sampled_us, cached_us), min(sampled_us, cached_us)
                cache_ratio = hi / lo
                stale = cache_ratio > 1.0 + threshold
                if stale:
                    recommendation = (
                        f"re-tune {key_str}: cached mean_us {cached_us:.1f} vs "
                        f"sampled {sampled_us:.1f} ({cache_ratio:.2f}x apart, "
                        f"threshold {1.0 + threshold:.2f}x)"
                    )
            else:
                recommendation = f"plan method {plan.method!r} != sample method {method!r}; not comparable"
        findings.append(
            DriftFinding(
                problem=labels.get("problem", ""),
                backend=backend,
                dtype=dtype,
                method=method,
                sampled_us=sampled_us,
                samples=int(h["count"]),
                model_us=model_us,
                model_ratio=model_ratio,
                cached_us=cached_us,
                cache_ratio=cache_ratio,
                threshold=threshold,
                stale=stale,
                key=key_str,
                recommendation=recommendation,
            )
        )
    return findings


def record_findings(findings: Iterable[DriftFinding], *, ledger=None, registry: _metrics.Registry | None = None,
                    sha: str | None = None) -> int:
    """Persist stale findings: ``tune.plan.stale{key}`` counters plus one
    regression-ledger row per stale plan.  Returns the stale count."""
    if not _metrics.enabled():
        return sum(1 for f in findings if f.stale)
    reg = registry if registry is not None else _metrics.get_registry()
    n_stale = 0
    for f in findings:
        if not f.stale:
            continue
        n_stale += 1
        reg.inc("tune.plan.stale", 1, key=f.key or f.problem)
        if ledger is not None:
            ledger.record(
                "drift",
                {
                    "sampled_us": f.sampled_us,
                    "cached_us": f.cached_us,
                    "cache_ratio": f.cache_ratio,
                    "model_ratio": f.model_ratio,
                },
                variant=f.key or f.problem,
                dtype=f.dtype,
                sha=sha,
                meta={"method": f.method, "recommendation": f.recommendation},
            )
    return n_stale
