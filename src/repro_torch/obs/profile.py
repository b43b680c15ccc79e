"""Sampled measured timing windows around host-side dispatch.

The port's copy of ``repro.obs.profile``: ``Profiler``, ``get_profiler``,
``configure``, ``sampling``, ``sample_call`` (the KV pool's windows) and
``record_gemm_sample`` (``core.ops.matmul``'s window around K1 and the drift
probe's readings).  A sampled window covers the call and a wait for the card
(``torch.cuda.synchronize()`` where the reference waits with
``block_until_ready``), so it charges any pending work on the stream to the
sampled stream: dispatch to retire on the host's clock.  Inactive by
default: it samples only with telemetry enabled and a rate above 0
(``REPRO_PROFILE_RATE`` or ``configure``).  Sampling is a deterministic
per-stream Bresenham draw, so a run at rate r times exactly floor(r * calls)
windows (+-1).

Series written (in the default registry unless a registry is passed):

    {stream}.calls{labels}       every call while the profiler is active
    {stream}.sampled{labels}     calls that got a timing window
    {stream}.sampled_us{labels}  total measured µs across sampled calls
    {stream}_us{labels}          histogram of per-call measured µs
    profile.gemm_us{backend,dtype,problem,method}
                                 one GEMM reading (``record_gemm_sample``)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.obs import metrics as _metrics

__all__ = ["Profiler", "get_profiler", "configure", "sampling", "sample_call", "record_gemm_sample"]


def _env_rate() -> float:
    raw = os.environ.get("REPRO_PROFILE_RATE", "").strip()
    if not raw:
        return 0.0
    try:
        return max(0.0, min(1.0, float(raw)))
    except ValueError:
        return 0.0


def _wait(out: Any) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (a CPU result is
    already done)."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


class Profiler:
    """Rate-limited measured-timing sampler with deterministic per-stream
    Bresenham draws (``acc += rate``; a window when ``acc >= 1``)."""

    def __init__(self, sample_rate: float = 0.0) -> None:
        self.sample_rate = float(sample_rate)
        self._acc: dict[Any, float] = {}
        self._lock = threading.Lock()

    def active(self) -> bool:
        """True when sampling can fire: rate > 0 and telemetry enabled."""
        return self.sample_rate > 0.0 and _metrics.enabled()

    def configure(self, sample_rate: float) -> None:
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))

    def reset(self) -> None:
        """Restore the env-derived rate and clear sampling accumulators."""
        with self._lock:
            self._acc.clear()
        self.sample_rate = _env_rate()

    def should_sample(self, stream: Any) -> bool:
        if not self.active():
            return False
        with self._lock:
            acc = self._acc.get(stream, 0.0) + self.sample_rate
            if acc >= 1.0:
                self._acc[stream] = acc - 1.0
                return True
            self._acc[stream] = acc
            return False

    def timed(self, stream: str, thunk: Callable[[], Any], **labels) -> tuple[Any, float | None]:
        """Run ``thunk``; on a sampled call, return (result, wall seconds up
        to the card's finishing it), else (result, None)."""
        if not self.should_sample((stream, _metrics._label_key(labels))):
            return thunk(), None
        t0 = time.perf_counter()
        out = thunk()
        _wait(out)
        return out, time.perf_counter() - t0

    def sample_call(self, stream: str, thunk: Callable[[], Any], *,
                    registry: _metrics.Registry | None = None, **labels) -> Any:
        """``timed`` plus the series write-out (see module docstring)."""
        if not (_metrics.enabled() and self.sample_rate > 0.0):
            return thunk()
        reg = registry if registry is not None else _metrics.get_registry()
        reg.inc(f"{stream}.calls", 1, **labels)
        out, wall = self.timed(stream, thunk, **labels)
        if wall is not None:
            reg.inc(f"{stream}.sampled", 1, **labels)
            reg.inc(f"{stream}.sampled_us", wall * 1e6, **labels)
            reg.observe(f"{stream}_us", wall * 1e6, **labels)
        return out


_profiler = Profiler(_env_rate())


def get_profiler() -> Profiler:
    return _profiler


def configure(sample_rate: float) -> None:
    """Set the process-wide sampling rate (clamped to [0, 1])."""
    _profiler.configure(sample_rate)


@contextlib.contextmanager
def sampling(sample_rate: float):
    """Temporarily set the sampling rate (tests)."""
    prev = _profiler.sample_rate
    _profiler.configure(sample_rate)
    try:
        yield _profiler
    finally:
        _profiler.sample_rate = prev


def sample_call(stream: str, thunk: Callable[[], Any], **labels) -> Any:
    """``get_profiler().sample_call``; inactive, it is a rate check and the call."""
    if not _profiler.active():
        return thunk()
    return _profiler.sample_call(stream, thunk, **labels)


def record_gemm_sample(m: int, n: int, k: int, *, backend: str, dtype: Any, wall_s: float,
                       method: str = "eager-wall", registry: _metrics.Registry | None = None) -> None:
    """Record one measured GEMM time into ``profile.gemm_us``.

    ``method`` carries provenance as the plan cache does: ``eager-wall``
    windows (sampled around an ``ops.matmul`` call, host clock to the card's
    finishing it) compare only with each other, while the drift probe's
    readings carry ``tune.measure``'s method (``cuda-events``), so the
    watchdog holds them against a cached plan's ``mean_us`` like for like.
    """
    if not _metrics.enabled():
        return
    reg = registry if registry is not None else _metrics.get_registry()
    labels = {"backend": backend, "dtype": dtype if isinstance(dtype, str) else str(dtype).removeprefix("torch."),
              "problem": f"{int(m)}x{int(n)}x{int(k)}", "method": method}
    reg.inc("profile.gemm.sampled", 1, **labels)
    reg.inc("profile.gemm.sampled_us", wall_s * 1e6, **labels)
    reg.observe("profile.gemm_us", wall_s * 1e6, **labels)
