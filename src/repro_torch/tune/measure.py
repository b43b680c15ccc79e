"""Timing of one block geometry -- the f_max measurement analogue.

The counterpart of ``repro.tune.measure``.  The paper gets its measured
column by synthesising each survivor and reading f_max from Quartus; we get
ours by launching the kernel on the path that the candidate geometry names
and timing it.  Three methods:

  cuda-events     the card: CUDA events around back-to-back launches, the
                  stream held by a spin kernel until every launch is queued
                  (``time_ms``), the weights cycled through copies that
                  exceed the 50 MB L2, as the served path reads each layer's
                  weights cold.
  reference-wall  the ``reference`` backend: host wall clock of the
                  Definition-4 oracle (``core.systolic.blocked_matmul``).
  cpu-proxy       only when the caller asks for the CPU: time one (bm, bk) x
                  (bk, bn) block product on the CPU and scale by the grid's
                  size, the twin of the reference's ``xla-proxy``.  It keeps
                  the relative order of block shapes, not the card's times,
                  and is persisted under its own method name.

"auto" picks cuda-events on the card, reference-wall for the ``reference``
backend and cpu-proxy when the caller passed ``device="cpu"``; with no card
and no ``device="cpu"`` it raises, as every entry point of the port does.
The returned Measurement names the method, and the cache keeps it.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time

import torch

from repro_torch.core.blocking import BlockPlan
from repro_torch.core.device import resolve_device
from repro_torch.core.dse import QUANT_DTYPES

METHODS = ("auto", "cuda-events", "reference-wall", "cpu-proxy")

# Kernel families the default measurement loop can drive.  "cuda-systolic"
# times K1 (bf16 / fp32) or K5 (int8 / e4m3) at the geometry's path;
# "cuda-grouped" times K4 on the per-expert problem at E=1; "reference"
# times the Definition-4 oracle (which needs the geometry to divide the
# problem).
MEASURABLE_BACKENDS = ("cuda-systolic", "cuda-grouped", "reference")
CYCLE_BYTES = 150e6  # weight copies cycled per timing: three times the H100's 50 MB L2


@dataclasses.dataclass(frozen=True)
class Measurement:
    mean_us: float
    best_us: float
    repeats: int
    method: str


def resolve_method(method: str, backend: str, device: str | torch.device | None = None) -> tuple[str, torch.device]:
    """(method, device) for a measurement; ``device`` None is the card,
    which must be there."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {METHODS}")
    dev = resolve_device(device)
    if method == "auto":
        if backend == "reference":
            method = "reference-wall"
        else:
            method = "cuda-events" if dev.type == "cuda" else "cpu-proxy"
    if method == "cuda-events" and dev.type != "cuda":
        raise ValueError(f"cuda-events times the card, not {dev}")
    if method == "cpu-proxy" and dev.type != "cpu":
        raise ValueError("the CPU proxy runs only when the caller asks for the CPU (device='cpu')")
    return method, dev


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events).

    The stream is first held by a spin kernel lasting twice the host time of
    the calls, so all of them are queued before the first starts: the events
    then time the device, not the Python that launches it.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2e9))  # cycles at <= 2 GHz: at least 2x the host time
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_callable(fn, *, warmup: int, repeats: int) -> tuple[float, float]:
    """(best_us, mean_us) of fn() on the host clock; fn must block until its
    result is ready."""
    for _ in range(max(warmup, 1)):
        fn()
    times = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return min(times), statistics.fmean(times)


def cycler(items: list):
    """A function returning the next of ``items`` on each call, round robin."""
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(items)
        return items[it[0]]

    return nxt


def _randn(shape, gen, device, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)


def _kernel_call(m, n, k, plan: BlockPlan, dtype: str, activation: str, backend: str, dev: torch.device):
    """A function launching ``backend``'s kernel on ``plan``'s path at
    (M, N, K), weights cycled through copies past the L2."""
    from repro_torch.kernels.grouped import ops as grouped_ops
    from repro_torch.kernels.systolic import ops as mm_ops
    from repro_torch.quant.qarray import quantize_act, quantize_weight

    gen = torch.Generator(device=dev).manual_seed(0)
    wide = torch.float32 if dtype == "float32" else torch.bfloat16
    copies = max(1, math.ceil(CYCLE_BYTES / max(1, k * n * (1 if dtype in QUANT_DTYPES else wide.itemsize))))
    if backend == "cuda-grouped":
        x = _randn((1, m, k), gen, dev, wide)
        nxt = cycler([_randn((1, k, n), gen, dev, wide) for _ in range(copies)])
        return lambda: grouped_ops.grouped_matmul(x, nxt(), plan=plan)
    if dtype in QUANT_DTYPES:
        # The served layout: activations quantized per row x 128-k block,
        # weights per 128-k block x column, laid out K-major (quant.k_major).
        qd = "int8" if dtype == "int8" else "fp8"
        qa = quantize_act(_randn((m, k), gen, dev), qd)

        def weight():
            qb = quantize_weight(_randn((k, n), gen, dev), qd)
            return dataclasses.replace(qb, values=qb.values.t().contiguous().t())

        nxt = cycler([weight() for _ in range(copies)])
        return lambda: mm_ops.quant_matmul(qa, nxt(), activation=activation, plan=plan)
    a = _randn((m, k), gen, dev, wide)
    nxt = cycler([_randn((k, n), gen, dev, wide) for _ in range(copies)])
    return lambda: mm_ops.matmul(a, nxt(), activation=activation, plan=plan)


def measure_matmul(
    m: int,
    n: int,
    k: int,
    bm: int,
    bn: int,
    bk: int,
    *,
    dtype: str = "bfloat16",
    activation: str = "none",
    backend: str = "cuda-systolic",
    method: str = "auto",
    repeats: int = 3,
    warmup: int = 1,
    iters: int | None = None,
    device: str | torch.device | None = None,
) -> Measurement:
    """Time one (bm, bn, bk) geometry through the given kernel family.

    On the card each of ``repeats`` readings is the mean of ``iters``
    back-to-back launches (default 20 at M <= 16, else 10)."""
    if backend not in MEASURABLE_BACKENDS:
        raise ValueError(
            f"cannot measure backend {backend!r}; supported: "
            f"{MEASURABLE_BACKENDS} (pass autotune(measure_fn=...) for others)"
        )
    if activation != "none" and backend != "cuda-systolic":
        # Only the systolic kernels have a fused epilogue; caching a timing
        # labelled with an activation the kernel never ran would be a lie.
        raise ValueError(f"backend {backend!r} has no fused activation; got {activation!r}")
    method, dev = resolve_method(method, backend, device)
    plan = BlockPlan(m, n, k, bm, bn, bk, in_dtype=dtype)

    if method == "cpu-proxy":
        return _measure_cpu_proxy(m, n, k, bm, bn, bk, dtype=dtype, repeats=repeats, warmup=warmup)
    if method == "reference-wall":
        if m % bm or n % bn or k % bk:
            raise ValueError(f"reference backend needs dividing blocks; ({m},{n},{k}) % ({bm},{bn},{bk}) != 0")
        from repro_torch.core.systolic import blocked_matmul

        gen = torch.Generator(device=dev).manual_seed(0)
        wide = torch.float32 if dtype == "float32" else torch.bfloat16
        a, b = _randn((m, k), gen, dev, wide), _randn((k, n), gen, dev, wide)

        def run():
            out = blocked_matmul(a, b, plan)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return out

        best, mean = _time_callable(run, warmup=warmup, repeats=repeats)
        return Measurement(mean_us=mean, best_us=best, repeats=repeats, method=method)

    fn = _kernel_call(m, n, k, plan, dtype, activation, backend, dev)
    iters = iters or (20 if m <= 16 else 10)
    times = [time_ms(fn, iters, warmup=max(warmup, 1)) * 1e3 for _ in range(max(repeats, 1))]
    return Measurement(mean_us=statistics.fmean(times), best_us=min(times), repeats=len(times), method=method)


def _measure_cpu_proxy(m, n, k, bm, bn, bk, *, dtype, repeats, warmup) -> Measurement:
    """Block-product wall clock on the CPU scaled by grid size.

    The proxy keeps the *relative* ordering of block shapes (bigger blocks
    amortise per-call overhead; undersized ones pay it per grid step), which
    is all the argmin over candidates needs on a host without the card.
    Narrow dtypes multiply in fp32 (the CPU has no int8 / e4m3 product).
    """
    eff_bm, eff_bn, eff_bk = min(bm, m), min(bn, n), min(bk, k)
    steps = -(m // -eff_bm) * -(n // -eff_bn) * -(k // -eff_bk)  # ceil-div grid volume
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator().manual_seed(0)
    a, b = _randn((eff_bm, eff_bk), gen, "cpu", dt), _randn((eff_bk, eff_bn), gen, "cpu", dt)
    best, mean = _time_callable(lambda: a @ b, warmup=warmup, repeats=repeats)
    return Measurement(mean_us=mean * steps, best_us=best * steps, repeats=repeats, method="cpu-proxy")
