#!/usr/bin/env python3
"""Host cost of the GEMM dispatch, and of the decode step it runs in, for one checkout.

    python3 tools/dispatch_cost.py [--src ROOT] [--device cpu|cuda] [--obs on|off] [--calls 20000] [--steps 24]
                                   [--out FILE]

``repro_torch`` is imported from ``ROOT/src`` (default: this checkout), so
two checkouts are compared by running this script once per checkout, in
turn, within one call to the machine.  A checkout that predates the plan
cache (no ``repro_torch.tune``) is measured on what it has.

On the CPU (``--device cpu``, no card needed): the Python that decides one
K1 launch's tile at internlm2-1.8b's decode shape (4, 2048, 2048) in bf16,
per call (the least mean of five runs of ``--calls`` calls): the shape rule
alone (``gemm_path``, all that a launch decided before the plan cache), and,
where the checkout has the cache, ``tune.cache.plan_path`` then
``kernel.launch_path`` on a miss (an empty cache) and on a hit.  Where the
checkout records GEMMs (``obs.attribution.record_gemm``), also the Python
that recording adds to one ``core.ops.matmul`` call at (4, 2048) @ (2048,
2048) bf16 on a plan-cache miss, the plain version stubbed out so only the
dispatch runs, the sampler off: telemetry off (as ``REPRO_OBS=0``), on inside a ``collecting``
scope (the serving engine's steps) and on outside any scope (training steps;
the process's tally reaches the registry at its next read, outside the
timing), in alternating rounds of ``--calls`` calls; each reading the median
of the rounds, and what recording adds the median of each round's
difference to the off arm.

On the card (``--device cuda``, the default), with an empty plan cache
unless said otherwise:
  * the host wall per ``ops.matmul`` call at (4, 256) @ (256, 256) bf16
    (outside any scope), ``--calls`` back-to-back calls then one synchronize (a few us of device
    work each, so the loop runs at the host's pace); where the checkout has
    the cache, also on a hit: the rule's own tile timed with CUDA events
    (``tune.measure.measure_matmul``) and stored, so hit and miss launch the
    same tile;
  * the wall of each of ``--steps`` decode steps of full-width internlm2-1.8b
    (random weights from seed 0, bf16, batch 4, a 512-token prompt) through
    ``ServeEngine``, untraced, each step synchronized; median and min.

``--obs on|off`` sets telemetry for the card's readings (off: as
``REPRO_OBS=0``), so the decode step with and without recording is read by
running the script once per setting, alternated, in one call to the machine.

Prints one JSON object as its last line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_SHAPE = (4, 2048, 2048)  # (M, N, K): internlm2-1.8b's wq / wo at batch 4
SMALL_SHAPE = (4, 256, 256)


def per_call_us(fn, calls: int, rounds: int = 5) -> float:
    """The least mean time of ``fn`` over ``rounds`` runs of ``calls`` calls."""
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def cpu_costs(calls: int) -> dict:
    import torch

    from repro_torch.kernels.systolic import kernel as mk

    m, n, k = DECODE_SHAPE
    bf16 = torch.bfloat16
    out = {"rule_us": per_call_us(lambda: mk.gemm_path(m, n, k, bf16, True, 132, False), calls)}
    try:
        from repro_torch.tune import cache
        from repro_torch.tune.cache import CacheKey, TunedPlan
    except ImportError:
        return out

    def decide():
        path, k_chunk, source = cache.plan_path("cuda-systolic", m, n, k, "bfloat16", "none", None)
        return mk.launch_path(path, k_chunk, source, m, n, k, bf16, True, False, 132)

    out["miss_us"] = per_call_us(decide, calls)
    assert decide()[2] == "rule"
    # A hit on the rule's own tile: a synthetic entry, timed here for its host cost only.
    rule = mk.block_of(mk.gemm_path(m, n, k, bf16, True, 132), m, n, k, 132)
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", m, n, k, "bfloat16"),
                                TunedPlan(*rule, mean_us=0.0, best_us=0.0, method=cache.DISPATCHED_METHOD))
    assert decide()[2] == "tuned"
    out["hit_us"] = per_call_us(decide, calls)
    return out


def obs_costs(calls: int, rounds: int = 24) -> dict:
    """us a ``core.ops.matmul`` call at DECODE_SHAPE with telemetry off, on
    in a scope and on outside one, the plain product stubbed out; the
    median of ``rounds`` alternating rounds each."""
    from unittest import mock

    import torch

    from repro_torch.core import ops
    from repro_torch.kernels.systolic import ops as mm_ops
    from repro_torch.obs import attribution, metrics

    m, n, k = DECODE_SHAPE
    x, w = torch.zeros((m, k), dtype=torch.bfloat16), torch.zeros((k, n), dtype=torch.bfloat16)
    y = torch.empty((m, n), dtype=torch.bfloat16)

    def loop():
        for _ in range(calls):
            ops.matmul(x, w)

    def timed(on: bool, scoped: bool) -> float:
        metrics.enable(on)
        totals = attribution.GemmTotals()
        t0 = time.perf_counter()
        if scoped:
            with attribution.collecting(totals):
                loop()
        else:
            loop()
        dt = (time.perf_counter() - t0) / calls * 1e6
        assert totals.calls == (calls if on and scoped else 0)
        return dt

    arms = {"off_us": (False, False), "on_scoped_us": (True, True), "on_direct_us": (True, False)}
    got = {name: [] for name in arms}
    with mock.patch.object(mm_ops, "matmul_ref", lambda *a, **kw: y):
        try:
            loop()  # warm-up
            for r in range(rounds):
                for name in (arms if r % 2 == 0 else reversed(arms)):
                    got[name].append(timed(*arms[name]))
        finally:
            metrics.enable(True)
            metrics.reset()
    out = {name: statistics.median(v) for name, v in got.items()}
    # what recording adds: the median of each round's on - off (the arms of
    # a round run back to back, so a slower stretch of the host cancels)
    out["added_scoped_us"] = statistics.median(on - off for on, off in zip(got["on_scoped_us"], got["off_us"]))
    out["added_direct_us"] = statistics.median(on - off for on, off in zip(got["on_direct_us"], got["off_us"]))
    out["rounds"] = got
    return out


def matmul_costs(calls: int) -> dict:
    import torch

    from repro_torch.kernels.systolic import kernel as mk
    from repro_torch.kernels.systolic import ops

    m, n, k = SMALL_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)

    def wall() -> float:
        ops.matmul(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ops.matmul(a, b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    out = {"miss_us": [wall() for _ in range(3)]}
    try:
        from repro_torch.tune import cache
        from repro_torch.tune.cache import CacheKey, TunedPlan
        from repro_torch.tune.measure import measure_matmul
    except ImportError:
        return out
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rule_path = mk.gemm_path(m, n, k, torch.bfloat16, True, sms)
    rule = mk.block_of(rule_path, m, n, k, sms)
    ms = measure_matmul(m, n, k, *rule)
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", m, n, k, "bfloat16"),
                                TunedPlan(*rule, mean_us=ms.mean_us, best_us=ms.best_us, method=ms.method,
                                          repeats=ms.repeats))
    before = mk.launches_by_plan.copy()
    ops.matmul(a, b)
    assert [key[5] for key in mk.launches_by_plan - before] == ["tuned"]
    out["hit_us"] = [wall() for _ in range(3)]
    out["tile"] = [rule_path, *rule]
    return out


def decode_steps(steps: int) -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.serve import init_params
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = configs.get_config("internlm2-1.8b")
    model = get_model(cfg)
    device = torch.device("cuda")
    params, act_ctx = init_params(model, 0, device, "none")
    engine = ServeEngine(model, params, ServeConfig(max_len=512 + steps + 8, batch=4), device=device)
    batch = make_batch(cfg, batch=4, seq=512, kind="prefill", seed=0, device=device)
    with act_ctx:
        tok = engine.prefill(batch)
        tok = engine.decode(tok, 2)[:, -1:]  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(steps):
            t0 = time.perf_counter()
            tok = engine.decode(tok, 1)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    return {"ms": walls, "median_ms": statistics.median(walls), "min_ms": min(walls)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=ROOT, help="root of the checkout whose repro_torch is measured")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--obs", choices=("on", "off"), default="on",
                    help="telemetry for the card's readings (off: as REPRO_OBS=0)")
    ap.add_argument("--calls", type=int, default=20000)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, os.path.join(src, "src"))
    with tempfile.TemporaryDirectory(prefix="dispatch_cost_") as tmp:
        # An empty plan cache of this run's own: a cache left on the machine moves no tile.
        os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp, "plans.json")
        return run(args, src)


def run(args, src: str) -> int:
    import torch

    out = {"src": src, "device": args.device}
    try:
        from repro_torch.obs import attribution
    except ImportError:
        attribution = None
    records = attribution is not None and hasattr(attribution, "record_gemm")
    if args.device == "cpu":
        if records:
            out["record"] = obs_costs(args.calls)  # on a miss: before cpu_costs stores a plan for the shape
        out["decide"] = cpu_costs(args.calls)
    else:
        if not torch.cuda.is_available():
            print("dispatch_cost: no CUDA device; pass --device cpu", file=sys.stderr)
            return 1
        from repro_torch.obs import metrics

        metrics.enable(args.obs == "on")
        out["card"] = torch.cuda.get_device_name(0)
        out["obs"] = args.obs
        out["records_gemms"] = records
        out["decode_step"] = decode_steps(args.steps)  # before the matmul loop stores a plan
        out["matmul"] = matmul_costs(args.calls)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
