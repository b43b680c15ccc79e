"""CLI for the autotuner.

    PYTHONPATH=src python -m repro_torch.tune --m 2048 --n 2048 --k 2048

The counterpart of ``python -m repro.tune``.  The first run measures the
fitter survivors on the card and persists the winner; the second run for the
same problem reports a cache hit.  ``--list`` dumps the cache.  Without a
card it raises unless ``--device cpu`` (the CPU proxy, or the ``reference``
backend's wall clock).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.tune",
        description="Measured block-plan autotuner (the measured half of Table I).",
    )
    p.add_argument("--m", type=int, default=512)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--k", type=int, default=512)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--activation", default="none")
    p.add_argument("--backend", default="cuda-systolic", choices=("cuda-systolic", "cuda-grouped", "reference"))
    p.add_argument("--top-k", type=int, default=8, dest="top_k",
                   help="measure at most this many fitter survivors")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--method", default="auto", choices=("auto", "cuda-events", "reference-wall", "cpu-proxy"))
    p.add_argument("--device", default=None, help="cpu to measure on the CPU (default: the card)")
    p.add_argument("--cache", default=None,
                   help="cache file (default: $REPRO_TORCH_TUNE_CACHE or ~/.cache/repro-torch-tune/plans.json)")
    p.add_argument("--force", action="store_true", help="re-measure even on a cache hit")
    p.add_argument("--list", action="store_true", dest="list_entries", help="print cache entries and exit")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from repro_torch.tune import autotune
    from repro_torch.tune.cache import DISPATCHED_METHOD, PlanCache, default_cache

    cache = PlanCache(args.cache) if args.cache else default_cache()

    if args.list_entries:
        entries = cache.items()
        print(f"# cache {cache.path} ({len(entries)} entries)")
        for key, plan in entries:
            print(f"{key} -> {plan.bm}x{plan.bn}x{plan.bk} "
                  f"best={plan.best_us:.1f}us mean={plan.mean_us:.1f}us "
                  f"[{plan.method} x{plan.repeats}]")
        return 0

    result = autotune(
        args.m, args.n, args.k,
        dtype=args.dtype,
        activation=args.activation,
        backend=args.backend,
        top_k=args.top_k,
        repeats=args.repeats,
        warmup=args.warmup,
        method=args.method,
        cache=cache,
        force=args.force,
        device=args.device,
    )

    key = result.key
    print(f"# problem  {key.backend} {key.chip} "
          f"M={key.m} N={key.n} K={key.k} {key.dtype} act={key.activation}")
    if result.cache_hit:
        print("# cache hit -- no measurement performed (use --force to re-tune)")
    else:
        print(f"# measured {len(result.records)} fitter survivors [{result.winner.method}]")
        for rec in result.records:
            print(f"  {rec.ident:>16} {rec.path or '':>14}  measured={rec.measured_us:10.3f}us  "
                  f"analytical={rec.analytical_us:8.3f}us  ai={rec.arithmetic_intensity:.0f}")
    w = result.winner
    print(f"winner {w.bm}x{w.bn}x{w.bk}  best={w.best_us:.3f}us  "
          f"mean={w.mean_us:.3f}us  method={w.method}")
    print(f"cache  {cache.path}")
    if w.method != DISPATCHED_METHOD and key.backend != "reference":
        # A CPU proxy's (or a stub's) winner says nothing of the card.
        print(f"note   kept for inspection: the kernels dispatch only plans timed on the card ({DISPATCHED_METHOD})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
