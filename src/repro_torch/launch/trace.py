"""Where a served step's time goes on the card: a torch.profiler trace of one
prefill and a few decode steps through ``ServeEngine``.

    PYTHONPATH=src python -m repro_torch.launch.trace --arch internlm2-1.8b \
        --batch 4 --prompt-len 512 --steps 3 [--quantize w8a8] [--chrome trace.json]
    PYTHONPATH=src python -m repro_torch.launch.trace --arch qwen3-moe-30b-a3b --steps 3 [--quantize w8a8]
    PYTHONPATH=src python -m repro_torch.launch.trace --arch minicpm3-4b --steps 3 [--quantize w8a8]
    PYTHONPATH=src python -m repro_torch.launch.trace --batch 1 --prompt-len 8192 \
        --chunk-size 512 --steps 1
    PYTHONPATH=src python -m repro_torch.launch.trace --arch zamba2-7b --prompt-len 1 --steps 3

The recurrent families (xlstm-125m, zamba2-7b) prefill by a loop of decode
steps, one per prompt token, so ``--prompt-len 1`` traces one step of their
sequential prefill as the "prefill" phase.

With ``--chunk-size`` the prompt is prefilled as the chunked scheduler does it
(``ServeEngine.prefill_chunk`` over ``chunk_schedule``, each chunk its own
phase) into a fresh cache, and the decode steps follow from that cache.

Weights are random, drawn from ``--seed``.  For each phase it prints the host
wall time, the device busy time (union of the kernels' intervals inside the
phase) and the device's idle share, then the kernels with the most device
time and the host operators with the most self time.  It needs the card: a
trace with no device kernels is an error, not a result.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.serve import init_params
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import chunk_schedule


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


PHASES = ("prefill", "prefill_chunk", "decode_step", "train_step")  # train_step: chip_smoke.py's traced step
SPANS = PHASES + ("train_forward",)  # train_forward: train.loop.make_grad_fn's forward, inside a train_step


def _device_work(events):
    """Device-side events that are work (kernels, copies), not the device
    mirror of a record_function range."""
    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in SPANS]


def phase_breakdown(events) -> list[dict]:
    """Host wall, device busy, idle share and device kernel count for each
    record_function range."""
    work = [(e.time_range.start, e.time_range.end) for e in _device_work(events)]
    if not work:
        raise RuntimeError("the trace holds no device kernels: the profiler saw no card activity")
    rows = []
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in PHASES:
            lo, hi = e.time_range.start, e.time_range.end
            inside = [(max(s, lo), min(t, hi)) for s, t in work if t > lo and s < hi]
            busy = _union_us(inside)
            wall = hi - lo
            rows.append({"phase": e.name, "wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
                         "idle_share": 1.0 - busy / wall if wall > 0 else 0.0,
                         "device_kernels": len(inside)})
    return rows


def top_kernels(events, n: int = 12) -> list[dict]:
    by: dict[str, list[float]] = {}
    for e in _device_work(events):
        by.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    rows = [{"kernel": k, "calls": len(v), "device_ms": sum(v) / 1e3} for k, v in by.items()]
    return sorted(rows, key=lambda r: -r["device_ms"])[:n]


def top_host_ops(prof, n: int = 12) -> list[dict]:
    rows = [{"op": k.key, "calls": k.count, "self_cpu_ms": k.self_cpu_time_total / 1e3}
            for k in prof.key_averages()]
    return sorted(rows, key=lambda r: -r["self_cpu_ms"])[:n]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=configs.ALL_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3, help="decode steps traced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chrome", default=None, help="also export the Chrome trace here")
    ap.add_argument("--json", default=None, help="also write the tables here")
    ap.add_argument("--quantize", choices=("none", "w8a16", "w8a8"), default="none",
                    help="serve quantized weights (as launch.serve --quantize)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="prefill in chunks of this length, as the chunked scheduler does")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = configs.get_config(args.arch)
    model = get_model(cfg)
    params, act_ctx = init_params(model, args.seed, device, args.quantize)
    engine = ServeEngine(model, params, ServeConfig(max_len=args.prompt_len + args.steps + 4,
                                                    batch=args.batch), device=device)
    batch = make_batch(cfg, batch=args.batch, seq=args.prompt_len, kind="prefill",
                       seed=args.seed, device=device)
    with act_ctx:
        return _trace(engine, batch, args)


def _chunked_prefill(engine: ServeEngine, batch: dict, chunk: int, traced: bool) -> torch.Tensor:
    """Prefill ``batch`` chunk by chunk into a fresh cache that becomes the
    engine's resident one (each chunk a ``prefill_chunk`` phase when
    ``traced``); returns the first sampled token."""
    tokens = batch["tokens"]
    cache = engine.model.init_cache(tokens.shape[0], engine.scfg.max_len, device=engine.device)
    for off, length in chunk_schedule(tokens.shape[1], chunk):
        with record_function("prefill_chunk") if traced else contextlib.nullcontext():
            tok, cache = engine.prefill_chunk(tokens[:, off : off + length], cache, off,
                                              last=off + length == tokens.shape[1])
            torch.cuda.synchronize()
    engine.cache, engine.pos = cache, tokens.shape[1]
    return tok


def _trace(engine: ServeEngine, batch: dict, args) -> dict:
    def prefill(traced: bool) -> torch.Tensor:
        if args.chunk_size:
            return _chunked_prefill(engine, batch, args.chunk_size, traced)
        with record_function("prefill") if traced else contextlib.nullcontext():
            tok = engine.prefill(batch)
            torch.cuda.synchronize()
        return tok

    engine.decode(prefill(False), 2)  # warm-up
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tok = prefill(True)
        for _ in range(args.steps):
            with record_function("decode_step"):
                tok = engine.decode(tok, 1)
                torch.cuda.synchronize()
    events = prof.events()
    out = {
        "device": torch.cuda.get_device_name(0),
        "phases": phase_breakdown(events),
        "kernels": top_kernels(events),
        "host_ops": top_host_ops(prof),
    }
    for r in out["phases"]:
        print(f"{r['phase']:12s} wall {r['wall_ms']:.3f} ms  device busy {r['device_busy_ms']:.3f} ms  "
              f"idle {r['idle_share']:.3f}  kernels {r['device_kernels']}")
    print("kernels by device time (whole trace):")
    for r in out["kernels"]:
        print(f"  {r['device_ms']:10.3f} ms  x{r['calls']:<5d} {r['kernel'][:100]}")
    print("host operators by self CPU time (whole trace):")
    for r in out["host_ops"]:
        print(f"  {r['self_cpu_ms']:10.3f} ms  x{r['calls']:<5d} {r['op'][:100]}")
    if args.chrome:
        prof.export_chrome_trace(args.chrome)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
