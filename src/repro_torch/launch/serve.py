"""Serving launcher for the PyTorch port: synchronized batched prefill +
decode, or trace-driven continuous batching (``--continuous``).

Runs on the card by default; ``--device cpu`` runs the plain CPU path::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --device cpu --batch 2 --prompt-len 16 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --quantize w8a8 --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --batch 4 --prompt-len 512 --gen 32

Continuous batching (Poisson arrivals of ``--rate`` per tick, ragged prompt
and generation lengths around ``--mean-prompt`` / ``--mean-gen``, at most
``--prompt-len`` / ``--gen``; the scheduler refills freed slots of
``--slots`` as requests arrive; ``--policy gang`` admits only into an empty
pool, as synchronized batching does)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --continuous --requests 16 --slots 8 --rate 0.5 --mean-prompt 128 \
        --mean-gen 24 --prompt-len 512 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --device cpu --continuous --requests 6 --slots 3

``--chunked-prefill`` splits each prompt into ``--chunk-size`` chunks
(remainders in power-of-two buckets) and runs at most ``--chunk-budget`` of
them per tick beside the decode step; ``--quantize kv8`` keeps the
continuous pool in int8 with per-head, per-slot scales::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --device cpu --continuous --chunked-prefill --chunk-size 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --continuous --quantize kv8 --requests 16 --slots 8

Weights are random, drawn from ``--seed``.  A MoE config (qwen3-moe-30b-a3b)
runs its expert GEMMs on the grouped kernel; an MLA config (minicpm3-4b)
caches the attention's latents.  ``--quantize w8a16`` keeps the projection
weights in int8 and dequantizes them at each GEMM; ``w8a8`` also quantizes
the activations per token and runs every projection on the block-scaled
int8 kernel; both work in either mode and on every family.  As in the
reference, a MoE layer's router and experts and MLA's ``wkv_b`` stay wide::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \
        --quantize w8a8 --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \
        --quantize w8a8 --smoke --device cpu
``kv8`` applies to the continuous pool only: without ``--continuous`` it
warns and serves unquantized, as the reference does.  The paged pool, the
adversarial trace and the metrics / SLO / profiling flags of
``repro.launch.serve`` belong to later parts of the port.
"""

from __future__ import annotations

import argparse
import contextlib
import time
import warnings

import torch

from repro_torch import configs, quant
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import make_batch, make_request_trace
from repro_torch.kernels import _build
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import cast_params
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_synchronized(model, params, args, device: torch.device) -> torch.Tensor:
    cfg = model.cfg
    engine = ServeEngine(
        model,
        params,
        ServeConfig(max_len=args.prompt_len + args.gen, batch=args.batch, temperature=args.temperature,
                    seed=args.seed),
        device=device,
    )
    prompts = make_batch(cfg, batch=args.batch, seq=args.prompt_len, kind="prefill",
                         seed=args.seed, device=device)

    t0 = time.perf_counter()
    first = engine.prefill(prompts)
    _sync(device)
    t_pf = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len} in {t_pf * 1e3:.3f} ms")

    pieces = [first]
    n_dec = args.gen - 1
    if n_dec > 0:
        t0 = time.perf_counter()
        out = engine.decode(first, n_dec)
        _sync(device)
        t_dec = time.perf_counter() - t0
        pieces.append(out)
        print(f"decode {n_dec} steps: {t_dec / n_dec * 1e3:.3f} ms/step, "
              f"{args.batch * n_dec / t_dec:.1f} tok/s")
    sample = torch.cat(pieces, dim=1)
    print("sample tokens:", sample[0, :16].tolist())
    return sample


def run_continuous(model, params, args, device: torch.device) -> dict:
    """Serve a Poisson request trace through ContinuousScheduler; returns
    {rid: generated tokens}."""
    trace = make_request_trace(
        model.cfg,
        n_requests=args.requests,
        mean_prompt=args.mean_prompt,
        mean_gen=args.mean_gen,
        rate=args.rate,
        seed=args.seed,
        max_prompt=args.prompt_len,
        max_gen=args.gen,
        device=device,
    )
    max_len = max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)
    engine = ServeEngine(
        model,
        params,
        ServeConfig(max_len=max_len, batch=args.slots, temperature=args.temperature, seed=args.seed),
        device=device,
    )
    sched = ContinuousScheduler(
        engine,
        policy=args.policy,
        chunked_prefill=args.chunked_prefill,
        chunk_size=args.chunk_size,
        chunk_budget=args.chunk_budget,
        quantize_kv=args.quantize == "kv8",
    )
    results = sched.run(requests_from_trace(trace))
    s = sched.stats.summary()
    mode = f"{args.policy}+chunked" if args.chunked_prefill else args.policy
    print(
        f"continuous[{mode}] {args.requests} requests over "
        f"{s['ticks']} ticks ({s['idle_ticks']} idle, "
        f"{s['prefill_chunks']} prefill chunks) | "
        f"{s['tokens_out']} tokens, {s['tok_per_s']:.1f} tok/s | "
        f"step latency p50 {s['p50_step_ms']:.2f} ms / p99 {s['p99_step_ms']:.2f} ms | "
        f"tick latency p50 {s['p50_tick_ms']:.2f} ms / p99 {s['p99_tick_ms']:.2f} ms | "
        f"mean slot occupancy {s['mean_occupancy']:.2%}"
    )
    print(f"ttft p50 {s['ttft_p50_ms']:.2f} ms / p99 {s['ttft_p99_ms']:.2f} ms | "
          f"kv bytes resident {s['kv_bytes_resident']}")
    rid0 = min(results)
    print(f"sample tokens (request {rid0}):", results[rid0][:16].tolist())
    return results


def main(argv: list[str] | None = None) -> torch.Tensor | dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", help="the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    # continuous-batching mode
    ap.add_argument("--continuous", action="store_true",
                    help="trace-driven continuous batching (Poisson arrivals, ragged lengths)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--rate", type=float, default=0.5, help="arrivals per decode step")
    ap.add_argument("--mean-prompt", type=int, default=24)
    ap.add_argument("--mean-gen", type=int, default=12)
    ap.add_argument("--policy", choices=ContinuousScheduler.POLICIES, default="continuous",
                    help="'gang' reproduces synchronized batching for comparison")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="split prompts into bucketed chunks and co-schedule them with the decode step "
                    "(keeps decode latency flat under long prompts)")
    ap.add_argument("--chunk-size", type=int, default=128,
                    help="prefill chunk length (remainders bucket to powers of two)")
    ap.add_argument("--chunk-budget", type=int, default=1, help="max prefill chunks per scheduler tick")
    ap.add_argument(
        "--quantize",
        choices=("none", "w8a16", "w8a8", "kv8"),
        default="none",
        help="w8a16 = int8 weight-only (weights dequantize at each GEMM), w8a8 = int8 "
        "weights and per-token int8 activations through the block-scaled kernel, kv8 = "
        "int8 KV pool of continuous serving with per-head-per-slot scales",
    )
    args = ap.parse_args(argv)
    if args.quantize == "kv8" and not args.continuous:
        warnings.warn("--quantize kv8 applies to the continuous-batching KV pool; ignored in synchronized mode")

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"kernel build: {_build.build_all():.1f} s")  # so the prefill time below is the prefill's
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    model = get_model(cfg)
    params, act_ctx = init_params(model, args.seed, device, args.quantize)
    with act_ctx:
        if args.continuous:
            return run_continuous(model, params, args, device)
        return run_synchronized(model, params, args, device)


def init_params(model, seed: int, device: torch.device, quantize: str = "none"):
    """Random weights from ``seed`` -> (params, the activation-quant context
    to serve them under).  w8a16 / w8a8 quantize the fp32 masters, as the
    reference does (it inits in fp32), and cast what stays wide to the
    compute dtype once, one layer at a time: each layer's masters are drawn,
    quantized, cast and dropped before the next is drawn, so the peak is one
    layer of fp32 beside the served tree (the whole model's masters would
    not fit on one card for qwen3-moe-30b-a3b: 30.5 B x 4 bytes).  The
    result is the whole model's masters quantized and cast, bit for bit.
    kv8 quantizes the KV pool, not the weights: its parameters are the fp
    ones."""
    if quantize == "kv8":
        quantize = "none"
    if quantize not in ("none", "w8a16", "w8a8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    if quantize == "none":
        return model.init(seed, device), contextlib.nullcontext()
    dtype = getattr(torch, model.cfg.dtype)
    params = model.init(seed, device, dtype=torch.float32,
                        transform=lambda piece: cast_params(quant.quantize_params(piece), dtype))
    n_q, q_bytes = quant.count_quantized(params)
    print(f"quantize[{quantize}]: {n_q} projection weights -> int8 ({q_bytes / 1e6:.1f} MB resident values)")
    if quantize == "w8a16":
        return params, contextlib.nullcontext()
    return quant.k_major(params), quant.use_act_quant("int8")  # the layout the block-scaled kernel reads


if __name__ == "__main__":
    main()
