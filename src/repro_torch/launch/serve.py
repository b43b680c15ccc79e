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
warns and serves unquantized, as the reference does.

The recurrent families -- xlstm-125m (SSM: mLSTM + sLSTM) and zamba2-7b
(hybrid: Mamba2 + one shared attention block) -- prefill by a loop of decode
steps over the prompt, as the reference does, and serve in every mode: w8a16
/ w8a8 quantize the mLSTM, SwiGLU and shared-attention projections and the
head (Mamba2's in_proj / out_proj and sLSTM's w_x stay wide, as in the
reference); chunked prefill carries the state on the request and writes it
into the slot once; ``--quantize kv8`` and ``--paged`` warn and serve
unquantized and unpaged (the state has no sequence axis)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --smoke --device cpu --batch 2 --prompt-len 16 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --smoke --device cpu --continuous --chunked-prefill --chunk-size 4

Paged KV (``--paged``): the continuous pool swaps the per-slot ``max_len``
stripe for ``--page-size``-row pages behind a per-slot page table, so
reserved KV bytes follow the tokens held; ``--pages`` sizes the arena
(default: every slot's full stripe; undersize it to make the scheduler
reclaim prefix pages and preempt).  ``--prefix-cache`` adds the radix prefix
cache: requests sharing a prompt prefix map the same refcounted pages and
prefill only their suffix.  ``--adversarial`` replaces the Poisson trace with
the long-prompt trace (``--requests`` minus ``--long-requests`` short
requests of ``--mean-prompt`` tokens decoding ``--mean-gen`` from tick 0, and
``--long-requests`` prompts of ``--prompt-len`` tokens arriving at tick 2,
their first ``--shared-prefix`` tokens identical)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --smoke --device cpu --continuous --paged --page-size 8 --prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --continuous --paged --prefix-cache --adversarial --requests 6 \
        --long-requests 2 --prompt-len 4096 --shared-prefix 4000 --slots 4

The modality frontends: musicgen-medium (audio: four parallel codebook
streams in and out, so each sampled token is one id per codebook) and
internvl2-1b (vlm: a prompt of ``--prompt-len`` positions holds its 256
projected patches and the text after them; the cache holds the patches
too).  ``--continuous`` serves both; there the trace's prompt lengths
(``--mean-prompt``, at most ``--prompt-len``) count a vit prompt's text, and
its patches come before it.  The vit frontend's prompts are not chunkable
and not prefix-cached (``--chunked-prefill`` and ``--prefix-cache`` warn and
prefill monolithically, as the reference does)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b \
        --smoke --device cpu --continuous --requests 6 --slots 3

Telemetry (``repro_torch.obs``): ``--metrics-dir`` writes the merged metrics
snapshot (``snapshot.json``: the dispatch registry -- ``gemm.*``,
``tune.plan.*``, ``profile.*`` -- and the scheduler's, with the run summary),
the Chrome trace (``trace.json``), in continuous mode a ``snapshot-<tick>.json``
every ``--metrics-interval`` ticks (the newest ``--metrics-keep`` kept) and
flight-recorder bundles on SLO violations (``--slo-ttft-ms``, ``--slo-itl-ms``,
``--slo-queue-wait-ms``).  ``--profile-sample-rate`` times that fraction of
K1 calls and KV-pool dispatches in windows, and after a continuous run
re-measures the decode GEMMs with CUDA events (the drift probe) against the
plan cache; ``$REPRO_TORCH_LEDGER`` also records stale plans.  Then
``python -m repro_torch.obs doctor <dir>`` diagnoses the run::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --continuous --requests 16 --slots 8 --profile-sample-rate 0.5 \
        --metrics-dir /tmp/serve-metrics
    PYTHONPATH=src python -m repro_torch.obs doctor /tmp/serve-metrics
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import warnings

import torch

from repro_torch import configs, quant
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import make_adversarial_trace, make_batch, make_request_trace
from repro_torch.kernels import _build
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import cast_params
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ledger import Ledger
from repro_torch.obs.slo import FlightRecorder, SLOSpec
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace


def _dump_metrics(metrics_dir: str, extra_registry=None, extra: dict | None = None,
                  name: str = "snapshot.json") -> str:
    """Write the merged metrics snapshot to ``metrics_dir/<name>`` (the
    process-wide dispatch registry + the scheduler's private registry)."""
    regs = [obs_metrics.get_registry()]
    if extra_registry is not None:
        regs.append(extra_registry)
    doc = obs_metrics.snapshot_doc(*regs, extra=extra)
    os.makedirs(metrics_dir, exist_ok=True)
    path = os.path.join(metrics_dir, name)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def _prune_tick_snapshots(metrics_dir: str, keep: int) -> None:
    """Keep only the newest ``keep`` periodic ``snapshot-<tick>.json`` files
    (the final merged ``snapshot.json`` is never pruned)."""
    ticks = sorted(f for f in os.listdir(metrics_dir) if f.startswith("snapshot-") and f.endswith(".json"))
    for stale in ticks[:-keep] if keep > 0 else ticks:
        with contextlib.suppress(OSError):
            os.remove(os.path.join(metrics_dir, stale))


def _dump_trace(metrics_dir: str) -> str:
    path = os.path.join(metrics_dir, "trace.json")
    obs_trace.get_tracer().export_chrome(path)
    return path


def drift_probe(engine) -> list:
    """Re-measure the run's decode GEMMs off the serving path (CUDA events on
    the card) and hold the samples against the plan cache and the roofline;
    stale plans go into the registry (``tune.plan.stale{key}``) and, with
    ``$REPRO_TORCH_LEDGER``, a ledger.  Returns the probe's rows."""
    probe = obs_drift.probe_decode_plans(engine)
    findings = obs_drift.check_drift(obs_metrics.get_registry().snapshot())
    ledger_path = os.environ.get("REPRO_TORCH_LEDGER")
    n_stale = obs_drift.record_findings(findings, ledger=Ledger(ledger_path) if ledger_path else None)
    print(f"drift probe: {len(probe)} decode GEMMs re-measured, {n_stale} stale plan(s)")
    for row in probe:
        if "error" in row:
            print(f"  {row['name']} {row['problem']}: not measured: {row['error']}")
        else:
            print(f"  {row['name']} {row['problem']} on {row['path']}: {row['mean_us']:.3f} us "
                  f"[{row['method']}], model {row['model_us']:.3f} us")
    for f in findings:
        if f.stale:
            print(f"  STALE {f.recommendation}")
    return probe


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _prefix(cfg) -> int:
    """Cache positions a prompt holds before its text: the vit frontend's patches."""
    return cfg.n_patches if cfg.frontend == "vit" else 0


def run_synchronized(model, params, args, device: torch.device) -> torch.Tensor:
    cfg = model.cfg
    engine = ServeEngine(
        model,
        params,
        ServeConfig(max_len=args.prompt_len + args.gen + _prefix(cfg), batch=args.batch,
                    temperature=args.temperature, seed=args.seed),
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
    print(engine.decode_plan_report())
    sample = torch.cat(pieces, dim=1)
    print("sample tokens:", sample[0, :16].tolist())
    if args.metrics_dir:
        print("metrics snapshot:", _dump_metrics(args.metrics_dir))
        print("chrome trace:", _dump_trace(args.metrics_dir))
    return sample


def run_continuous(model, params, args, device: torch.device) -> dict:
    """Serve a request trace through ContinuousScheduler (Poisson, or with
    ``--adversarial`` the long-prompt trace); returns {rid: generated
    tokens}."""
    if args.adversarial:
        trace = make_adversarial_trace(
            model.cfg,
            n_short=max(1, args.requests - args.long_requests),
            short_prompt=args.mean_prompt,
            short_gen=args.mean_gen,
            long_prompt=args.prompt_len,
            n_long=args.long_requests,
            shared_prefix=args.shared_prefix,
            seed=args.seed,
            device=device,
        )
    else:
        p = _prefix(model.cfg)  # a vit prompt's positions: its patches, then the trace's text lengths
        trace = make_request_trace(
            model.cfg,
            n_requests=args.requests,
            mean_prompt=args.mean_prompt + p,
            mean_gen=args.mean_gen,
            rate=args.rate,
            seed=args.seed,
            min_prompt=4 + p,
            max_prompt=args.prompt_len + p,
            max_gen=args.gen,
            device=device,
        )
    max_len = max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace) + _prefix(model.cfg)
    engine = ServeEngine(
        model,
        params,
        ServeConfig(max_len=max_len, batch=args.slots, temperature=args.temperature, seed=args.seed),
        device=device,
    )
    slo = None
    if args.slo_ttft_ms or args.slo_itl_ms or args.slo_queue_wait_ms:
        slo = SLOSpec(ttft_ms=args.slo_ttft_ms, itl_ms=args.slo_itl_ms, queue_wait_ms=args.slo_queue_wait_ms)
        print(f"slo budgets: {slo.describe()}")
    sched = ContinuousScheduler(
        engine,
        policy=args.policy,
        chunked_prefill=args.chunked_prefill,
        chunk_size=args.chunk_size,
        chunk_budget=args.chunk_budget,
        quantize_kv=args.quantize == "kv8",
        paged=args.paged,
        page_size=args.page_size,
        n_pages=args.pages,
        prefix_cache=args.prefix_cache,
        slo=slo,
    )
    on_tick = None
    if args.metrics_dir:
        # Flight recorder: postmortem bundles on SLO violation or engine
        # exception, snapshotting both registries.
        sched.flight_recorder = FlightRecorder(args.metrics_dir,
                                               registries=(obs_metrics.get_registry(), sched.stats.registry))
        interval, keep = max(1, args.metrics_interval), max(1, args.metrics_keep)

        def on_tick(sc) -> None:
            if sc.tick % interval == 0:
                _dump_metrics(args.metrics_dir, sc.stats.registry, extra=sc.stats.summary(),
                              name=f"snapshot-{sc.tick:06d}.json")
                _prune_tick_snapshots(args.metrics_dir, keep)

    results = sched.run(requests_from_trace(trace), on_tick=on_tick)
    if obs_profile.get_profiler().active():
        drift_probe(engine)  # its findings land in the registry before the final snapshot
    s = sched.stats.summary()
    mode = f"{args.policy}+chunked" if args.chunked_prefill else args.policy
    print(
        f"continuous[{mode}] {len(trace)} requests over "
        f"{s['ticks']} ticks ({s['idle_ticks']} idle, "
        f"{s['prefill_chunks']} prefill chunks) | "
        f"{s['tokens_out']} tokens, {s['tok_per_s']:.1f} tok/s | "
        f"step latency p50 {s['p50_step_ms']:.2f} ms / p99 {s['p99_step_ms']:.2f} ms | "
        f"tick latency p50 {s['p50_tick_ms']:.2f} ms / p99 {s['p99_tick_ms']:.2f} ms | "
        f"mean slot occupancy {s['mean_occupancy']:.2%}"
    )
    if sched.paged:
        print(
            f"paged kv: {sched.pool.pages_in_use}/{sched.pool.n_pages} pages "
            f"in use at drain, page size {sched.pool.page_size} | "
            f"prefix hits {s['prefix_hits']} ({s['prefix_hit_tokens']} tokens "
            f"of prefill skipped) | preempted {s['preempted']} | "
            f"kv bytes live {s['kv_bytes_live']}"
        )
    print(f"ttft p50 {s['ttft_p50_ms']:.2f} ms / p99 {s['ttft_p99_ms']:.2f} ms | "
          f"kv bytes resident {s['kv_bytes_resident']}")
    if s["decode_mfu"] or s["model_residual"]:
        print(f"decode mfu {s['decode_mfu']:.6f} (mean over {s['decode_steps']} steps, of the card's datasheet peak "
              f"for {model.cfg.dtype}) | model residual {s['model_residual']:.4f}x the roofline")
    if slo is not None:
        print(f"slo: {s['requests_conformant']}/{s['requests_finished']} requests conformant, "
              f"{s['slo_violations']} violations | goodput {s['goodput_toks']} toks, "
              f"{s['goodput_tok_per_s']:.1f} tok/s (raw {s['tok_per_s']:.1f})")
        fr = sched.flight_recorder
        if fr is not None and fr.paths:
            print(f"postmortem bundles: {len(fr.paths)} in {args.metrics_dir}"
                  + (f" ({fr.suppressed} suppressed)" if fr.suppressed else ""))
    print(engine.decode_plan_report())
    rid0 = min(results)
    print(f"sample tokens (request {rid0}):", results[rid0][:16].tolist())
    if args.metrics_dir:
        # The final snapshot carries the run summary (MFU, TTFT / ITL, KV
        # bytes) in "extra" beside the raw registry series.
        print("metrics snapshot:", _dump_metrics(args.metrics_dir, sched.stats.registry, extra=s))
        print("chrome trace:", _dump_trace(args.metrics_dir))
        print(f"diagnose: python -m repro_torch.obs doctor {args.metrics_dir}")
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
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: fixed-size pages behind a per-slot page table instead of the per-slot "
                    "max_len stripe (continuous mode, attention families only)")
    ap.add_argument("--page-size", type=int, default=16, metavar="ROWS", help="KV rows per page (--paged)")
    ap.add_argument("--pages", type=int, default=None, metavar="N",
                    help="page arena size; default slots * ceil(max_len / page_size) (undersize it to exercise "
                    "prefix reclaim and preemption)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over --paged: requests sharing a prompt prefix attach the same "
                    "refcounted pages and prefill only their suffix")
    ap.add_argument("--adversarial", action="store_true",
                    help="replace the Poisson trace with the long-prompt trace (requests - long-requests short "
                    "requests at tick 0, long --prompt-len prompts mid-run; continuous mode only)")
    ap.add_argument("--long-requests", type=int, default=1, metavar="N",
                    help="--adversarial: long prompts arriving in the mid-run burst")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="TOKENS",
                    help="--adversarial: identical leading tokens across the long prompts (exercises "
                    "--prefix-cache under page pressure)")
    ap.add_argument(
        "--quantize",
        choices=("none", "w8a16", "w8a8", "kv8"),
        default="none",
        help="w8a16 = int8 weight-only (weights dequantize at each GEMM), w8a8 = int8 "
        "weights and per-token int8 activations through the block-scaled kernel, kv8 = "
        "int8 KV pool of continuous serving with per-head-per-slot scales",
    )
    ap.add_argument("--metrics-dir", default=None,
                    help="write telemetry here: the final snapshot.json, in continuous mode periodic "
                    "snapshot-<tick>.json (the newest --metrics-keep kept), trace.json (Chrome trace_event) and "
                    "postmortem-*.json flight-recorder bundles on SLO violations; validate with python -m "
                    "repro_torch.obs <files>, diagnose with python -m repro_torch.obs doctor <dir>")
    ap.add_argument("--metrics-interval", type=int, default=50, metavar="TICKS",
                    help="ticks between periodic snapshot-<tick>.json dumps (continuous mode)")
    ap.add_argument("--metrics-keep", type=int, default=16, metavar="K",
                    help="keep only the newest K periodic snapshot-<tick>.json files")
    ap.add_argument("--slo-ttft-ms", type=float, default=None, help="TTFT budget (admission -> first token), ms")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="inter-token latency budget (gap between a request's consecutive tokens), ms")
    ap.add_argument("--slo-queue-wait-ms", type=float, default=None,
                    help="queue-wait budget (eligible -> slot granted), ms")
    ap.add_argument("--profile-sample-rate", type=float, default=None, metavar="RATE",
                    help="time this fraction of K1 calls and KV-pool dispatches in windows (host clock to the "
                    "card's finishing the call), and run the drift probe after a continuous run; 0 disables; "
                    "default $REPRO_PROFILE_RATE or 0")
    args = ap.parse_args(argv)
    if args.profile_sample_rate is not None:
        obs_profile.configure(args.profile_sample_rate)
        if args.profile_sample_rate > 0:
            print(f"profiling: sample rate {args.profile_sample_rate}")
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
    compute dtype once (the fp32 leaves of ``layers.FP32_KEYS`` stay fp32),
    one layer at a time (the hybrid's shared block as one piece, after its
    Mamba2 layers): each layer's masters are drawn,
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
