#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100, end to end.

Run from the root of the repository on a machine with the card and nvcc:

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name and power limit as nvidia-smi gives them, and the
     build of the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main path's shapes and on ragged ones, max errors beside the
     tolerance (the systolic GEMM on each of its wgmma tiles, with ragged
     M, N and K that TMA zero-fills; flash attention at head dims 16, 64,
     120 and 128, K/V at 1/1, 1/2 and 1/8 of the query heads, in the
     model's strided layout, with windows, a masked tail and without the
     causal mask; the block-scaled int8 / fp8 GEMM on K-major weights, as
     w8a8 serves them, also over scale blocks of 256, 128, 64, 32, 16 and
     whole-K; the grouped
     GEMM at capacities 8, 100, 160 and 200 with each expert's token rows
     empty, partial, full or as a decode step routes them);
  3. full-width internlm2-1.8b in bf16 (random weights from a seed) served
     through ServeEngine: batch 4, prompt 512, 32 greedy tokens, with the
     kernels' launch counts checked exactly, in all and per GEMM shape, every
     prefill launch of each GEMM on a wgmma path and every decode one on its
     decode tile, and every flash launch given K/V at the model's own KV
     heads; the
     kernel path's prefill logits and two decode steps from the same cache
     against the same model run through the plain versions on the card; and
     the SMOKE config in fp32 on the card against the port's CPU path;
     then the same parameters served continuously: 16 requests of a
     Poisson trace (prompts up to 512 tokens, generations up to 64) through
     ContinuousScheduler over 8 slots, with the lifecycle checked (every
     request finished with all its tokens, the pool drained, slots reused,
     slots at different positions in one tick), launch counts exact per
     kernel, per GEMM shape and path and per flash shape and head count
     (warmup included), every request's prefill and decode-step logits
     against the same request served alone at batch 1 with the scheduler's
     tokens fed back, and the continuous serving numbers;
     then the same model served w8a8 (int8 weights quantized from the same
     fp32 masters, per-token int8 activations), every projection on the
     block-scaled kernel, with the same launch, kernel-vs-plain and decode
     checks (each kernel call of the prefill also against its plain version
     on the model's own inputs), and its logits against the bf16 model's
     within the reference's bound of 0.15 x the largest logit; then
     full-width qwen3-moe-30b-a3b in bf16, every expert GEMM on the grouped
     kernel, with the same launch and decode checks, kernel-vs-plain logits
     with the plain path routed to the kernel path's experts (bf16's
     tolerance) and routing freely (twice it), a routing witness (each
     grouped call of the prefill against its plain version on the model's
     own dispatched tokens; the (token, choice) assignments and capacity
     drops that differ between the paths, by layer; one-ulp nudges of the
     plain path alone), the same checks and witness on models and prompts
     from two more seeds, and the SMOKE MoE config in fp32 on the card
     against the port's CPU path; every path's prefill twice, bit-identical;
  4. each kernel timed at the served paths' shapes (CUDA events) beside its
     bound, its plain version and one PyTorch library call (a yardstick the
     port never calls; none computes the block-scaled product, so the
     quantized kernel's is null; it is also timed beside K1 and with whole-K
     scales); the systolic GEMM's prefill shapes also on each wgmma tile; the
     grouped GEMM at all rows and with the rows the MoE model's routing gave
     in phase 3, each with its own bound; flash attention in each model's
     layout, K/V at its KV heads; one JSON line lists the kernels, each
     shape's time weighted by the launches the main path made at that shape;
  5. the last line: {"ok": true, "device": {...}}.
Without a card, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import configs, quant  # noqa: E402
from repro_torch.core.hw import H100, dtype_bytes  # noqa: E402
from repro_torch.data.synthetic import make_batch, make_request_trace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import flash_attention_call_ref  # noqa: E402
from repro_torch.kernels.grouped import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.grouped import ops as grouped_ops  # noqa: E402
from repro_torch.kernels.grouped.ref import grouped_matmul_ref  # noqa: E402
from repro_torch.kernels.systolic import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.systolic import ops as mm_ops  # noqa: E402
from repro_torch.kernels.systolic.ref import (  # noqa: E402
    ACTIVATIONS,
    matmul_ref,
    quant_matmul_ref,
    quant_systolic_matmul_ref,
)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.transformer import cast_params  # noqa: E402
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace  # noqa: E402
from repro_torch.serving.scheduler import FINISHED  # noqa: E402

ARCH = "internlm2-1.8b"
MOE_ARCH = "qwen3-moe-30b-a3b"
BATCH, PROMPT, GEN = 4, 512, 32
SEED = 0
# The continuous path: a Poisson request trace (0.5 arrivals per tick,
# prompts geometric around 128 tokens in [4, 512], generations around 24 in
# [1, 64]) over 8 slots.
CONT_SLOTS = 8
CONT_TRACE = dict(n_requests=16, mean_prompt=128, mean_gen=24, rate=0.5, seed=SEED, max_prompt=512, max_gen=64)
BF16 = torch.bfloat16
# Tolerances (|got - want| <= atol + rtol * |want|), with their reasons:
GEMM_TOL_BF16 = (2e-2, 2e-2)  # one bf16 ulp where kernel and plain round the fp32 sum
GEMM_RTOL_FP32 = 1e-5  # fp32 atol is 1e-5 * sqrt(K): summation order, growing with sqrt(K)
ATTN_TOL = {BF16: 3e-2, torch.float32: 2e-4}  # P rounded to bf16 / online vs direct softmax
LOGITS_TOL_BF16 = 5e-2  # of the largest logit: bf16 activations rounded at other points
LOGITS_TOL_FP32 = 1e-4  # fp32 SMOKE model, card vs CPU: summation order only
# Block-scaled GEMM vs its dequantize-then-fp32 plain version: atol 1e-5 x
# (max|sum| + 1), the reference's own (same quantized values, other fp32
# order; the activations are <= 1.1-Lipschitz), plus one bf16 ulp (2^-7
# relative) where the output is bf16 and the two round different fp32 sums.
QGEMM_ATOL = 1e-5
QGEMM_RTOL_BF16 = 2**-7
# w8a8 kernel path vs plain path at full width: bf16 activations rounded at
# other points (as LOGITS_TOL_BF16), and each layer's per-token int8 rounding
# turns a one-ulp bf16 difference into a one-step int8 difference where a
# value sits near a rounding boundary (a bf16 ulp is about a sixth of an int8
# step at typical magnitudes).  Phase 3 prints the witnesses: every kernel
# call inside the model against its plain version, the int8 activations that
# differ between the paths, and how far a one-ulp nudge of the input moves
# the plain path alone.
LOGITS_TOL_W8A8 = 5e-2
W8A8_VS_BF16_TOL = 0.15  # of the bf16 model's largest logit: tests/test_quant.py's w8a8 bound
# MoE kernel path vs plain path at full width: bf16's reason, and routing is
# discrete, so a rounding difference near a top-k tie sends a token to
# another expert (and moves which slots overflow capacity), a jump far
# larger than an ulp.  The kernel gate is the comparison with the plain path
# routed exactly as the kernel path (same experts per token, its own
# weights), held at bf16's 5e-2.  Each path routing freely moves as far as
# the model moves under a one-ulp nudge of its input, so that comparison is
# held at 1e-1: above the largest nudge reading (8.65 % of the largest
# logit, over three model seeds x three nudges x prefill and three decode
# steps, first measured on an H100).  Phase 3 prints the witnesses: every
# grouped call of the prefill against its plain version on the model's own
# dispatched tokens, the assignments and drops that differ between the paths
# by layer, the routed-alike gap, and the nudge readings, for the model of
# the main path and for models and prompts from two more seeds.
LOGITS_TOL_MOE = 1e-1
MOE_WITNESS_SEEDS = (1, 2)  # more models and prompts for the MoE witness
MOE_NUDGES, MOE_NUDGE_STEPS = 3, 3  # one-ulp nudges per model, decode steps each
SOURCES = {
    "systolic_mmm": ("src/repro_torch/csrc/systolic_mmm.cu", "src/repro/kernels/systolic/kernel.py:37"),
    "systolic_qmm": ("src/repro_torch/csrc/systolic_qmm.cu", "src/repro/kernels/systolic/kernel.py:174"),
    "flash_attn": ("src/repro_torch/csrc/flash_attn.cu", "src/repro/kernels/attention/kernel.py:30"),
    "grouped_mmm": ("src/repro_torch/csrc/grouped_mmm.cu", "src/repro/kernels/grouped/kernel.py:26"),
}
KERNELS = tuple(SOURCES)


def projections(cfg) -> collections.Counter:
    """(K, N) -> launches per layer of the projection GEMM (fp or block-scaled):
    q, k, v, o, then the SwiGLU's gate, up and down or the MoE router."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    c = collections.Counter()
    c[(d, cfg.n_heads * hd)] += 1
    c[(d, cfg.n_kv_heads * hd)] += 2
    c[(cfg.n_heads * hd, d)] += 1
    if cfg.moe is None:
        c[(d, cfg.d_ff)] += 2
        c[(cfg.d_ff, d)] += 1
    else:
        c[(d, cfg.moe.n_experts)] += 1
    return c


def expert_gemms(cfg) -> collections.Counter:
    """(K, N) -> grouped launches per MoE layer: gate and up, then down."""
    if cfg.moe is None:
        return collections.Counter()
    d, ff = cfg.d_model, cfg.moe.d_ff_expert
    c = collections.Counter()
    c[(d, ff)] += 2
    c[(ff, d)] += 1
    return c


def gemm_out_dtype(cfg, k: int, n: int) -> torch.dtype:
    """The router writes fp32 logits; every other projection the compute dtype."""
    return torch.float32 if cfg.moe is not None and (k, n) == (cfg.d_model, cfg.moe.n_experts) else BF16


failures: list[str] = []


def say(msg: str) -> None:
    print(msg, flush=True)


def expect(ok: bool, what: str) -> None:
    say(f"  {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def reset_counts() -> None:
    mm_kernel.launches = 0
    mm_kernel.launches_by_shape.clear()
    mm_kernel.launches_by_path.clear()
    mm_kernel.quant_launches = 0
    mm_kernel.quant_launches_by_shape.clear()
    mm_kernel.quant_launches_by_path.clear()
    attn_kernel.launches = 0
    attn_kernel.launches_by_heads.clear()
    attn_kernel.launches_by_shape.clear()
    grouped_kernel.launches = 0
    grouped_kernel.launches_by_shape.clear()
    grouped_kernel.launches_by_path.clear()


def counts() -> dict:
    """Launches of each kernel since the last reset."""
    return {"systolic_mmm": mm_kernel.launches, "systolic_qmm": mm_kernel.quant_launches,
            "flash_attn": attn_kernel.launches, "grouped_mmm": grouped_kernel.launches}


def shape_counts() -> dict:
    """Launches of each GEMM since the last reset, by shape at the launch site:
    (M, K, N) for the projection GEMMs, (E, C, K, N) for the grouped one."""
    return {"systolic_mmm": dict(mm_kernel.launches_by_shape),
            "systolic_qmm": dict(mm_kernel.quant_launches_by_shape),
            "grouped_mmm": dict(grouped_kernel.launches_by_shape)}


def flash_shape_counts() -> dict:
    """Flash launches since the last reset by (B, Sq, Skv)."""
    return dict(attn_kernel.launches_by_shape)


def route_counts() -> dict:
    """Since the last reset: the launches of each GEMM by path, and flash
    attention's by the (H, Hkv) head counts it was given."""
    return {"systolic_mmm_paths": dict(mm_kernel.launches_by_path),
            "systolic_qmm_paths": dict(mm_kernel.quant_launches_by_path),
            "grouped_mmm_paths": dict(grouped_kernel.launches_by_path),
            "flash_attn_heads": dict(attn_kernel.launches_by_heads)}


@contextlib.contextmanager
def plain_versions():
    """Route the kernel wrappers' CUDA calls to their plain versions (for the
    comparison run only; the port itself has no such switch)."""

    def mm(a, b, bias, *, out_dtype, activation="none"):
        return matmul_ref(a, b, bias, activation=activation, out_dtype=out_dtype)

    with mock.patch.object(mm_kernel, "systolic_matmul_call", mm), \
            mock.patch.object(mm_kernel, "quant_systolic_matmul_call", quant_systolic_matmul_ref), \
            mock.patch.object(attn_kernel, "flash_attention_call", flash_attention_call_ref), \
            mock.patch.object(grouped_kernel, "grouped_matmul_call", lambda x, w, rows=None: grouped_matmul_ref(x, w)):
        yield


@contextlib.contextmanager
def quantized_activations(record: list, against: list | None = None):
    """Record each activation that core.ops quantizes for a GEMM, in call
    order: its int8 values, or, with ``against`` (the values another run
    recorded), how many of them differ from that run's at the same call, how
    many by more than one int8 step, and the largest difference in steps."""
    real = quant.quantize_act

    def rec(x, *args, **kw):
        q = real(x, *args, **kw)
        if against is None:
            record.append(q.values)
        else:
            d = (q.values.int() - against[len(record)].int()).abs()
            record.append((int((d > 0).sum()), int((d > 1).sum()), d.numel(), int(d.max())))
        return q

    with mock.patch.object(quant, "quantize_act", rec):
        yield


@contextlib.contextmanager
def checked_quant_calls(worst: list):
    """Hold every block-scaled kernel call against its plain version on the
    same inputs -- the model's own activations and scales -- within phase
    2's tolerance, recording each call's largest error as a share of its
    tolerance (the comparison itself launches no kernel)."""
    real = mm_kernel.quant_systolic_matmul_call

    def call(a, a_s, b, b_s, *, qk_a, qk_b, out_dtype, activation="none"):
        kw = dict(qk_a=qk_a, qk_b=qk_b)
        got = real(a, a_s, b, b_s, out_dtype=out_dtype, activation=activation, **kw)
        want = quant_systolic_matmul_ref(a, a_s, b, b_s, out_dtype=out_dtype, activation=activation, **kw)
        pre = quant_systolic_matmul_ref(a, a_s, b, b_s, out_dtype=torch.float32, **kw)
        tol = QGEMM_ATOL * (pre.abs().max() + 1.0)
        tol = tol + (QGEMM_RTOL_BF16 if out_dtype == BF16 else 0.0) * want.float().abs()
        worst.append(((got.float() - want.float()).abs() / tol).max().item())
        return got

    with mock.patch.object(mm_kernel, "quant_systolic_matmul_call", call):
        yield

@contextlib.contextmanager
def checked_grouped_calls(worst: list):
    """Hold every grouped kernel call against its plain version on the same
    inputs -- the model's own dispatched tokens -- within phase 2's bf16
    tolerance, recording each call's largest error as a share of it."""
    real = grouped_kernel.grouped_matmul_call
    atol, rtol = GEMM_TOL_BF16

    def call(x, w, rows=None):
        got = real(x, w, rows)
        want = grouped_matmul_ref(x, w)  # every row, as the reference computes them
        worst.append(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max().item())
        return got

    with mock.patch.object(grouped_kernel, "grouped_matmul_call", call):
        yield


@contextlib.contextmanager
def topk_choices(record: list, replay: bool = False):
    """Record each MoE layer's top-k experts in call order; or, with
    ``replay``, route each layer to the recorded experts instead, weighting
    them by this run's own router probabilities (the run then dispatches
    and drops exactly as the recorded one did)."""
    real = moe._topk_shardable
    recorded = iter(record)

    def topk(probs, k):
        if replay:
            e = next(recorded)
            return probs.gather(-1, e), e
        w, e = real(probs, k)
        record.append(e.clone())
        return w, e

    with mock.patch.object(moe, "_topk_shardable", topk):
        yield


@contextlib.contextmanager
def recorded_routing(record: list):
    """Record each MoE layer's routing, in call order: the (token, choice)
    experts (G, T, k), which of those slots were dropped past capacity, and
    each expert's rows that hold a token (G, E), as the grouped kernel gets them."""
    real = moe._dispatch_group

    def dispatch(xf, top_e, top_w, cap, cfg):
        out = real(xf, top_e, top_w, cap, cfg)
        _, _, pos, order, _, rows = out
        dropped = torch.zeros_like(pos, dtype=torch.bool).scatter_(-1, order, pos >= cap)
        record.append((top_e.clone(), dropped.reshape(top_e.shape), rows.clone()))
        return out

    with mock.patch.object(moe, "_dispatch_group", dispatch):
        yield


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def close(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> tuple[bool, float, float]:
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((d <= atol + rtol * w).all())
    return ok, d.max().item(), (d / w.clamp_min(1e-6)).max().item()


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


# ---------------------------------------------------------------------------
# Phase 1: device and build
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("[1] device (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader):")
    say(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say(f"    device {name} sm_{cap[0]}{cap[1]} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, this card is sm_{cap[0]}{cap[1]}")
    secs = _build.build_all()
    say(f"    kernel build: {secs:.1f} s (nvcc {_build.nvcc_path()}, one process per source)")
    for src, log in sorted(_build.build_log().items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                say(f"    ptxas {src}: {line.split(':', 1)[-1].strip()}")
    return {"nvidia_smi": smi, "name": name, "build_s": secs, "torch": torch.__version__}


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_gemm(m, k, n, dtype, gen, *, bias=False, act="none", out_dtype=None) -> float:
    a, b = randn((m, k), gen, dtype), randn((k, n), gen, dtype)
    bv = randn((n,), gen, torch.float32) if bias else None
    before = collections.Counter(mm_kernel.launches_by_path)
    got = mm_ops.matmul(a, b, bv, activation=act, out_dtype=out_dtype)
    path = next(iter(mm_kernel.launches_by_path - before))
    want = matmul_ref(a, b, bv, activation=act, out_dtype=out_dtype)
    atol, rtol = GEMM_TOL_BF16 if dtype == BF16 else (1e-5 * math.sqrt(k), GEMM_RTOL_FP32)
    ok, err, rel = close(got, want, atol, rtol)
    expect(ok, f"gemm {str(dtype)[6:]:8s} M={m:<5d} K={k:<5d} N={n:<5d} bias={bias!s:5s} act={act:5s} "
               f"{path:13s} max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.0e})")
    return err


def flash_operand(b, s, h, d, dtype, gen, layout):
    """A (B, H, S, D) operand: contiguous ("bhsd"), the transposed view of a
    (B, S, H, D) tensor ("bshd", as the models hold q, k and v), or that of
    every other head of a wider one ("sliced": uneven head and row strides)."""
    if layout == "bhsd":
        return randn((b, h, s, d), gen, dtype)
    if layout == "bshd":
        return randn((b, s, h, d), gen, dtype).transpose(1, 2)
    return randn((b, s, 2 * h, d), gen, dtype)[:, :, ::2].transpose(1, 2)


def check_flash(b, h, s, d, dtype, gen, *, hkv=None, window=None, causal=True, kv_valid=None, skv=None,
                layout="bshd") -> float:
    """Flash attention, K/V at ``hkv`` heads (default ``h``), against its
    plain version (K/V repeated to the query heads) on the same operands."""
    hkv, skv = hkv or h, skv or s
    q = flash_operand(b, s, h, d, dtype, gen, layout)
    k, v = (flash_operand(b, skv, hkv, d, dtype, gen, layout) for _ in range(2))
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
    kw = dict(scale=d**-0.5, causal=causal, window=window, kv_valid=skv if kv_valid is None else kv_valid)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)
    tol = ATTN_TOL[dtype]
    ok, err, rel = close(got, want, tol, tol)
    expect(ok, f"flash {str(dtype)[6:]:8s} B={b} H={h}/{hkv} Sq={s} Skv={skv} D={d} {layout} causal={causal} "
               f"window={window} kv_valid={kv_valid} max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.0e})")
    return err


def check_qgemm(m, k, n, qd, gen, *, qk=(128, 128), act="none", out_dtype=BF16) -> float:
    """The block-scaled kernel against its plain version on one quantized
    pair, the weight K-major as the served w8a8 weights are."""
    qa = quant.quantize(randn((m, k), gen, torch.float32), qd, block=(1, qk[0]))
    qb = quant.quantize(randn((k, n), gen, torch.float32), qd, block=(qk[1], 1))
    qbk = quant.k_major({"w": qb})["w"]
    before = collections.Counter(mm_kernel.quant_launches_by_path)
    got = mm_ops.quant_matmul(qa, qbk, out_dtype=out_dtype, activation=act)
    path = next(iter(mm_kernel.quant_launches_by_path - before))
    want = quant_matmul_ref(qa, qb, activation=act, out_dtype=out_dtype)
    pre = quant_matmul_ref(qa, qb, out_dtype=torch.float32)
    atol = QGEMM_ATOL * (pre.abs().max().item() + 1.0)
    rtol = QGEMM_RTOL_BF16 if out_dtype == BF16 else 0.0
    ok, err, rel = close(got, want, atol, rtol)
    expect(ok and got.dtype == out_dtype,
           f"qgemm {qd:4s} M={m:<5d} K={k:<5d} N={n:<5d} qk={qk!s:9s} act={act:5s} out={str(out_dtype)[6:]:8s} "
           f"{path:6s} max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
    return err


def rows_pattern(name: str, e: int, c: int, gen) -> list | None:
    """Rows that can hold a token, per expert: None (the kernel computes all
    C), "empty" (0), "partial" (random counts in [0, C]), "full" (C), or
    "decode" (a batch-4 top-8 decode step: 32 slots on random experts)."""
    if name == "none":
        return None
    if name == "decode":
        picks = torch.randint(0, e, (BATCH * 8,), generator=gen, device="cuda")
        return torch.bincount(picks, minlength=e).clamp(max=c).tolist()
    if name == "partial":
        return torch.randint(0, c + 1, (e,), generator=gen, device="cuda").tolist()
    return [0 if name == "empty" else c] * e


def check_grouped(e, c, k, n, dtype, gen, rows: str = "none") -> float:
    """The grouped expert GEMM against its plain version (output in the
    operands' dtype), with the rows of a ``rows_pattern`` (x zero past each
    expert's count, as the dispatch leaves it)."""
    x, w = randn((e, c, k), gen, dtype), randn((e, k, n), gen, dtype)
    counts = rows_pattern(rows, e, c, gen)
    r = None
    if counts is not None:
        r = torch.tensor(counts, dtype=torch.int32, device="cuda")
        x = x * (torch.arange(c, device="cuda")[None, :, None] < r[:, None, None]).to(dtype)
    before = collections.Counter(grouped_kernel.launches_by_path)
    got = grouped_ops.grouped_matmul(x, w, rows=r)
    path = next(iter(grouped_kernel.launches_by_path - before))
    want = grouped_matmul_ref(x, w)
    atol, rtol = GEMM_TOL_BF16 if dtype == BF16 else (1e-5 * math.sqrt(k), GEMM_RTOL_FP32)
    ok, err, rel = close(got, want, atol, rtol)
    same = "" if r is None else (" bits = all rows" if torch.equal(got, grouped_ops.grouped_matmul(x, w))
                                 else " BITS DIFFER from all rows")
    expect(ok and tuple(got.shape) == (e, c, n) and got.dtype == dtype and "DIFFER" not in same,
           f"grouped {str(dtype)[6:]:8s} E={e:<4d} C={c:<4d} K={k:<5d} N={n:<5d} rows={rows:7s} {path:13s} "
           f"max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.0e}){same}")
    return err


def continuous_trace(cfg) -> list[dict]:
    """The continuous path's request trace, on the card."""
    return make_request_trace(cfg, device="cuda", **CONT_TRACE)


def phase_kernels() -> dict:
    say("[2] kernels against their plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mm_err = 0.0
    for arch in (ARCH, MOE_ARCH):
        cfg = configs.get_config(arch)
        for m in (4, BATCH * PROMPT):
            for k, n in projections(cfg):
                mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen, out_dtype=gemm_out_dtype(cfg, k, n)))
    # The continuous path's GEMMs: the decode step over the slots, and each
    # request's batch-1 prefill at its prompt length.
    cfg = configs.get_config(ARCH)
    cont_lens = sorted({t["prompt"]["tokens"].shape[1] for t in continuous_trace(cfg)})
    for m in (CONT_SLOTS, *cont_lens):
        for k, n in projections(cfg):
            mm_err = max(mm_err, check_gemm(m, k, n, BF16, gen))
    for m, n, k in ((33, 257, 129), (100, 130, 70)):
        for dt in (torch.float32, BF16):
            check_gemm(m, k, n, dt, gen)
    check_gemm(1, 1000, 300, BF16, gen)  # decode tile, K split across blocks, ragged N and K
    for act in ACTIVATIONS:
        check_gemm(64, 96, 160, torch.float32, gen, bias=True, act=act)
        check_gemm(4, 1000, 300, BF16, gen, bias=True, act=act)  # epilogue after the split-K sum
        check_gemm(100, 130, 70, BF16, gen, bias=True, act=act, out_dtype=torch.float32)
    check_gemm(BATCH * PROMPT, 2048, 8192, BF16, gen, bias=True)  # the shape K2 is timed at
    # Ragged M, N and K (multiples of 8) that TMA zero-fills, on each wgmma
    # tile the path rule picks (128x256, 128x128, 64x128), every epilogue.
    for m, n, k in ((2000, 8184, 2040), (1000, 2040, 1000), (300, 264, 200), (17, 8, 8)):
        for act in ACTIVATIONS:
            check_gemm(m, k, n, BF16, gen, bias=True, act=act, out_dtype=torch.float32 if act == "gelu" else None)
    q_err = 0.0
    for qd in quant.QDTYPES:
        for m in (4, BATCH * PROMPT):
            for k, n in projections(configs.get_config(ARCH)):
                err = check_qgemm(m, k, n, qd, gen)
                q_err = max(q_err, err) if qd == "int8" else q_err  # the main path's dtype
        # Ragged: the WMMA tiles (K off the 16 grid, N off the 8 grid, the
        # decode tile) and the wgmma tile (K a multiple of 16, N of 8).
        for m, k, n in ((72, 100, 130), (300, 515, 257), (1, 300, 1000), (9, 70, 4000),
                        (300, 528, 264), (2000, 2064, 1032), (17, 16, 8)):
            check_qgemm(m, k, n, qd, gen, out_dtype=torch.float32)
        for qk in ((64, 64), (32, 32), (0, 0), (128, 64), (32, 0), (48, 32), (256, 256)):
            check_qgemm(4, 1000, 300, qd, gen, qk=qk, out_dtype=torch.float32)  # split-K, partial last block
            check_qgemm(100, 520, 130, qd, gen, qk=qk, out_dtype=torch.float32)
            check_qgemm(100, 528, 136, qd, gen, qk=qk, out_dtype=torch.float32)  # int8 whole-K: the wgmma tile
        for act in ACTIVATIONS:
            check_qgemm(4, 1000, 300, qd, gen, act=act)
            check_qgemm(100, 520, 130, qd, gen, act=act, out_dtype=torch.float32)
            check_qgemm(300, 528, 264, qd, gen, act=act)
            check_qgemm(300, 528, 264, qd, gen, act=act, out_dtype=torch.float32)
    attn_err = 0.0
    for arch in (ARCH, MOE_ARCH):  # each model's heads, in its own (B, S, H, D) layout
        cfg = configs.get_config(arch)
        for s, window in ((PROMPT, None), (PROMPT, 128), (500, None)):
            attn_err = max(attn_err, check_flash(BATCH, cfg.n_heads, s, cfg.resolved_head_dim, BF16, gen,
                                                 hkv=cfg.n_kv_heads, window=window))
    cfg = configs.get_config(ARCH)
    for s in cont_lens:  # the continuous path's batch-1 prefills
        attn_err = max(attn_err, check_flash(1, cfg.n_heads, s, cfg.resolved_head_dim, BF16, gen, hkv=cfg.n_kv_heads))
    for d in (16, 64, 120, 128):  # head dims of the zoo (120: h2o-danube3; 16 and 64: SMOKE configs)
        for hkv in (8, 4, 1):  # 1, 2 and 8 query heads per KV head
            for layout in ("bshd", "bhsd", "sliced"):
                check_flash(2, 8, 200, d, BF16, gen, hkv=hkv, layout=layout)
            check_flash(2, 8, 190, d, BF16, gen, hkv=hkv, window=64, kv_valid=150)
            check_flash(2, 8, 100, d, BF16, gen, hkv=hkv, causal=False, kv_valid=70)
            check_flash(2, 8, 130, d, torch.float32, gen, hkv=hkv, window=32, skv=230, layout="sliced")
    g_err = 0.0
    moe_cfg = configs.get_config(MOE_ARCH)
    e_moe = moe_cfg.moe.n_experts
    for t in (BATCH * PROMPT, BATCH):  # prefill and decode capacity: 160 and 8 rows per expert
        c = moe.capacity(t, moe_cfg)
        for k, n in expert_gemms(moe_cfg):
            for rows in ("none", "full", "partial", "empty", "decode"):
                g_err = max(g_err, check_grouped(e_moe, c, k, n, BF16, gen, rows))
    for c in (100, 200):  # the 128-row wgmma tile, one and two row tiles per expert
        for k, n in expert_gemms(moe_cfg):
            for rows in ("none", "partial", "decode"):
                check_grouped(16, c, k, n, BF16, gen, rows)
    for c in (100, 160, 200):  # K and N not multiples of 64, multiples of 8 (TMA zero-fills)
        for rows in ("none", "empty", "partial", "full"):
            check_grouped(5, c, 200, 136, BF16, gen, rows)
    for c in (1, 13, 100):  # ragged C (the decode and WMMA tiles), K and N
        check_grouped(4, c, 70, 130, BF16, gen)
        check_grouped(4, c, 70, 130, BF16, gen, "partial")
        check_grouped(4, c, 70, 130, torch.float32, gen)
        check_grouped(4, c, 70, 130, torch.float32, gen, "partial")
    check_grouped(1, 160, 2048, 768, BF16, gen)  # one expert
    check_grouped(1, 8, 768, 2048, torch.float32, gen)
    torch.cuda.synchronize()
    return {"systolic_mmm": mm_err, "systolic_qmm": q_err, "flash_attn": attn_err, "grouped_mmm": g_err}


# ---------------------------------------------------------------------------
# Phase 3: serve full-width internlm2-1.8b
# ---------------------------------------------------------------------------


def launches_at(cfg, gemm: str, tokens: int, steps: int, prefill: bool) -> tuple[dict, dict]:
    """(launches per kernel, launches per kernel and shape) that ``steps``
    forward passes over ``tokens`` rows (M) must make, each a prefill or a
    decode step: every projection on ``gemm`` ("systolic_mmm" or
    "systolic_qmm"), every expert GEMM on the grouped kernel at the dispatch
    capacity, flash attention once per layer in prefill only."""
    n_layers = cfg.n_layers
    shapes = {"systolic_mmm": {}, "systolic_qmm": {}, "grouped_mmm": {}}
    shapes[gemm] = {(tokens, k, n): mult * n_layers * steps for (k, n), mult in projections(cfg).items()}
    if cfg.moe is not None:
        g = cfg.moe.dispatch_groups
        rows = g * moe.capacity(tokens // g, cfg)  # the groups fold into one launch
        shapes["grouped_mmm"] = {(cfg.moe.n_experts, rows, k, n): mult * n_layers * steps
                                 for (k, n), mult in expert_gemms(cfg).items()}
    total = {name: sum(by.values()) for name, by in shapes.items()}
    total["flash_attn"] = n_layers * steps if prefill else 0
    return total, shapes


def expected_launches(cfg, gemm: str, prefill: bool) -> tuple[dict, dict]:
    """``launches_at`` for a synchronized prefill (BATCH x PROMPT rows) or
    its GEN - 1 decode steps (BATCH rows)."""
    if prefill:
        return launches_at(cfg, gemm, BATCH * PROMPT, 1, True)
    return launches_at(cfg, gemm, BATCH, GEN - 1, False)


def expected_routes(cfg, shapes: dict, prefills: int) -> dict:
    """Each GEMM's launches by path that the shapes ``shapes`` (from
    launches_at) must make with operands the model hands over aligned, int8
    weights K-major and 128-k scale blocks (every launch at M > 16 on a
    wgmma tile, every one at M <= 16 on the decode tile), and flash
    attention's by the model's (H, Hkv), once per layer in each of
    ``prefills`` prefills."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mm, qmm, grouped = collections.Counter(), collections.Counter(), collections.Counter()
    for (m, k, n), c in shapes["systolic_mmm"].items():
        mm[mm_kernel.gemm_path(m, n, k, BF16, True, sms)] += c
    for (m, k, n), c in shapes["systolic_qmm"].items():
        qmm[mm_kernel.qgemm_path(m, n, k, quant.DEFAULT_BLOCK_K, torch.int8, True)] += c
    for (e, rows, k, n), c in shapes["grouped_mmm"].items():
        grouped[grouped_kernel.grouped_path(rows, k, n, BF16, True)] += c
    return {"systolic_mmm_paths": dict(mm), "systolic_qmm_paths": dict(qmm), "grouped_mmm_paths": dict(grouped),
            "flash_attn_heads": {(cfg.n_heads, cfg.n_kv_heads): cfg.n_layers * prefills} if prefills else {}}


def serve_path(label: str, model, params, want: dict, batch, feed=None) -> dict:
    """Serve one synchronized batch through ServeEngine on the kernels, with
    the counts set to 0 just before prefill and decode and read just after;
    then hold the kernel path's prefill logits and two decode steps from one
    cache against the plain path, and a second kernel-path prefill against
    the first, bit for bit.  ``want``: the kernel that the projections must
    hit ("systolic_mmm" or "systolic_qmm") and the logits tolerance.
    ``feed``: the tokens to feed the two decode steps (default: the kernel
    path's own greedy tokens)."""
    cfg = model.cfg
    engine = ServeEngine(model, params, ServeConfig(max_len=PROMPT + GEN, batch=BATCH), device="cuda")
    engine.generate(batch, 2)  # warm-up: library handles, first launches (not counted)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    first = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pf_counts, pf_shapes, pf_routes = counts(), shape_counts(), route_counts()
    reset_counts()
    t0 = time.perf_counter()
    rest = engine.decode(first, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    dec_counts, dec_shapes, dec_routes = counts(), shape_counts(), route_counts()
    tokens = torch.cat([first, rest], dim=1)
    say(f"    {label}: prefill {t_prefill * 1e3:.3f} ms; decode {t_decode / (GEN - 1) * 1e3:.3f} ms/step, "
        f"{BATCH * (GEN - 1) / t_decode:.1f} tok/s over {GEN - 1} steps")
    want_pf, want_pf_shapes = expected_launches(cfg, want["gemm"], prefill=True)
    want_dec, want_dec_shapes = expected_launches(cfg, want["gemm"], prefill=False)
    expect(pf_counts == want_pf, f"{label} prefill launches: {pf_counts}, want {want_pf}")
    expect(dec_counts == want_dec, f"{label} decode launches over {GEN - 1} steps: {dec_counts}, want {want_dec}")
    expect(tuple(tokens.shape) == (BATCH, GEN) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
           f"{label} tokens {tuple(tokens.shape)} in [0, {cfg.vocab_size}): {tokens[0, :12].tolist()}")
    # Per-shape counts, from the launch site: the timing phase weights each
    # shape's time by these, so they must be the model's own GEMMs.
    for name, by in pf_shapes.items():
        expect(by == want_pf_shapes[name], f"{label} prefill {name} launches by shape: {sorted(by.items())}")
        expect(dec_shapes[name] == want_dec_shapes[name],
               f"{label} decode {name} launches by shape: {sorted(dec_shapes[name].items())}")
    # Routes: each GEMM's path of every launch (a prefill operand off TMA's
    # alignment would land on a WMMA tile),
    # flash's K/V heads.
    for name in ("systolic_mmm", "systolic_qmm", "grouped_mmm"):
        pf_paths = pf_routes[f"{name}_paths"]
        if pf_counts[name]:
            expect(all(p.startswith("wgmma") for p in pf_paths) and sum(pf_paths.values()) == pf_counts[name],
                   f"{label} prefill: all {pf_counts[name]} {name} launches on a wgmma tile: {pf_paths}")
    for phase, got_r, want_r in (("prefill", pf_routes, expected_routes(cfg, want_pf_shapes, 1)),
                                 ("decode", dec_routes, expected_routes(cfg, want_dec_shapes, 0))):
        for key in got_r:
            expect(got_r[key] == want_r[key], f"{label} {phase} {key}: {got_r[key]}, want {want_r[key]}")

    logits = []  # the kernel path's prefill and two decode-step logits
    # w8a8: each GEMM's int8 activations on the kernel path, the plain path's
    # differences from them, and each kernel call against its plain version.
    # MoE: each grouped call against its plain version, and each layer's
    # routing on both paths.
    acts_k, flips, in_model, routing_k, routing_p, choices = [], [], [], [], [], []
    quantized = want["gemm"] == "systolic_qmm"
    is_moe = cfg.moe is not None
    with torch.no_grad():
        reset_counts()
        with contextlib.ExitStack() as stack:
            if quantized:
                stack.enter_context(quantized_activations(acts_k))
                stack.enter_context(checked_quant_calls(in_model))
            if is_moe:
                stack.enter_context(checked_grouped_calls(in_model))
                stack.enter_context(recorded_routing(routing_k))
                stack.enter_context(topk_choices(choices))
            got, cache_k = model.prefill(params, batch, max_len=PROMPT + GEN)
        again, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        expect(torch.equal(got, again), f"{label} two kernel-path prefills give bit-identical logits")
        del again
        kernel_counts = counts()
        if quantized or is_moe:
            n_calls = sum(want_pf_shapes["grouped_mmm" if is_moe else "systolic_qmm"].values())
            expect(len(in_model) == n_calls and max(in_model) <= 1.0,
                   f"{label} prefill: each of the {len(in_model)} {'grouped' if is_moe else 'block-scaled'} kernel "
                   f"calls against its plain version on the model's own inputs: worst error "
                   f"{max(in_model):.3f} of the tolerance")
        with contextlib.ExitStack() as stack:
            stack.enter_context(plain_versions())
            if quantized:
                stack.enter_context(quantized_activations(flips, acts_k))
            if is_moe:
                stack.enter_context(recorded_routing(routing_p))
            want_l, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        plain_counts = {k: c - kernel_counts[k] for k, c in counts().items()}
        expect(not any(plain_counts.values()), f"{label} plain-path prefill launched no kernel ({plain_counts})")
        err, scale = compare_logits(f"{label} prefill", got, want_l, want["tol"])
        if quantized:
            flips = activation_flips(label, flips, cfg.n_layers)
        routing = routing_witness(label, routing_k, routing_p) if is_moe else None
        # MoE: each layer's rows per expert (G = 1), for phase 4's timing at the model's routing.
        prefill_rows = [r[2][0].tolist() for r in routing_k]
        alike = []  # MoE: the gaps with the plain path routed as the kernel path
        if is_moe:
            with plain_versions(), topk_choices(choices, replay=True):
                want_r, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
            alike.append(compare_logits(f"{label} prefill, plain path routed as the kernel path", got, want_r,
                                        LOGITS_TOL_BF16)[0])
        del acts_k, routing_k, routing_p, choices
        logits.append(got)
        # Two decode steps from one cache: the kernel path's primed cache, and
        # a copy of it for the plain path (and, MoE, another for the plain
        # path routed as the kernel path); all are fed the same tokens.
        cache_p = _tree(torch.clone, cache_k)
        cache_r = _tree(torch.clone, cache_k) if is_moe else None
        tok, dec_err, fed, routing_dec = got.argmax(-1).to(torch.int32), 0.0, [], []
        for step in range(2):
            tok = tok if feed is None else feed[step]
            fed.append(tok)
            choices = []
            with contextlib.ExitStack() as stack:
                if is_moe:
                    stack.enter_context(topk_choices(choices))
                    if step == 0:
                        stack.enter_context(recorded_routing(routing_dec))
                lk, cache_k = model.decode_step(params, tok, cache=cache_k, pos=PROMPT + step)
            n0 = counts()
            with plain_versions():
                lp, cache_p = model.decode_step(params, tok, cache=cache_p, pos=PROMPT + step)
                if is_moe:
                    with topk_choices(choices, replay=True):
                        lr, cache_r = model.decode_step(params, tok, cache=cache_r, pos=PROMPT + step)
                    alike.append(compare_logits(f"{label} decode step {step}, plain path routed as the kernel path",
                                                lk, lr, LOGITS_TOL_BF16)[0])
            expect(counts() == n0, f"{label} plain-path decode step {step} launched no kernel")
            dec_err = max(dec_err, compare_logits(f"{label} decode step {step}", lk, lp, want["tol"])[0])
            logits.append(lk)
            tok = lk.argmax(-1).to(torch.int32)
    del engine, cache_k, cache_p, cache_r

    def listed(shapes):  # {kernel: [[*shape, launches], ...]}
        return {name: [[*key, c] for key, c in sorted(by.items())] for name, by in shapes.items() if by}

    return {
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_step": t_decode / (GEN - 1) * 1e3,
        "decode_tok_s": BATCH * (GEN - 1) / t_decode,
        "prefill_launches": pf_counts,
        "decode_launches": dec_counts,
        "prefill_shapes": listed(pf_shapes),
        "decode_shapes": listed(dec_shapes),
        "prefill_routes": {k: {str(kk): c for kk, c in v.items()} for k, v in pf_routes.items()},
        "decode_routes": {k: {str(kk): c for kk, c in v.items()} for k, v in dec_routes.items()},
        "logits_max_abs_err": err,
        "logits_scale": scale,
        "prefill_activation_flips": flips,
        "prefill_routing": routing,
        "routed_alike_max_abs_err": alike,  # MoE: prefill, decode step 0, decode step 1
        "prefill_kernel_calls_worst_share_of_tol": max(in_model) if in_model else None,
        "prefill_rows": prefill_rows,  # MoE: rows per expert by layer, prefill and decode step 0
        "decode_rows": [r[2][0].tolist() for r in routing_dec],
        "decode_logits_max_abs_err": dec_err,
        "logits": logits,
        "fed": fed,
    }


def routing_witness(label: str, kernel: list, plain: list) -> dict:
    """By layer, the (token, choice) expert assignments in which the plain
    path's prefill differs from the kernel path's, the tokens whose set of
    experts differs, and the slots dropped past capacity on each path and on
    one path only.  Layer 0 routes the same normed embedding after one
    attention block on both paths, so any difference there comes from the
    attention and projection kernels' rounding."""
    expect(len(kernel) == len(plain), f"{label} prefill routed {len(kernel)} layers on the kernel path, "
                                      f"{len(plain)} on the plain path")
    rows = []
    for (ek, dk, _), (ep, dp, _) in zip(kernel, plain):
        sets_differ = (ek.sort(dim=-1).values != ep.sort(dim=-1).values).any(dim=-1)
        rows.append({"assignments_differ": int((ek != ep).sum()), "tokens_other_experts": int(sets_differ.sum()),
                     "dropped_kernel": int(dk.sum()), "dropped_plain": int(dp.sum()),
                     "drops_differ": int((dk != dp).sum())})
    n = kernel[0][0].numel() if kernel else 0
    say(f"    {label} prefill routing, plain vs kernel path, by layer ((token, choice) assignments that differ of "
        f"{n}): {' '.join(str(r['assignments_differ']) for r in rows)}")
    say(f"    ... tokens routed to another set of experts: {' '.join(str(r['tokens_other_experts']) for r in rows)}")
    say(f"    ... slots dropped past capacity (kernel path): {' '.join(str(r['dropped_kernel']) for r in rows)}; "
        f"dropped on one path only: {' '.join(str(r['drops_differ']) for r in rows)}")
    return {"slots_per_layer": n, "by_layer": rows}


def continuous_expected(cfg, prompt_lens: list, decode_steps: int) -> tuple[dict, dict, dict, dict]:
    """(launches per kernel, per kernel and shape, by route, flash launches by
    (B, Sq, Skv)) that a continuous run must make: a batch-1 prefill per
    request at M = its prompt length, one more per distinct prompt length in
    warmup, and ``decode_steps`` + 1 (warmup's all-empty step) decode steps
    at M = the slot count."""
    prefills = collections.Counter(prompt_lens) + collections.Counter(set(prompt_lens))
    runs = [launches_at(cfg, "systolic_mmm", m, c, True) for m, c in prefills.items()]
    runs.append(launches_at(cfg, "systolic_mmm", CONT_SLOTS, decode_steps + 1, False))
    total, shapes = collections.Counter(), {"systolic_mmm": {}, "systolic_qmm": {}, "grouped_mmm": {}}
    for t, by in runs:
        total.update(t)
        for name, sh in by.items():
            for key, c in sh.items():
                shapes[name][key] = shapes[name].get(key, 0) + c
    total = {name: total[name] for name in KERNELS}
    flash = {(1, m, m): cfg.n_layers * c for m, c in prefills.items()}
    return total, shapes, expected_routes(cfg, shapes, sum(prefills.values())), flash


def phase_continuous(model, params, smi: str) -> dict:
    """Serve the continuous trace through ContinuousScheduler with the counts
    set to 0 just before the run and read just after; check the lifecycle
    and the launches; then replay each request alone at batch 1 (prefill,
    then decode with the scheduler's tokens fed back) and hold the
    scheduler's prefill and decode-step logits against the replay's.  The
    model's prefill and decode_step are wrapped here, in the script, to
    record what the scheduler's engine computed."""
    cfg = model.cfg
    trace = continuous_trace(cfg)
    lens = [t["prompt"]["tokens"].shape[1] for t in trace]
    gens = [t["max_new_tokens"] for t in trace]
    max_len = max(p + g for p, g in zip(lens, gens))
    say(f"[3] continuous serving of {ARCH} bf16: {len(trace)} requests arriving over "
        f"{trace[-1]['arrival']:.1f} ticks, prompts {min(lens)}-{max(lens)} (mean {sum(lens) / len(lens):.1f}), "
        f"generations {min(gens)}-{max(gens)} (mean {sum(gens) / len(gens):.1f}), {CONT_SLOTS} slots, max_len {max_len}")
    rid_of = {id(t["prompt"]): t["rid"] for t in trace}
    first_logits, steps, sched = {}, [], None

    def prefill(p, batch, max_len):
        logits, cache = model.prefill(p, batch, max_len=max_len)
        if id(batch) in rid_of:  # warmup's call comes first; the admission's overwrites it
            first_logits[rid_of[id(batch)]] = logits.clone()
        return logits, cache

    def decode_step(p, tok, cache, pos):
        logits, cache = model.decode_step(p, tok, cache=cache, pos=pos)
        rids = {slot: r.rid for slot, r in sched._slot_req.items()}
        if rids:  # warmup's all-empty step serves no request
            steps.append((sched.pool.positions.copy(), logits.clone(), rids))  # the host's copy of pos
        return logits, cache

    recorded = dataclasses.replace(model, prefill=prefill, decode_step=decode_step)
    engine = ServeEngine(recorded, params, ServeConfig(max_len=max_len, batch=CONT_SLOTS), device="cuda")
    sched = ContinuousScheduler(engine, policy="continuous")
    reqs = requests_from_trace(trace)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, got_shapes, got_routes, got_flash = counts(), shape_counts(), route_counts(), flash_shape_counts()
    st = sched.stats.summary()

    # Lifecycle.
    expect(all(r.state == FINISHED and len(results[r.rid]) == r.max_new_tokens for r in reqs),
           f"continuous: all {len(reqs)} requests finished with exactly max_new_tokens tokens "
           f"({st['tokens_out']} tokens, want {sum(gens)})")
    expect(sched.pool.n_free == CONT_SLOTS and (sched.pool.positions == -1).all(),
           f"continuous: the pool drained ({sched.pool.n_free} of {CONT_SLOTS} slots free)")
    rids_by_slot = collections.defaultdict(set)
    for _, _, rids in steps:
        for slot, rid in rids.items():
            rids_by_slot[slot].add(rid)
    admitted = int(sched.stats.registry.counter_value("sched.admitted"))
    reused = sum(len(v) > 1 for v in rids_by_slot.values())
    expect(admitted == len(reqs) > CONT_SLOTS and reused > 0,
           f"continuous: {admitted} admissions into {CONT_SLOTS} slots, {reused} slots served more than one request")
    ragged = sum(len({int(pos[s]) for s in rids}) > 1 for pos, _, rids in steps)
    expect(ragged > 0, f"continuous: {ragged} of {len(steps)} decode ticks decoded slots at different positions")

    # Launches: exact per kernel, GEMM shape and path, flash shape and heads.
    want, want_shapes, want_routes, want_flash = continuous_expected(cfg, lens, st["decode_steps"])
    expect(got == want, f"continuous launches (warmup included): {got}, want {want}")
    for name, by in got_shapes.items():
        expect(by == want_shapes[name], f"continuous {name} launches by shape: {len(by)} shapes, "
                                        f"{sum(by.values())} launches" + ("" if by == want_shapes[name] else
                                                                          f": {sorted(by.items())}"))
    for key in got_routes:
        expect(got_routes[key] == want_routes[key], f"continuous {key}: {got_routes[key]}, want {want_routes[key]}")
    expect(got_flash == want_flash, f"continuous flash_attn launches by (B, Sq, Skv): {len(got_flash)} shapes, "
                                    f"{sum(got_flash.values())} launches")

    # Each request alone at batch 1, the scheduler's tokens fed back.
    pf_err, dec_err, same, rows_seen = 0.0, 0.0, 0, 0
    with torch.no_grad():
        for t, r in zip(trace, reqs):
            out, p = results[r.rid], lens[r.rid]
            rows = {int(pos[s]): logits[s:s + 1] for pos, logits, rids in steps for s, rid in rids.items()
                    if rid == r.rid}
            alone, cache = model.prefill(params, t["prompt"], max_len=max_len)
            errs = [(alone - first_logits[r.rid]).abs().max().item() / max(1.0, alone.abs().max().item())]
            argmax = [int(alone.argmax())]
            taken = [int(first_logits[r.rid].argmax())]
            for j in range(len(out) - 1):
                tok = torch.tensor([[int(out[j])]], dtype=torch.int32, device="cuda")
                alone, cache = model.decode_step(params, tok, cache=cache, pos=p + j)
                row = rows[p + j]
                errs.append((alone - row).abs().max().item() / max(1.0, alone.abs().max().item()))
                argmax.append(int(alone.argmax()))
                taken.append(int(row.argmax()))
            rows_seen += len(rows)
            pf_err, dec_err = max(pf_err, errs[0]), max([dec_err, *errs[1:]])
            same += argmax == [int(x) for x in out]
            expect(len(rows) == len(out) - 1 and taken == [int(x) for x in out] and max(errs) <= LOGITS_TOL_BF16,
                   f"continuous request {r.rid} (prompt {p}, {len(out)} tokens, slot ticks {len(rows)}): logits vs "
                   f"alone at batch 1, largest error {max(errs):.2%} of the largest logit (tol "
                   f"{LOGITS_TOL_BF16:.0%}); its tokens are the argmax of its own logits")
            del cache
    say(f"    continuous vs alone: prefill logits within {pf_err:.2%}, decode-step rows within {dec_err:.2%} of the "
        f"largest logit over {rows_seen} rows; {same} of {len(reqs)} requests' greedy tokens equal their isolated "
        f"generate() exactly (bf16 near-ties may flip; for information only)")
    say(f"    continuous numbers ({smi}): {len(reqs)} requests, {st['ticks']} ticks ({st['idle_ticks']} idle), "
        f"{st['decode_steps']} decode steps, {st['tokens_out']} tokens; {st['tok_per_s']} tok/s; step p50 "
        f"{st['p50_step_ms']} / p99 {st['p99_step_ms']} ms; tick p50 {st['p50_tick_ms']} / p99 {st['p99_tick_ms']} ms; "
        f"TTFT p50 {st['ttft_p50_ms']} / p99 {st['ttft_p99_ms']} ms; mean occupancy {st['mean_occupancy']}; "
        f"kv_bytes_resident {st['kv_bytes_resident']}; prefill {st['prefill_s']} s + decode {st['decode_s']} s; "
        f"run wall {st['run_wall_s']} s ({wall:.3f} s with warmup)")
    del engine, sched, steps, first_logits

    def listed(shapes):  # {kernel: [[*shape, launches], ...]}
        return {name: [[*key, c] for key, c in sorted(by.items())] for name, by in shapes.items() if by}

    return {"summary": st, "wall_s_with_warmup": wall, "prompt_lens": lens, "max_new_tokens": gens,
            "launches": got, "shapes": listed(got_shapes),
            "routes": {k: {str(kk): c for kk, c in v.items()} for k, v in got_routes.items()},
            "flash_shapes": [[*key, c] for key, c in sorted(got_flash.items())],
            "prefill_logits_max_share": pf_err, "decode_logits_max_share": dec_err,
            "requests_tokens_equal_alone": same}


def phase_serve(smi: str) -> tuple[dict, dict, dict]:
    """The bf16 model, the same parameters served continuously, then the
    w8a8 model quantized from the same fp32 masters."""
    cfg = configs.get_config(ARCH)
    say(f"[3] serve {ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    t0 = time.perf_counter()
    masters = model.init(SEED, "cuda", dtype=torch.float32)  # the fp32 values both models come from
    params = cast_params(masters, BF16)
    qparams = quant.k_major(cast_params(quant.quantize_params(masters), BF16))  # as launch/serve.py lays them out
    del masters
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q, q_bytes = quant.count_quantized(qparams)
    say(f"    init {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
        f"w8a8: {n_q} projection weights -> int8 ({q_bytes / 1e6:.1f} MB resident values)")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    bf16 = serve_path("bf16", model, params, {"gemm": "systolic_mmm", "tol": LOGITS_TOL_BF16}, batch)
    cont = phase_continuous(model, params, smi)
    with quant.use_act_quant("int8"):
        w8a8 = serve_path("w8a8", model, qparams, {"gemm": "systolic_qmm", "tol": LOGITS_TOL_W8A8}, batch,
                          feed=bf16["fed"])
    w8a8["rounding_sensitivity"] = rounding_sensitivity(
        model, batch, [("bf16", params, contextlib.nullcontext()), ("w8a8", qparams, quant.use_act_quant("int8"))]
    )
    # w8a8 against the bf16 model from the same fp32 weights, both on the
    # kernels, prefill and two decode steps fed the same tokens.
    w8a8["vs_bf16_max_abs_err"], w8a8["vs_bf16_bound"] = [], []
    for what, got, want in zip(("prefill", "decode step 0", "decode step 1"), w8a8["logits"], bf16["logits"]):
        err = (got - want).abs().max().item()
        bound = W8A8_VS_BF16_TOL * want.abs().max().item()
        expect(bool(torch.isfinite(got).all()) and err < bound,
               f"w8a8 vs bf16 {what} logits: max_abs={err:.3e} (bound {W8A8_VS_BF16_TOL} x max|logit| = "
               f"{bound:.3e}); greedy tokens agree in {int((got.argmax(-1) == want.argmax(-1)).sum())} of "
               f"{got.shape[0]} rows")
        w8a8["vs_bf16_max_abs_err"].append(err)
        w8a8["vs_bf16_bound"].append(bound)
    for r in (bf16, w8a8):
        del r["logits"], r["fed"]
    del params, qparams, model, batch
    torch.cuda.empty_cache()
    return bf16, w8a8, cont


def phase_serve_moe() -> dict:
    """The MoE model in bf16, built directly in bf16 (fp32 drawn one tensor
    at a time), after the dense models' memory has been given back."""
    cfg = configs.get_config(MOE_ARCH)
    m = cfg.moe
    say(f"[3] serve {MOE_ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"qk_norm={cfg.qk_norm} experts {m.n_experts} top-{m.top_k} d_ff_expert={m.d_ff_expert} "
        f"V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    say(f"    init {time.perf_counter() - t0:.1f} s: {n:,} parameters, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card (peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    qk_scales = 2 * cfg.resolved_head_dim * cfg.n_layers if cfg.qk_norm else 0  # count_params leaves them out
    expect(n == model.n_params + qk_scales,
           f"{MOE_ARCH} parameters {n} = the config's count {model.n_params} + {qk_scales} qk-norm scales")
    want = {"gemm": "systolic_mmm", "tol": LOGITS_TOL_MOE}
    out, seeds = None, {}
    # The model of the main path, then the same checks and witnesses on
    # models and prompts drawn from other seeds (the MoE tolerance rests on
    # the largest readings over all of them).
    for seed in (SEED, *MOE_WITNESS_SEEDS):
        if seed != SEED:
            del params
            torch.cuda.empty_cache()
            params = model.init(seed, "cuda")
        batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=seed, device="cuda")
        label = "moe" if seed == SEED else f"moe seed {seed}"
        r = serve_path(label, model, params, want, batch)
        r["rounding_sensitivity"] = rounding_sensitivity(model, batch, [(label, params, contextlib.nullcontext())],
                                                         nudges=MOE_NUDGES, steps=MOE_NUDGE_STEPS, seed=seed)
        del r["logits"], r["fed"], batch
        seeds[seed] = r
        out = out or r
    out["witness_seeds"] = {seed: {k: r[k] for k in ("logits_max_abs_err", "logits_scale", "decode_logits_max_abs_err",
                                                     "routed_alike_max_abs_err", "rounding_sensitivity")}
                            for seed, r in seeds.items()}
    free = max(max(r["logits_max_abs_err"] / r["logits_scale"], r["decode_logits_max_abs_err"] / r["logits_scale"])
               for r in seeds.values())
    alike = max(max(r["routed_alike_max_abs_err"]) / r["logits_scale"] for r in seeds.values())
    nudge = max(max(v["prefill"], v["decode_step"]) for r in seeds.values() for v in r["rounding_sensitivity"].values())
    say(f"    MoE witness over seeds {[SEED, *MOE_WITNESS_SEEDS]}: kernel vs plain path, largest gap as a share of "
        f"the prefill's largest logit: {free:.2%} routing freely (tol {LOGITS_TOL_MOE:.0%}), {alike:.2%} routed alike "
        f"(tol {LOGITS_TOL_BF16:.0%}); one-ulp nudge of the plain path alone, largest reading {nudge:.2%}")
    out["witness_max"] = {"free": free, "routed_alike": alike, "nudge": nudge}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"    peak device memory over the MoE phase: {out['peak_gb']:.2f} GB")
    del params, model
    torch.cuda.empty_cache()
    return out


def activation_flips(label: str, flips: list, n_layers: int) -> dict:
    """Summarise, by layer, the int8 activation values in which the plain
    path's prefill differs from the kernel path's (seven quantized GEMM
    inputs per layer: q, k, v, o, gate, up, down).  The first layer's q, k
    and v inputs come from the same embedding and norm on both paths, so they
    must agree exactly; every later difference starts from the paths' bf16
    GEMM outputs differing by rounding."""
    expect(len(flips) == 7 * n_layers, f"{label} prefill quantized {len(flips)} GEMM inputs per path, "
                                       f"want {7 * n_layers}")
    by_layer = [flips[7 * i:7 * i + 7] for i in range(n_layers)]
    frac = [sum(f[0] for f in lay) / sum(f[2] for f in lay) for lay in by_layer]
    frac2 = [sum(f[1] for f in lay) / sum(f[2] for f in lay) for lay in by_layer]
    first_qkv = sum(f[0] for f in flips[:3])
    expect(first_qkv == 0, f"{label} prefill: layer 0's q/k/v inputs quantize identically on both paths "
                           f"({first_qkv} values differ)")
    say(f"    {label} prefill int8 activations differing, plain vs kernel path, share by layer: "
        f"{' '.join(f'{x:.2e}' for x in frac)}")
    say(f"    ... by more than one int8 step: {' '.join(f'{x:.2e}' for x in frac2)}; "
        f"largest difference {max(f[3] for f in flips)} steps; layer 0 by GEMM input (q k v o gate up down): "
        f"{' '.join(f'{f[0] / f[2]:.2e}' for f in flips[:7])}")
    return {"share_by_layer": frac, "share_over_one_step_by_layer": frac2, "max_step": max(f[3] for f in flips),
            "layer0_share_by_input": [f[0] / f[2] for f in flips[:7]],
            "differing": sum(f[0] for f in flips), "elements": sum(f[2] for f in flips)}


def rounding_sensitivity(model, batch, variants: list, nudges: int = 1, steps: int = 1, seed: int = SEED) -> dict:
    """How far the plain path alone moves under a rounding-sized change of
    its input: the embedding table nudged up by one bf16 ulp on a random half
    of its elements (``nudges`` draws from ``seed``), prefill logits of each
    nudged against the unchanged model, as a share of the largest logit, for
    each (label, params, activation-quant context) variant in turn; then
    ``steps`` greedy decode steps of the unchanged model from its primed
    cache, each step also run by every nudged model from a copy of the
    unchanged cache (so only that step's own token is nudged).  Read beside
    each model's kernel-vs-plain error."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)

    def share(a, b):
        return (b - a).abs().max().item() / max(1.0, a.abs().max().item())

    out = {}
    with torch.no_grad(), plain_versions():
        for label, p, ctx in variants:
            table = p["embed"]["table"]
            nudged = []
            for _ in range(nudges):
                bump = torch.randint(0, 2, table.shape, generator=gen, device="cuda", dtype=torch.int16)
                nudged.append({**p, "embed": {**p["embed"], "table": (table.view(torch.int16) + bump).view(table.dtype)}})
                del bump
            readings = []  # per nudge: the prefill's share, then each decode step's
            with ctx:
                base, cache = model.prefill(p, batch, max_len=PROMPT + GEN)
                for q in nudged:
                    readings.append([share(base, model.prefill(q, batch, max_len=PROMPT + GEN)[0])])
                tok = base.argmax(-1).to(torch.int32)
                for step in range(steps):
                    moved = [model.decode_step(q, tok, cache=_tree(torch.clone, cache), pos=PROMPT + step)[0]
                             for q in nudged]
                    logits, cache = model.decode_step(p, tok, cache=cache, pos=PROMPT + step)
                    for r, m in zip(readings, moved):
                        r.append(share(logits, m))
                    tok = logits.argmax(-1).to(torch.int32)
            del cache, nudged
            out[label] = {"prefill": max(r[0] for r in readings), "decode_step": max(x for r in readings for x in r[1:]),
                          "readings": readings}
            expect(all(math.isfinite(x) for r in readings for x in r),
                   f"{label} plain path, embedding nudged by one bf16 ulp: logits move by "
                   f"{out[label]['prefill']:.2%} of the largest at prefill, {out[label]['decode_step']:.2%} "
                   f"in a decode step" + (f" (largest of {nudges} nudges x {steps} steps)" if nudges * steps > 1 else ""))
    return out


def compare_logits(what: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """Kernel-path logits (B, 1, V) against the plain path's, within ``tol``
    of the largest; then the greedy tokens.  Random weights leave near-ties among
    the top logits, which bf16 rounding may order either way (one row in four
    flipped in an earlier run), so a row may pick another token than the
    plain path only if that token's plain logit is within twice the row's
    measured error of the plain maximum; any other disagreement fails."""
    d = (got - want).abs()
    err = d.max().item()
    scale = max(1.0, want.abs().max().item())
    expect(bool(torch.isfinite(got).all()) and err <= tol * scale,
           f"{what} logits {tuple(got.shape)}, kernel path vs plain path: max_abs={err:.3e} "
           f"(tol {tol} x {scale:.2f})")
    tk, tp = got.argmax(-1), want.argmax(-1)
    row_err = d.amax(-1)
    gap = want.amax(-1) - want.gather(-1, tk.unsqueeze(-1)).squeeze(-1)
    same = tk == tp
    expect(bool((same | (gap <= 2 * row_err)).all()),
           f"{what} greedy tokens: {int(same.sum())} of {same.numel()} rows identical, the rest "
           f"near-ties (plain-logit gap {[round(g, 4) for g in gap[~same].tolist()]} <= 2 x row error)")
    return err, scale


def phase_small_reference(arch: str) -> None:
    """SMOKE config in fp32: the card (kernels) against the port's CPU path,
    which tests/test_torch_serve.py and tests/test_torch_moe.py hold against
    the JAX package."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    model = get_model(cfg)
    cpu = model.init(SEED, "cpu")
    gpu = _tree(lambda t: t.to("cuda"), cpu)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        eng = ServeEngine(model, params, ServeConfig(max_len=40, batch=2), device=dev)
        b = make_batch(cfg, batch=2, seq=32, kind="prefill", seed=SEED, device=dev)
        with torch.no_grad():
            logits, _ = model.prefill(params, b, max_len=40)
        out[dev] = (logits.cpu(), eng.generate(b, 8).cpu())
    err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    expect(err <= LOGITS_TOL_FP32,
           f"{arch} SMOKE fp32 prefill logits, card vs CPU: max_abs={err:.3e} (tol {LOGITS_TOL_FP32})")
    expect(torch.equal(out["cpu"][1], out["cuda"][1]),
           f"{arch} SMOKE fp32 8 greedy tokens, card vs CPU identical: {out['cuda'][1][0].tolist()}")


# ---------------------------------------------------------------------------
# Phase 4: timing and the kernels line
# ---------------------------------------------------------------------------


def _gemm_cost(m, k, n, out_dtype=BF16):
    """Operations and HBM bytes of one bf16 projection: each input read once,
    the output written once."""
    flops = 2 * m * n * k
    nbytes = (m * k + k * n) * dtype_bytes(BF16) + m * n * dtype_bytes(out_dtype)
    return flops, nbytes


def cycler(items: list):
    """A function returning the next of ``items`` on each call, round robin."""
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(items)
        return items[it[0]]

    return nxt


def time_gemm(m, k, n, gen, out_dtype=BF16, tiles: bool = True) -> dict:
    """Kernel, plain and library times of one bf16 projection.  Weights are
    cycled through enough copies to exceed the 50 MB L2, as the main path
    reads each layer's weights cold.  With ``tiles``, a shape on a wgmma path
    is also timed on each wgmma tile through the C entry (launches that no
    counter sees), for the path rule's record."""
    a = randn((m, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
    iters = 20 if m <= 16 else 10
    lib = (lambda: torch.mm(a, nxt(), out_dtype=torch.float32)) if out_dtype == torch.float32 \
        else (lambda: torch.matmul(a, nxt()))
    t = {
        "kernel": time_ms(lambda: mm_ops.matmul(a, nxt(), out_dtype=out_dtype), iters),
        "plain": time_ms(lambda: matmul_ref(a, nxt(), out_dtype=out_dtype), iters),
        "library": time_ms(lib, iters),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    path = mm_kernel.gemm_path(m, n, k, BF16, True, sms)
    by_path = {}
    if tiles and path.startswith("wgmma"):
        lib_, fn = mm_kernel._entry("systolic_mmm")
        out = torch.empty((m, n), dtype=out_dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def on(tile):
            code = fn(a.data_ptr(), nxt().data_ptr(), None, out.data_ptr(), m, n, k, mm_kernel.DTYPE_CODES[BF16],
                      mm_kernel.DTYPE_CODES[out_dtype], 0, mm_kernel.PATHS.index(tile), None, 0, stream)
            _build.check(lib_, "systolic_mmm launch", code)

        by_path = {tile: time_ms(lambda: on(tile), iters) for tile, _, _ in mm_kernel.WGMMA_TILES}
    flops, nbytes = _gemm_cost(m, k, n, out_dtype)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"m": m, "k": k, "n": n, "out": str(out_dtype)[6:], "path": path, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_s * 1e3, "bound_by": bound_by, "ms_by_path": by_path}


def _grouped_cost(k, n, c, rows):
    """Operations and HBM bytes one expert GEMM must move with each expert's
    rows that hold a token (``rows``, one count per expert): the weights of
    the experts that hold any, those rows of x read once, all of y written."""
    used = sum(rows)
    nbytes = (sum(1 for r in rows if r) * k * n + used * k + len(rows) * c * n) * dtype_bytes(BF16)
    return 2 * used * k * n, nbytes


def time_grouped(e, c, k, n, gen, patterns: list) -> dict:
    """Kernel, plain and library (torch.bmm, bf16 in and out) times of one
    expert GEMM over all C rows (the reference's work, the bound's too), the
    expert weights cycled through >= 150 MB of copies (one copy at the
    path's shapes, 403 MB), as the main path reads each layer's experts
    cold; then, apart (``routed_*``), the kernel given the model's rows:
    ``patterns``, one per MoE layer of the served run (recorded in phase 3),
    cycled with the weights (which tiles the kernel computes depends on the
    rows alone, not on x's values), with its own bound over the experts and
    rows it reads."""
    x = randn((e, c, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (e * k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((e, k, n), gen, BF16) for _ in range(copies)])
    t = {
        "kernel": time_ms(lambda: grouped_ops.grouped_matmul(x, nxt()), 10),
        "plain": time_ms(lambda: grouped_matmul_ref(x, nxt()), 5),
        "library": time_ms(lambda: torch.bmm(x, nxt()), 10),
    }
    rows = cycler([torch.tensor(p, dtype=torch.int32, device="cuda") for p in patterns])
    t["routed"] = time_ms(lambda: grouped_ops.grouped_matmul(x, nxt(), rows=rows()), max(10, len(patterns)))
    flops, nbytes = _grouped_cost(k, n, c, [c] * e)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    routed_bounds = [H100.bound_s(*_grouped_cost(k, n, c, p), "bfloat16") for p in patterns]
    routed_bound_s = sum(b for b, _ in routed_bounds) / len(routed_bounds)
    return {"e": e, "c": c, "k": k, "n": n, "path": grouped_kernel.grouped_path(c, k, n, BF16, True),
            "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "experts_with_tokens": sum(sum(1 for r in p if r) for p in patterns) / len(patterns),
            "rows_with_tokens": sum(sum(p) for p in patterns) / len(patterns),
            "routed_ms": t["routed"], "routed_bound_ms": routed_bound_s * 1e3, "routed_bound_by": routed_bounds[0][1]}


def time_flash(gen, cfg, b: int = BATCH, s: int = PROMPT) -> dict:
    """Flash attention as the model calls it: q (B, S, H, D) and k, v (B, S,
    Hkv, D), handed over as (B, H, S, D) views; the plain version repeats
    K/V; SDPA (the yardstick) takes the same views with enable_gqa.  The
    bound reads K and V at Hkv heads."""
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = randn((b, s, h, d), gen, BF16).transpose(1, 2)
    k, v = (randn((b, s, hkv, d), gen, BF16).transpose(1, 2) for _ in range(2))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(scale=d**-0.5, causal=True, window=None, kv_valid=s)
    t = {
        "kernel": time_ms(lambda: attn_ops.flash_attention(q, k, v, causal=True), 20),
        "plain": time_ms(lambda: flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                          **kw), 10),
        "library": time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20),
    }
    pairs = s * (s + 1) // 2  # causal: the (q, k) pairs this run's mask keeps
    flops = 4 * b * h * pairs * d
    nbytes = 2 * b * s * (h + hkv) * d * dtype_bytes(BF16)  # q and k, v read, o written
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"b": b, "h": h, "hkv": hkv, "s": s, "d": d, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def _qgemm_cost(m, k, n, qk=quant.DEFAULT_BLOCK_K):
    """Operations and HBM bytes of one w8a8 projection: int8 values and fp32
    per-row / per-column scales read once, the bf16 output written once."""
    kb = -(-k // qk)
    nbytes = m * k + k * n + 4 * (m * kb + kb * n) + m * n * dtype_bytes(BF16)
    return 2 * m * n * k, nbytes


def time_qgemm(m, k, n, gen) -> dict:
    """Kernel and plain times of one w8a8 projection (int8, 128-k scale
    blocks, bf16 out, the weights K-major as served), weights cycled through
    >= 150 MB of copies as in time_gemm.  No PyTorch call computes a product
    scaled per k block, so library_ms is null.  For information only: the
    same kernel with one scale block over all of K (one retire instead of
    one per 128 k), K1 (the bf16 systolic GEMM) at the same shape, and two
    other functions, torch._int_mm (int8 -> int32, no scales; it refuses
    M <= 16) and the bf16 torch.matmul of the same shape."""
    qa = quant.quantize_act(randn((m, k), gen, torch.float32))
    qbs = [quant.quantize_weight(randn((k, n), gen, torch.float32)) for _ in range(math.ceil(150e6 / (k * n)))]
    qbs = [quant.k_major({"w": qb})["w"] for qb in qbs]
    nxt = cycler(qbs)
    iters = 20 if m <= 16 else 10
    t = {
        "kernel": time_ms(lambda: mm_ops.quant_matmul(qa, nxt(), out_dtype=BF16), iters),
        "plain": time_ms(lambda: quant_matmul_ref(qa, nxt(), out_dtype=BF16), iters),
    }
    qa0 = quant.quantize(qa.dequantize(), block=(1, 0))
    nxt0 = cycler([quant.k_major({"w": quant.quantize(qb.dequantize(), block=(0, 1))})["w"] for qb in qbs])
    t["whole_k"] = time_ms(lambda: mm_ops.quant_matmul(qa0, nxt0(), out_dtype=BF16), iters)
    a16 = randn((m, k), gen, BF16)
    nxt16 = cycler([randn((k, n), gen, BF16) for _ in range(math.ceil(150e6 / (2 * k * n)))])
    t["k1_bf16"] = time_ms(lambda: mm_ops.matmul(a16, nxt16()), iters)
    t["bf16_matmul"] = time_ms(lambda: torch.matmul(a16, nxt16()), iters)
    t["int_mm"] = time_ms(lambda: torch._int_mm(qa.values, nxt().values), iters) if m > 16 else None
    flops, nbytes = _qgemm_cost(m, k, n)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "int8")
    path = mm_kernel.qgemm_path(m, n, k, quant.DEFAULT_BLOCK_K, torch.int8, True)
    return {"m": m, "k": k, "n": n, "path": path, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": None,
            "info_int_mm_ms": t["int_mm"], "info_bf16_matmul_ms": t["bf16_matmul"], "info_k1_bf16_ms": t["k1_bf16"],
            "info_whole_k_scales_ms": t["whole_k"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def time_gemm_bias(m, k, n, gen) -> dict:
    """The bias epilogue (TPU kernel _mmm_bias_kernel) at one stated shape:
    bf16, fp32 bias, no activation; torch.addmm is the one PyTorch call that
    computes the same function.  The main path passes no bias."""
    a = randn((m, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
    bias = randn((n,), gen, torch.float32)
    bias16 = bias.to(BF16)
    t = {
        "kernel": time_ms(lambda: mm_ops.matmul(a, nxt(), bias), 10),
        "plain": time_ms(lambda: matmul_ref(a, nxt(), bias), 10),
        "library": time_ms(lambda: torch.addmm(bias16, a, nxt()), 10),
    }
    flops, nbytes = _gemm_cost(m, k, n)
    bound_s, bound_by = H100.bound_s(flops + m * n, nbytes + 4 * n, "bfloat16")
    return {"m": m, "k": k, "n": n, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by, "launches": 0}


def _merged(paths: list, kernel: str) -> dict:
    """shape -> launches of ``kernel`` over prefill and decode of every path
    (a continuous run lists its launches under "shapes")."""
    out = collections.Counter()
    for r in paths:
        for phase in ("prefill_shapes", "decode_shapes", "shapes"):
            for *shape, c in r.get(phase, {}).get(kernel, []):
                out[tuple(shape)] += c
    return dict(out)


def phase_timing(errs: dict, bf16: dict, w8a8: dict, moe_r: dict, cont: dict) -> tuple[list[dict], dict]:
    say("[4] kernel times at the served paths' shapes (CUDA events; ms per call)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    moe_cfg = configs.get_config(MOE_ARCH)
    shapes = []
    synchronized = _merged([bf16, moe_r], "systolic_mmm")
    for (m, k, n), n_calls in _merged([bf16, moe_r, cont], "systolic_mmm").items():
        # each wgmma tile timed at the synchronized paths' shapes only
        r = time_gemm(m, k, n, gen, gemm_out_dtype(moe_cfg, k, n), tiles=(m, k, n) in synchronized)
        r["launches"] = n_calls  # as counted at the launch site on the served paths
        shapes.append(r)
        tiles = "".join(f"  {p[6:]} {t:.4f}" for p, t in r["ms_by_path"].items())
        say(f"    systolic_mmm M={m:<5d} K={k:<5d} N={n:<5d} out={r['out']:8s} x{r['launches']:<5d} "
            f"{r['path']:13s} kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  torch.matmul {r['library_ms']:.4f}  "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})" + (f"  [each wgmma tile:{tiles}]" if tiles else ""))
    qshapes = []
    for (m, k, n), n_calls in _merged([w8a8], "systolic_qmm").items():
        r = time_qgemm(m, k, n, gen)
        r["launches"] = n_calls
        qshapes.append(r)
        int_mm = "n/a" if r["info_int_mm_ms"] is None else f"{r['info_int_mm_ms']:.4f}"
        say(f"    systolic_qmm M={m:<5d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} {r['path']:6s} kernel {r['ms']:.4f}  "
            f"plain {r['plain_ms']:.4f}  library null  bound {r['bound_ms']:.4f} ({r['bound_by']})  "
            f"[info: whole-K scales {r['info_whole_k_scales_ms']:.4f}; K1 bf16 {r['info_k1_bf16_ms']:.4f}; other "
            f"functions: torch._int_mm {int_mm}, bf16 torch.matmul {r['info_bf16_matmul_ms']:.4f}]")
    gshapes = []
    for (e, c, k, n), n_calls in _merged([moe_r], "grouped_mmm").items():
        patterns = moe_r["prefill_rows"] if c > grouped_kernel.DECODE_MAX_M else moe_r["decode_rows"]
        r = time_grouped(e, c, k, n, gen, patterns)
        r["launches"] = n_calls
        gshapes.append(r)
        say(f"    grouped_mmm E={e:<4d} C={c:<4d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} {r['path']:13s} all rows: "
            f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  torch.bmm {r['library_ms']:.4f}  bound "
            f"{r['bound_ms']:.4f} ({r['bound_by']}); the model's rows ({r['experts_with_tokens']:.1f} "
            f"experts, {r['rows_with_tokens']:.1f} rows with tokens, mean of {len(patterns)} layers): kernel "
            f"{r['routed_ms']:.4f}  bound {r['routed_bound_ms']:.4f} ({r['routed_bound_by']})")
    k2 = time_gemm_bias(BATCH * PROMPT, 2048, 8192, gen)
    say(f"    systolic_mmm + bias (K2) M={k2['m']} K={k2['k']} N={k2['n']} x0 (not on the main path) "
        f"kernel {k2['ms']:.4f}  plain {k2['plain_ms']:.4f}  torch.addmm {k2['library_ms']:.4f}  "
        f"bound {k2['bound_ms']:.4f} ({k2['bound_by']})")
    flash = []
    # Flash launches are counted by head counts: each path's prefill launches
    # are at its model's (H, Hkv), phase 3 checks (16, 8) and (32, 4); the
    # continuous path's also by (B, Sq, Skv), batch 1 at each prompt length.
    dense_cfg = configs.get_config(ARCH)
    runs = [(dense_cfg, BATCH, PROMPT, sum(r["prefill_launches"]["flash_attn"] for r in (bf16, w8a8))),
            (moe_cfg, BATCH, PROMPT, moe_r["prefill_launches"]["flash_attn"])]
    runs += [(dense_cfg, b, sq, n_calls) for b, sq, _, n_calls in cont["flash_shapes"]]
    for cfg, b, sq, n_calls in runs:
        fl = time_flash(gen, cfg, b, sq)
        fl["launches"] = n_calls
        flash.append(fl)
        say(f"    flash_attn B={fl['b']} H={fl['h']}/{fl['hkv']} S={fl['s']} D={fl['d']} causal x{fl['launches']} "
            f"kernel {fl['ms']:.4f}  plain {fl['plain_ms']:.4f}  sdpa(enable_gqa) {fl['library_ms']:.4f}  "
            f"bound {fl['bound_ms']:.4f} ({fl['bound_by']})")

    def entry(name, rows):
        # Totals over every launch the served paths made (prefill + decode);
        # the grouped GEMM's also at the model's own rows, apart.
        keys = ("ms", "plain_ms", "bound_ms") + (("routed_ms", "routed_bound_ms") if "routed_ms" in rows[0] else ())
        tot = {key: sum(r[key] * r["launches"] for r in rows) for key in keys}
        lib = [r["library_ms"] for r in rows]
        by = {}
        for r in rows:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches"]
        src, replaces = SOURCES[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(r["launches"] for r in rows), "max_abs_err": errs[name], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": max(by, key=by.get),
                "library_ms": None if None in lib else sum(x * r["launches"] for x, r in zip(lib, rows)),
                **{key: tot[key] for key in keys[3:]}, "shapes": rows}

    # Each kernel's launches are those of every served path that runs it: the
    # fp GEMM on the bf16 (synchronized and continuous) and MoE models, flash
    # attention on all four paths, the block-scaled GEMM on the w8a8 model,
    # the grouped GEMM on the MoE model.
    return [entry("systolic_mmm", shapes), entry("flash_attn", flash), entry("systolic_qmm", qshapes),
            entry("grouped_mmm", gshapes)], k2


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA card.")
    ap.add_argument("--out", default=None, help="also write every number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    # The plain GEMMs are fp32 matmuls, which TF32 would round to ~3 digits:
    # they rely on PyTorch's default of full fp32.
    expect(not torch.backends.cuda.matmul.allow_tf32 and torch.get_float32_matmul_precision() == "highest",
           f"fp32 matmuls in full fp32 (allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
           f"precision={torch.get_float32_matmul_precision()})")
    t_start = time.perf_counter()
    device = phase_device()
    errs = phase_kernels()
    bf16, w8a8, cont = phase_serve(device["nvidia_smi"])
    phase_small_reference(ARCH)
    moe_r = phase_serve_moe()
    phase_small_reference(MOE_ARCH)
    kernels, k2 = phase_timing(errs, bf16, w8a8, moe_r, cont)
    say(f"    wall {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "serve": bf16, "serve_continuous": cont, "serve_w8a8": w8a8, "serve_moe": moe_r,
                       "kernels": kernels, "systolic_mmm_bias": k2, "failures": failures}, f, indent=1)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for f_ in failures:
            print(f"  {f_}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shapes"} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
