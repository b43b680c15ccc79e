#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100, end to end.

Run from the root of the repository on a machine with the card and nvcc:

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name and power limit as nvidia-smi gives them, and the
     build of the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main path's shapes and on ragged ones, max errors beside the
     tolerance (the block-scaled int8 / fp8 GEMM also over scale blocks of
     128, 64, 32 and whole-K);
  3. full-width internlm2-1.8b in bf16 (random weights from a seed) served
     through ServeEngine: batch 4, prompt 512, 32 greedy tokens, with the
     kernels' launch counts checked exactly, in all and per GEMM shape; the
     kernel path's prefill logits and two decode steps from the same cache
     against the same model run through the plain versions on the card; and
     the SMOKE config in fp32 on the card against the port's CPU path;
     then the same model served w8a8 (int8 weights quantized from the same
     fp32 masters, per-token int8 activations), every projection on the
     block-scaled kernel, with the same launch, kernel-vs-plain and decode
     checks (each kernel call of the prefill also against its plain version
     on the model's own inputs), and its logits against the bf16 model's
     within the reference's bound of 0.15 x the largest logit;
  4. each kernel timed at the main path's shapes (CUDA events) beside its
     bound, its plain version and one PyTorch library call (a yardstick the
     port never calls; none computes the block-scaled product, so the
     quantized kernel's is null); one JSON line lists the kernels, each
     shape's time weighted by the launches the main path made at that shape;
  5. the last line: {"ok": true, "device": {...}}.
Without a card, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.systolic import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.systolic import ops as mm_ops  # noqa: E402
from repro_torch.kernels.systolic.ref import (  # noqa: E402
    ACTIVATIONS,
    matmul_ref,
    quant_matmul_ref,
    quant_systolic_matmul_ref,
)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.models.transformer import cast_params  # noqa: E402
from repro_torch.serving import ServeConfig, ServeEngine  # noqa: E402

ARCH = "internlm2-1.8b"
BATCH, PROMPT, GEN = 4, 512, 32
SEED = 0
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
# (K, N) of the seven projections of one internlm2-1.8b layer, with multiplicity.
PROJECTIONS = {(2048, 2048): 2, (2048, 1024): 2, (2048, 8192): 2, (8192, 2048): 1}
SOURCES = {
    "systolic_mmm": ("src/repro_torch/csrc/systolic_mmm.cu", "src/repro/kernels/systolic/kernel.py:37"),
    "systolic_qmm": ("src/repro_torch/csrc/systolic_qmm.cu", "src/repro/kernels/systolic/kernel.py:174"),
    "flash_attn": ("src/repro_torch/csrc/flash_attn.cu", "src/repro/kernels/attention/kernel.py:30"),
}

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
    mm_kernel.quant_launches = 0
    mm_kernel.quant_launches_by_shape.clear()
    attn_kernel.launches = 0


def counts() -> tuple[int, int, int]:
    """(systolic, quantized systolic, flash) launches since the last reset."""
    return mm_kernel.launches, mm_kernel.quant_launches, attn_kernel.launches


@contextlib.contextmanager
def plain_versions():
    """Route the kernel wrappers' CUDA calls to their plain versions (for the
    comparison run only; the port itself has no such switch)."""

    def mm(a, b, bias, *, out_dtype, activation="none"):
        return matmul_ref(a, b, bias, activation=activation, out_dtype=out_dtype)

    def flash(q, k, v, *, scale, causal, window, kv_valid):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, kv_valid=kv_valid)

    with mock.patch.object(mm_kernel, "systolic_matmul_call", mm), \
            mock.patch.object(mm_kernel, "quant_systolic_matmul_call", quant_systolic_matmul_ref), \
            mock.patch.object(attn_kernel, "flash_attention_call", flash):
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
    got = mm_ops.matmul(a, b, bv, activation=act, out_dtype=out_dtype)
    want = matmul_ref(a, b, bv, activation=act, out_dtype=out_dtype)
    atol, rtol = GEMM_TOL_BF16 if dtype == BF16 else (1e-5 * math.sqrt(k), GEMM_RTOL_FP32)
    ok, err, rel = close(got, want, atol, rtol)
    expect(ok, f"gemm {str(dtype)[6:]:8s} M={m:<5d} K={k:<5d} N={n:<5d} bias={bias!s:5s} act={act:5s} "
               f"max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.0e})")
    return err


def check_flash(b, h, s, d, dtype, gen, *, window=None, causal=True) -> float:
    q, k, v = (randn((b, h, s, d), gen, dtype) for _ in range(3))
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.reshape(b * h, s, d), k.reshape(b * h, s, d), v.reshape(b * h, s, d),
                         causal=causal, window=window).reshape(got.shape)
    tol = ATTN_TOL[dtype]
    ok, err, rel = close(got, want, tol, tol)
    expect(ok, f"flash {str(dtype)[6:]:8s} BH={b * h} S={s} D={d} causal={causal} window={window} "
               f"max_abs={err:.3e} max_rel={rel:.3e} (tol {tol:.0e})")
    return err


def check_qgemm(m, k, n, qd, gen, *, qk=(128, 128), act="none", out_dtype=BF16) -> float:
    """The block-scaled kernel against its plain version on one quantized pair."""
    qa = quant.quantize(randn((m, k), gen, torch.float32), qd, block=(1, qk[0]))
    qb = quant.quantize(randn((k, n), gen, torch.float32), qd, block=(qk[1], 1))
    got = mm_ops.quant_matmul(qa, qb, out_dtype=out_dtype, activation=act)
    want = quant_matmul_ref(qa, qb, activation=act, out_dtype=out_dtype)
    pre = quant_matmul_ref(qa, qb, out_dtype=torch.float32)
    atol = QGEMM_ATOL * (pre.abs().max().item() + 1.0)
    rtol = QGEMM_RTOL_BF16 if out_dtype == BF16 else 0.0
    ok, err, rel = close(got, want, atol, rtol)
    expect(ok and got.dtype == out_dtype,
           f"qgemm {qd:4s} M={m:<5d} K={k:<5d} N={n:<5d} qk={qk!s:9s} act={act:5s} out={str(out_dtype)[6:]:8s} "
           f"max_abs={err:.3e} max_rel={rel:.3e} (atol {atol:.1e}, rtol {rtol:.1e})")
    return err


def phase_kernels() -> dict:
    say("[2] kernels against their plain versions on the card")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    mm_err = 0.0
    for m in (4, BATCH * PROMPT):
        for k, n in PROJECTIONS:
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
    q_err = 0.0
    for qd in quant.QDTYPES:
        for m in (4, BATCH * PROMPT):
            for k, n in PROJECTIONS:
                err = check_qgemm(m, k, n, qd, gen)
                q_err = max(q_err, err) if qd == "int8" else q_err  # the main path's dtype
        for m, k, n in ((72, 100, 130), (300, 515, 257), (1, 300, 1000), (9, 70, 4000)):
            check_qgemm(m, k, n, qd, gen, out_dtype=torch.float32)
        for qk in ((64, 64), (32, 32), (0, 0), (128, 64), (32, 0), (48, 32)):
            check_qgemm(4, 1000, 300, qd, gen, qk=qk, out_dtype=torch.float32)  # split-K, partial last block
            check_qgemm(100, 520, 130, qd, gen, qk=qk, out_dtype=torch.float32)
        for act in ACTIVATIONS:
            check_qgemm(4, 1000, 300, qd, gen, act=act)
            check_qgemm(100, 520, 130, qd, gen, act=act, out_dtype=torch.float32)
    attn_err = 0.0
    for s, window in ((512, None), (512, 128), (500, None)):
        attn_err = max(attn_err, check_flash(BATCH, 16, s, 128, BF16, gen, window=window))
    check_flash(2, 2, 130, 64, torch.float32, gen, window=32)
    check_flash(2, 2, 100, 16, BF16, gen, causal=False)
    torch.cuda.synchronize()
    return {"systolic_mmm": mm_err, "systolic_qmm": q_err, "flash_attn": attn_err}


# ---------------------------------------------------------------------------
# Phase 3: serve full-width internlm2-1.8b
# ---------------------------------------------------------------------------


def serve_path(label: str, model, params, want: dict, batch, feed=None) -> dict:
    """Serve one synchronized batch through ServeEngine on the kernels, with
    the counts set to 0 just before prefill and decode and read just after;
    then hold the kernel path's prefill logits and two decode steps from one
    cache against the plain path.  ``want``: the GEMM counter that the
    projections must hit ("systolic" or "quant") and the logits tolerance.
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
    pf_counts = counts()
    pf_shapes = dict(mm_kernel.launches_by_shape if want["gemm"] == "systolic" else mm_kernel.quant_launches_by_shape)
    reset_counts()
    t0 = time.perf_counter()
    rest = engine.decode(first, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    dec_counts = counts()
    dec_shapes = dict(mm_kernel.launches_by_shape if want["gemm"] == "systolic" else mm_kernel.quant_launches_by_shape)
    tokens = torch.cat([first, rest], dim=1)
    n_proj = 7 * cfg.n_layers
    say(f"    {label}: prefill {t_prefill * 1e3:.3f} ms; decode {t_decode / (GEN - 1) * 1e3:.3f} ms/step, "
        f"{BATCH * (GEN - 1) / t_decode:.1f} tok/s over {GEN - 1} steps")
    gemm = (n_proj, 0) if want["gemm"] == "systolic" else (0, n_proj)
    want_pf = (*gemm, cfg.n_layers)
    want_dec = (gemm[0] * (GEN - 1), gemm[1] * (GEN - 1), 0)
    expect(pf_counts == want_pf, f"{label} prefill launches (systolic, quant, flash): {pf_counts}, want {want_pf}")
    expect(dec_counts == want_dec,
           f"{label} decode launches over {GEN - 1} steps (systolic, quant, flash): {dec_counts}, want {want_dec}")
    expect(tuple(tokens.shape) == (BATCH, GEN) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
           f"{label} tokens {tuple(tokens.shape)} in [0, {cfg.vocab_size}): {tokens[0, :12].tolist()}")
    # Per-shape counts, from the launch site: the timing phase weights each
    # shape's time by these, so they must be the model's seven projections.
    want_pf_shapes = {(BATCH * PROMPT, k, n): mult * cfg.n_layers for (k, n), mult in PROJECTIONS.items()}
    want_dec_shapes = {(BATCH, k, n): mult * cfg.n_layers * (GEN - 1) for (k, n), mult in PROJECTIONS.items()}
    expect(pf_shapes == want_pf_shapes, f"{label} prefill {want['gemm']} launches by (M, K, N): {sorted(pf_shapes.items())}")
    expect(dec_shapes == want_dec_shapes, f"{label} decode {want['gemm']} launches by (M, K, N): {sorted(dec_shapes.items())}")

    logits = []  # the kernel path's prefill and two decode-step logits
    # w8a8: each GEMM's int8 activations on the kernel path, the plain path's
    # differences from them, and each kernel call against its plain version.
    acts_k, flips, in_model = [], [], []
    quantized = want["gemm"] == "quant"
    with torch.no_grad():
        reset_counts()
        with contextlib.ExitStack() as stack:
            if quantized:
                stack.enter_context(quantized_activations(acts_k))
                stack.enter_context(checked_quant_calls(in_model))
            got, cache_k = model.prefill(params, batch, max_len=PROMPT + GEN)
        kernel_counts = counts()
        if quantized:
            expect(len(in_model) == 7 * cfg.n_layers and max(in_model) <= 1.0,
                   f"{label} prefill: each of the {len(in_model)} block-scaled kernel calls against its plain "
                   f"version on the model's own inputs: worst error {max(in_model):.3f} of the tolerance")
        with plain_versions(), quantized_activations(flips, acts_k) if quantized else contextlib.nullcontext():
            want_l, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        plain_counts = tuple(c - k for c, k in zip(counts(), kernel_counts))
        expect(plain_counts == (0, 0, 0), f"{label} plain-path prefill launched no kernel ({plain_counts})")
        err, scale = compare_logits(f"{label} prefill", got, want_l, want["tol"])
        if quantized:
            flips = activation_flips(label, flips, cfg.n_layers)
        del acts_k
        logits.append(got)
        # Two decode steps from one cache: the kernel path's primed cache, and
        # a copy of it for the plain path; both are fed the same tokens.
        cache_p = _tree(torch.clone, cache_k)
        tok, dec_err, fed = got.argmax(-1).to(torch.int32), 0.0, []
        for step in range(2):
            tok = tok if feed is None else feed[step]
            fed.append(tok)
            lk, cache_k = model.decode_step(params, tok, cache=cache_k, pos=PROMPT + step)
            n0 = counts()
            with plain_versions():
                lp, cache_p = model.decode_step(params, tok, cache=cache_p, pos=PROMPT + step)
            expect(counts() == n0, f"{label} plain-path decode step {step} launched no kernel")
            dec_err = max(dec_err, compare_logits(f"{label} decode step {step}", lk, lp, want["tol"])[0])
            logits.append(lk)
            tok = lk.argmax(-1).to(torch.int32)
    del engine, cache_k, cache_p
    return {
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_step": t_decode / (GEN - 1) * 1e3,
        "decode_tok_s": BATCH * (GEN - 1) / t_decode,
        "prefill_launches": list(pf_counts),  # (systolic, quant, flash)
        "decode_launches": list(dec_counts),
        "prefill_shapes": [[*mkn, c] for mkn, c in sorted(pf_shapes.items())],  # [M, K, N, launches]
        "decode_shapes": [[*mkn, c] for mkn, c in sorted(dec_shapes.items())],
        "logits_max_abs_err": err,
        "logits_scale": scale,
        "prefill_activation_flips": flips,
        "decode_logits_max_abs_err": dec_err,
        "logits": logits,
        "fed": fed,
    }


def phase_serve() -> tuple[dict, dict]:
    """The bf16 model, then the w8a8 model quantized from the same fp32 masters."""
    cfg = configs.get_config(ARCH)
    say(f"[3] serve {ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    t0 = time.perf_counter()
    masters = model.init(SEED, "cuda", dtype=torch.float32)  # the fp32 values both models come from
    params = cast_params(masters, BF16)
    qparams = cast_params(quant.quantize_params(masters), BF16)
    del masters
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_q, q_bytes = quant.count_quantized(qparams)
    say(f"    init {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
        f"w8a8: {n_q} projection weights -> int8 ({q_bytes / 1e6:.1f} MB resident values)")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    bf16 = serve_path("bf16", model, params, {"gemm": "systolic", "tol": LOGITS_TOL_BF16}, batch)
    with quant.use_act_quant("int8"):
        w8a8 = serve_path("w8a8", model, qparams, {"gemm": "quant", "tol": LOGITS_TOL_W8A8}, batch,
                          feed=bf16["fed"])
    w8a8["rounding_sensitivity"] = rounding_sensitivity(model, params, qparams, batch)
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
    del params, qparams
    torch.cuda.empty_cache()
    return bf16, w8a8


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


def rounding_sensitivity(model, params, qparams, batch) -> dict:
    """How far the plain path alone moves under a rounding-sized change of
    its input: the embedding table nudged up by one bf16 ulp on a random half
    of its elements (from the seed), prefill logits of the nudged against the
    unchanged model, bf16 and w8a8, as a share of the largest logit.  Read
    beside each model's kernel-vs-plain error."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    out = {}
    with torch.no_grad(), plain_versions():
        for label, p in (("bf16", params), ("w8a8", qparams)):
            table = p["embed"]["table"]
            bump = torch.randint(0, 2, table.shape, generator=gen, device="cuda", dtype=torch.int16)
            nudged = {**p, "embed": {**p["embed"], "table": (table.view(torch.int16) + bump).view(table.dtype)}}
            with quant.use_act_quant("int8") if label == "w8a8" else contextlib.nullcontext():
                base, _ = model.prefill(p, batch, max_len=PROMPT + GEN)
                moved, _ = model.prefill(nudged, batch, max_len=PROMPT + GEN)
            out[label] = (moved - base).abs().max().item() / max(1.0, base.abs().max().item())
            expect(math.isfinite(out[label]), f"{label} plain path, embedding nudged by one bf16 ulp: prefill "
                                              f"logits move by {out[label]:.2%} of the largest")
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


def phase_small_reference() -> None:
    """SMOKE internlm2 in fp32: the card (kernels) against the port's CPU path,
    which tests/test_torch_serve.py holds against the JAX package."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")
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
    expect(err <= LOGITS_TOL_FP32, f"SMOKE fp32 prefill logits, card vs CPU: max_abs={err:.3e} (tol {LOGITS_TOL_FP32})")
    expect(torch.equal(out["cpu"][1], out["cuda"][1]),
           f"SMOKE fp32 8 greedy tokens, card vs CPU identical: {out['cuda'][1][0].tolist()}")


# ---------------------------------------------------------------------------
# Phase 4: timing and the kernels line
# ---------------------------------------------------------------------------


def _gemm_cost(m, k, n):
    """Operations and HBM bytes of one bf16 projection: each input read once,
    the output written once."""
    flops = 2 * m * n * k
    nbytes = (m * k + k * n + m * n) * dtype_bytes(BF16)
    return flops, nbytes


def cycler(items: list):
    """A function returning the next of ``items`` on each call, round robin."""
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % len(items)
        return items[it[0]]

    return nxt


def time_gemm(m, k, n, gen) -> dict:
    """Kernel, plain and library times of one bf16 projection.  Weights are
    cycled through enough copies to exceed the 50 MB L2, as the main path
    reads each layer's weights cold."""
    a = randn((m, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
    nxt = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
    iters = 20 if m <= 16 else 10
    t = {
        "kernel": time_ms(lambda: mm_ops.matmul(a, nxt()), iters),
        "plain": time_ms(lambda: matmul_ref(a, nxt()), iters),
        "library": time_ms(lambda: torch.matmul(a, nxt()), iters),
    }
    flops, nbytes = _gemm_cost(m, k, n)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"m": m, "k": k, "n": n, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def time_flash(gen) -> dict:
    b, h, s, d = BATCH, 16, PROMPT, 128
    q, k, v = (randn((b, h, s, d), gen, BF16) for _ in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t = {
        "kernel": time_ms(lambda: attn_ops.flash_attention(q, k, v, causal=True), 20),
        "plain": time_ms(lambda: attention_ref(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                                               v.reshape(b * h, s, d), causal=True), 10),
        "library": time_ms(lambda: sdpa(q, k, v, is_causal=True), 20),
    }
    pairs = s * (s + 1) // 2  # causal: the (q, k) pairs this run's mask keeps
    flops = 4 * b * h * pairs * d
    nbytes = 4 * b * h * s * d * dtype_bytes(BF16)  # q, k, v read, o written
    bound_s, bound_by = H100.bound_s(flops, nbytes, "bfloat16")
    return {"bh": b * h, "s": s, "d": d, "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": bound_s * 1e3, "bound_by": bound_by}


def _qgemm_cost(m, k, n, qk=quant.DEFAULT_BLOCK_K):
    """Operations and HBM bytes of one w8a8 projection: int8 values and fp32
    per-row / per-column scales read once, the bf16 output written once."""
    kb = -(-k // qk)
    nbytes = m * k + k * n + 4 * (m * kb + kb * n) + m * n * dtype_bytes(BF16)
    return 2 * m * n * k, nbytes


def time_qgemm(m, k, n, gen) -> dict:
    """Kernel and plain times of one w8a8 projection (int8, 128-k scale
    blocks, bf16 out), weights cycled through >= 150 MB of copies as in
    time_gemm.  No PyTorch call computes a product scaled per k block, so
    library_ms is null.  For information only: the same kernel with one
    scale block over all of K (one retire instead of one per 128 k), and two
    other functions, torch._int_mm (int8 -> int32, no scales; it refuses
    M <= 16) and the bf16 torch.matmul of the same shape."""
    qa = quant.quantize_act(randn((m, k), gen, torch.float32))
    qbs = [quant.quantize_weight(randn((k, n), gen, torch.float32)) for _ in range(math.ceil(150e6 / (k * n)))]
    nxt = cycler(qbs)
    iters = 20 if m <= 16 else 10
    t = {
        "kernel": time_ms(lambda: mm_ops.quant_matmul(qa, nxt(), out_dtype=BF16), iters),
        "plain": time_ms(lambda: quant_matmul_ref(qa, nxt(), out_dtype=BF16), iters),
    }
    qa0 = quant.quantize(qa.dequantize(), block=(1, 0))
    nxt0 = cycler([quant.quantize(qb.dequantize(), block=(0, 1)) for qb in qbs])
    t["whole_k"] = time_ms(lambda: mm_ops.quant_matmul(qa0, nxt0(), out_dtype=BF16), iters)
    a16 = randn((m, k), gen, BF16)
    nxt16 = cycler([randn((k, n), gen, BF16) for _ in range(math.ceil(150e6 / (2 * k * n)))])
    t["bf16_matmul"] = time_ms(lambda: torch.matmul(a16, nxt16()), iters)
    t["int_mm"] = time_ms(lambda: torch._int_mm(qa.values, nxt().values), iters) if m > 16 else None
    flops, nbytes = _qgemm_cost(m, k, n)
    bound_s, bound_by = H100.bound_s(flops, nbytes, "int8")
    return {"m": m, "k": k, "n": n, "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": None,
            "info_int_mm_ms": t["int_mm"], "info_bf16_matmul_ms": t["bf16_matmul"],
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


def phase_timing(errs: dict, bf16: dict, w8a8: dict) -> tuple[list[dict], dict]:
    say("[4] kernel times at the main path's shapes (CUDA events; ms per call)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shapes = []
    for m, k, n, n_calls in bf16["prefill_shapes"] + bf16["decode_shapes"]:
        r = time_gemm(m, k, n, gen)
        r["launches"] = n_calls  # as counted at the launch site on the main path
        shapes.append(r)
        say(f"    systolic_mmm M={m:<5d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} kernel {r['ms']:.4f}  "
            f"plain {r['plain_ms']:.4f}  torch.matmul {r['library_ms']:.4f}  "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    qshapes = []
    for m, k, n, n_calls in w8a8["prefill_shapes"] + w8a8["decode_shapes"]:
        r = time_qgemm(m, k, n, gen)
        r["launches"] = n_calls
        qshapes.append(r)
        int_mm = "n/a" if r["info_int_mm_ms"] is None else f"{r['info_int_mm_ms']:.4f}"
        say(f"    systolic_qmm M={m:<5d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} kernel {r['ms']:.4f}  "
            f"plain {r['plain_ms']:.4f}  library null  bound {r['bound_ms']:.4f} ({r['bound_by']})  "
            f"[info: whole-K scales {r['info_whole_k_scales_ms']:.4f}; other functions: torch._int_mm {int_mm}, "
            f"bf16 torch.matmul {r['info_bf16_matmul_ms']:.4f}]")
    k2 = time_gemm_bias(BATCH * PROMPT, 2048, 8192, gen)
    say(f"    systolic_mmm + bias (K2) M={k2['m']} K={k2['k']} N={k2['n']} x0 (not on the main path) "
        f"kernel {k2['ms']:.4f}  plain {k2['plain_ms']:.4f}  torch.addmm {k2['library_ms']:.4f}  "
        f"bound {k2['bound_ms']:.4f} ({k2['bound_by']})")
    fl = time_flash(gen)
    fl["launches"] = bf16["prefill_launches"][2] + bf16["decode_launches"][2]
    say(f"    flash_attn BH={fl['bh']} S={fl['s']} D={fl['d']} causal x{fl['launches']} kernel {fl['ms']:.4f}  "
        f"plain {fl['plain_ms']:.4f}  sdpa {fl['library_ms']:.4f}  bound {fl['bound_ms']:.4f} ({fl['bound_by']})")

    def entry(name, rows, launches):
        # Totals over every launch the main path made (prefill + decode).
        tot = {key: sum(r[key] * r["launches"] for r in rows) for key in ("ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in rows]
        by = {}
        for r in rows:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches"]
        src, replaces = SOURCES[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": errs[name], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": max(by, key=by.get),
                "library_ms": None if None in lib else sum(x * r["launches"] for x, r in zip(lib, rows)),
                "shapes": rows}

    # Each kernel's launches come from the served path that runs it: the bf16
    # model for the fp GEMM and flash attention, the w8a8 model for the
    # block-scaled GEMM (the w8a8 model launches no fp GEMM and the same
    # flash kernels).
    return [entry("systolic_mmm", shapes, bf16["prefill_launches"][0] + bf16["decode_launches"][0]),
            entry("flash_attn", [fl], fl["launches"]),
            entry("systolic_qmm", qshapes, w8a8["prefill_launches"][1] + w8a8["decode_launches"][1])], k2


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
    bf16, w8a8 = phase_serve()
    phase_small_reference()
    kernels, k2 = phase_timing(errs, bf16, w8a8)
    say(f"    wall {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "serve": bf16, "serve_w8a8": w8a8, "kernels": kernels,
                       "systolic_mmm_bias": k2, "failures": failures}, f, indent=1)
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
