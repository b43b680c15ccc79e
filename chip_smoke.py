#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA H100, end to end.

Run from the root of the repository on a machine with the card and nvcc:

    python3 chip_smoke.py [--out details.json]

Phases, each printing its own lines; any failure exits non-zero:
  1. device: the card's name and power limit as nvidia-smi gives them, and the
     build of the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. each hand-written kernel against its plain PyTorch version on the card,
     at the main path's shapes and on ragged ones, max errors beside the
     tolerance;
  3. full-width internlm2-1.8b in bf16 (random weights from a seed) served
     through ServeEngine: batch 4, prompt 512, 32 greedy tokens, with the
     kernels' launch counts checked exactly, in all and per GEMM shape; the
     kernel path's prefill logits and two decode steps from the same cache
     against the same model run through the plain versions on the card; and
     the SMOKE config in fp32 on the card against the port's CPU path;
  4. each kernel timed at the main path's shapes (CUDA events) beside its
     bound, its plain version and one PyTorch library call (a yardstick the
     port never calls); one JSON line lists the kernels, each shape's time
     weighted by the launches the main path made at that shape;
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

from repro_torch import configs  # noqa: E402
from repro_torch.core.hw import H100, dtype_bytes  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.systolic import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.systolic import ops as mm_ops  # noqa: E402
from repro_torch.kernels.systolic.ref import ACTIVATIONS, matmul_ref  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
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
# (K, N) of the seven projections of one internlm2-1.8b layer, with multiplicity.
PROJECTIONS = {(2048, 2048): 2, (2048, 1024): 2, (2048, 8192): 2, (8192, 2048): 1}
SOURCES = {
    "systolic_mmm": ("src/repro_torch/csrc/systolic_mmm.cu", "src/repro/kernels/systolic/kernel.py:37"),
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
    attn_kernel.launches = 0


def counts() -> tuple[int, int]:
    return mm_kernel.launches, attn_kernel.launches


@contextlib.contextmanager
def plain_versions():
    """Route both kernel wrappers' CUDA calls to their plain versions (for the
    comparison run only; the port itself has no such switch)."""

    def mm(a, b, bias, *, out_dtype, activation="none"):
        return matmul_ref(a, b, bias, activation=activation, out_dtype=out_dtype)

    def flash(q, k, v, *, scale, causal, window, kv_valid):
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale, kv_valid=kv_valid)

    with mock.patch.object(mm_kernel, "systolic_matmul_call", mm), \
            mock.patch.object(attn_kernel, "flash_attention_call", flash):
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
    attn_err = 0.0
    for s, window in ((512, None), (512, 128), (500, None)):
        attn_err = max(attn_err, check_flash(BATCH, 16, s, 128, BF16, gen, window=window))
    check_flash(2, 2, 130, 64, torch.float32, gen, window=32)
    check_flash(2, 2, 100, 16, BF16, gen, causal=False)
    torch.cuda.synchronize()
    return {"systolic_mmm": mm_err, "flash_attn": attn_err}


# ---------------------------------------------------------------------------
# Phase 3: serve full-width internlm2-1.8b
# ---------------------------------------------------------------------------


def phase_serve() -> dict:
    cfg = configs.get_config(ARCH)
    say(f"[3] serve {ARCH} (full width: {cfg.n_layers}L d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
        f"d_ff={cfg.d_ff} V={cfg.vocab_size}) in {cfg.dtype}, batch {BATCH}, prompt {PROMPT}, {GEN} tokens")
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, "cuda")
    torch.cuda.synchronize()
    say(f"    init {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    engine = ServeEngine(model, params, ServeConfig(max_len=PROMPT + GEN, batch=BATCH), device="cuda")
    batch = make_batch(cfg, batch=BATCH, seq=PROMPT, kind="prefill", seed=SEED, device="cuda")
    engine.generate(batch, 2)  # warm-up: library handles, first launches (not counted)
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    first = engine.prefill(batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    pf_counts, pf_shapes = counts(), dict(mm_kernel.launches_by_shape)
    reset_counts()
    t0 = time.perf_counter()
    rest = engine.decode(first, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    dec_counts, dec_shapes = counts(), dict(mm_kernel.launches_by_shape)
    tokens = torch.cat([first, rest], dim=1)
    n_proj = 7 * cfg.n_layers
    say(f"    prefill {t_prefill * 1e3:.3f} ms; decode {t_decode / (GEN - 1) * 1e3:.3f} ms/step, "
        f"{BATCH * (GEN - 1) / t_decode:.1f} tok/s over {GEN - 1} steps")
    expect(pf_counts == (n_proj, cfg.n_layers),
           f"prefill launches: systolic {pf_counts[0]} (want {n_proj}), flash {pf_counts[1]} (want {cfg.n_layers})")
    expect(dec_counts == (n_proj * (GEN - 1), 0),
           f"decode launches over {GEN - 1} steps: systolic {dec_counts[0]} (want {n_proj * (GEN - 1)}), "
           f"flash {dec_counts[1]} (want 0)")
    expect(tuple(tokens.shape) == (BATCH, GEN) and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
           f"tokens {tuple(tokens.shape)} in [0, {cfg.vocab_size}): {tokens[0, :12].tolist()}")
    # Per-shape counts, from the launch site: the timing phase weights each
    # shape's time by these, so they must be the model's seven projections.
    want_pf = {(BATCH * PROMPT, k, n): mult * cfg.n_layers for (k, n), mult in PROJECTIONS.items()}
    want_dec = {(BATCH, k, n): mult * cfg.n_layers * (GEN - 1) for (k, n), mult in PROJECTIONS.items()}
    expect(pf_shapes == want_pf, f"prefill systolic launches by (M, K, N): {sorted(pf_shapes.items())}")
    expect(dec_shapes == want_dec, f"decode systolic launches by (M, K, N): {sorted(dec_shapes.items())}")

    with torch.no_grad():
        reset_counts()
        got, cache_k = model.prefill(params, batch, max_len=PROMPT + GEN)
        kernel_counts = counts()
        with plain_versions():
            want, _ = model.prefill(params, batch, max_len=PROMPT + GEN)
        plain_counts = tuple(c - k for c, k in zip(counts(), kernel_counts))
        expect(plain_counts == (0, 0), f"plain-path prefill launched no kernel ({plain_counts})")
        err, scale = compare_logits("prefill", got, want)
        # Two decode steps from one cache: the kernel path's primed cache, and
        # a copy of it for the plain path; both are fed the same tokens.
        cache_p = _tree(torch.clone, cache_k)
        tok, dec_err = got.argmax(-1).to(torch.int32), 0.0
        for step in range(2):
            lk, cache_k = model.decode_step(params, tok, cache=cache_k, pos=PROMPT + step)
            n0 = counts()
            with plain_versions():
                lp, cache_p = model.decode_step(params, tok, cache=cache_p, pos=PROMPT + step)
            expect(counts() == n0, f"plain-path decode step {step} launched no kernel")
            dec_err = max(dec_err, compare_logits(f"decode step {step}", lk, lp)[0])
            tok = lk.argmax(-1).to(torch.int32)
    del engine, params, cache_k, cache_p
    torch.cuda.empty_cache()
    return {
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_step": t_decode / (GEN - 1) * 1e3,
        "decode_tok_s": BATCH * (GEN - 1) / t_decode,
        "prefill_launches": list(pf_counts),
        "decode_launches": list(dec_counts),
        "prefill_shapes": [[*mkn, c] for mkn, c in sorted(pf_shapes.items())],  # [M, K, N, launches]
        "decode_shapes": [[*mkn, c] for mkn, c in sorted(dec_shapes.items())],
        "logits_max_abs_err": err,
        "logits_scale": scale,
        "decode_logits_max_abs_err": dec_err,
    }


def compare_logits(what: str, got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Kernel-path logits (B, 1, V) against the plain path's, within the bf16
    tolerance; then the greedy tokens.  Random weights leave near-ties among
    the top logits, which bf16 rounding may order either way (one row in four
    flipped in an earlier run), so a row may pick another token than the
    plain path only if that token's plain logit is within twice the row's
    measured error of the plain maximum; any other disagreement fails."""
    d = (got - want).abs()
    err = d.max().item()
    scale = max(1.0, want.abs().max().item())
    expect(bool(torch.isfinite(got).all()) and err <= LOGITS_TOL_BF16 * scale,
           f"{what} logits {tuple(got.shape)}, kernel path vs plain path: max_abs={err:.3e} "
           f"(tol {LOGITS_TOL_BF16} x {scale:.2f})")
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


def time_gemm(m, k, n, gen) -> dict:
    """Kernel, plain and library times of one bf16 projection.  Weights are
    cycled through enough copies to exceed the 50 MB L2, as the main path
    reads each layer's weights cold."""
    a = randn((m, k), gen, BF16)
    copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
    bs = [randn((k, n), gen, BF16) for _ in range(copies)]
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % copies
        return bs[it[0]]

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


def phase_timing(errs: dict, serve: dict) -> list[dict]:
    say("[4] kernel times at the main path's shapes (CUDA events; ms per call)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shapes = []
    for m, k, n, n_calls in serve["prefill_shapes"] + serve["decode_shapes"]:
        r = time_gemm(m, k, n, gen)
        r["launches"] = n_calls  # as counted at the launch site on the main path
        shapes.append(r)
        say(f"    systolic_mmm M={m:<5d} K={k:<5d} N={n:<5d} x{r['launches']:<5d} kernel {r['ms']:.4f}  "
            f"plain {r['plain_ms']:.4f}  torch.matmul {r['library_ms']:.4f}  "
            f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    fl = time_flash(gen)
    fl["launches"] = serve["prefill_launches"][1] + serve["decode_launches"][1]
    say(f"    flash_attn BH={fl['bh']} S={fl['s']} D={fl['d']} causal x{fl['launches']} kernel {fl['ms']:.4f}  "
        f"plain {fl['plain_ms']:.4f}  sdpa {fl['library_ms']:.4f}  bound {fl['bound_ms']:.4f} ({fl['bound_by']})")

    def entry(name, rows, launches):
        # Totals over every launch the main path made (prefill + decode).
        tot = {key: sum(r[key] * r["launches"] for r in rows)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by = {}
        for r in rows:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"] * r["launches"]
        src, replaces = SOURCES[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": launches, "max_abs_err": errs[name], "ms": tot["ms"],
                "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": max(by, key=by.get), "library_ms": tot["library_ms"],
                "shapes": rows}

    mm_launches = serve["prefill_launches"][0] + serve["decode_launches"][0]
    return [entry("systolic_mmm", shapes, mm_launches),
            entry("flash_attn", [fl], serve["prefill_launches"][1] + serve["decode_launches"][1])]


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA card.")
    ap.add_argument("--out", default=None, help="also write every number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = phase_device()
    errs = phase_kernels()
    serve = phase_serve()
    phase_small_reference()
    kernels = phase_timing(errs, serve)
    say(f"    wall {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "serve": serve, "kernels": kernels, "failures": failures}, f, indent=1)
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
