#!/usr/bin/env python3
"""Measure how far Hopper's fp8 (e4m3) wgmma lands from the block-scaled GEMM's plain version.

Run from the root of the repository on a machine with the card and nvcc:

    python3 tools/fp8_wgmma_error.py [--out fp8.json]

``tools/fp8_wgmma_error.cu`` (built here with the port's nvcc flags into
``src/repro_torch/_build/tools/``) runs the block-scaled product on
``wgmma.m64n128k32.f32.e4m3.e4m3`` and retires each scale step's partial
into fp32 as the port's int8 wgmma tile does.  For each shape and scale step
(whole K, 128 and 32) it prints the largest error against the plain version
(``kernels/systolic/ref.py::quant_matmul_ref``, fp32) beside
``chip_smoke.py``'s tolerance for the block-scaled GEMM, 1e-5 * (max|sum| +
1), and their ratio; the same for the port's kernel (fp8 on its WMMA tile,
widened to bf16) on the same operands; and both against a float64 sum of the
same quantized values.  Operands are quantized from normal random values
(seed 0) as ``chip_smoke.py`` makes them: activations per row x step,
weights per step x column.  First, a check of the probe itself: small
integer operands with unit scales, whose sums every accumulator holds
exactly, must come out exact.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import quant  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.systolic import ops as mm_ops  # noqa: E402
from repro_torch.kernels.systolic.ref import quant_matmul_ref  # noqa: E402

TOL = 1e-5  # chip_smoke.py's QGEMM_ATOL, of max|sum| + 1
SHAPES = [(256, 512, 256), (2048, 2048, 2048)]  # (M, K, N): small, and an internlm2-1.8b prefill projection
STEPS = [0, 128, 32]  # scale step in k: whole K, the served 128, the finest the probe takes


def build() -> ctypes.CDLL:
    out_dir = os.path.join(ROOT, "src", "repro_torch", "_build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libfp8_wgmma_error.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib,
           os.path.join(ROOT, "tools", "fp8_wgmma_error.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    print("\n".join(line for line in (done.stdout + done.stderr).splitlines() if "registers" in line or "spill" in line))
    fn = ctypes.CDLL(lib).fp8_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn


def probe(fn, qa, qb, step: int) -> torch.Tensor:
    m, k = qa.shape
    n = qb.shape[1]
    a_s, _ = mm_ops._row_scales(qa, m, k)
    b_s, _ = mm_ops._col_scales(qb, k, n)
    b = qb.values.t().contiguous()  # (N, K): K-major, as 8-bit wgmma reads B
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    code = fn(qa.values.contiguous().data_ptr(), a_s.data_ptr(), b.data_ptr(), b_s.data_ptr(), out.data_ptr(),
              m, n, k, step)
    if code:
        raise RuntimeError(f"fp8_wgmma launch failed: CUDA error {code}")
    torch.cuda.synchronize()
    return out


def exact(qa, qb, step: int) -> torch.Tensor:
    """The block-scaled sum in float64, step by step in the plain version's order."""
    k = qa.shape[1]
    run = step or k
    a, b = qa.values.double(), qb.values.double()
    total = torch.zeros((qa.shape[0], qb.shape[1]), dtype=torch.float64, device="cuda")
    for k0 in range(0, k, run):  # one scale block per step (the blocks are `run` wide)
        s_a = qa.scales.double()[:, k0 // run, None]
        s_b = qb.scales.double()[None, k0 // run]
        total += (a[:, k0:k0 + run] @ b[k0:k0 + run]) * s_a * s_b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write every number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp8_wgmma_error: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    fn = build()
    gen = torch.Generator(device="cuda").manual_seed(0)

    # The probe itself: integers in [-3, 3] with unit scales; every k32 sum
    # is at most 288 in magnitude, exact in any accumulator.
    ints = [torch.randint(-3, 4, shape, generator=gen, device="cuda").float() for shape in ((256, 512), (512, 256))]
    qa = quant.QArray(ints[0].to(torch.float8_e4m3fn), torch.ones((256, 1), device="cuda"), (1, 512), "fp8")
    qb = quant.QArray(ints[1].to(torch.float8_e4m3fn), torch.ones((1, 256), device="cuda"), (512, 1), "fp8")
    harness = (probe(fn, qa, qb, 0) - (ints[0] @ ints[1])).abs().max().item()
    print(f"probe check, small integers, unit scales: max |probe - exact| = {harness:.3e} (must be 0)")
    report = {"device": smi, "probe_check_max_abs": harness, "rows": []}
    for m, k, n in SHAPES:
        for step in STEPS:
            qa = quant.quantize(torch.randn((m, k), generator=gen, device="cuda"), "fp8", block=(1, step))
            qb = quant.quantize(torch.randn((k, n), generator=gen, device="cuda"), "fp8", block=(step, 1))
            want = quant_matmul_ref(qa, qb, out_dtype=torch.float32)
            atol = TOL * (want.abs().max().item() + 1.0)
            got = probe(fn, qa, qb, step)
            port = mm_ops.quant_matmul(qa, qb, out_dtype=torch.float32)  # the port's kernel: fp8 on WMMA
            ref64 = exact(qa, qb, step)
            row = {"m": m, "k": k, "n": n, "step": step, "atol": atol,
                   "wgmma_max_abs": (got - want).abs().max().item(),
                   "port_max_abs": (port - want).abs().max().item(),
                   "wgmma_vs_f64": (got.double() - ref64).abs().max().item(),
                   "port_vs_f64": (port.double() - ref64).abs().max().item(),
                   "plain_vs_f64": (want.double() - ref64).abs().max().item()}
            row["wgmma_share_of_tol"] = row["wgmma_max_abs"] / atol
            row["port_share_of_tol"] = row["port_max_abs"] / atol
            report["rows"].append(row)
            print(f"M={m:<5d} K={k:<5d} N={n:<5d} step={step or 'K':<4} tol {atol:.3e}: e4m3 wgmma "
                  f"{row['wgmma_max_abs']:.3e} ({row['wgmma_share_of_tol']:.3f} x tol); port's WMMA tile "
                  f"{row['port_max_abs']:.3e} ({row['port_share_of_tol']:.3f} x tol); against float64: wgmma "
                  f"{row['wgmma_vs_f64']:.3e}, port {row['port_vs_f64']:.3e}, plain {row['plain_vs_f64']:.3e}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if harness == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
