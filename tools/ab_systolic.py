#!/usr/bin/env python3
"""Time the systolic GEMM of this checkout against another checkout's, in one process.

Run from the root of the repository on a machine with the card and nvcc:

    python3 tools/ab_systolic.py --base <root of another checkout> [--rounds 9] [--out ab.json]

Both trees' ``src/repro_torch/csrc/systolic_mmm.cu`` are built with this
tree's nvcc flags into ``src/repro_torch/_build/ab/`` and loaded side by side
through their C entry points (ctypes keeps each library's symbols local).
Printed: ptxas's register and spill lines of both builds; how many of the
base build's kernels have an identical SASS body in this build's
(``cuobjdump``, when present; kernel names differ when the code moved, so
bodies are matched, not names); then per shape the median, min and max
device time of each side over ``--rounds`` rounds, each round timing both
in turn (the base first in even rounds, this tree first in odd ones), with
``chip_smoke.py``'s CUDA-event timer and its weights cycled from HBM.
Shapes: internlm2-1.8b's projections at M = 2048 (prefill) and M = 4
(decode), and qwen3-moe-30b-a3b's attention and router projections.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import cycler, randn, time_ms  # noqa: E402
from repro_torch.core.hw import dtype_bytes  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.systolic.kernel import _ARGTYPES, DTYPE_CODES  # noqa: E402

SRC = os.path.join("src", "repro_torch", "csrc", "systolic_mmm.cu")
OUT_DIR = os.path.join(ROOT, "src", "repro_torch", "_build", "ab")
BF16, F32 = torch.bfloat16, torch.float32
# (M, K, N, out dtype)
SHAPES = [(m, k, n, BF16) for m in (2048, 4) for k, n in ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))]
SHAPES += [(m, k, n, BF16) for m in (2048, 4) for k, n in ((2048, 4096), (2048, 512), (4096, 2048))]
SHAPES += [(m, 2048, 128, F32) for m in (2048, 4)]


def build(tree: str, name: str) -> tuple[str, list[str]]:
    """Compile ``tree``'s systolic GEMM; returns the library and ptxas's lines."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"lib{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, os.path.join(tree, SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    return out, [ln.strip() for ln in log if "registers" in ln or "spill" in ln]


def sass_bodies(lib: str) -> dict[str, tuple[str, ...]] | None:
    """Each kernel's SASS without addresses and encodings, by name (None
    without cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    bodies: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            bodies[name] = []
        elif name is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*", line)
            if ins:
                bodies[name].append(ins.group(1))
    return {k: tuple(v) for k, v in bodies.items()}


class Lib:
    def __init__(self, path: str):
        self.lib = ctypes.CDLL(path)
        self.fn = self.lib.systolic_mmm
        self.fn.argtypes = _ARGTYPES["systolic_mmm"]
        self.fn.restype = ctypes.c_int
        self.lib.split_workspace.argtypes = [ctypes.c_int] * 4
        self.lib.split_workspace.restype = ctypes.c_longlong

    def caller(self, a, nxt, out, m, k, n):
        nbytes = self.lib.split_workspace(m, n, k, 1)
        ws = torch.empty(max(1, nbytes // 4), dtype=F32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        code_out = DTYPE_CODES[out.dtype]

        def call():
            rc = self.fn(a.data_ptr(), nxt().data_ptr(), None, out.data_ptr(), m, n, k, 1, code_out, 0,
                         ws.data_ptr() if nbytes else None, nbytes, stream)
            if rc:
                raise RuntimeError(f"systolic_mmm launch failed: CUDA error {rc}")

        return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--out", default=None, help="also write every reading to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_systolic: no CUDA device available", file=sys.stderr)
        return 2
    libs, report = {}, {"rounds": args.rounds}
    for side, tree in (("base", os.path.abspath(args.base)), ("change", ROOT)):
        path, ptxas = build(tree, side)
        libs[side] = Lib(path)
        report[f"ptxas_{side}"] = ptxas
        print(f"{side} ({tree}) ptxas:")
        for ln in ptxas:
            print(f"    {ln}")
        report[f"sass_{side}"] = sass_bodies(path)
    sb, sc = report.pop("sass_base"), report.pop("sass_change")
    if sb is None:
        print("SASS: cuobjdump not found, not compared")
    else:
        change_bodies = set(sc.values())
        same = [name for name, body in sb.items() if body in change_bodies]
        report["sass_identical"] = f"{len(same)} of {len(sb)}"
        print(f"SASS: {len(same)} of the base build's {len(sb)} kernels have an identical body in this build's "
              f"({len(sc)} kernels)")
        for name in sorted(set(sb) - set(same)):
            print(f"    differs: {name}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    report["shapes"] = []
    for m, k, n, out_dtype in SHAPES:
        a = randn((m, k), gen, BF16)
        copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
        nxt = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
        outs = {s: torch.empty((m, n), dtype=out_dtype, device="cuda") for s in libs}
        calls = {s: libs[s].caller(a, nxt, outs[s], m, k, n) for s in libs}
        iters = 50 if m <= 16 else 20
        times = {s: [] for s in libs}
        for r in range(args.rounds):
            for s in (("base", "change") if r % 2 == 0 else ("change", "base")):
                times[s].append(time_ms(calls[s], iters))
        b0 = nxt()
        for s in libs:  # one product on the same operands: bit-identical if the code is
            libs[s].caller(a, lambda: b0, outs[s], m, k, n)()
        torch.cuda.synchronize()
        same_out = torch.equal(outs["base"], outs["change"])
        med = {s: statistics.median(v) for s, v in times.items()}
        row = {"m": m, "k": k, "n": n, "out": str(out_dtype)[6:], "ms": times,
               "median_ms": med, "change_over_base": med["change"] / med["base"], "outputs_identical": same_out}
        report["shapes"].append(row)
        print(f"M={m:<5d} K={k:<5d} N={n:<5d} out={row['out']:8s} "
              + "  ".join(f"{s} median {med[s]:.4f} [{min(times[s]):.4f}, {max(times[s]):.4f}]" for s in libs)
              + f"  change/base {row['change_over_base']:.4f}" + ("" if same_out else "  (outputs differ)"))
    ratios = [r["change_over_base"] for r in report["shapes"]]
    print(f"change/base over {len(ratios)} shapes: median {statistics.median(ratios):.4f}, "
          f"min {min(ratios):.4f}, max {max(ratios):.4f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
