#!/usr/bin/env python3
"""Time the port's GEMM and attention kernels of this checkout against another checkout's, in one process.

Run from the root of the repository on a machine with the card and nvcc:

    python3 tools/ab_systolic.py --base <root of another checkout> [--rounds 9] [--out ab.json]

Both trees' ``systolic_mmm.cu`` (K1), ``grouped_mmm.cu`` (K4),
``flash_attn.cu`` (K3) and ``systolic_qmm.cu`` (K5, the block-scaled int8 GEMM)
under ``src/repro_torch/csrc/`` are built with this
tree's nvcc flags into ``src/repro_torch/_build/ab/`` and loaded side by side
through their C entry points (ctypes keeps each library's symbols local).
Printed: ptxas's register and spill lines of every build; per source, how many
of the base build's kernels have an identical SASS body in this build's
(``cuobjdump``, when present; kernel names differ when the code moved, so
bodies are matched, not names); then per shape the median, min and max
device time of each side over ``--rounds`` rounds, each round timing both in
turn (the base first in even rounds, this tree first in odd ones), with
``chip_smoke.py``'s CUDA-event timer and its weights cycled from HBM, and
whether the two sides' outputs on the same operands are bit-identical.
Shapes: internlm2-1.8b's projections at M = 2048 (prefill) and M = 4
(decode), on K1 in bf16 and on K5 in int8 (128-k scale blocks, bf16 out, as
w8a8 serves them), qwen3-moe-30b-a3b's attention and router projections, its
expert GEMMs at prefill and decode capacity (all rows), and both models'
prefill attention.

The entry points' signatures are read from each tree's source, so either
side may predate this tree: a systolic entry without a ``path`` argument
picks its tile itself (this tree passes the path ``gemm_path`` picks, and,
where the entry takes a ``k_chunk``, 0: the rule's split-K), a
grouped entry without ``rows`` and ``path`` picks its tile itself (this tree
passes ``grouped_path``'s and no rows), a block-scaled entry without
``path`` (which reads B row-major) is given the int8 weight row-major while
one with it (which reads B only K-major) is given the same values K-major
(``quant.k_major``, as w8a8 serves them) and the path ``qgemm_path`` picks,
so the bit-equality of the K5 rows holds the K-major kernel to the
row-major one, and a flash entry over (BH, S, D) is
given contiguous K/V repeated to the query heads while the head-aware entry
is given the model's (B, S, H, D) layout with K/V at the model's KV heads.
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
from repro_torch import quant  # noqa: E402
from repro_torch.core.hw import dtype_bytes  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.grouped import kernel as grouped_kernel  # noqa: E402
from repro_torch.kernels.systolic import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.systolic.kernel import DTYPE_CODES, PATHS, gemm_path  # noqa: E402

CSRC = os.path.join("src", "repro_torch", "csrc")
OUT_DIR = os.path.join(ROOT, "src", "repro_torch", "_build", "ab")
SOURCES = ("systolic_mmm", "grouped_mmm", "flash_attn", "systolic_qmm")
BF16, F32 = torch.bfloat16, torch.float32
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# systolic (M, K, N, out dtype)
SHAPES = [(m, k, n, BF16) for m in (2048, 4) for k, n in ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))]
SHAPES += [(m, k, n, BF16) for m in (2048, 4) for k, n in ((2048, 4096), (2048, 512), (4096, 2048))]
SHAPES += [(m, 2048, 128, F32) for m in (2048, 4)]
GROUPED_SHAPES = [(128, c, k, n) for c in (160, 8) for k, n in ((2048, 768), (768, 2048))]  # (E, C, K, N)
QGEMM_SHAPES = [(m, k, n) for m in (2048, 4) for k, n in ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))]
FLASH_SHAPES = [(4, 512, 16, 8, 128), (4, 512, 32, 4, 128)]  # (B, S, H, Hkv, D), causal


def build(tree: str, name: str, side: str) -> tuple[str, list[str]]:
    """Compile ``tree``'s ``csrc/<name>.cu``; returns the library and ptxas's lines."""
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"lib{name}-{side}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, os.path.join(tree, CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name} ({side}) failed:\n{proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    return out, [ln.strip() for ln in log if "registers" in ln or "spill" in ln]


def n_params(tree: str, source: str, func: str) -> int:
    """The number of parameters of ``extern "C" int <func>(...)`` in the tree's ``csrc/<source>.cu``."""
    src = open(os.path.join(tree, CSRC, f"{source}.cu")).read()
    sig = re.search(r'extern "C" int ' + func + r"\(([^)]*)\)", src).group(1)
    return sig.count(",") + 1


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


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def checked(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


class Side:
    """One tree's four libraries, bound by the signatures in its source."""

    def __init__(self, tree: str, paths: dict[str, str]):
        self.systolic = ctypes.CDLL(paths["systolic_mmm"])
        mm_params = n_params(tree, "systolic_mmm", "systolic_mmm")
        self.with_path = mm_params >= 14
        self.k_chunk = [0] if mm_params == 15 else []  # the decode tile's contraction per block: the rule's
        self.mm = self.systolic.systolic_mmm
        self.mm.argtypes = [_P, _P, _P, _P, *[_I] * (6 + self.with_path + len(self.k_chunk)), _P, _LL, _P]
        self.mm.restype = _I
        self.systolic.split_workspace.argtypes = [_I] * (4 + len(self.k_chunk))
        self.systolic.split_workspace.restype = _LL
        self.gm_paths = n_params(tree, "grouped_mmm", "grouped_mmm") == 11
        self.gm = ctypes.CDLL(paths["grouped_mmm"]).grouped_mmm
        self.gm.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, *([_P, _I] if self.gm_paths else []), _P]
        self.gm.restype = _I
        qlib = ctypes.CDLL(paths["systolic_qmm"])
        self.q_kmajor = n_params(tree, "systolic_qmm", "systolic_qmm") == 17  # with `path`: B K-major
        self.qm = qlib.systolic_qmm
        self.qm.argtypes = [_P] * 5 + [_I] * (9 if self.q_kmajor else 8) + [_P, _LL, _P]
        self.qm.restype = _I
        qlib.split_workspace.argtypes = [_I] * (4 + len(self.k_chunk))
        qlib.split_workspace.restype = _LL
        self.q_ws = qlib.split_workspace
        self.head_aware = n_params(tree, "flash_attn", "flash_attn_fwd") > 14
        self.fa_lse = [None] if n_params(tree, "flash_attn", "flash_attn_fwd") > 25 else []  # the lse output, unused
        self.fa = ctypes.CDLL(paths["flash_attn"]).flash_attn_fwd
        self.fa.argtypes = ([_P] * (4 + len(self.fa_lse)) + [_I] * 6 + [_LL] * 9 + [ctypes.c_float, _I, _I, _I, _I, _P]
                            if self.head_aware else [_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, _I, _I, _I, _P])
        self.fa.restype = _I

    def gemm(self, a, nxt, out, m, k, n):
        nbytes = self.systolic.split_workspace(m, n, k, 1, *self.k_chunk)
        ws = torch.empty(max(1, nbytes // 4), dtype=F32, device="cuda")
        code_out = DTYPE_CODES[out.dtype]
        path = [PATHS.index(gemm_path(m, n, k, BF16, True, torch.cuda.get_device_properties(0).multi_processor_count))]

        def call():
            checked(self.mm(a.data_ptr(), nxt().data_ptr(), None, out.data_ptr(), m, n, k, 1, code_out, 0,
                            *(path if self.with_path else []), *self.k_chunk, ws.data_ptr() if nbytes else None,
                            nbytes, stream()),
                    "systolic_mmm")

        return call

    def grouped(self, x, nxt, y, e, c, k, n):
        path = [None, grouped_kernel.PATHS.index(grouped_kernel.grouped_path(c, k, n, BF16, True))]

        def call():
            checked(self.gm(x.data_ptr(), nxt().data_ptr(), y.data_ptr(), e, c, k, n, DTYPE_CODES[BF16],
                            *(path if self.gm_paths else []), stream()), "grouped_mmm")

        return call

    def qgemm(self, qa, nxt, out, m, k, n):
        """int8, 128-k scale blocks, bf16 out; ``nxt()`` gives (row-major QArray, its K-major twin)."""
        nbytes = self.q_ws(m, n, k, 1, *self.k_chunk)
        ws = torch.empty(max(1, nbytes // 4), dtype=F32, device="cuda")
        a_s = qa.scales.contiguous()
        path = mm_kernel.QPATHS.index(mm_kernel.qgemm_path(m, n, k, 128, torch.int8, True))

        def call():
            row, kmaj = nxt()
            b = kmaj if self.q_kmajor else row
            checked(self.qm(qa.values.data_ptr(), a_s.data_ptr(), b.values.data_ptr(), b.scales.data_ptr(),
                            out.data_ptr(), m, n, k, 128, 128, 0, DTYPE_CODES[BF16], 0,
                            *([path] if self.q_kmajor else []), ws.data_ptr() if nbytes else None, nbytes,
                            stream()), "systolic_qmm")

        return call

    def flash(self, q, k, v, o, b, s, h, hkv, d):
        """q (B, S, H, D), k/v (B, S, Hkv, D) contiguous, o (B, S, H, D); the
        (BH, S, D) entry gets its own contiguous copies, K/V repeated."""
        scale = d**-0.5
        if self.head_aware:
            strides = [*(q.stride()[:3]), *(k.stride()[:3]), *(v.stride()[:3])]

            def call():
                checked(self.fa(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *self.fa_lse, b, h, hkv, s, s,
                                d, *strides,
                                scale, 1, 0, s, DTYPE_CODES[BF16], stream()), "flash_attn_fwd")

            return call, lambda: o
        rep = h // hkv
        qb = q.transpose(1, 2).reshape(b * h, s, d).contiguous()
        kb, vb = (t.repeat_interleave(rep, dim=2).transpose(1, 2).reshape(b * h, s, d).contiguous() for t in (k, v))
        ob = torch.empty_like(qb)

        def call():
            checked(self.fa(qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), ob.data_ptr(), b * h, s, s, d, scale, 1, 0, s,
                            DTYPE_CODES[BF16], stream()), "flash_attn_fwd")

        return call, lambda: ob.reshape(b, h, s, d).transpose(1, 2)


def alternate(calls: dict, rounds: int, iters: int) -> dict:
    times = {s: [] for s in calls}
    for r in range(rounds):
        for s in (("base", "change") if r % 2 == 0 else ("change", "base")):
            times[s].append(time_ms(calls[s], iters))
    return times


def row_of(label: str, times: dict, same: bool, extra: str = "") -> dict:
    med = {s: statistics.median(v) for s, v in times.items()}
    ratio = med["change"] / med["base"]
    print(f"{label} " + "  ".join(f"{s} median {med[s]:.4f} [{min(times[s]):.4f}, {max(times[s]):.4f}]" for s in times)
          + f"  change/base {ratio:.4f}" + ("" if same else "  (outputs differ)") + extra, flush=True)
    return {"ms": times, "median_ms": med, "change_over_base": ratio, "outputs_identical": same}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout to compare against")
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--out", default=None, help="also write every reading to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_systolic: no CUDA device available", file=sys.stderr)
        return 2
    trees = {"base": os.path.abspath(args.base), "change": ROOT}
    report = {"rounds": args.rounds, "device": torch.cuda.get_device_name(0)}
    libs = {side: {} for side in trees}
    for name in SOURCES:
        sass = {}
        for side, tree in trees.items():
            path, ptxas = build(tree, name, side)
            libs[side][name] = path
            report[f"ptxas_{name}_{side}"] = ptxas
            print(f"{name} {side} ({tree}) ptxas:")
            for ln in ptxas:
                print(f"    {ln}")
            sass[side] = sass_bodies(path)
        if sass["base"] is None:
            print(f"{name} SASS: cuobjdump not found, not compared")
            continue
        change_bodies = set(sass["change"].values())
        same = [k for k, body in sass["base"].items() if body in change_bodies]
        report[f"sass_identical_{name}"] = f"{len(same)} of {len(sass['base'])}"
        print(f"{name} SASS: {len(same)} of the base build's {len(sass['base'])} kernels have an identical body in "
              f"this build's ({len(sass['change'])} kernels)")
        for k in sorted(set(sass["base"]) - set(same)):
            print(f"    differs: {k}")
    sides = {side: Side(trees[side], libs[side]) for side in trees}

    gen = torch.Generator(device="cuda").manual_seed(0)
    report["shapes"] = []
    for m, k, n, out_dtype in SHAPES:
        a = randn((m, k), gen, BF16)
        copies = max(1, math.ceil(150e6 / (k * n * dtype_bytes(BF16))))
        nxt = cycler([randn((k, n), gen, BF16) for _ in range(copies)])
        outs = {s: torch.empty((m, n), dtype=out_dtype, device="cuda") for s in sides}
        times = alternate({s: sides[s].gemm(a, nxt, outs[s], m, k, n) for s in sides}, args.rounds,
                          50 if m <= 16 else 20)
        b0 = nxt()
        for s in sides:  # one product on the same operands: bit-identical if the code is
            sides[s].gemm(a, lambda: b0, outs[s], m, k, n)()
        torch.cuda.synchronize()
        row = row_of(f"systolic M={m:<5d} K={k:<5d} N={n:<5d} out={str(out_dtype)[6:]:8s}", times,
                     torch.equal(outs["base"], outs["change"]))
        report["shapes"].append({"kernel": "systolic_mmm", "m": m, "k": k, "n": n, "out": str(out_dtype)[6:], **row})
    for e, c, k, n in GROUPED_SHAPES:
        x = randn((e, c, k), gen, BF16)
        copies = max(1, math.ceil(150e6 / (e * k * n * dtype_bytes(BF16))))
        nxt = cycler([randn((e, k, n), gen, BF16) for _ in range(copies)])
        ys = {s: torch.empty((e, c, n), dtype=BF16, device="cuda") for s in sides}
        times = alternate({s: sides[s].grouped(x, nxt, ys[s], e, c, k, n) for s in sides}, args.rounds, 10)
        w0 = nxt()
        for s in sides:
            sides[s].grouped(x, lambda: w0, ys[s], e, c, k, n)()
        torch.cuda.synchronize()
        row = row_of(f"grouped E={e} C={c:<4d} K={k:<5d} N={n:<5d}", times, torch.equal(ys["base"], ys["change"]))
        report["shapes"].append({"kernel": "grouped_mmm", "e": e, "c": c, "k": k, "n": n, **row})
    for m, k, n in QGEMM_SHAPES:
        qa = quant.quantize_act(randn((m, k), gen, F32))
        qbs = [quant.quantize_weight(randn((k, n), gen, F32)) for _ in range(math.ceil(150e6 / (k * n)))]
        nxt = cycler([(qb, quant.k_major({"w": qb})["w"]) for qb in qbs])
        outs = {s: torch.empty((m, n), dtype=BF16, device="cuda") for s in sides}
        times = alternate({s: sides[s].qgemm(qa, nxt, outs[s], m, k, n) for s in sides}, args.rounds,
                          50 if m <= 16 else 20)
        pair = nxt()
        for s in sides:  # one product on the same values: bit-identical if the int8 arithmetic is
            sides[s].qgemm(qa, lambda: pair, outs[s], m, k, n)()
        torch.cuda.synchronize()
        row = row_of(f"qgemm int8 M={m:<5d} K={k:<5d} N={n:<5d}", times, torch.equal(outs["base"], outs["change"]))
        report["shapes"].append({"kernel": "systolic_qmm", "m": m, "k": k, "n": n, **row})
    for b, s_len, h, hkv, d in FLASH_SHAPES:
        q = randn((b, s_len, h, d), gen, BF16)
        k, v = (randn((b, s_len, hkv, d), gen, BF16) for _ in range(2))
        outs = {s: torch.empty_like(q) for s in sides}
        calls, results = {}, {}
        for s in sides:
            calls[s], results[s] = sides[s].flash(q, k, v, outs[s], b, s_len, h, hkv, d)
        times = alternate(calls, args.rounds, 20)
        for s in sides:
            calls[s]()
        torch.cuda.synchronize()
        diff = (results["base"]().float() - results["change"]().float()).abs().max().item()
        row = row_of(f"flash B={b} S={s_len} H={h}/{hkv} D={d} causal", times, diff == 0.0,
                     f"  max |base - change| {diff:.3e}")
        report["shapes"].append({"kernel": "flash_attn", "b": b, "s": s_len, "h": h, "hkv": hkv, "d": d,
                                 "max_abs_diff": diff, **row})
    for kernel in ("systolic_mmm", "grouped_mmm", "systolic_qmm", "flash_attn"):
        ratios = [r["change_over_base"] for r in report["shapes"] if r["kernel"] == kernel]
        print(f"{kernel} change/base over {len(ratios)} shapes: median {statistics.median(ratios):.4f}, "
              f"min {min(ratios):.4f}, max {max(ratios):.4f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
