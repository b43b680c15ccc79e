#!/usr/bin/env python3
"""Time the collective matmul at internlm2-1.8b's sharded projections on the
cards of one host, one process a card (NCCL):

    torchrun --nproc-per-node 4 tools/tp_matmul_time.py [--tokens 2048 8192] [--out tp.json]

For each projection and M, on bf16 operands at the models' weight scale:
the overlapped ring (``distributed.collective_matmul``, tp ring steps of K1
with each hop issued before the step it hides under), ``overlap=False``
(all-gather then K1, or K1 then reduce-scatter), single-card K1 on the
whole problem, one ring step's K1 alone and one ring hop alone (the ring's
send / receive of one chunk) beside its NVLink bound; and the overlap ratio
t_hop / t_step, modeled (the card model's hop over every NVLink link and
step at the bf16 peak) and measured two ways: from these CUDA-event times
(the ring's time beyond tp measured steps, per hop, over a measured step)
and as the port's own ``collective.overlap_ratio{kind="measured"}`` gauge
reads it (a sampled host-clock window, over the modeled step).  Times are
medians of CUDA-event readings on rank 0, every rank running the same
calls in step.  One ring call is also traced (torch.profiler): the device
time of its K1 launches, of NCCL's kernels and of everything else, summed
per class over the streams, against the ring's own wall, so host time shows
as the wall no device work fills.  Rank 0 prints one row per projection and
M, after the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core import hw  # noqa: E402
from repro_torch.distributed import collective_matmul as cm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.systolic import ops as mm_ops  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.obs import metrics, profile  # noqa: E402

# internlm2-1.8b's sharded GEMMs in the tensor-parallel layout (distributed/tp_layout.py): (name, K, N, form)
GEMMS = (("wq", 2048, 2048, "allgather"), ("wk / wv", 2048, 1024, "allgather"),
         ("gate / up", 2048, 8192, "allgather"), ("wo", 2048, 2048, "reducescatter"),
         ("down", 8192, 2048, "reducescatter"))


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of ``fn`` on this rank, all ranks starting together."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def traced_us(fn) -> dict:
    """Device us of one traced call of ``fn`` by kernel class (K1, NCCL,
    the rest), summed over streams, and the call's host wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"k1": 0.0, "nccl": 0.0, "other": 0.0, "wall": wall * 1e6}
    for e in prof.key_averages():
        dev = e.self_device_time_total
        if dev <= 0 or e.device_type.name != "CUDA":
            continue
        name = e.key.lower()
        out["nccl" if "nccl" in name else "k1" if "mmm" in name or "wgmma" in name else "other"] += dev
    return out


def row(mesh: Mesh, name: str, m: int, k: int, n: int, form: str, reps: int, gen) -> dict:
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn((k, n), generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)
    if form == "allgather":
        a_loc, b_loc = a[idx * m // tp:(idx + 1) * m // tp], b[:, idx * n // tp:(idx + 1) * n // tp].contiguous()
        step = (a_loc, b_loc, torch.bfloat16)
        hop = a_loc
    else:
        a_loc, b_loc = a[:, idx * k // tp:(idx + 1) * k // tp].contiguous(), b[idx * k // tp:(idx + 1) * k // tp]
        step = (a_loc[:m // tp], b_loc, torch.float32)
        hop = torch.empty((m // tp, n), dtype=torch.float32, device="cuda")
    call = cm.all_gather_matmul if form == "allgather" else cm.reduce_scatter_matmul
    ring = cm._ring(mesh, "model", "plus")
    spare = torch.empty_like(hop)
    ms = {
        "ring": median_ms(lambda: call(a_loc, b_loc, mesh=mesh), reps),
        "no_overlap": median_ms(lambda: call(a_loc, b_loc, mesh=mesh, overlap=False), reps),
        "single_card": median_ms(lambda: mm_ops.matmul(a, b), reps),
        "step": median_ms(lambda: mm_ops.matmul(step[0], step[1], out_dtype=step[2]), reps),
        "hop": median_ms(lambda: ring.wait(ring.start(hop, spare)), reps),
    }
    hop_bytes = hop.numel() * hop.element_size()
    chip = hw.get_chip(None)
    t_hop, t_step = cm._hop_step_model(tp, m, n, k, torch.bfloat16, hop_bytes)
    # the port's own measured gauge: every call sampled
    metrics.reset()
    with profile.sampling(1.0):
        for _ in range(reps):
            call(a_loc, b_loc, mesh=mesh)
    gauges = metrics.get_registry().snapshot()["gauges"]
    exposed = max(0.0, ms["ring"] - tp * ms["step"]) / (tp - 1)
    traced = traced_us(lambda: call(a_loc, b_loc, mesh=mesh))
    return {"name": name, "form": form, "m": m, "k": k, "n": n, "tp": tp, **{f"{key}_ms": v for key, v in ms.items()},
            **{f"ring_traced_{key}_us": v for key, v in traced.items()},
            "hop_bytes": hop_bytes, "hop_bound_ms": hop_bytes / (chip.nvlink_bw_per_link * chip.nvlink_links) * 1e3,
            "step_bound_ms": t_step * 1e3, "overlap_ratio_modeled": t_hop / t_step,
            "overlap_ratio_measured_events": exposed / ms["step"],
            "overlap_ratio_measured_gauge": gauges.get(f'collective.overlap_ratio{{kind="measured",mode="{form}"}}')}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, nargs="+", default=[2048, 8192], help="M, the rows of A")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", timeout=datetime.timedelta(seconds=300))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if world < 2:
            raise SystemExit("one process a card, at least two: torchrun --nproc-per-node N tools/tp_matmul_time.py")
        if rank == 0:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
            print(smi)
            print(f"kernel build: {_build.build_all():.1f} s; {world} ranks, NCCL")
        dist.barrier()
        mesh = Mesh((world,), ("model",))
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = [row(mesh, name, m, k, n, form, args.reps, gen) for m in args.tokens for name, k, n, form in GEMMS]
        if rank == 0:
            for r in rows:
                print(f"{r['name']:9s} {r['form']:13s} M={r['m']:<5d} K={r['k']:<5d} N={r['n']:<5d} tp={r['tp']}: "
                      f"ring {r['ring_ms']:.4f}  overlap=False {r['no_overlap_ms']:.4f}  single card {r['single_card_ms']:.4f}"
                      f"  step {r['step_ms']:.4f} (bound {r['step_bound_ms']:.4f})  hop {r['hop_ms']:.4f} of "
                      f"{r['hop_bytes']:,} B (NVLink bound {r['hop_bound_ms']:.4f})  overlap ratio modeled "
                      f"{r['overlap_ratio_modeled']:.3f}, measured {r['overlap_ratio_measured_events']:.3f} (events) / "
                      f"{r['overlap_ratio_measured_gauge']} (gauge); one ring call traced: wall "
                      f"{r['ring_traced_wall_us']:.1f} us, device K1 {r['ring_traced_k1_us']:.1f} NCCL "
                      f"{r['ring_traced_nccl_us']:.1f} other {r['ring_traced_other_us']:.1f} us", flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
