#!/usr/bin/env python3
"""How long spawned ranks take to start, with their arguments in the spawn's pipe or in a file.

    python3 tools/spawn_startup.py [--world 2 4] [--mb 8] [--repeats 3] [--load 0]

``launch.mesh.run_ranks`` starts one spawned process a rank.  A spawn's
``Process.start()`` writes the pickled process object -- its target and
its arguments -- into a pipe the child reads, and blocks once the pipe's
buffer (64 KiB on Linux) is full until the child reads on, which it does
only after importing the target's module.  So arguments larger than the
buffer start the ranks one after another, each start waiting for one
child's imports.  This script times both ways on the CPU, for each world
size: ``pipe`` passes ``--mb`` MB of float32 values as a process argument;
``file`` (what ``run_ranks`` does) saves them to a file each child loads
after its imports.  Before them each child unpickles a
``train.loop.TrainConfig``, whose module imports most of ``repro_torch``
(and torch), as a rank unpickles its body from a test module.  A reading
is the seconds from the first ``start()`` until the last child has loaded
the arguments (the median of ``--repeats``).  ``--load N`` runs N busy
processes meanwhile, as a loaded host (a test suite's workers) would.
Needs no card.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))  # the children inherit it


def _child(t0: float, q, heavy, data, path: str | None) -> None:
    import torch

    if path is not None:
        data = torch.load(path, weights_only=False)
    q.put(time.time() - t0 if data is not None else -1.0)


def _busy(stop) -> None:
    while not stop.is_set():
        sum(i * i for i in range(10000))


def start_seconds(world: int, mb: float, how: str, tmp: str) -> float:
    """Seconds until the last of ``world`` children has its arguments."""
    import numpy as np
    import torch

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    data = np.zeros(int(mb * 2**20) // 4, dtype=np.float32)
    path = None
    if how == "file":
        path = os.path.join(tmp, "args.pt")
        torch.save(data, path)
        data = None
    from repro_torch.train.loop import TrainConfig

    t0 = time.time()
    procs = [ctx.Process(target=_child, args=(t0, q, TrainConfig(), data, path)) for _ in range(world)]
    for p in procs:
        p.start()
    got = [q.get(timeout=300) for _ in procs]
    for p in procs:
        p.join()
    return max(got)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--load", type=int, default=0, help="busy processes running meanwhile")
    args = ap.parse_args()
    ctx = multiprocessing.get_context("spawn")
    stop = ctx.Event()
    burners = [ctx.Process(target=_busy, args=(stop,)) for _ in range(args.load)]
    for b in burners:
        b.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for world in args.world:
                for how in ("pipe", "file"):
                    runs = [start_seconds(world, args.mb, how, tmp) for _ in range(args.repeats)]
                    print(f"world {world} args {args.mb:g} MB through the {how}: start-up {statistics.median(runs):.2f} s "
                          f"(runs {[round(r, 2) for r in runs]}, {args.load} busy processes, {os.cpu_count()} CPUs)")
    finally:
        stop.set()
        for b in burners:
            b.join()


if __name__ == "__main__":
    main()
