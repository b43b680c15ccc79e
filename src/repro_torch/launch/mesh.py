"""Meshes of ranks: the counterpart of ``repro.launch.mesh``.

A ``Mesh`` knows its shape and axis names and nothing else until it is
asked for a process group, so the sharding specs (``distributed.sharding``)
are computed and tested in one process.  Once ``torch.distributed`` is
initialized -- one process per rank, ``torchrun --nproc-per-node N``; NCCL
with one card a rank, Gloo on the CPU -- ``mesh.group("model")`` is the
process group of the ranks that share this rank's other coordinates, and
``mesh.axis_index("model")`` its place on that axis.  Global rank r sits at
the row-major coordinates of r in the mesh's shape, as a JAX mesh lays its
devices out.

Mesh layouts (the reference's, DESIGN.md §4):
  single-pod: (16, 16)      axes ("data", "model")
  multi-pod:  (2, 16, 16)   axes ("pod", "data", "model")
  local:      (data, model) over the ranks this job runs
"""

from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import time
import traceback

import torch
import torch.distributed as dist


class Mesh:
    """A logical mesh: ``shape`` maps each axis name to its size, in order."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names) or any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        self._groups: dict[str, object] = {}

    def __repr__(self) -> str:
        return f"Mesh({tuple(self.shape.values())}, {self.axis_names})"

    def coords(self, rank: int) -> dict[str, int]:
        """The axis coordinates of global rank ``rank`` (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def axis_ranks(self, axis: str | tuple[str, ...], rank: int) -> list[int]:
        """The global ranks on ``axis`` through ``rank``, in axis order (a
        tuple of axes: the ranks sharing ``rank``'s other coordinates,
        row-major over those axes)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        c = self.coords(rank)
        out = []
        for i in range(math.prod(self.shape[a] for a in axes)):
            at = {}
            for a in reversed(axes):
                i, at[a] = divmod(i, self.shape[a])
            out.append(self.rank_of({**c, **at}))
        return out

    def axis_index(self, axis: str) -> int:
        """This process's coordinate on ``axis`` (0 without a process group)."""
        return self.coords(dist.get_rank())[axis] if dist.is_initialized() else 0

    def group(self, axis: str | tuple[str, ...]):
        """The process group of this rank's line along ``axis`` (a tuple of
        axes: the ranks sharing its other coordinates; the whole world when
        the axes span it).  Every rank must make its first call for an axis
        together: ``new_group`` is collective."""
        if axis not in self._groups:
            if not dist.is_initialized():
                raise RuntimeError(f"mesh axis {axis!r}: torch.distributed is not initialized")
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(f"{self!r} needs {self.size} ranks; this job runs {world}")
            axes = (axis,) if isinstance(axis, str) else tuple(axis)
            if math.prod(self.shape[a] for a in axes) == world:
                self._groups[axis] = dist.group.WORLD
            else:
                mine = None
                for r in range(world):  # every line, in the same order on every rank
                    ranks = self.axis_ranks(axis, r)
                    if ranks[0] != r:
                        continue
                    g = dist.new_group(ranks)
                    if dist.get_rank() in ranks:
                        mine = g
                self._groups[axis] = mine
        return self._groups[axis]


def _fix(model: int, n: int) -> str:
    return (f"start one process per rank on a host with {n} card(s): torchrun --nproc-per-node {n} -m "
            f"repro_torch.launch.serve --model-parallel {model} ..., or to train torchrun --nproc-per-node {n} -m "
            f"repro_torch.launch.train --distributed ... (on the CPU add --device cpu, which takes Gloo)")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout, as a logical mesh (its specs)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh(data: int = 1, model: int = 1, device: str | torch.device | None = None) -> Mesh:
    """A (data, model) mesh over the ranks of this job, one card a rank on
    ``device`` "cuda" (the default).  Asking for more ranks than the job
    runs, or more cards than are visible, raises a message naming the fix;
    it never falls back to a smaller mesh."""
    want = data * model
    have = dist.get_world_size() if dist.is_initialized() else 1
    if want > have:
        raise ValueError(f"requested a {data}x{model} ('data', 'model') mesh but this job runs {have} process(es); "
                         + _fix(model, want))
    if torch.device("cuda" if device is None else device).type == "cuda":
        cards = torch.cuda.device_count()
        if want > cards:
            raise ValueError(f"requested a {data}x{model} ('data', 'model') mesh but only {cards} card(s) are "
                             f"visible; " + _fix(model, want))
    return Mesh((data, model), ("data", "model"))


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes the global batch shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Mesh, name: str) -> int:
    if name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


# ---------------------------------------------------------------------------
# Ranks on one host, without a launcher
# ---------------------------------------------------------------------------


# The ranks' start-up (spawn, imports, arguments loaded): seconds to tens of seconds on a loaded host.
START_TIMEOUT_S = 300.0


def _rank_main(fn, rank: int, world: int, backend: str, workdir: str, timeout_s: float, ready, go) -> None:
    try:
        args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
        ready.put(rank)  # imported (``fn`` unpickled, ``args`` loaded): this rank has started
        if not go.wait(START_TIMEOUT_S):
            raise TimeoutError(f"rank {rank}: the other ranks did not start within {START_TIMEOUT_S} s")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(workdir, "store"), world), rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(workdir, f"result-{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def _await_start(procs: list, ready) -> tuple[float, list[int]]:
    """Wait until every rank has started or one has exited -> (the seconds
    it took, the ranks not started)."""
    t0 = time.monotonic()
    started: set[int] = set()
    while len(started) < len(procs) and time.monotonic() - t0 < START_TIMEOUT_S:
        try:
            started.add(ready.get(timeout=0.05))
        except queue.Empty:
            if any(p.exitcode is not None for r, p in enumerate(procs) if r not in started):
                break
    return time.monotonic() - t0, [r for r in range(len(procs)) if r not in started]


def run_ranks(fn, world: int, workdir: str, *, backend: str = "gloo", args: tuple = (),
              timeout_s: float = 60.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, each a rank
    of a ``backend`` process group that rendezvous through a file in
    ``workdir`` (no port to pick); -> the ranks' return values, in rank
    order.  ``args`` reach the ranks through a file in ``workdir``, not the
    spawn's pipe: a start blocks on a pipe holding more than its buffer
    until the child has imported ``fn``'s module, which would start the
    ranks one after another.  The ranks' start-up (the spawn, the imports,
    ``args`` loaded) has its own limit, ``START_TIMEOUT_S``: on a loaded
    host it takes seconds to tens of seconds, and no rank joins the process
    group before every rank has started.  From then on each collective
    times out after ``timeout_s``, and so does the whole run: a rank that
    raises, exits or hangs fails it with the ranks' tracebacks, and every
    process is stopped before this returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    ready, go = ctx.Queue(), ctx.Event()
    torch.save(args, os.path.join(workdir, "args.pt"))
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, workdir, timeout_s, ready, go))
             for r in range(world)]
    for p in procs:
        p.start()
    start_s, late = _await_start(procs, ready)
    hung: list[int] = []
    if not late:
        go.set()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errors = []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"error-{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0 and r not in hung and r not in late:
            errors.append(f"rank {r}: exit code {p.exitcode}")
    if late or hung or errors:
        raise RuntimeError(f"{world} ranks: "
                           + (f"ranks {late} not started after {start_s:.1f} s (limit {START_TIMEOUT_S} s); "
                              if late else "")
                           + (f"ranks {hung} still running {timeout_s} s after all {world} started "
                              f"(start-up {start_s:.1f} s); " if hung else "")
                           + "\n".join(errors))
    return [torch.load(os.path.join(workdir, f"result-{r}.pt"), weights_only=False) for r in range(world)]
