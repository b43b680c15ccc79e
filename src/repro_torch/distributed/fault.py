"""Fault tolerance at the job level: the counterpart of ``repro.distributed.fault``.

The failure modes that matter across many cards are a card or host dying
(the job aborts and restarts from its checkpoint), a loss of cards (the
restart runs on a smaller mesh) and transient runtime errors.

  Heartbeat        a liveness file per host, written atomically; a watchdog
                   treats a stale one as a dead worker (the reference's
                   file name and JSON, so either package reads the other's).
  restart_loop     a supervisor that re-invokes a job after a failure, with
                   exponential backoff; the job resumes from the newest
                   complete checkpoint (the DONE-marker protocol of
                   ``checkpoint/ckpt.py``).
  elastic_meshes   the downsize ladder (2, 16, 16) -> (16, 16) -> (8, 16)
                   -> (4, 16), and ``pick_mesh_for`` the largest rung that
                   fits the live card count, else pure data parallelism
                   (n, 1).  A checkpoint holds whole leaves, so a restore
                   onto any of these meshes cuts each rank's shards out of
                   them (``restore_checkpoint(shardings=...)``).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable

from repro_torch.launch.mesh import Mesh


class Heartbeat:
    def __init__(self, path: str, host: int = 0):
        self.file = os.path.join(path, f"heartbeat_{host:05d}.json")
        os.makedirs(path, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": time.time(), "step": step}, f)
        os.replace(tmp, self.file)

    @staticmethod
    def stale_hosts(path: str, timeout_s: float = 300.0) -> list[int]:
        """The hosts whose last beat is older than ``timeout_s``, sorted."""
        now = time.time()
        dead = []
        if not os.path.isdir(path):
            return dead
        for name in os.listdir(path):
            if not name.startswith("heartbeat_") or name.endswith(".tmp"):
                continue
            with open(os.path.join(path, name)) as f:
                info = json.load(f)
            if now - info["t"] > timeout_s:
                dead.append(int(name.split("_")[1].split(".")[0]))
        return sorted(dead)


def elastic_meshes() -> list[tuple[tuple[int, ...], tuple[str, ...]]]:
    """The downsize ladder a restarted job walks until a mesh fits the
    surviving card count."""
    return [
        ((2, 16, 16), ("pod", "data", "model")),
        ((16, 16), ("data", "model")),
        ((8, 16), ("data", "model")),
        ((4, 16), ("data", "model")),
    ]


def pick_mesh_for(n_devices: int) -> Mesh:
    """The largest ladder mesh that fits ``n_devices``, else pure data
    parallelism over all of them."""
    for shape, axes in elastic_meshes():
        if math.prod(shape) <= n_devices:
            return Mesh(shape, axes)
    return Mesh((n_devices, 1), ("data", "model"))


def restart_loop(job: Callable[[int], None], *, max_restarts: int = 3, backoff_s: float = 1.0) -> int:
    """Run ``job(attempt)``; after a failure wait ``backoff_s * 2**attempt``
    and run it again, up to ``max_restarts`` times, then re-raise.  The job
    resumes from its checkpoint itself (``Trainer.try_resume``).  -> the
    number of restarts consumed."""
    for attempt in range(max_restarts + 1):
        try:
            job(attempt)
            return attempt
        except Exception:
            if attempt == max_restarts:
                raise
            time.sleep(backoff_s * (2**attempt))
    return max_restarts  # pragma: no cover
