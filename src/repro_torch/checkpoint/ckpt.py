"""Checkpoints of the port's trees: npz per host, atomic save, async writer.

The counterpart of ``repro.checkpoint.ckpt``, with the same contract:
  * save is ATOMIC: a checkpoint is written into ``step_<n>.tmp`` and
    renamed; it is complete iff its DONE marker exists, and only complete
    checkpoints are resumed from, so a crash mid-write never corrupts a
    resume point;
  * save is ASYNC: the leaves are copied to host memory on the caller's
    thread, then written on a worker thread, off the training loop
    (``AsyncCheckpointer``);
  * restore fills a template: its structure, and each leaf's dtype and
    device; restore is ELASTIC: leaves are saved whole (a data-parallel
    trainer gathers its moment blocks first and rank 0 writes), and
    ``shardings`` cuts each rank's block out of them on restore, so a job
    saved on one data-parallel mesh resumes on another (one rank included);
  * step resume: the step is part of the checkpoint; the data pipeline is
    stateless (``batch_at(step)``).
Leaves are keyed by their tree path (``core.tree.leaves_with_path``: dict
keys, list indices and dataclass fields joined by "/"); bf16 leaves are
stored widened to fp32 (exact; numpy has no bf16) and cast back on restore.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_path, unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()  # a snapshot: the trainer steps its tensors in place
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in leaves_with_path(tree)}


def _lookup(tree: Any, path: str):
    """The entry of ``tree`` at ``path`` ("/"-joined keys, indices and
    fields), or None where the walk meets None."""
    for part in path.split("/"):
        if tree is None:
            return None
        if isinstance(tree, dict):
            tree = tree[part]
        elif isinstance(tree, list):
            tree = tree[int(part)]
        else:
            tree = getattr(tree, part)
    return tree


def _unflatten_into(tree: Any, blobs: dict[str, np.ndarray], shardings: Any = None) -> Any:
    out = []
    for key, leaf in leaves_with_path(tree):
        if key not in blobs:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = torch.from_numpy(np.array(blobs[key]))
        cut = None if shardings is None else _lookup(shardings, key)
        if cut is not None:
            t = cut(t)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != expected {tuple(leaf.shape)}")
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return unflatten(tree, out)


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _write(root: str, step: int, blobs: dict[str, np.ndarray], host: int) -> str:
    d = _ckpt_dir(root, step)
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"host_{host:05d}.npz"), **blobs)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(blobs)}, f)
    if os.path.exists(d):  # idempotent: step already saved
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, d)
    with open(os.path.join(d, "DONE"), "w") as f:
        f.write("ok")
    return d


def save_checkpoint(root: str, step: int, tree: Any, *, host: int = 0) -> str:
    """Blocking save.  Returns the checkpoint directory."""
    return _write(root, step, _flatten(tree), host)


def _complete_steps(root: str) -> list[int]:
    return sorted(
        int(name.split("_")[1])
        for name in os.listdir(root)
        if name.startswith("step_") and not name.endswith(".tmp") and os.path.exists(os.path.join(root, name, "DONE"))
    )


def latest_step(root: str) -> int | None:
    """Newest COMPLETE checkpoint step, or None."""
    if not os.path.isdir(root):
        return None
    steps = _complete_steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(root: str, template: Any, *, step: int | None = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``template``, each leaf in the
    template leaf's dtype and on its device.  ``shardings``: a tree of the
    template's structure (None standing for a subtree restored whole) whose
    leaves cut this rank's block out of a whole leaf
    (``ZeroLayout.shardings``); the template then holds the blocks' shapes.
    -> (tree, step)."""
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = _ckpt_dir(root, step)
    blobs: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                blobs.update({k: z[k] for k in z.files})
    return _unflatten_into(template, blobs, shardings), step


class AsyncCheckpointer:
    """Fire-and-forget background saver (one write in flight at a time)."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()  # one outstanding write; the device -> host copy happens on the caller's thread
        blobs = _flatten(tree)

        def _run():
            try:
                _write(self.root, step, blobs, 0)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _complete_steps(self.root)[: -self.keep]:
            shutil.rmtree(_ckpt_dir(self.root, s), ignore_errors=True)
