"""Activation sharding annotations: the counterpart of ``repro.distributed.annotate``.

The reference's ``constrain(x, *axes)`` and ``constrain_pref`` hand GSPMD a
sharding hint inside the mesh context that ``annotations(mesh)`` opens, and
GSPMD inserts the collectives that realize it.  The port has no compiler to
hand a hint to: each process is one rank and already holds its local
shard, and the collectives are written out where the data moves
(``distributed.data_parallel``, ``distributed.tp_layout``).  What ports is
the choice the hint encodes: ``constrain_spec`` and ``constrain_pref_spec``
are pure functions of (shape, axes, mesh) that return the spec tuple the
reference would build (one entry per dimension: None, an axis name, or a
tuple of axis names).  ``constrain`` and ``constrain_pref`` return their
tensor unchanged.  No code path of the port reads this module: it is kept
so that the specs the reference's hints choose stay checked against the
reference (``tests/test_torch_data_parallel.py``); the layouts the port
runs come from ``distributed.sharding`` (the data-parallel trainer's batch
split is ``sharding.batch_specs``, the same ``("pod", "data")`` rule on
dim 0).

Axis names not in the mesh are dropped per dimension; a dimension that
does not divide its axes' size is left unsharded.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from repro_torch.launch.mesh import Mesh

_MESH = contextvars.ContextVar("repro_torch_annotation_mesh", default=None)

BATCH_AXES = ("pod", "data")


@contextlib.contextmanager
def annotations(mesh: Mesh):
    """The mesh ``current_mesh`` returns inside the context."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh() -> Mesh | None:
    return _MESH.get()


def _resolve(ax, mesh: Mesh):
    """-> (the spec entry for ``ax`` on ``mesh``: one name, a tuple of names
    or None, the product of those axes' sizes)."""
    if ax is None:
        return None, 1
    axes = ax if isinstance(ax, tuple) else (ax,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if not axes:
        return None, 1
    size = math.prod(mesh.shape[a] for a in axes)
    return (axes if len(axes) > 1 else axes[0]), size


def constrain_spec(shape: tuple[int, ...], axes: tuple, mesh: Mesh) -> tuple:
    """The spec ``constrain`` chooses: dimension i over ``axes[i]`` (extra
    axes past the rank ignored, missing ones None) where it divides."""
    spec = []
    for i, ax in enumerate(axes[: len(shape)]):
        name, size = _resolve(ax, mesh)
        spec.append(name if name is not None and shape[i] % size == 0 else None)
    return tuple(spec)


def constrain_pref_spec(shape: tuple[int, ...], batch_dim: int | None, candidates: tuple[int, ...],
                        mesh: Mesh) -> tuple:
    """The spec ``constrain_pref`` chooses: ``batch_dim`` over ("pod",
    "data") where it divides, and "model" on the first candidate dimension
    whose size divides the TP degree (the attention-internal rule: heads,
    else the query sequence)."""
    spec = [None] * len(shape)
    if batch_dim is not None:
        name, size = _resolve(BATCH_AXES, mesh)
        if name is not None and shape[batch_dim] % size == 0:
            spec[batch_dim] = name
    mname, msize = _resolve("model", mesh)
    if mname is not None:
        for c in candidates:
            if c < len(shape) and shape[c] % msize == 0:
                spec[c] = mname
                break
    return tuple(spec)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` unchanged.  The reference hints GSPMD to lay ``x`` out as
    ``constrain_spec`` says; on explicit ranks each process already holds
    its local shard, so there is nothing to move."""
    return x


def constrain_pref(x: torch.Tensor, batch_dim: int | None, candidates: tuple[int, ...]) -> torch.Tensor:
    """``x`` unchanged, as ``constrain``; its spec is ``constrain_pref_spec``."""
    return x
