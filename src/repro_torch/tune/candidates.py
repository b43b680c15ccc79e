"""Candidate generation: the analytical half of the DSE loop.

The counterpart of ``repro.tune.candidates``.  It mirrors the paper's flow:
enumerate geometries, run the "fitter" (``core.dse.explore``: a tile of the
kernel runs the geometry, shared memory and registers hold it), and hand only
the survivors to the measurement stage -- the paper pays hours of
place-and-route per survivor, we pay a timed launch.

The pruning stage additionally ranks survivors by their roofline bound and
keeps the top-K, because measuring every feasible shape is wasteful when the
model already tells us the tail is hopeless.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dse, hw


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One fitter-surviving geometry, ranked for measurement."""

    record: dse.DSERecord
    rank: int  # position in the analytical ranking (0 = analytical best)

    @property
    def block(self) -> tuple[int, int, int]:
        return (self.record.bm, self.record.bn, self.record.bk)

    @property
    def ident(self) -> str:
        return self.record.ident


def generate(
    m: int,
    n: int,
    k: int,
    *,
    dtype: str | None = None,
    in_dtype_bytes: int | None = None,
    chip: hw.GPU | str | None = None,
    bms=None,
    bns=None,
    bks=None,
    top_k: int | None = 8,
    backend: str = "cuda-systolic",
) -> list[Candidate]:
    """Fitter-pruned, analytically-ranked candidates for an (M, N, K) matmul.

    Returns at most ``top_k`` candidates (None = all survivors), ordered by
    the analytical roofline bound.  The axes default to the geometries
    ``backend``'s kernel runs on the problem (``dse.explore``); if nothing
    survives, the tile the untuned rule runs is the one candidate, so the
    tuner always has something to measure.  ``dtype`` sizes the streams and, for int8 /
    e4m3, prices the candidates against the 2x narrow peak with the scale
    sidecars' traffic, so int8 and bf16 tunings of one problem rank (and
    cache) apart.
    """
    chip = hw.get_chip(chip)
    records = dse.explore(
        m, n, k, bms=bms, bns=bns, bks=bks,
        in_dtype=dtype, in_dtype_bytes=in_dtype_bytes, chip=chip, backend=backend,
    )
    survivors = [r for r in records if r.fits]
    if not survivors:
        survivors = [_heuristic_record(m, n, k, dtype, in_dtype_bytes, chip, backend)]
    survivors.sort(key=lambda r: (r.analytical_us, -r.arithmetic_intensity))
    if top_k is not None:
        survivors = survivors[:top_k]
    return [Candidate(record=r, rank=i) for i, r in enumerate(survivors)]


def rule_block(m: int, n: int, k: int, dtype: str | None, backend: str = "cuda-systolic",
               chip: hw.GPU | str | None = None) -> tuple[str, tuple[int, int, int]]:
    """(path, (bm, bn, bk)) the kernel's untuned shape rule runs an (M, N, K)
    problem of ``dtype`` operands on, 16-byte aligned, on ``chip``'s SM
    count: ``gemm_path`` (the decode tile at ``plan_split``'s chunk),
    ``qgemm_path`` at 128-k scale blocks or ``grouped_path``; the
    ``reference`` backend has no rule of its own and takes the systolic
    GEMM's."""
    from repro_torch.kernels.grouped import kernel as gk
    from repro_torch.kernels.systolic import kernel as mm

    tdt = getattr(torch, dtype or "bfloat16")
    sms = hw.get_chip(chip).n_sm
    if backend == "cuda-grouped":
        path = gk.grouped_path(m, k, n, tdt, True)
        return path, gk.TILES[path]
    if dtype in dse.QUANT_DTYPES:
        step = dse._quant_block_k(dtype, None)
        path = mm.qgemm_path(m, n, k, step if step < k else 0, tdt, True)
        return path, mm.qtiles(tdt)[path]
    path = mm.gemm_path(m, n, k, tdt, True, sms)
    return path, mm.block_of(path, m, n, k, sms)


def _heuristic_record(m, n, k, dtype, in_dtype_bytes, chip, backend: str = "cuda-systolic") -> dse.DSERecord:
    """The untuned rule's tile as a degenerate candidate set: by construction
    the exact geometry the kernel would run untuned (``rule_block``)."""
    _, (bm, bn, bk) = rule_block(m, n, k, dtype, backend, chip)
    return dse.explore(m, n, k, bms=(bm,), bns=(bn,), bks=(bk,), in_dtype=dtype, in_dtype_bytes=in_dtype_bytes,
                       chip=chip, backend=backend)[0]
