"""Design-space exploration over block shapes -- the Table I analogue.

The counterpart of ``repro.core.dse``.  The paper explores (d_i0, d_j0,
d_k0, d_p) by synthesising each candidate and reading f_max from the fitter;
rows A/B/D *fail* the fitter.  On the card the clock is fixed and the
kernels are compiled once, so the DSE becomes: enumerate (bm, bn, bk), reject
the shapes that no tile of the kernel runs or that exceed shared memory or
the registers (the fitter analogue), and rank the survivors by their roofline
terms.  The measured column comes from ``repro_torch.tune``.

By default the axes are the geometries the kernel runs on the problem
(``kernels/systolic/kernel.py`` ``TILES`` / ``qtiles``,
``kernels/grouped/kernel.py`` ``TILES``; at M <= 16 the decode tile at each
contraction chunk).  A caller's axes are enumerated whole: a geometry that
no tile runs on the problem gives a record with ``fits=False``.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.core import hw
from repro_torch.core.blocking import BlockPlan


@dataclasses.dataclass(frozen=True)
class DSERecord:
    bm: int
    bn: int
    bk: int
    smem_kib: float
    fits: bool  # the "fitter" column of Table I
    arithmetic_intensity: float
    compute_bound: bool
    compute_us: float
    memory_us: float
    bound_by: str
    # Problem geometry the record was derived for, so a record is
    # self-contained (repro_torch.tune measures straight from a record).
    m: int = 0
    n: int = 0
    k: int = 0
    in_dtype_bytes: int = 2
    # Dtype identity (None = bf16-sized record).  int8 and fp8 both stream 1
    # byte/element but key different kernels and cache entries.
    in_dtype: str | None = None
    # Scale-block length along K for quantized records (0 = unquantized).
    quant_block_k: int = 0
    # The measured column: Table I's f_max analogue.  ``explore`` leaves it
    # None; ``attach_measurements`` / repro_torch.tune fill it in.
    measured_us: float | None = None
    # The kernel path that runs this geometry on the problem (None: none does).
    path: str | None = None

    @property
    def ident(self) -> str:
        return f"{self.bm}x{self.bn}x{self.bk}"

    @property
    def analytical_us(self) -> float:
        """Roofline time bound: the analytical ranking key."""
        return max(self.compute_us, self.memory_us)

    def with_measurement(self, measured_us: float) -> "DSERecord":
        return dataclasses.replace(self, measured_us=float(measured_us))


# Canonical storage names of the quant level.
QUANT_DTYPES = ("int8", "float8_e4m3fn")
BACKENDS = ("cuda-systolic", "cuda-grouped", "reference")


def _quant_block_k(in_dtype: str | None, quant_block_k: int | None) -> int:
    """Default scale granularity: 128 along K for narrow dtypes, else 0."""
    if quant_block_k is not None:
        return quant_block_k
    return 128 if in_dtype in QUANT_DTYPES else 0


def decode_chunks(k: int, sms: int, n: int = 0) -> list[int]:
    """The decode tile's contraction chunks worth measuring for K: every
    power-of-two multiple of its 64-deep k stage below K, K itself (no
    split), and the untuned rule's (``plan_split`` for an N-wide product)."""
    from repro_torch.kernels.systolic import kernel as mm

    chunks = {mm.DECODE_BK * 2**i for i in range(16) if mm.DECODE_BK * 2**i < k}
    chunks.add(-(-max(k, 1) // mm.DECODE_BK) * mm.DECODE_BK)
    if n:
        chunks.add(mm.block_of("decode", 1, n, k, sms)[2])
    return sorted(chunks)


def kernel_tiles(m: int, n: int, k: int, dtype: str | None, backend: str,
                 chip: hw.GPU | str | None = None) -> list[tuple[int, int, int]]:
    """The geometries ``backend``'s kernel runs on an (M, N, K) problem of
    ``dtype`` operands, 16-byte aligned: its tiles whose paths take the
    problem (at M <= 16 the decode tile, at each ``decode_chunks`` chunk for
    the systolic GEMM); for ``reference``, the systolic GEMM's bf16 prefill
    tiles that divide the problem."""
    from repro_torch.kernels.grouped import kernel as gk
    from repro_torch.kernels.systolic import kernel as mm

    dtype = dtype or "bfloat16"
    if backend == "reference":
        tiles = [mm.TILES[p] for p in ("wmma", "wgmma_64x128", "wgmma_128x128", "wgmma_128x256")]
    elif backend == "cuda-grouped":
        tiles = list(gk.TILES.values())
    elif dtype in QUANT_DTYPES:
        tiles = list(mm.qtiles(getattr(torch, dtype)).values())
    elif m <= mm.DECODE_MAX_M and dtype != "float32":
        bm, bn, _ = mm.TILES["decode"]
        return [(bm, bn, c) for c in decode_chunks(k, hw.get_chip(chip).n_sm, n)]
    else:
        tiles = [t for p, t in mm.TILES.items() if p != "decode"]
    return [t for t in tiles if kernel_path(*t, m, n, k, dtype, backend) is not None]


def block_path(bm: int, bn: int, bk: int, dtype: str | None, backend: str) -> tuple[str, int]:
    """(path, k_chunk) of ``backend``'s kernel that a (bm, bn, bk) geometry
    names for ``dtype`` operands (``kernels/*/kernel.py`` ``path_of_block``
    / ``qpath_of_block``; k_chunk the decode tile's contraction per block, 0
    for every other path); raises ValueError on a geometry no tile runs."""
    from repro_torch.kernels.grouped import kernel as gk
    from repro_torch.kernels.systolic import kernel as mm

    dtype = dtype or "bfloat16"
    if backend == "cuda-grouped":
        return gk.path_of_block(bm, bn, bk), 0
    if backend != "cuda-systolic":
        raise ValueError(f"backend {backend!r} has no kernel paths; kernels: cuda-systolic, cuda-grouped")
    if dtype in QUANT_DTYPES:
        return mm.qpath_of_block(bm, bn, bk, getattr(torch, dtype)), 0
    return mm.path_of_block(bm, bn, bk)


def kernel_path(bm: int, bn: int, bk: int, m: int, n: int, k: int, dtype: str | None, backend: str,
                quant_block_k: int | None = None) -> tuple[str, int] | None:
    """(path, k_chunk) of ``backend``'s kernel that runs a (bm, bn, bk)
    geometry on an (M, N, K) problem of ``dtype`` operands, 16-byte aligned
    and B row-major, or None (``block_path``, then the path's refusal).  The
    ``reference`` backend (``core.systolic.blocked_matmul``) runs any
    geometry that divides the problem."""
    from repro_torch.kernels.grouped import kernel as gk
    from repro_torch.kernels.systolic import kernel as mm

    dtype = dtype or "bfloat16"
    if backend == "reference":
        return None if m % bm or n % bn or k % bk else ("reference", 0)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; backends: {BACKENDS}")
    try:
        path, k_chunk = block_path(bm, bn, bk, dtype, backend)
    except ValueError:
        return None
    tdt = getattr(torch, dtype)
    if backend == "cuda-grouped":
        refused = gk.path_refusal(path, m, k, n, tdt, True)
    elif dtype in QUANT_DTYPES:
        qbk = _quant_block_k(dtype, quant_block_k)
        refused = mm.qpath_refusal(path, m, n, k, qbk if qbk < k else 0, tdt, True)
    else:
        refused = mm.path_refusal(path, m, n, k, tdt, True, False, k_chunk)
    return None if refused else (path, k_chunk)


def explore(
    m: int,
    n: int,
    k: int,
    *,
    bms=None,
    bns=None,
    bks=None,
    in_dtype: str | None = None,
    in_dtype_bytes: int | None = None,
    quant_block_k: int | None = None,
    chip: hw.GPU | str | None = None,
    backend: str = "cuda-systolic",
) -> list[DSERecord]:
    """Enumerate candidate block shapes for an (M, N, K) matmul.

    With no axes, the geometries ``backend``'s kernel runs on the problem
    (``kernel_tiles``); with ``bms``, ``bns`` and ``bks``, their product, each
    geometry that no tile runs on the problem a ``fits=False`` record.  A
    record fits when a tile runs it and its plan fits shared memory and the
    registers (``BlockPlan.fits_smem`` / ``fits_registers``).

    ``in_dtype``
    adds the quant level: element bytes from ``hw.DTYPE_BYTES``, the
    per-dtype peak, and fp32 scale sidecars at ``quant_block_k`` granularity
    (default 128) counted in shared memory and the memory column.
    """
    chip = hw.get_chip(chip)
    bf16_bytes = hw.dtype_bytes("bfloat16")
    if in_dtype is None and in_dtype_bytes is None:
        in_dtype_bytes = bf16_bytes
    qbk = _quant_block_k(in_dtype, quant_block_k)
    plan_kw = dict(
        in_dtype=in_dtype,
        in_dtype_bytes=in_dtype_bytes or bf16_bytes,
        quant_block_k=qbk,
        # Quantized plans emit wide (bf16) outputs from narrow streams.
        out_dtype_bytes=bf16_bytes if qbk else None,
    )
    if bms is None and bns is None and bks is None:
        geometries = kernel_tiles(m, n, k, in_dtype, backend, chip)
    else:
        geometries = itertools.product(bms, bns, bks)
    records = []
    for bm, bn, bk in geometries:
        plan = BlockPlan(m, n, k, bm, bn, bk, **plan_kw)
        resolved = kernel_path(bm, bn, bk, m, n, k, in_dtype, backend, qbk)
        path = resolved and resolved[0]
        # The decode tile's bk is its contraction per block; it stages
        # 64-deep k slices of it.
        staged = dataclasses.replace(plan, bk=64) if path == "decode" else plan
        records.append(
            DSERecord(
                bm=bm,
                bn=bn,
                bk=bk,
                smem_kib=staged.smem_bytes() / 1024,
                fits=path is not None and staged.fits_smem(chip) and staged.fits_registers(chip),
                arithmetic_intensity=plan.arithmetic_intensity(),
                compute_bound=plan.compute_bound(chip),
                compute_us=plan.compute_seconds(chip) * 1e6,
                memory_us=plan.memory_seconds(chip) * 1e6,
                bound_by=plan.bound_by(chip),
                m=m,
                n=n,
                k=k,
                in_dtype_bytes=plan.in_dtype_bytes,
                in_dtype=in_dtype,
                quant_block_k=qbk,
                path=path,
            )
        )
    return records


def attach_measurements(records, measure) -> list[DSERecord]:
    """Fill the measured column for feasible records.

    ``measure`` maps a DSERecord to a time in microseconds (or None to skip)
    -- typically ``repro_torch.tune.measure`` behind a functools partial.
    Infeasible ('fitter failed') records pass through unmeasured, exactly
    like Table I's blank f_max cells.
    """
    out = []
    for r in records:
        t = measure(r) if r.fits else None
        out.append(r if t is None else r.with_measurement(t))
    return out


def best(records: list[DSERecord]) -> DSERecord:
    """Rank feasible shapes; measured time wins over the analytical model.

    Records carrying a ``measured_us`` (the f_max-analogue column) are
    preferred as a group and ranked by measurement; purely analytical
    records fall back to lowest max(compute, memory) time, then AI.
    """
    feasible = [r for r in records if r.fits]
    if not feasible:
        raise ValueError("no feasible block shape (all 'fitter failed')")
    measured = [r for r in feasible if r.measured_us is not None]
    if measured:
        return min(measured, key=lambda r: (r.measured_us, r.analytical_us))
    return min(
        feasible,
        key=lambda r: (r.analytical_us, -r.arithmetic_intensity),
    )
