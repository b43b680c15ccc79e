"""Contract auditor: a plan's claims against the launch the kernel makes.

The counterpart of ``repro.check.audit``, redesigned around the CUDA launch
geometry: the port has no jaxpr to trace.  The paper's design flow trusts a
static resource model (DSP/M20K counts per candidate geometry); the port
trusts ``BlockPlan``'s shared-memory, register and tile accounting
(``core/blocking.py``) and each kernel binding's Python accounting of its
launch (``kernels/*/kernel.py`` ``launch_of``).  This module holds both
against what runs:

* **The dispatcher's decision is settled for the plan** as ``ops.matmul``
  settles it on the card: ``tune.cache.plan_path`` with the explicit plan,
  then the kernel's ``launch_path`` / ``qlaunch_path`` (grouped:
  ``launch_path``), then the tile it runs (``block_of`` / ``qtiles`` /
  ``TILES``).  A launched plan read back from a launch counter
  (``launches_by_plan``) is held to the decision its source names at the
  operands' alignment the key records: the shape rule's for "rule" and
  "tuned_refused" (a refused tuned path runs the rule's, as documented), the
  plan cache's for "tuned".
* **Static rules** (any device): ``no-tile`` (a geometry no tile runs),
  ``plan-refused`` (the dispatcher refuses the plan on such operands),
  ``geometry-drift`` (the blocks run differ from the plan's after the
  documented clamps: the decode tile's bk is its contraction per block,
  clamped to K; a K-major twin runs its row-major tile), ``path-drift`` (a
  launched path the rule or the cache did not pick), ``grid-mismatch`` (the
  grid does not tile the problem, or exceeds a launch limit),
  ``dtype-bytes-mismatch``, ``out-dtype-mismatch``, ``scale-straddle`` (K5's
  scale step against the wgmma tile's 128-deep k stage and the WMMA tiles'
  16-deep retire), ``smem-underdeclared`` / ``smem-budget`` (the declared
  ``smem_bytes()`` against the tile's, and the tile's against the card's
  limit), ``workspace-mismatch`` (split-K partials: splits x M x N x 4
  bytes), ``flops-mismatch`` (the FLOPs ``obs.attribution`` records for the
  launch against 2*M*N*K, what the decode MFU divides).  The kernels declare
  no cost estimate, so the reference's ``hbm-mismatch`` has nothing to hold.
* **On the card** (``device="cuda"``, the default) each binary also reports
  the launch it makes (``kernels/_build.py`` ``query``: grid, threads,
  dynamic shared memory, split, and ``cudaFuncGetAttributes`` of the
  kernel), and the rules hold the Python accounting against it:
  ``grid-mismatch`` and ``smem-mismatch`` against the binary's launch,
  ``smem-underdeclared`` against its dynamic plus static bytes,
  ``smem-budget`` against the card's ``sharedMemPerBlockOptin``,
  ``workspace-mismatch`` against the binary's ``split_workspace``, and
  ``register-spill`` when a kernel whose plan claims ``fits_registers``
  spills (``localSizeBytes > 0``).  Registers are judged by spills, not by
  ``numRegs``: ``setmaxnreg`` moves registers between warpgroups after the
  launch.  Every audited launch is also made once on seeded operands (K1,
  K4 and K5 through their dispatcher at the launch's tile and alignment, K3
  through its wrapper) and held against its plain version
  (``output-mismatch``; ``path-drift`` if it ran another path).  Asked for
  the card on a host without one, the audit raises; it never falls back to
  the static part.

Findings use pseudo-paths (``<plan:512x512x512/128x128x64@bfloat16>``) so the
baseline mechanism treats them like lint findings.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
from typing import Any, Iterable, NamedTuple

import torch

from repro_torch.check.findings import AUDIT, Finding
from repro_torch.core import dse, hw
from repro_torch.core.blocking import BlockPlan, round_up
from repro_torch.kernels import _build
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.grouped import kernel as grouped_kernel
from repro_torch.kernels.systolic import kernel as mm_kernel
from repro_torch.obs import attribution, metrics
from repro_torch.tune import cache as tune_cache

# The paper-config sweep (the reference's): the square baseline, a skinny-M
# activation GEMM and a deep-K contraction, at the fp baseline and both
# quantized storage dtypes.
PAPER_PROBLEMS = ((512, 512, 512), (256, 2048, 512), (512, 512, 2048))
PAPER_DTYPES = ("bfloat16", "int8", "float8_e4m3fn")
QUANT_DTYPES = dse.QUANT_DTYPES
SYSTOLIC, GROUPED = "cuda-systolic", "cuda-grouped"  # the plan cache's backends (kernels/*/ops.py)
COLLECTIVE_SKIP = "skipped: not ported (ROADMAP item 9)"
WMMA_RETIRE_K = 16  # csrc/systolic_qmm.cu: the WMMA tiles retire a scale step per 16-deep fragment
MAX_GRID_YZ = 65535
MAX_GRID_X = 2**31 - 1
MAX_THREADS = 1024
SEED = 0  # the probes' operands
# A launch's output against its plain version: |got - want| <= tol * (1 + |want|)
# (atol = rtol), the port's kernel tests' bf16 tolerances; attention by dtype
# (P rounded to bf16 / online against direct softmax).
GEMM_TOL = 2e-2
ATTN_TOL = {"bfloat16": 3e-2, "float32": 2e-4}
# What the CPU cannot check: the binaries' own reports.
BINARY_CHECKS = ("grid, threads, split and dynamic shared memory against the binary's launch",
                 "static shared memory", "registers and local-memory spills",
                 "the binary's split-K workspace", "the card's own shared-memory limit")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# The device an audit runs for.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Target:
    """Where the audit's launches and queries go: the card (binary reports,
    its SM count and shared-memory limit) or the CPU (the static part, the
    H100's datasheet numbers)."""

    device: torch.device
    sms: int
    smem_limit: int
    probes: dict = dataclasses.field(default_factory=dict)  # _Gemm -> _Probe

    @property
    def card(self) -> bool:
        return self.device.type == "cuda"

    @classmethod
    def of(cls, device: str | torch.device | None) -> "_Target":
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("the card audit needs a CUDA device: no CUDA device on this host "
                                   "(device='cpu' runs the static part only)")
            index = torch.cuda.current_device() if device.index is None else device.index
            device = torch.device("cuda", index)
            props = torch.cuda.get_device_properties(index)
            return cls(device, props.multi_processor_count, props.shared_memory_per_block_optin)
        if device.type != "cpu":
            raise ValueError(f"the audit runs on 'cuda' or 'cpu', not {device}")
        return cls(device, hw.H100.n_sm, hw.H100.smem_per_block)


def _target(device) -> _Target:
    return device if isinstance(device, _Target) else _Target.of(device)


def _stats_base(t: _Target) -> dict[str, Any]:
    return {"device": str(t.device), "binary_checks_not_made": [] if t.card else list(BINARY_CHECKS)}


class _Emitter:
    def __init__(self, path: str, symbol: str):
        self.path, self.symbol = path, symbol
        self.findings: list[Finding] = []

    def __call__(self, rule: str, message: str) -> None:
        self.findings.append(Finding(engine=AUDIT, rule=rule, path=self.path, line=0, symbol=self.symbol,
                                     message=message))


# ---------------------------------------------------------------------------
# One launch: the Python accounting against the problem, the declared plan
# and (on the card) the binary.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Gemm:
    """One GEMM launch as the dispatcher settled it.  ``m`` is the grouped
    GEMM's per-expert C and ``batch`` its experts; ``qk_a`` / ``qk_b`` the
    block-scaled GEMM's scale blocks as the kernel takes them (0: whole K);
    ``aligned`` the operands' base alignment the path was settled on."""

    backend: str
    path: str
    m: int
    n: int
    k: int
    dtype: str
    batch: int = 1
    k_chunk: int = 0
    qk_a: int = 0
    qk_b: int = 0
    aligned: bool = True

    @property
    def quant(self) -> bool:
        return self.dtype in QUANT_DTYPES

    @property
    def k_major(self) -> bool:
        return self.path.endswith("_kmajor")

    def block(self, sms: int) -> tuple[int, int, int]:
        """The (bm, bn, bk) the path runs the problem on."""
        if self.backend == GROUPED:
            return grouped_kernel.TILES[self.path]
        if self.quant:
            return mm_kernel.qtiles(_dtype(self.dtype))[self.path]
        return mm_kernel.block_of(self.path, self.m, self.n, self.k, sms, self.k_chunk)

    def launch(self, sms: int) -> _build.Launch:
        """The binding's Python accounting of the launch."""
        if self.backend == GROUPED:
            return grouped_kernel.launch_of(self.path, self.batch, self.m, self.k, self.n)
        if self.quant:
            return mm_kernel.qlaunch_of(self.path, self.m, self.n, self.k, _dtype(self.dtype), sms)
        return mm_kernel.launch_of(self.path, self.m, self.n, self.k, sms, self.k_chunk)

    def query(self) -> tuple[_build.Launch, _build.Compiled]:
        """The binary's report of the launch (card only), at the default
        output dtype: the operands' (bf16 for the block-scaled GEMM)."""
        dt = _dtype(self.dtype)
        if self.backend == GROUPED:
            return grouped_kernel.launch_query(self.path, self.batch, self.m, self.k, self.n, dt)
        if self.quant:
            return mm_kernel.qlaunch_query(self.path, self.m, self.n, self.k, self.qk_a, self.qk_b, dt,
                                           torch.bfloat16)
        return mm_kernel.launch_query(self.path, self.m, self.n, self.k, dt, dt, self.k_chunk)

    def workspace(self, device: torch.device) -> int:
        """The split-K workspace the binding allocates for the launch, as the
        binary sizes it (``split_workspace``; card only)."""
        if self.backend == GROUPED:
            return 0
        name = "systolic_qmm" if self.quant else "systolic_mmm"
        splittable = self.quant or self.path.startswith("decode")
        return mm_kernel._workspace_bytes(name, self.m, self.n, self.k, splittable, self.k_chunk, device.index)

    def staged_plan(self, sms: int) -> BlockPlan:
        """The tile's own plan: its (bm, bn, bk), the decode tile staging
        64-deep k slices of its contraction per block (as ``dse.explore``
        prices it)."""
        bm, bn, bk = self.block(sms)
        if self.path.removesuffix("_kmajor") == "decode":
            bk = mm_kernel.DECODE_BK
        qbk = (self.qk_a or self.qk_b or self.k) if self.quant else 0
        return BlockPlan(self.m, self.n, self.k, bm, bn, bk, in_dtype=self.dtype, quant_block_k=qbk,
                         out_dtype_bytes=hw.dtype_bytes("bfloat16") if self.quant else None)


def _check_grid(emit, launch: _build.Launch, rows: int, cols: int, bm: int, bn: int, z: int) -> None:
    """The grid tiles a (rows, cols) problem with (bm, bn) blocks, z slices
    or matrices on its z axis, within the launch limits."""
    want = (-(-cols // bn), -(-rows // bm), z)
    if launch.grid != want:
        emit("grid-mismatch", f"the launch's grid {launch.grid} does not tile the problem: ({rows}, {cols}) with "
                              f"({bm}, {bn}) blocks and {z} on z need {want}")
    gx, gy, gz = launch.grid
    if gx > MAX_GRID_X or gy > MAX_GRID_YZ or gz > MAX_GRID_YZ or not 0 < launch.threads <= MAX_THREADS:
        emit("grid-mismatch", f"the launch's grid {launch.grid} x {launch.threads} threads exceeds the launch "
                              f"limits (x < 2^31, y and z <= {MAX_GRID_YZ}, threads <= {MAX_THREADS})")


def _check_binary(emit, t: _Target, launch: _build.Launch, got: _build.Launch, compiled: _build.Compiled,
                  declared: int | None, claims_registers: bool) -> None:
    """The binary's report against the Python accounting (card only)."""
    if (got.grid, got.threads, got.splits, got.k_chunk) != (launch.grid, launch.threads, launch.splits,
                                                           launch.k_chunk):
        emit("grid-mismatch", f"the binary launches grid {got.grid} x {got.threads} threads, {got.splits} "
                              f"split(s) of {got.k_chunk}; the Python accounting says {launch.grid} x "
                              f"{launch.threads}, {launch.splits} of {launch.k_chunk}")
    if got.threads > compiled.max_threads:
        emit("grid-mismatch", f"the binary launches {got.threads} threads a block; its kernel takes at most "
                              f"{compiled.max_threads}")
    if got.dyn_smem != launch.dyn_smem:
        emit("smem-mismatch", f"the binary allocates {got.dyn_smem} B of dynamic shared memory; the Python "
                              f"accounting says {launch.dyn_smem} B")
    total = got.dyn_smem + compiled.static_smem
    if declared is not None and declared < total:
        emit("smem-underdeclared", f"plan declares smem_bytes={declared} but the binary's block takes {total} B "
                                   f"({got.dyn_smem} dynamic + {compiled.static_smem} static) -- the fitter "
                                   f"would admit a shape that does not fit")
    if total > t.smem_limit:
        emit("smem-budget", f"the binary's block takes {total} B of shared memory, over the card's "
                            f"{t.smem_limit} B a block")
    if compiled.local_bytes > 0 and claims_registers:
        emit("register-spill", f"the compiled kernel spills {compiled.local_bytes} B a thread to local memory "
                               f"({compiled.regs} registers) while its plan claims fits_registers")


class _Probe(NamedTuple):
    """One launch of a problem through its dispatcher: the FLOPs
    ``obs.attribution`` recorded and their keys, the output's element bytes,
    and on the card the launch counter's new keys and the output's largest
    error against the plain version (None off the card)."""

    flops: float
    out_bytes: int
    recorded: list
    launched: list
    max_abs_err: float | None
    within: bool


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` based one element past an allocation, so
    not 16-byte aligned (as a launch on a sliced activation sees it)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def _compare(got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, bool]:
    """(max |got - want|, every element within tol * (1 + |want|))."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return err.max().item(), bool((err <= tol + tol * want.abs()).all())


def _probe(t: _Target, g: _Gemm) -> _Probe:
    """Run the dispatcher once on seeded operands of the launch's problem
    (zeros off the card; A off its alignment where the launch's was), with
    telemetry on: an explicit plan of the launch's tile sends it down the
    same path.  On the card the output is held against the plain version
    and the launch counter's new keys are returned.  The records are taken
    out of the scope, so the default registry is left as it was.  Cached
    per launch."""
    if g in t.probes:
        return t.probes[g]
    from repro_torch.kernels.grouped import ops as grouped_ops
    from repro_torch.kernels.grouped.ref import grouped_matmul_ref
    from repro_torch.kernels.systolic import ops as mm_ops
    from repro_torch.kernels.systolic.ref import matmul_ref, quant_matmul_ref
    from repro_torch.quant.qarray import quantize_act, quantize_weight

    dt, dev = _dtype(g.dtype), t.device
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, scale=1.0):  # off the card nothing is compared, and zeros cost less to make
        return torch.randn(*shape, generator=gen, device=dev) * scale if t.card else torch.zeros(*shape)

    def shift(x):
        return x if g.aligned else _misaligned(x)

    if g.backend == GROUPED:
        x, w = shift(rand(g.batch, g.m, g.k).to(dt)), rand(g.batch, g.k, g.n, scale=g.k**-0.5).to(dt)
        call, plain = functools.partial(grouped_ops.grouped_matmul, x, w), functools.partial(grouped_matmul_ref, x, w)
        counter, at = grouped_kernel.launches_by_plan, 4
    elif g.quant:
        qa = quantize_act(rand(g.m, g.k), g.dtype, block_k=g.qk_a)
        qb = quantize_weight(rand(g.n, g.k, scale=g.k**-0.5).t(), g.dtype, block_k=g.qk_b)
        qa = dataclasses.replace(qa, values=shift(qa.values))
        qb = dataclasses.replace(qb, values=qb.values.t().contiguous().t())  # K-major, as quant.k_major lays it
        call = functools.partial(mm_ops.quant_matmul, qa, qb)
        plain = functools.partial(quant_matmul_ref, qa, qb, out_dtype=torch.bfloat16)
        counter, at = mm_kernel.quant_launches_by_plan, 3
    else:
        a = shift(rand(g.m, g.k).to(dt))
        b = rand(g.n, g.k, scale=g.k**-0.5).to(dt).t() if g.k_major else rand(g.k, g.n, scale=g.k**-0.5).to(dt)
        call, plain = functools.partial(mm_ops.matmul, a, b), functools.partial(matmul_ref, a, b)
        counter, at = mm_kernel.launches_by_plan, 3
    plan = BlockPlan(g.m, g.n, g.k, *g.block(t.sms), in_dtype=g.dtype)
    totals = attribution.GemmTotals()
    was = metrics.enabled()
    metrics.enable(True)
    try:
        with attribution.collecting(totals), torch.no_grad():
            before = collections.Counter(counter)
            out = call(plan=plan)
            launched = sorted(counter - before)
            tally, totals._tally = totals._tally, {}  # out of the scope: nothing reaches the registry
    finally:
        metrics.enable(was)
    flops = sum(attribution.launch_flops(k) * c for k, c in tally.items())
    err, within = _compare(out, plain(), GEMM_TOL) if t.card else (None, True)
    t.probes[g] = _Probe(flops, out.element_size(), list(tally), [(k[at], k[-1]) for k in launched], err, within)
    return t.probes[g]


def _audit_gemm(t: _Target, g: _Gemm, emit, *, declared_smem: int | None = None, out_bytes: int | None = None,
                claims_registers: bool | None = None) -> None:
    """Every launch rule for one settled GEMM launch.  ``declared_smem``:
    the plan's claim (default: the tile's own plan's ``smem_bytes()``);
    ``out_bytes``: the plan's output element size (default: the operands')."""
    bm, bn, bk = g.block(t.sms)
    staged = g.staged_plan(t.sms)
    declared = staged.smem_bytes() if declared_smem is None else declared_smem
    if claims_registers is None:
        claims_registers = staged.fits_registers()
    launch = g.launch(t.sms)
    z = g.batch if g.backend == GROUPED else launch.splits
    _check_grid(emit, launch, g.m, g.n, bm, bn, z)
    if launch.splits > 1 and not (0 < launch.k_chunk and (launch.splits - 1) * launch.k_chunk < g.k
                                  <= launch.splits * launch.k_chunk):
        emit("grid-mismatch", f"{launch.splits} split(s) of {launch.k_chunk} do not cover K={g.k} once")
    workspace = launch.splits * g.m * g.n * 4 if launch.splits > 1 else 0  # fp32 partials
    if declared < launch.dyn_smem:
        emit("smem-underdeclared", f"plan declares smem_bytes={declared} but the tile allocates "
                                   f"{launch.dyn_smem} B of dynamic shared memory -- the fitter would admit a "
                                   f"shape that does not fit")
    if launch.dyn_smem > t.smem_limit:
        emit("smem-budget", f"the tile allocates {launch.dyn_smem} B of shared memory, over the {t.smem_limit} "
                            f"B a block")
    probe = _probe(t, g)
    written = probe.out_bytes
    want_flops = 2.0 * g.batch * g.m * g.n * g.k
    if probe.flops != want_flops:
        emit("flops-mismatch", f"obs.attribution records {probe.flops:.0f} FLOPs for the launch "
                               f"({probe.recorded}); 2*M*N*K is {want_flops:.0f}")
    want_out = hw.dtype_bytes("bfloat16") if g.quant else hw.dtype_bytes(g.dtype)
    if written != want_out:
        emit("out-dtype-mismatch", f"the dispatcher writes {written} B elements where the kernel's default "
                                   f"output is {want_out} B")
    if out_bytes is not None and out_bytes != written:
        emit("out-dtype-mismatch", f"plan claims out_dtype_bytes={out_bytes} but the dispatcher writes "
                                   f"{written} B elements")
    if not t.card:
        return
    if probe.launched != [(g.path, g.aligned)]:
        emit("path-drift", f"the probe of {g.path} (aligned={g.aligned}) launched {probe.launched}")
    if not probe.within:
        emit("output-mismatch", f"the {g.path} launch differs from its plain version by {probe.max_abs_err} "
                                f"(atol = rtol = {GEMM_TOL})")
    got, compiled = g.query()
    _check_binary(emit, t, launch, got, compiled, declared, claims_registers)
    binary_ws = g.workspace(t.device)
    if binary_ws != workspace:
        emit("workspace-mismatch", f"the binary's split_workspace is {binary_ws} B; {launch.splits} split(s) "
                                   f"x M x N x 4 is {workspace} B")


# ---------------------------------------------------------------------------
# Settling a plan the way the card's dispatcher does.
# ---------------------------------------------------------------------------


def _plan_path(plan: BlockPlan, dtype: str, backend: str = SYSTOLIC, batch: int = 1) -> str:
    lead = f"{batch}x" if backend == GROUPED else ""
    return f"<plan:{lead}{plan.m}x{plan.n}x{plan.k}/{plan.bm}x{plan.bn}x{plan.bk}@{dtype}>"


def _scale_blocks(plan: BlockPlan) -> tuple[int, int]:
    """(qk_a, qk_b) as the kernel takes them for a plan's scale block on
    both operands: a block spanning K is whole-K (0)."""
    q = plan.quant_block_k if plan.quant_block_k < plan.k else 0
    return q, q


def _straddle(path: str | None, step: int, bk: int) -> str | None:
    """Why a scale step straddles the tile's k stage (None: it does not):
    the wgmma tile retires at the end of its 128-deep stages, the WMMA tiles
    per 16-deep fragment; with no tile, the declared bk (the reference's
    rule)."""
    if not step:
        return None
    unit = mm_kernel.WGMMA_QK if path == "wgmma" else WMMA_RETIRE_K if path is not None else bk
    if step % unit:
        return f"scale step {step} straddles the {unit}-deep k {'stage' if unit != WMMA_RETIRE_K else 'retire'}"
    return None


def audit_matmul_plan(
    plan: BlockPlan,
    *,
    dtype: str | None = None,
    device: str | torch.device | None = "cuda",
    backend: str = SYSTOLIC,
    experts: int = 1,
    k_major: bool = False,
    declared_smem_bytes: int | None = None,
    declared_in_dtype_bytes: int | None = None,
) -> list[Finding]:
    """Audit one BlockPlan against the launch the dispatcher makes of it.

    The plan is settled as an explicit plan (``tune.cache.plan_path``, the
    kernel's launch path, its tile), then every launch rule runs.  ``backend``
    "cuda-grouped" audits K4 over ``experts`` experts (the plan's M the
    per-expert C); ``k_major`` a K1 launch with B K-major.  ``declared_*``
    override what the plan object would claim -- the injection point for
    corrupted-record tests and the ``--plans`` CLI gate (a DSERecord's
    ``smem_kib`` is a stored copy of ``smem_bytes()`` and can drift from the
    code that computes it).
    """
    t = _target(device)
    dtype = dtype or plan.in_dtype or "bfloat16"
    quant = dtype in QUANT_DTYPES
    emit = _Emitter(_plan_path(plan, dtype, backend, experts), "audit_matmul_plan")
    m, n, k = plan.m, plan.n, plan.k

    # -- static contract checks ----------------------------------------------
    in_bytes = declared_in_dtype_bytes if declared_in_dtype_bytes is not None else plan.in_dtype_bytes
    table_bytes = hw.dtype_bytes(dtype)
    if in_bytes != table_bytes:
        emit("dtype-bytes-mismatch", f"plan claims in_dtype_bytes={in_bytes} but hw.dtype_bytes({dtype!r})="
                                     f"{table_bytes} -- hardcoded byte width?")

    # -- the dispatcher's decision ---------------------------------------------
    try:
        path, k_chunk, source = tune_cache.plan_path(backend, m, n, k, dtype, plan=plan)
    except ValueError as e:
        emit("no-tile", f"no tile of the kernel runs the declared geometry: {e}")
        return emit.findings
    qk_a = qk_b = 0
    if quant:
        qk_a, qk_b = _scale_blocks(plan)
        why = _straddle(path, mm_kernel.launch_step(qk_a, qk_b, k), plan.bk)
        if why:  # the kernel refuses the step, so the geometry never runs as declared
            emit("scale-straddle", f"{why} of the {path} tile (bk={plan.bk}); one k stage must sit inside one "
                                   f"scale block, so this plan never launches as declared")
            return emit.findings
    aligned = True  # the audit's operands: fresh allocations
    try:
        if backend == GROUPED:
            path, source = grouped_kernel.launch_path(path, source, m, k, n, _dtype(dtype), aligned)
        elif quant:
            path, source = mm_kernel.qlaunch_path(path, source, m, n, k, mm_kernel.launch_step(qk_a, qk_b, k),
                                                  _dtype(dtype), aligned)
        else:
            path = path + "_kmajor" if k_major else path
            path, k_chunk, source = mm_kernel.launch_path(path, k_chunk, source, m, n, k, _dtype(dtype), aligned,
                                                          k_major, t.sms)
    except ValueError as e:
        emit("plan-refused", f"the dispatcher refuses the plan on ({m}, {k}) @ ({k}, {n}) {dtype} operands: {e}")
        return emit.findings
    g = _Gemm(backend, path, m, n, k, dtype, experts, k_chunk, qk_a, qk_b)

    # Geometry: the tile run must be the plan's, modulo the documented clamps.
    expected = (plan.bm, plan.bn, plan.bk)
    if g.path.removesuffix("_kmajor") == "decode" and not quant:
        expected = (plan.bm, plan.bn, min(plan.bk, round_up(max(k, 1), mm_kernel.DECODE_BK)))
    actual = g.block(t.sms)
    if actual != expected:
        emit("geometry-drift", f"plan declares blocks {(plan.bm, plan.bn, plan.bk)} (expected {expected} after "
                               f"documented clamps) but the dispatcher runs {actual} on path {g.path}")
    staged = g.staged_plan(t.sms)
    declared = declared_smem_bytes
    if declared is None:
        declared = (dataclasses.replace(plan, bk=staged.bk) if staged.bk != plan.bk else plan).smem_bytes()
    _audit_gemm(t, g, emit, declared_smem=declared, out_bytes=plan._out_bytes,
                claims_registers=plan.fits_registers())
    return emit.findings


# ---------------------------------------------------------------------------
# Launched plans: the keys the launch counters hold.
# ---------------------------------------------------------------------------


def _rule_path(g: _Gemm, sms: int) -> str:
    """The path the shape rule picks for the launch's problem at its
    operands' alignment."""
    dt = _dtype(g.dtype)
    if g.backend == GROUPED:
        return grouped_kernel.grouped_path(g.m, g.k, g.n, dt, g.aligned)
    if g.quant:
        return mm_kernel.qgemm_path(g.m, g.n, g.k, mm_kernel.launch_step(g.qk_a, g.qk_b, g.k), dt, g.aligned)
    return mm_kernel.gemm_path(g.m, g.n, g.k, dt, g.aligned, sms, g.k_major)


def _check_source(emit, t: _Target, g: _Gemm, source: str) -> None:
    """A launched path against the decision its source names (a tuned plan
    read for the unfused epilogue: no served projection fuses one)."""
    if source in ("rule", "tuned_refused"):
        rule = _rule_path(g, t.sms)
        if g.path != rule or (g.k_chunk and source == "rule"):
            emit("path-drift", f"a {source!r} launch ran {g.path} (k_chunk {g.k_chunk}, aligned={g.aligned}); "
                               f"the shape rule picks {rule}")
    elif source == "tuned":
        hit = tune_cache.tuned_path(g.backend, g.m, g.n, g.k, g.dtype)
        base = g.path.removesuffix("_kmajor")
        if hit is None or (hit.path, hit.k_chunk) != (base, g.k_chunk):
            emit("path-drift", f"a 'tuned' launch ran {g.path} (k_chunk {g.k_chunk}); the plan cache holds "
                               f"{None if hit is None else (hit.path, hit.k_chunk)}")
    elif source != "explicit":
        emit("path-drift", f"unknown plan source {source!r}")


def _launch_keys(systolic=(), quant=(), grouped=(), attention=()):
    """The counters' ``launches_by_plan`` keys as launches: K1 (M, K, N,
    path, k_chunk, source, aligned), K5 (M, K, N, path, source, dtype, qk_a,
    qk_b, aligned), K4 (E, C, K, N, path, source, aligned), K3 (B, Sq, Skv,
    H, Hkv, D, dtype)."""
    for m, k, n, path, k_chunk, source, aligned in systolic:
        dtype = "float32" if path.startswith("fma") else "bfloat16"
        yield "systolic", _Gemm(SYSTOLIC, path, m, n, k, dtype, 1, k_chunk, aligned=aligned), source
    for m, k, n, path, source, dtype, qk_a, qk_b, aligned in quant:
        yield "quant", _Gemm(SYSTOLIC, path, m, n, k, dtype, 1, 0, qk_a, qk_b, aligned), source
    for e, c, k, n, path, source, aligned in grouped:
        dtype = "float32" if path == "fma" else "bfloat16"
        yield "grouped", _Gemm(GROUPED, path, c, n, k, dtype, e, aligned=aligned), source
    for key in attention:
        yield "attention", key, None


def _attention_probe(t: _Target, key: tuple) -> tuple[list, float, bool]:
    """Launch K3 once on seeded operands at (B, Sq, Skv, H, Hkv, D, dtype),
    causal where Sq = Skv, and hold the output against its plain version
    (computed a group of KV heads at a time, to bound the score matrix):
    (the counter's new keys, max |error|, within tolerance)."""
    from repro_torch.kernels.attention.ref import flash_attention_call_ref

    b, sq, skv, h, hkv, d, dtype = key
    dt, dev = _dtype(dtype), t.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev).to(dt)
               for s, n in ((sq, h), (skv, hkv), (skv, hkv)))
    args = dict(scale=d**-0.5, causal=sq == skv, window=None, kv_valid=skv)
    before = collections.Counter(attn_kernel.launches_by_plan)
    out = attn_kernel.flash_attention_call(q, k, v, **args)
    launched = sorted(attn_kernel.launches_by_plan - before)
    rep = h // hkv
    per = max(1, 2**28 // (b * rep * sq * skv))  # KV heads a group: 1 GiB of fp32 scores
    err, within = 0.0, True
    for j in range(0, hkv, per):
        heads = slice(j * rep, (j + per) * rep)
        want = flash_attention_call_ref(q[:, :, heads], k[:, :, j:j + per], v[:, :, j:j + per], **args)
        e, w = _compare(out[:, :, heads], want, ATTN_TOL[dtype])
        err, within = max(err, e), within and w
    return launched, err, within


def _audit_attention(t: _Target, key: tuple, emit) -> None:
    """One flash launch at (B, Sq, Skv, H, Hkv, D, dtype)."""
    b, sq, skv, h, hkv, d, dtype = key
    dt = _dtype(dtype)
    launch = attn_kernel.launch_of(b, h, sq, d, dt)
    bq = attn_kernel.W_BQ if dt == torch.bfloat16 else attn_kernel.F_BQ
    if launch.grid != (h, b, -(-sq // bq)):
        emit("grid-mismatch", f"flash grid {launch.grid} does not cover {h} heads x {b} rows x {sq} queries in "
                              f"{bq}-row tiles")
    gx, gy, gz = launch.grid
    if gy > MAX_GRID_YZ or gz > MAX_GRID_YZ or b > attn_kernel.MAX_BATCH or not 0 < launch.threads <= MAX_THREADS:
        emit("grid-mismatch", f"flash grid {launch.grid} exceeds the launch limits")
    if hkv == 0 or h % hkv or not 0 < d <= attn_kernel.MAX_HEAD_DIM:
        emit("grid-mismatch", f"flash launch at H={h}, Hkv={hkv}, D={d} is outside what the kernel takes")
    if launch.dyn_smem > t.smem_limit:
        emit("smem-budget", f"the flash block allocates {launch.dyn_smem} B of shared memory, over the "
                            f"{t.smem_limit} B a block")
    if t.card:
        got, compiled = attn_kernel.launch_query(b, h, hkv, sq, skv, d, dt)
        _check_binary(emit, t, launch, got, compiled, None, True)
        launched, err, within = _attention_probe(t, key)
        if launched != [key]:
            emit("path-drift", f"the flash probe at {key} launched {launched}")
        if not within:
            emit("output-mismatch", f"the flash launch differs from its plain version by {err} "
                                    f"(atol = rtol = {ATTN_TOL[dtype]})")


def audit_launches(*, systolic=(), quant=(), grouped=(), attention=(),
                   device: str | torch.device | None = "cuda") -> tuple[list[Finding], dict[str, Any]]:
    """Audit launched plans as the launch counters hold them: ``systolic``
    K1's ``launches_by_plan`` keys, ``quant`` K5's ``quant_launches_by_plan``
    keys, ``grouped`` K4's ``launches_by_plan`` keys and ``attention`` K3's.
    Each launch's path is held to the decision its source names at its
    operands' alignment, then every launch rule runs on the path's tile; on
    the card each is launched once more on seeded operands and held against
    its plain version.  Returns (findings, stats) with the count and
    coverage of each family."""
    t = _target(device)
    findings: list[Finding] = []
    stats: dict[str, Any] = {**_stats_base(t), "launched": {}, "audited": {}}
    for family, g, source in _launch_keys(systolic, quant, grouped, attention):
        stats["launched"][family] = stats["launched"].get(family, 0) + 1
        if family == "attention":
            emit = _Emitter(f"<launch:flash:{'x'.join(map(str, g[:6]))}@{g[6]}>", "audit_launches")
            _audit_attention(t, g, emit)
        else:
            lead = f"{g.batch}x" if g.backend == GROUPED else ""
            emit = _Emitter(f"<launch:{family}:{lead}{g.m}x{g.n}x{g.k}/{g.path}"
                            f"{f'/{g.k_chunk}' if g.k_chunk else ''}@{g.dtype}>", "audit_launches")
            _check_source(emit, t, g, source)
            _audit_gemm(t, g, emit)
        findings.extend(emit.findings)
        stats["audited"][family] = stats["audited"].get(family, 0) + 1
    launched = sum(stats["launched"].values())
    stats["coverage"] = sum(stats["audited"].values()) / launched if launched else 1.0
    return findings, stats


# ---------------------------------------------------------------------------
# DSERecord audit: stored claims vs the recomputed model.
# ---------------------------------------------------------------------------


def _record_plan(record: dse.DSERecord) -> BlockPlan:
    """The BlockPlan a DSERecord describes."""
    return BlockPlan(record.m, record.n, record.k, record.bm, record.bn, record.bk,
                     in_dtype=record.in_dtype, in_dtype_bytes=record.in_dtype_bytes,
                     quant_block_k=record.quant_block_k,
                     out_dtype_bytes=hw.dtype_bytes("bfloat16") if record.quant_block_k else None)


def audit_record(record: dse.DSERecord, device: str | torch.device | None = "cpu",
                 backend: str = SYSTOLIC) -> list[Finding]:
    """Check a stored DSERecord's claims against the recomputed model.

    Records are serialized into the tune cache and survive refactors of the
    accounting they snapshot -- exactly the drift the paper's fitter had no
    defense against.  Nothing launches, so any ``device`` gives the same
    findings (the card's is resolved all the same: asked for it on a host
    without one, this raises).
    """
    _target(device)
    emit = _Emitter(f"<record:{record.m}x{record.n}x{record.k}/{record.ident}@{record.in_dtype or 'bf16'}>",
                    "audit_record")
    plan = _record_plan(record)
    resolved = dse.kernel_path(record.bm, record.bn, record.bk, record.m, record.n, record.k, record.in_dtype,
                               backend, record.quant_block_k)
    path = resolved and resolved[0]
    staged = dataclasses.replace(plan, bk=mm_kernel.DECODE_BK) if path == "decode" else plan
    true_kib = staged.smem_bytes() / 1024
    if not math.isclose(record.smem_kib, true_kib, rel_tol=1e-9, abs_tol=1e-6):
        emit("record-smem-drift", f"record claims smem_kib={record.smem_kib:.3f} but the plan computes "
                                  f"{true_kib:.3f} KiB -- stored claim drifted from BlockPlan.smem_bytes()")
    true_fits = path is not None and staged.fits_smem() and staged.fits_registers()
    if record.fits != true_fits:
        emit("record-fits-drift", f"record claims fits={record.fits} but the fitter computes {true_fits} for "
                                  f"blocks {record.ident}")
    if record.in_dtype is not None:
        table = hw.dtype_bytes(record.in_dtype)
        if record.in_dtype_bytes != table:
            emit("record-dtype-bytes", f"record claims in_dtype_bytes={record.in_dtype_bytes} but "
                                       f"hw.dtype_bytes({record.in_dtype!r})={table}")
    if record.quant_block_k:
        step = record.quant_block_k if record.quant_block_k < record.k else 0
        why = _straddle(path, step, record.bk)
        if why:
            emit("record-scale-straddle", f"record bk={record.bk}: {why}; dse.explore should never emit this "
                                          f"geometry")
    if record.path != path:
        emit("record-path-drift", f"record claims path {record.path!r} but dse.kernel_path gives {path!r}")
    return emit.findings


# ---------------------------------------------------------------------------
# Paper-config sweep: every candidate the tuner would measure, audited.
# ---------------------------------------------------------------------------


def sweep_paper_candidates(
    device: str | torch.device | None = "cuda",
    *,
    problems: Iterable[tuple[int, int, int]] = PAPER_PROBLEMS,
    dtypes: Iterable[str] = PAPER_DTYPES,
    plans: bool = True,
    top_k: int | None = 8,
) -> tuple[list[Finding], dict[str, Any]]:
    """Audit 100% of ``tune.candidates.generate`` output for the paper config.

    Each candidate gets the record audit (stored claims) and, with
    ``plans=True``, the full plan audit through the dispatcher (on the card
    with each binary's report).  Returns (findings, stats)."""
    from repro_torch.tune import candidates as tune_candidates

    t = _target(device)
    problems, dtypes = list(problems), list(dtypes)
    findings: list[Finding] = []
    audited = settled = 0
    for m, n, k in problems:
        for dtype in dtypes:
            for cand in tune_candidates.generate(m, n, k, dtype=dtype, top_k=top_k):
                audited += 1
                findings.extend(audit_record(cand.record, t))
                if plans:
                    settled += 1
                    findings.extend(audit_matmul_plan(_record_plan(cand.record), dtype=dtype, device=t))
    stats = {**_stats_base(t), "plans_audited": audited, "plans_settled": settled,
             "problems": problems, "dtypes": dtypes}
    return findings, stats


# ---------------------------------------------------------------------------
# Dispatch paths: one representative call per kernel family.
# ---------------------------------------------------------------------------


def _family_calls(device: torch.device, seed: int = 0):
    """(family, call, plain, settled keys, tolerance) per kernel family at
    the reference's shapes: the call through the public wrapper, its plain
    version, the launch counter's key the dispatcher settles for it
    statically, and the tolerance (atol = rtol)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.ref import flash_attention_call_ref
    from repro_torch.kernels.grouped import ops as grouped_ops
    from repro_torch.kernels.grouped.ref import grouped_matmul_ref
    from repro_torch.kernels.systolic import ops as mm_ops
    from repro_torch.kernels.systolic.ref import matmul_ref, quant_matmul_ref
    from repro_torch.quant.qarray import quantize_act, quantize_weight

    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen).to(dtype).to(device)

    sms = mm_kernel.sm_count(device)
    a, b = rand(512, 512), rand(512, 512)
    path, k_chunk, source = tune_cache.plan_path(SYSTOLIC, 512, 512, 512, "bfloat16")
    al = mm_kernel.aligned(a, b)
    path, k_chunk, source = mm_kernel.launch_path(path, k_chunk, source, 512, 512, 512, torch.bfloat16, al, False,
                                                  sms)
    yield ("systolic", lambda: mm_ops.matmul(a, b), lambda: matmul_ref(a, b, None, out_dtype=torch.bfloat16),
           ((512, 512, 512, path, k_chunk, source, al),), GEMM_TOL)

    qa = quantize_act(rand(512, 512, dtype=torch.float32), "int8", block_k=128)
    qb = quantize_weight(rand(512, 512, dtype=torch.float32), "int8", block_k=128)
    qb = dataclasses.replace(qb, values=qb.values.t().contiguous().t())  # K-major, as quant.k_major lays weights
    step = mm_kernel.launch_step(128, 128, 512)
    qpath, _, qsource = tune_cache.plan_path(SYSTOLIC, 512, 512, 512, "int8")
    al = mm_kernel.aligned(qa.values, qb.values)
    qpath, qsource = mm_kernel.qlaunch_path(qpath, qsource, 512, 512, 512, step, torch.int8, al)
    yield ("quant", lambda: mm_ops.quant_matmul(qa, qb),
           lambda: quant_matmul_ref(qa, qb, out_dtype=torch.bfloat16),
           ((512, 512, 512, qpath, qsource, "int8", 128, 128, al),), GEMM_TOL)

    x, w = rand(4, 256, 512), rand(4, 512, 512)
    gpath, _, gsource = tune_cache.plan_path(GROUPED, 256, 512, 512, "bfloat16")
    al = grouped_kernel.aligned(x, w)
    gpath, gsource = grouped_kernel.launch_path(gpath, gsource, 256, 512, 512, torch.bfloat16, al)
    yield ("grouped", lambda: grouped_ops.grouped_matmul(x, w), lambda: grouped_matmul_ref(x, w),
           ((4, 256, 512, 512, gpath, gsource, al),), GEMM_TOL)

    q, k, v = (rand(1, 2, 512, 128) for _ in range(3))
    yield ("attention", lambda: attn_ops.flash_attention(q, k, v),
           lambda: flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                            scale=128**-0.5, causal=True, window=None,
                                            kv_valid=512).transpose(1, 2),
           ((1, 512, 512, 2, 2, 128, "bfloat16"),), ATTN_TOL["bfloat16"])


_COUNTERS = {  # family -> the launch counter audit_launches reads
    "systolic": (mm_kernel, "launches_by_plan"),
    "quant": (mm_kernel, "quant_launches_by_plan"),
    "grouped": (grouped_kernel, "launches_by_plan"),
    "attention": (attn_kernel, "launches_by_plan"),
}


def audit_dispatch_paths(device: str | torch.device | None = "cuda") -> tuple[list[Finding], dict[str, Any]]:
    """One representative call per kernel family, at the reference's shapes.

    On the CPU each call's launch is settled statically (the dispatcher's
    own functions) and audited.  On the card each call launches through its
    public wrapper; the launches are read back from the counters
    (``launches_by_plan``), must be the launch settled statically, are
    audited with the binaries' reports, and each output is held against its
    plain version.  ``collective_matmul`` is recorded as skipped: it is not
    ported.
    """
    t = _target(device)
    findings: list[Finding] = []
    stats: dict[str, Any] = {**_stats_base(t), "paths": {}, "max_abs_err": {}}
    for family, call, plain, settled, tol in _family_calls(t.device):
        emit = _Emitter(f"<dispatch:{family}>", "audit_dispatch_paths")
        keys = settled
        if t.card:
            counter = getattr(*_COUNTERS[family])
            before = collections.Counter(counter)
            out = call()
            keys = tuple(sorted(counter - before))
            err, within = _compare(out, plain(), tol)
            stats["max_abs_err"][family] = err
            if not within:
                emit("output-mismatch", f"{family} kernel output differs from its plain version by {err} "
                                        f"(atol = rtol = {tol})")
            if keys != settled:
                emit("path-drift", f"the wrapper launched {keys}; the dispatcher settles {settled}")
        stats["paths"][family] = len(keys)
        if not keys:
            emit("no-launch", f"no {family} launch in the dispatch path")
        f, _ = audit_launches(device=t, **{family: keys})
        findings.extend(emit.findings + f)
    stats["paths"]["collective_matmul"] = COLLECTIVE_SKIP
    return findings, stats


# ---------------------------------------------------------------------------
# Injected-plan specs: the CLI's corruption gate.
# ---------------------------------------------------------------------------


def audit_plan_spec(spec: dict, device: str | torch.device | None = "cuda") -> list[Finding]:
    """Audit one JSON plan spec (the ``--plans`` injection format).

    Required keys: m n k bm bn bk.  Optional: dtype (default bfloat16),
    quant_block_k, declared_smem_bytes, declared_in_dtype_bytes,
    out_dtype_bytes, backend ("cuda-systolic" or "cuda-grouped"), experts
    (grouped), k_major -- the ``declared_*`` keys assert *claims* that are
    audited against the launch instead of the plan's own accounting.
    """
    dtype = spec.get("dtype", "bfloat16")
    qbk = int(spec.get("quant_block_k", 0) or 0)
    if dtype in QUANT_DTYPES and not qbk:
        qbk = dse._quant_block_k(dtype, None)
    plan = BlockPlan(
        int(spec["m"]), int(spec["n"]), int(spec["k"]), int(spec["bm"]), int(spec["bn"]), int(spec["bk"]),
        in_dtype=dtype,
        quant_block_k=qbk,
        out_dtype_bytes=(int(spec["out_dtype_bytes"]) if spec.get("out_dtype_bytes") is not None
                         else (hw.dtype_bytes("bfloat16") if qbk else None)),
    )
    return audit_matmul_plan(
        plan,
        dtype=dtype,
        device=device,
        backend=spec.get("backend", SYSTOLIC),
        experts=int(spec.get("experts", 1)),
        k_major=bool(spec.get("k_major", False)),
        declared_smem_bytes=spec.get("declared_smem_bytes"),
        declared_in_dtype_bytes=spec.get("declared_in_dtype_bytes"),
    )


def load_plan_specs(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["plans"] if isinstance(doc, dict) else doc


def run_audit(
    *,
    device: str | torch.device | None = "cuda",
    plans_file: str | None = None,
    sweep: bool = True,
    dispatch: bool = True,
) -> tuple[list[Finding], dict[str, Any]]:
    """The CLI's audit engine: dispatch paths + paper sweep + injected plans."""
    t = _target(device)
    findings: list[Finding] = []
    stats: dict[str, Any] = _stats_base(t)
    if dispatch:
        f, s = audit_dispatch_paths(t)
        findings.extend(f)
        stats.update(s)
    if sweep:
        f, s = sweep_paper_candidates(t)
        findings.extend(f)
        stats.update(s)
    if plans_file:
        specs = load_plan_specs(plans_file)
        for spec in specs:
            findings.extend(audit_plan_spec(spec, t))
        stats["injected_plans"] = len(specs)
    return findings, stats


def kernel_report(device: str | torch.device | None = "cuda") -> list[dict[str, Any]]:
    """Registers, spill bytes and shared memory of every path of every
    library, for each output dtype, as the binaries report them (card
    only), at small representative shapes: the compiled kernel a path runs
    does not depend on the shape."""
    t = _target(device)
    if not t.card:
        raise RuntimeError("kernel_report reads the binaries: it needs the card")
    rows = []

    def row(library, path, dtype, out, query):
        launch, comp = query
        rows.append({"library": library, "path": path, "dtype": dtype, "out": out, "regs": comp.regs,
                     "local_bytes": comp.local_bytes, "static_smem": comp.static_smem,
                     "dyn_smem": launch.dyn_smem, "threads": launch.threads})

    for path in mm_kernel.PATHS:
        dt = torch.float32 if path.startswith("fma") else torch.bfloat16
        m = 8 if path.startswith("decode") else 256
        for out in (torch.bfloat16, torch.float32):
            row("systolic_mmm", path, dt, out, mm_kernel.launch_query(path, m, 256, 1024, dt, out))
    for dt in (torch.int8, torch.float8_e4m3fn):
        for path in mm_kernel.qtiles(dt):
            m = 8 if path == "decode" else 256
            for out in (torch.bfloat16, torch.float32):
                row("systolic_qmm", path, dt, out, mm_kernel.qlaunch_query(path, m, 256, 1024, 128, 128, dt, out))
    for path in grouped_kernel.PATHS:
        dt = torch.float32 if path == "fma" else torch.bfloat16
        c = 8 if path == "decode" else 256
        row("grouped_mmm", path, dt, dt, grouped_kernel.launch_query(path, 4, c, 256, 256, dt))
    for dt, d in ((torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 128)):
        row("flash_attn", f"d{d}", dt, dt, attn_kernel.launch_query(1, 2, 2, 256, 256, d, dt))
    for r in rows:
        r["dtype"], r["out"] = hw._dtype_name(r["dtype"]), hw._dtype_name(r["out"])
    return rows
