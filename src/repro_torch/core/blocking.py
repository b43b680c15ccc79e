"""The card-side generalisation of the paper's reuse-ratio blocking (Def. 4).

The counterpart of ``repro.core.blocking``.  The paper derives its level-1
block sizes from *balance equations*: the on-chip cache must re-serve each
element r = B_array / B_global times so the slower memory level never stalls
the MACs (eqs. 14, 18).  On the H100 the same argument applies at each level:

  level 0  tensor-core instruction (wgmma m64nNk16 -- the paper's d_p)
  level 1  shared-memory tile      (bm, bn, bk) x stages  <- this module
  level 2  the card                (HBM resident)
  level 3  NVLink shards           (tp members below)

At each level the condition is eq. (14)'s:

  arithmetic_intensity(block) >= machine_balance(level)

and the paper's "fitter failure" rows of Table I become an analytical
shared-memory and register check.  The chip-neutral members (flops, HBM
traffic, intensity, reuse, the roofline terms, the tp members) are the
reference's; the on-chip accounting is the card's: a ring of ``stages``
(bm, bk) + (bk, bn) operand stages in shared memory, and the fp32
accumulator in the consumer threads' registers, not in shared memory.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hw

# Registers of a consumer thread that the accumulator cannot take: operand
# descriptors, addresses, loop state and the epilogue's values.
NON_ACC_REGS = 64
# wgmma_gemm.cuh: the TMA ring's stages and, past them, 8 bytes of mbarrier
# per stage for "full" and "empty" each and 1024 bytes of alignment slack.
STAGES = 4
BARRIER_BYTES = 8
ALIGN_BYTES = 1024


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """A concrete (bm, bn, bk) tiling of an (M, N, K) matmul."""

    m: int
    n: int
    k: int
    bm: int
    bn: int
    bk: int
    in_dtype_bytes: int = 2  # bf16 streams (derived from in_dtype when set)
    acc_dtype_bytes: int = 4  # fp32 accumulator, always
    stages: int = STAGES  # operand stages in the shared-memory ring
    # -- level-3 (NVLink): the tensor-parallel degree this plan shards over
    # (A row-sharded, B column-sharded, tp ring steps of an (m/tp, k) x
    # (k, n/tp) block each); tp=1 is the single-card plan.
    tp: int = 1
    # -- dtype identity: when set, ``in_dtype_bytes`` is derived from
    # hw.DTYPE_BYTES and the compute term uses the per-dtype peak.
    in_dtype: str | None = None
    # -- quantization: scale-block length along K (0 = not quantized).
    # Quantized plans stream fp32 scale sidecars -- per-row x per-k-block for
    # A, per-k-block x per-column for B -- which count toward shared memory
    # and HBM traffic below.
    quant_block_k: int = 0
    scale_dtype_bytes: int = 4
    # Output element size; None = same as the input stream (fp plans).
    out_dtype_bytes: int | None = None

    def __post_init__(self):
        if self.in_dtype is not None:
            object.__setattr__(self, "in_dtype_bytes", hw.dtype_bytes(self.in_dtype))

    @property
    def _out_bytes(self) -> int:
        return self.in_dtype_bytes if self.out_dtype_bytes is None else self.out_dtype_bytes

    @property
    def _k_scale_blocks(self) -> int:
        """Number of scale blocks along K (0 when unquantized)."""
        if not self.quant_block_k:
            return 0
        return math.ceil(self.k / self.quant_block_k)

    # -- level-1 (shared memory, registers): the "fitter" check --------------

    def smem_bytes(self) -> int:
        """Shared memory of one block: ``stages`` stages of an A (bm, bk) and
        a B (bk, bn) tile -- plus, quantized, one stage's row and column
        scales --, a full and an empty mbarrier per stage, and the alignment
        slack of the 128-byte swizzle.  Equal to what the wgmma tiles
        allocate (``WgTile::SMEM`` in csrc/wgmma_gemm.cuh, ``QTile::SMEM`` in
        csrc/systolic_qmm.cu).  The output tile is staged through the drained
        ring and the accumulator lives in registers, so neither adds here."""
        a_block = self.bm * self.bk * self.in_dtype_bytes
        b_block = self.bk * self.bn * self.in_dtype_bytes
        scales = (self.bm + self.bn) * self.scale_dtype_bytes if self.quant_block_k else 0
        return self.stages * (a_block + b_block + scales) + 2 * self.stages * BARRIER_BYTES + ALIGN_BYTES

    def fits_smem(self, chip: hw.GPU | str | None = None) -> bool:
        return self.smem_bytes() <= hw.get_chip(chip).smem_per_block

    def acc_regs_per_thread(self) -> int:
        """fp32 accumulator registers of one consumer thread: a consumer
        warpgroup of 128 threads holds 64 rows of the (bm, bn) tile."""
        threads = 128 * max(1, math.ceil(self.bm / 64))
        return math.ceil(self.bm * self.bn * self.acc_dtype_bytes / 4 / threads)

    def fits_registers(self, chip: hw.GPU | str | None = None) -> bool:
        return self.acc_regs_per_thread() <= hw.get_chip(chip).regs_per_consumer_thread - NON_ACC_REGS

    def mma_aligned(self, chip: hw.GPU | str | None = None) -> bool:
        """All three dims on wgmma's quanta: bm whole warpgroup instructions
        of 64 rows, bn a multiple of 8 within one instruction's 256, bk whole
        32-byte instructions."""
        chip = hw.get_chip(chip)
        return (
            self.bm % chip.mma_m == 0
            and self.bn % chip.mma_n == 0
            and self.bn <= chip.mma_n_max
            and self.bk * self.in_dtype_bytes % chip.mma_k_bytes == 0
        )

    # -- reuse ratios (paper eq. 14 reinterpreted) ---------------------------

    def reuse_ratios(self) -> tuple[float, float]:
        """(r_A, r_B): how many times each loaded element is used.

        With a C-stationary accumulator, an A element loaded on chip is used
        bn times (once per output column in the block) and a B element bm
        times.  These play exactly the role of eq. (14).
        """
        return float(self.bn), float(self.bm)

    def hbm_traffic_bytes(self) -> int:
        """Total HBM bytes moved by the whole (M,N,K) matmul under this plan.

        A is re-read once per column-block (N/bn times), B once per
        row-block (M/bm times); C is written once.  On the card the 50 MB L2
        serves many of those re-reads, so a measured time can lie below
        ``memory_seconds``; the least time the card can take reads each
        input once.
        """
        n_col_blocks = math.ceil(self.n / self.bn)
        n_row_blocks = math.ceil(self.m / self.bm)
        a_bytes = self.m * self.k * self.in_dtype_bytes * n_col_blocks
        b_bytes = self.k * self.n * self.in_dtype_bytes * n_row_blocks
        c_bytes = self.m * self.n * self._out_bytes
        s_bytes = 0
        if self.quant_block_k:
            kb = self._k_scale_blocks
            # Scale sidecars re-stream with their value arrays: A's (M, kb)
            # once per column block, B's (kb, N) once per row block.
            s_bytes = (
                self.m * kb * self.scale_dtype_bytes * n_col_blocks
                + kb * self.n * self.scale_dtype_bytes * n_row_blocks
            )
        return a_bytes + b_bytes + c_bytes + s_bytes

    def flops(self) -> int:
        return 2 * self.m * self.n * self.k

    def arithmetic_intensity(self) -> float:
        """FLOP per HBM byte under this plan (to compare with ~295)."""
        return self.flops() / self.hbm_traffic_bytes()

    def compute_bound(self, chip: hw.GPU | str | None = None) -> bool:
        return self.arithmetic_intensity() >= hw.get_chip(chip).machine_balance(self.in_dtype)

    # -- roofline terms (seconds on one card) --------------------------------

    def compute_seconds(self, chip: hw.GPU | str | None = None) -> float:
        return self.flops() / hw.get_chip(chip).peak_flops(self.in_dtype)

    def memory_seconds(self, chip: hw.GPU | str | None = None) -> float:
        return self.hbm_traffic_bytes() / hw.get_chip(chip).hbm_bw

    def bound_by(self, chip: hw.GPU | str | None = None) -> str:
        return "compute" if self.compute_seconds(chip) >= self.memory_seconds(chip) else "memory"

    # -- level-3 (NVLink) balance: eq. (14) across cards ---------------------
    # An overlapped collective matmul runs tp ring steps; during each, one A
    # chunk of (m/tp, k) crosses one link while an (m/tp, k) x (k, n/tp)
    # block matmul computes.  "Balanced" = the hop hides under the step.

    def shard_shape(self) -> tuple[int, int, int]:
        """The per-ring-step (m, n, k) problem each shard computes."""
        return (self.m // self.tp, self.n // self.tp, self.k)

    def hop_bytes(self) -> int:
        """Bytes one ring hop moves (one A chunk)."""
        if self.tp == 1:
            return 0
        return (self.m // self.tp) * self.k * self.in_dtype_bytes

    def hop_seconds(self, chip: hw.GPU | str | None = None, links: int = 1) -> float:
        return self.hop_bytes() / (hw.get_chip(chip).nvlink_bw_per_link * links)

    def shard_step_seconds(self, chip: hw.GPU | str | None = None) -> float:
        """Compute time of one ring step's block matmul on one shard."""
        sm, sn, sk = self.shard_shape()
        return 2 * sm * sn * sk / hw.get_chip(chip).peak_flops(self.in_dtype)

    def mesh_balanced(self, chip: hw.GPU | str | None = None, links: int = 1) -> bool:
        """Collective-bytes-under-compute: every hop hides under a step."""
        if self.tp == 1:
            return True
        return self.hop_seconds(chip, links) <= self.shard_step_seconds(chip)


def round_up(x: int, q: int) -> int:
    """Smallest multiple of q >= x (the padding quantum used everywhere)."""
    return (x + q - 1) // q * q


def _round_to(x: int, quantum: int) -> int:
    return max(quantum, (x // quantum) * quantum)


def derive_block_plan(
    m: int,
    n: int,
    k: int,
    *,
    in_dtype: str | None = None,
    in_dtype_bytes: int | None = None,
    chip: hw.GPU | str | None = None,
    max_bm: int = 1024,
    max_bn: int = 1024,
    max_bk: int = 2048,
) -> BlockPlan:
    """Derive a balanced (bm, bn, bk) from the level-1 balance equation.

    The paper's eq. (18) for the card, as the reference derives it for the
    TPU: start from the square block whose reuse meets the machine balance
    (AI ~ 2 bm bn / ((bm + bn) bytes) >= ~295 FLOP/B at bf16 gives 1024),
    with bk as large as K allows; then, while the block does not fit --
    ``stages`` stages in shared memory, the accumulator in a consumer
    thread's registers, wgmma's quanta --, halve bk down to one 128-byte
    swizzle panel first (the paper's cheap axis: it adds reuse for neither
    operand), then the larger of bm and bn (bm on a tie).  At large shapes in
    bf16 this lands on 128 x 256 x 64 with 4 stages, the kernel's widest
    wgmma tile.
    """
    chip = hw.get_chip(chip)
    if in_dtype is not None:
        in_dtype_bytes = hw.dtype_bytes(in_dtype)
    elif in_dtype_bytes is None:
        in_dtype_bytes = hw.dtype_bytes("bfloat16")
    qm, qn = chip.mma_m, chip.mma_n
    qk = 128 // in_dtype_bytes  # one 128-byte swizzle panel of k

    target = chip.machine_balance_hbm * in_dtype_bytes  # bm == bn target value
    side = _round_to(int(2 ** math.ceil(math.log2(max(qm, target)))), qm)
    bm = min(side, max(qm, round_up(m, qm)), max_bm)
    bn = min(side, max(qm, round_up(n, qm)), max_bn)
    bk = min(max_bk, _round_to(k, qk) if k >= qk else qk)

    def plan():
        return BlockPlan(m, n, k, bm, bn, bk, in_dtype=in_dtype, in_dtype_bytes=in_dtype_bytes)

    def fits(p):
        return p.fits_smem(chip) and p.fits_registers(chip) and p.mma_aligned(chip)

    p = plan()
    while not fits(p) and bk > qk:
        bk //= 2
        p = plan()
    while not fits(p) and (bm > qm or bn > qn):
        if bm >= bn and bm > qm:
            bm //= 2
        else:
            bn //= 2
        p = plan()
    if not fits(p):
        raise ValueError(f"no feasible block plan for ({m},{n},{k})")
    return p


# ---------------------------------------------------------------------------
# Level-3: the same balance equation across NVLink (beyond the paper).
# ---------------------------------------------------------------------------


def tensor_parallel_balance(
    m: int,
    n: int,
    k: int,
    tp: int,
    *,
    in_dtype: str | None = None,
    in_dtype_bytes: int | None = None,
    links: int = 1,
    chip: hw.GPU | str | None = None,
) -> dict[str, float]:
    """Check eq.-(14)-style balance for a TP-sharded matmul.

    Shard N over ``tp`` cards; each step all-gathers the (m,k) activations
    (ring: (tp-1)/tp of the tensor crosses each link) and computes
    2*m*(n/tp)*k FLOPs.  Returns the two times and the ratio; ratio <= 1
    means the collective hides under compute (balanced).
    """
    chip = hw.get_chip(chip)
    if in_dtype is not None:
        in_dtype_bytes = hw.dtype_bytes(in_dtype)
    elif in_dtype_bytes is None:
        in_dtype_bytes = hw.dtype_bytes("bfloat16")
    per_chip_flops = 2 * m * n * k / tp
    ag_bytes = m * k * in_dtype_bytes * (tp - 1) / tp
    t_compute = per_chip_flops / chip.peak_flops(in_dtype)
    t_coll = ag_bytes / (chip.nvlink_bw_per_link * links)
    return {
        "t_compute": t_compute,
        "t_collective": t_coll,
        "ratio": t_coll / t_compute if t_compute else float("inf"),
        "balanced": t_coll <= t_compute,
    }
