"""The paper's analytical performance model, equations (1)-(19), as code.

A copy of ``repro.core.analytical``: every equation in Sections II-V of
Gorlani & Plessl (2021), over the paper's Stratix-10 constants
(``hw.STRATIX10``), and the paper's measured tables (I-V) as data.
``tests/test_torch_analytical.py`` holds the copy equal to the original; the
card-side generalisation of the same methodology (balance equations deciding
block sizes) lives in ``core/blocking.py``.

Notation follows the paper:
  d_i0, d_j0, d_k0, d_p   -- systolic array sizes (superscript 0)
  d_i1, d_j1              -- level-1 (on-chip cache) block sizes
  d_i2, d_j2, d_k2        -- off-chip matrix sizes (superscript 2)
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hw


# ---------------------------------------------------------------------------
# Section II: pipelines, global memory, DSPs.
# ---------------------------------------------------------------------------


def pipeline_total_latency(l_body: float, ii: float, n_iterations: float) -> float:
    """l_tot = l_body + II * #it   [cycles]."""
    return l_body + ii * n_iterations


def op_throughput(t_op_per_cycle: float, f_max_hz: float, stall: float = 0.0) -> float:
    """Eqs. (1)/(3): T_op = (1 - stall) * T_op[op/cycle] * f_max  [op/s]."""
    if not 0.0 <= stall < 1.0:
        raise ValueError(f"stall must be in [0, 1), got {stall}")
    return (1.0 - stall) * t_op_per_cycle * f_max_hz


def stall_rate(
    b_r_bytes_per_cycle: float,
    f_max_hz: float,
    b_ddr_bytes_per_s: float,
    efficiency: float = 1.0,
) -> float:
    """Eq. (2) condition + stall formula.

    A stall exists iff  B_r * f_max > e * B_ddr;  then
    stall = 1 - e*B_ddr / (B_r * f_max).
    """
    requested = b_r_bytes_per_cycle * f_max_hz
    supplied = efficiency * b_ddr_bytes_per_s
    if requested <= supplied:
        return 0.0
    return 1.0 - supplied / requested


def dsp_peak_flops(n_dsp: int, f_max_hz: float) -> float:
    """Eq. (5): T_peak = 2 * #DSP * f_max  [FLOP/s]."""
    return hw.STRATIX10.flop_per_dsp_cycle * n_dsp * f_max_hz


def dot_unit_flop_throughput(d_p: int) -> int:
    """Eq. (7): a dot-product unit of width d_p does 2*d_p FLOP/cycle."""
    return 2 * d_p


def dot_unit_input_demand(d_p: int) -> int:
    """Eq. (8): B_in = 2*d_p + 1 sp-floats/cycle (z plus d_p of v and w)."""
    return 2 * d_p + 1


# ---------------------------------------------------------------------------
# Section III: the systolic arrays (Definitions 1 and 2).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Classical2DArray:
    """Definition 1 (Okuda-Song): d_i0 x d_j0 grid of MAC units."""

    d_i0: int
    d_j0: int
    l_mac: int = 5  # latency of one MAC unit, design-dependent

    def total_latency(self, k: int) -> int:
        return self.d_i0 + self.d_j0 + k - 1 + self.l_mac

    @property
    def flop_throughput(self) -> int:
        return 2 * self.d_i0 * self.d_j0

    @property
    def data_throughput(self) -> tuple[int, int]:
        """(B_A, B_B) sp-floats/cycle entering the grid."""
        return self.d_i0, self.d_j0


@dataclasses.dataclass(frozen=True)
class Systolic3DArray:
    """Definition 2: d_i0 x d_j0 x (d_k0/d_p) grid of dot-product units."""

    d_i0: int
    d_j0: int
    d_k0: int
    d_p: int
    l_dot: int = 6  # latency of one d_p-wide dot unit, design-dependent

    def __post_init__(self):
        if self.d_k0 % self.d_p != 0:
            raise ValueError(
                f"d_k0 ({self.d_k0}) must be a multiple of d_p ({self.d_p})"
            )

    @property
    def n_layers(self) -> int:
        return self.d_k0 // self.d_p

    @property
    def n_pe(self) -> int:
        """Eq. (12): #PE = d_i0 * d_j0 * d_k0 / d_p."""
        return self.d_i0 * self.d_j0 * self.n_layers

    @property
    def n_dsp(self) -> int:
        """Eq. (11): #DSP = d_i0 * d_j0 * d_k0."""
        return self.d_i0 * self.d_j0 * self.d_k0

    @property
    def flop_throughput(self) -> int:
        """Eq. (9): T_flop = 2 * d_i0 * d_j0 * d_k0  [FLOP/cycle]."""
        return 2 * self.d_i0 * self.d_j0 * self.d_k0

    @property
    def data_throughput(self) -> tuple[int, int]:
        """Eq. (10): (B_A, B_B) = (d_i0*d_k0, d_k0*d_j0) sp-floats/cycle."""
        return self.d_i0 * self.d_k0, self.d_k0 * self.d_j0

    def total_latency(self, k: int) -> float:
        """Definition 2 total latency (K is the common contraction dim)."""
        return (
            self.d_i0
            + self.d_j0
            + k / self.d_k0
            - 1
            + self.n_layers * self.l_dot
        )

    def loop_body_latency(self) -> float:
        """Eq. (13): l_body = d_i0 + d_j0 - 1 + (d_k0/d_p)*l_dot."""
        return self.d_i0 + self.d_j0 - 1 + self.n_layers * self.l_dot

    def peak_flops(self, f_max_hz: float) -> float:
        return dsp_peak_flops(self.n_dsp, f_max_hz)


# ---------------------------------------------------------------------------
# Section IV: reuse ratios and two-level blocking (Definition 4).
# ---------------------------------------------------------------------------


def reuse_ratios(
    b_a: float, b_b: float, b_g_a: float, b_g_b: float
) -> tuple[float, float]:
    """Eq. (14): r_A = B_A / B_gA,  r_B = B_B / B_gB.

    The minimum number of times each cached element must be reused so the
    global-memory stream (b_g_*) keeps the array (b_*) fed without stalls.
    """
    if b_g_a <= 0 or b_g_b <= 0:
        raise ValueError("global-memory throughputs must be positive")
    return b_a / b_g_a, b_b / b_g_b


def level1_blocks(
    array: Systolic3DArray, b_g_a: float, b_g_b: float
) -> tuple[int, int]:
    """Eq. (18): d_i1 = r_B * d_i0,  d_j1 = r_A * d_j0.

    Note the crossing: A's reuse ratio scales the *j* block (each cached A
    element is reused across r_A different j-columns of the outer product)
    and vice versa.
    """
    b_a, b_b = array.data_throughput
    r_a, r_b = reuse_ratios(b_a, b_b, b_g_a, b_g_b)
    d_i1 = int(math.ceil(r_b)) * array.d_i0
    d_j1 = int(math.ceil(r_a)) * array.d_j0
    return d_i1, d_j1


def compute_fraction(
    d_k2: int, array: Systolic3DArray, b_ddr_floats_per_cycle: float
) -> float:
    """Eq. (19): the fraction of pipeline iterations that are Compute ones.

    c_% = (d_k2/d_k0) / (1 + d_k2/d_k0 + d_i0*d_j0/B_ddr)

    The `1` is the non-overlapped initial Read, the middle term the
    overlapped Read/Compute iterations, the last the un-overlapped Write
    of a (d_i0 x d_j0) C tile at B_ddr floats/cycle per FIFO drain.
    This predicts the measured DSP efficiency e_D of Tables II-V.
    """
    k_iters = d_k2 / array.d_k0
    write_iters = array.d_i0 * array.d_j0 / b_ddr_floats_per_cycle
    return k_iters / (1.0 + k_iters + write_iters)


def matmul_flops(d_i2: int, d_j2: int, d_k2: int) -> int:
    """Section VI: #FLOP = d_i2 * d_j2 * (2*d_k2 - 1)."""
    return d_i2 * d_j2 * (2 * d_k2 - 1)


def measured_throughput(d_i2: int, d_j2: int, d_k2: int, seconds: float) -> float:
    """T_flops = #FLOP / kernel execution time."""
    return matmul_flops(d_i2, d_j2, d_k2) / seconds


def dsp_efficiency(t_flops: float, t_peak: float) -> float:
    """e_D = T_flops / T_peak."""
    return t_flops / t_peak


# ---------------------------------------------------------------------------
# Paper designs (Table I) for regression tests and benchmarks.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PaperDesign:
    ident: str
    array: Systolic3DArray
    f_max_hz: float | None  # None => fitter failed
    d_i1: int | None = None
    d_j1: int | None = None

    @property
    def fitter_ok(self) -> bool:
        return self.f_max_hz is not None

    def t_peak(self) -> float | None:
        if self.f_max_hz is None:
            return None
        return self.array.peak_flops(self.f_max_hz)


def paper_designs() -> dict[str, PaperDesign]:
    """Table I, with the level-1 block sizes from Tables II-V captions."""
    mk = Systolic3DArray
    return {
        "A": PaperDesign("A", mk(28, 28, 6, 3), None),
        "B": PaperDesign("B", mk(28, 28, 6, 2), None),
        "C": PaperDesign("C", mk(28, 28, 6, 1), 368e6, 672, 672),
        "D": PaperDesign("D", mk(72, 32, 2, 2), None),
        "E": PaperDesign("E", mk(72, 32, 2, 1), 368e6, 576, 576),
        "F": PaperDesign("F", mk(70, 32, 2, 2), 410e6, 560, 640),
        "G": PaperDesign("G", mk(64, 32, 2, 2), 398e6, 512, 512),
        "H": PaperDesign("H", mk(32, 32, 4, 4), 408e6, 512, 512),
        "I": PaperDesign("I", mk(32, 32, 4, 2), 396e6, 512, 512),
        "L": PaperDesign("L", mk(32, 16, 8, 8), 391e6, 512, 512),
        "M": PaperDesign("M", mk(32, 16, 8, 4), 363e6, 512, 512),
        "N": PaperDesign("N", mk(32, 16, 8, 2), 381e6, 512, 512),
    }


# Measured e_D per design per matrix size (Tables II-V), used as the
# regression target for eq. (19).  Keys are (design, d2).
PAPER_MEASURED_ED: dict[tuple[str, int], float] = {
    ("C", 672): 0.51, ("C", 1344): 0.67, ("C", 2688): 0.78,
    ("C", 5376): 0.84, ("C", 10752): 0.87, ("C", 21504): 0.89,
    ("E", 576): 0.47, ("E", 1152): 0.71, ("E", 2304): 0.82,
    ("E", 4608): 0.90, ("E", 9216): 0.95, ("E", 18432): 0.97,
    ("F", 560): 0.46, ("F", 1120): 0.68, ("F", 2240): 0.81,
    ("F", 4480): 0.89, ("F", 8960): 0.94, ("F", 17920): 0.96,
    ("G", 512): 0.45, ("G", 1024): 0.65, ("G", 2048): 0.80,
    ("G", 4096): 0.89, ("G", 8192): 0.94, ("G", 16384): 0.97,
    ("H", 512): 0.47, ("H", 1024): 0.65, ("H", 2048): 0.80,
    ("H", 4096): 0.88, ("H", 8192): 0.94, ("H", 16384): 0.97,
    ("I", 512): 0.48, ("I", 1024): 0.66, ("I", 2048): 0.80,
    ("I", 4096): 0.89, ("I", 8192): 0.94, ("I", 16384): 0.97,
    ("L", 512): 0.47, ("L", 1024): 0.65, ("L", 2048): 0.80,
    ("L", 4096): 0.88, ("L", 8192): 0.94, ("L", 16384): 0.97,
    ("M", 512): 0.49, ("M", 1024): 0.67, ("M", 2048): 0.81,
    ("M", 4096): 0.89, ("M", 8192): 0.94, ("M", 16384): 0.97,
    ("N", 512): 0.49, ("N", 1024): 0.66, ("N", 2048): 0.81,
    ("N", 4096): 0.89, ("N", 8192): 0.94, ("N", 16384): 0.97,
}
