"""Hardware constants: the paper's target (Stratix 10 / Bittware 520N), which
the analytical model reads, and the port's target card, whose numbers the
kernels' bounds, the blocking and the tuner are computed from.

The counterpart of ``repro.core.hw``.  The Stratix-10 record is the
reference's, copied.  The card's rates are NVIDIA's datasheet figures for
the H100 SXM (dense, no sparsity, at the full 700 W power limit), not
measurements: a card set to a lower power limit runs slower under load.  No
TPU record is kept here.  The reference's chip registry has no counterpart:
the port runs on one card, so ``get_chip`` resolves the H100 (or a record
passed in) and nothing retargets it.
"""

from __future__ import annotations

import dataclasses

import torch

# ---------------------------------------------------------------------------
# Paper hardware: Intel Stratix 10 GX2800 on a Bittware 520N.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stratix10:
    """Constants from the paper (Sections II-A/II-B/VI)."""

    # Four DDR4@2400MT/s modules, 19200 MB/s each (Section II-A).
    ddr_modules: int = 4
    ddr_bw_per_module: float = 19200e6  # bytes/s
    # 5760 DSPs on chip; 4713 available to kernel logic after the BSP
    # (Section VI); the paper's designs use at most 4704.
    dsp_total: int = 5760
    dsp_available: int = 4713
    dsp_used_max: int = 4704
    # A DSP in fused multiply-add configuration does 2 FLOP/cycle (eq. 5).
    flop_per_dsp_cycle: int = 2
    sp_float_bytes: int = 4

    def b_ddr_floats_per_cycle(self, f_max_hz: float) -> int:
        """Eq. (4): max sp-floats/cycle one LSU can request without stalls.

        LSUs are power-of-two sized; the byte budget per cycle that one
        memory controller can sustain halves when f_max crosses 300 MHz.
        """
        if f_max_hz <= 150e6:
            raise ValueError("paper model only covers 150 MHz < f_max <= 600 MHz")
        if f_max_hz <= 300e6:
            return 16  # 64 B/cycle
        if f_max_hz <= 600e6:
            return 8  # 32 B/cycle
        raise ValueError("f_max above 600 MHz is outside the paper's model")


STRATIX10 = Stratix10()


# ---------------------------------------------------------------------------
# The port's hardware: an NVIDIA card.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPU:
    name: str
    peak_flops_by_dtype: dict[str, float]  # FLOP/s (int8: op/s) by operand dtype (datasheet)
    hbm_bw: float  # bytes/s (datasheet)
    smem_per_block: int  # bytes of shared memory one block may use
    n_sm: int
    # NVLink: bytes/s one link moves each way (datasheet), for the tp members
    # of core.blocking; and the links a card has (all of them reach the
    # NVSwitch fabric, so a hop to any other card of the host can use them all).
    nvlink_bw_per_link: float
    nvlink_links: int = 18
    # Registers a consumer thread of the two-consumer wgmma tile holds after
    # setmaxnreg (csrc/wgmma_gemm.cuh); its fp32 accumulator lives there.
    regs_per_consumer_thread: int = 232
    # wgmma's quanta: 64 rows per warpgroup instruction, N a multiple of 8
    # (at most 256), K 32 bytes per instruction (16 bf16, 32 int8 / e4m3).
    mma_m: int = 64
    mma_n: int = 8
    mma_n_max: int = 256
    mma_k_bytes: int = 32

    def peak_flops(self, dtype: str | torch.dtype | None = None) -> float:
        """Peak FLOP/s (op/s for int8) for ``dtype`` operands; None is bf16,
        the served dtype.  "fp8" names e4m3, the port's fp8 storage."""
        name = "bfloat16" if dtype is None else _dtype_name(dtype)
        return self.peak_flops_by_dtype["float8_e4m3fn" if name == "fp8" else name]

    @property
    def machine_balance_hbm(self) -> float:
        """FLOP per HBM byte needed to be compute-bound at the bf16 peak
        (~295 for the H100)."""
        return self.peak_flops() / self.hbm_bw

    def machine_balance(self, dtype: str | torch.dtype | None = None) -> float:
        """FLOP per HBM byte needed to be compute-bound on ``dtype`` operands:
        int8 doubles the peak, fp32 (CUDA cores) takes it to ~20."""
        return self.peak_flops(dtype) / self.hbm_bw

    def machine_balance_nvlink(self, links: int = 1) -> float:
        """FLOP per collective byte needed for collectives to hide."""
        return self.peak_flops() / (self.nvlink_bw_per_link * links)

    def bound_s(self, flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
        """Least time for work of ``flops`` operations on ``dtype`` operands
        that moves ``nbytes`` to or from HBM, and which of the two bounds it."""
        t_ops = flops / self.peak_flops(dtype)
        t_bytes = nbytes / self.hbm_bw
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


H100 = GPU(
    name="h100",
    peak_flops_by_dtype={
        "bfloat16": 989e12,  # datasheet: tensor cores, dense
        "float16": 989e12,  # datasheet: tensor cores, dense
        "float32": 67e12,  # datasheet: CUDA cores (no TF32)
        "int8": 1979e12,  # datasheet: tensor cores, dense (ops/s)
        "float8_e4m3fn": 1979e12,  # datasheet: tensor cores, dense
    },
    hbm_bw=3.35e12,  # datasheet: HBM3, 80 GB part
    smem_per_block=232_448,  # 227 KB, opted in per kernel above 48 KB
    n_sm=132,
    nvlink_bw_per_link=25e9,  # datasheet: 900 GB/s over 18 NVLink 4 links, both ways: 25 GB/s each way a link
)


def get_chip(chip: str | GPU | None = None) -> GPU:
    """The card record: ``None`` or "h100" is the H100, a ``GPU`` record
    passes through (the parity tests build one from the reference's
    constants); any other name raises."""
    if chip is None or chip == H100.name:
        return H100
    if isinstance(chip, GPU):
        return chip
    raise KeyError(f"unknown chip {chip!r}; the port targets {H100.name!r}")


DTYPE_BYTES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "fp8": 1,
    "float8_e4m3fn": 1,
    "int32": 4,
}


def _dtype_name(dtype: str | torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def dtype_bytes(dtype: str | torch.dtype) -> int:
    """Bytes per element of a dtype given by name or as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return DTYPE_BYTES[_dtype_name(dtype)]
