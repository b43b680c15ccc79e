"""The port's target card, as the numbers its kernels' bounds are computed from.

All rates are NVIDIA's datasheet figures for the H100 SXM (dense, no
sparsity, at the full 700 W power limit), not measurements: a card set to a
lower power limit runs slower under load.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GPU:
    name: str
    peak_flops: dict[str, float]  # FLOP/s (int8: op/s) by operand dtype (datasheet)
    hbm_bw: float  # bytes/s (datasheet)
    smem_per_block: int  # bytes of shared memory one block may use
    n_sm: int

    def bound_s(self, flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
        """Least time for work of ``flops`` operations on ``dtype`` operands
        that moves ``nbytes`` to or from HBM, and which of the two bounds it."""
        t_ops = flops / self.peak_flops[dtype]
        t_bytes = nbytes / self.hbm_bw
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


H100 = GPU(
    name="h100",
    peak_flops={
        "bfloat16": 989e12,  # datasheet: tensor cores, dense
        "float16": 989e12,  # datasheet: tensor cores, dense
        "float32": 67e12,  # datasheet: CUDA cores (no TF32)
        "int8": 1979e12,  # datasheet: tensor cores, dense (ops/s)
        "float8_e4m3fn": 1979e12,  # datasheet: tensor cores, dense
    },
    hbm_bw=3.35e12,  # datasheet: HBM3, 80 GB part
    smem_per_block=232_448,  # 227 KB, opted in per kernel above 48 KB
    n_sm=132,
)

DTYPE_BYTES = {
    "float32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "float8_e4m3fn": 1,
    "int32": 4,
}


def dtype_bytes(dtype: str | torch.dtype) -> int:
    """Bytes per element of a dtype given by name or as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return DTYPE_BYTES[str(dtype)]
