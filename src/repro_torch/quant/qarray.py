"""Block-scaled quantized arrays (symmetric, zero-point-free).

The counterpart of ``repro.quant.qarray``, in PyTorch.  A ``QArray`` holds
narrow values (int8 or fp8 e4m3) plus fp32 per-block scales over the **last
two** axes; every leading axis gets per-index scales.  ``block = (qr, qc)``
tiles those two axes, ``0`` meaning "whole axis":

  * activations (M, K):  block (1, qk)  -> per-row x per-k-block scales
  * weights    (K, N):  block (qk, 1)  -> per-k-block x per-column scales

Quantization is symmetric round-to-nearest-even: ``scale = absmax / qmax``
per block, ``q = clip(round(x * (1 / scale)))`` (a multiply by the
reciprocal, as the reference does -- ``x / scale`` rounds differently on some
elements).  fp8 clips to +-448 and casts with round-to-nearest-even.
All-zero blocks get scale 1.  The values equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# Default scale granularity along the contraction axis.
DEFAULT_BLOCK_K = 128

# qdtype name -> (storage dtype, qmax); fp8's qmax is e4m3's largest finite value.
_QDTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}

QDTYPES = tuple(_QDTYPES)


def qdtype_info(qdtype: str):
    """(storage dtype, qmax) for a quantized dtype name."""
    try:
        return _QDTYPES[qdtype]
    except KeyError:
        raise ValueError(f"unknown quant dtype {qdtype!r}; valid: {QDTYPES}") from None


def _dtype_name(dtype) -> str:
    """"int8" / "float8_e4m3fn" for a torch dtype, the string itself otherwise."""
    return str(dtype).removeprefix("torch.")


def canonical_qdtype(qdtype) -> str:
    """Map aliases ("float8_e4m3fn", torch dtypes) onto the registry keys."""
    name = _dtype_name(qdtype)
    if name in _QDTYPES:
        return name
    if name.startswith("float8"):
        return "fp8"
    if name in ("int8", "i8"):
        return "int8"
    raise ValueError(f"unknown quant dtype {qdtype!r}; valid: {QDTYPES}")


def _resolve_block(shape, block) -> tuple[int, int]:
    """Normalise ``block`` against the last two axes (0/None = whole axis)."""
    if len(shape) < 2:
        raise ValueError(f"QArray needs ndim >= 2, got shape {tuple(shape)}")
    r, c = shape[-2], shape[-1]
    qr, qc = block
    qr = r if not qr else min(int(qr), r)
    qc = c if not qc else min(int(qc), c)
    if qr < 1 or qc < 1:
        raise ValueError(f"invalid quant block {block}")
    return qr, qc


def _blocked(x: torch.Tensor, qr: int, qc: int) -> torch.Tensor:
    """(..., R, C) -> (..., ceil(R/qr), qr, ceil(C/qc), qc): whole blocks,
    the ragged edge zero-padded."""
    *lead, r, c = x.shape
    rp = -(-r // qr) * qr
    cp = -(-c // qc) * qc
    if (rp, cp) != (r, c):
        x = F.pad(x, (0, cp - c, 0, rp - r))
    return x.reshape(*lead, rp // qr, qr, cp // qc, qc)


def _unblocked(xb: torch.Tensor, r: int, c: int) -> torch.Tensor:
    """Inverse of ``_blocked``: (..., R, C), the padding cut off."""
    *lead, nr, qr, nc, qc = xb.shape
    return xb.reshape(*lead, nr * qr, nc * qc)[..., :r, :c].contiguous()


def _per_block(scales: torch.Tensor) -> torch.Tensor:
    """(..., nR, nC) scales broadcastable against a ``_blocked`` array.  The
    reference expands them to element resolution (``_expand_scales``); a
    broadcast gives every element the same value without the copy."""
    return scales[..., :, None, :, None]


@dataclasses.dataclass(frozen=True)
class QArray:
    """Block-scaled quantized array.

    ``values``: int8 or float8_e4m3fn, the original shape.  ``scales``: fp32
    with the last two axes reduced to block counts.  ``block``: the (qr, qc)
    tile of the last two axes the scales apply to (element counts, clamped to
    the axis lengths).  ``qdtype``: registry name ("int8" | "fp8").
    """

    values: torch.Tensor
    scales: torch.Tensor
    block: tuple[int, int]
    qdtype: str

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self) -> int:
        return self.values.ndim

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        qr, qc = self.block
        r, c = self.values.shape[-2:]
        xb = _blocked(self.values.float(), qr, qc) * _per_block(self.scales)
        return _unblocked(xb.to(dtype), r, c)


def quantize(
    x: torch.Tensor,
    qdtype: str = "int8",
    *,
    block: tuple[int, int] = (1, DEFAULT_BLOCK_K),
) -> QArray:
    """Symmetric block-scaled quantization over the last two axes."""
    qdtype = canonical_qdtype(qdtype)
    storage, qmax = qdtype_info(qdtype)
    qr, qc = _resolve_block(x.shape, block)
    r, c = x.shape[-2:]
    xb = _blocked(x.float(), qr, qc)
    absmax = xb.abs().amax(dim=(-3, -1))
    scales = torch.where(absmax > 0, absmax / qmax, 1.0).float()
    scaled = xb * _per_block(1.0 / scales)  # the reciprocal's multiply, as the reference
    if qdtype == "int8":
        values = torch.clamp(torch.round(scaled), -qmax, qmax).to(storage)
    else:
        values = torch.clamp(scaled, -qmax, qmax).to(storage)
    return QArray(values=_unblocked(values, r, c), scales=scales, block=(qr, qc), qdtype=qdtype)


# ---------------------------------------------------------------------------
# GEMM-operand conveniences (the shapes core.ops / kernels dispatch with).
# ---------------------------------------------------------------------------


def quantize_act(x: torch.Tensor, qdtype: str = "int8", *, block_k: int = DEFAULT_BLOCK_K) -> QArray:
    """(..., M, K) activations: per-row x per-k-block scales."""
    return quantize(x, qdtype, block=(1, block_k))


def quantize_weight(w: torch.Tensor, qdtype: str = "int8", *, block_k: int = DEFAULT_BLOCK_K) -> QArray:
    """(..., K, N) weights: per-k-block x per-column scales."""
    return quantize(w, qdtype, block=(block_k, 1))
