"""repro_torch.quant: block-scaled int8/fp8 quantization, kernel to serving.

The counterpart of ``repro.quant``:

  * ``qarray``  -- ``QArray`` and quantize;
  * ``params``  -- weight-only quantization of parameter trees;
  * the activation-quantization *policy* below: a contextvar deciding
    whether ``core.ops.matmul`` quantizes activations on the fly when the
    weight is a QArray (w8a8) or leaves them wide (w8a16).

The quantized GEMM kernel lives with its fp sibling in
``repro_torch.kernels.systolic``.
"""

from __future__ import annotations

import contextlib
import contextvars

from repro_torch.quant.params import count_quantized, k_major, quantize_params
from repro_torch.quant.qarray import (
    DEFAULT_BLOCK_K,
    QDTYPES,
    QArray,
    canonical_qdtype,
    quantize,
    quantize_act,
    quantize_weight,
)

__all__ = [
    "DEFAULT_BLOCK_K",
    "QDTYPES",
    "QArray",
    "act_qdtype",
    "canonical_qdtype",
    "count_quantized",
    "k_major",
    "quantize",
    "quantize_act",
    "quantize_params",
    "quantize_weight",
    "use_act_quant",
]

_ACT_QDTYPE = contextvars.ContextVar("repro_torch_act_qdtype", default=None)


def act_qdtype() -> str | None:
    """Quant dtype for on-the-fly activation quantization, or None (w8a16:
    activations stay wide, QArray weights dequantize at the GEMM)."""
    return _ACT_QDTYPE.get()


@contextlib.contextmanager
def use_act_quant(qdtype: str | None):
    """Enable dynamic per-token activation quantization inside the scope
    (``qdtype`` "int8"/"fp8"); ``None`` restores weight-only behaviour."""
    if qdtype is not None:
        qdtype = canonical_qdtype(qdtype)
    token = _ACT_QDTYPE.set(qdtype)
    try:
        yield
    finally:
        _ACT_QDTYPE.reset(token)
