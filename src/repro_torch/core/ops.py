"""The matmuls every model projection and expert GEMM go through, and the
fp32-accumulating einsum.

The counterpart of ``repro.core.ops``.  There is no backend switch: on the
card every fp projection *is* the hand-written systolic kernel, every w8a8
projection the block-scaled one and every MoE expert GEMM the grouped one;
on the CPU their plain versions.  Each fp projection runs in a sampled
timing window (``obs.profile``) when the profiler is active, as the
reference's does.  Under ``distributed.tensor_parallel(mesh)`` an eligible
fp projection runs as the overlapped collective matmul instead
(``collective_matmul.maybe_tp_matmul``: replicated operands, the replicated
product); anything indivisible falls through to the single-card kernel.
"""

from __future__ import annotations

import torch

from repro_torch import quant
from repro_torch.distributed import collective_matmul as _cm
from repro_torch.kernels.grouped import ops as grouped_ops
from repro_torch.kernels.systolic import ops as systolic_ops
from repro_torch.obs import profile as _obs_profile
from repro_torch.quant.qarray import QArray


def matmul(x: torch.Tensor, w: torch.Tensor | QArray, *, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` with x of shape (..., K) and w of shape (K, N), fp32 accumulation.

    A ``QArray`` weight goes to the quantized dispatch: weight-only (w8a16:
    it dequantizes at the GEMM) unless ``quant.use_act_quant`` makes it w8a8.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    if w.shape[0] != k:
        raise ValueError(f"matmul shape mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    if isinstance(w, QArray):
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("a quantized (QArray) weight has no backward: quantized weights serve, "
                               "the reference does not train them")
        return _quant_matmul(x, w, out_dtype=out_dtype)
    x2, out_dtype = x.reshape(-1, k), out_dtype or x.dtype
    y2 = _cm.maybe_tp_matmul(x2, w, out_dtype=out_dtype) if _cm.current_tensor_parallel() is not None else None
    if y2 is not None:
        return y2.reshape(*lead, w.shape[1])
    prof = _obs_profile.get_profiler()
    if prof.active():
        # Sampled measured timing: the host clock from the call to the card's
        # finishing it, labelled "eager-wall" so the drift watchdog never holds
        # it against a plan the card timed with CUDA events.
        y2, wall = prof.timed("profile.gemm", lambda: systolic_ops.matmul(x2, w, out_dtype=out_dtype),
                              backend=systolic_ops.BACKEND)
        if wall is not None:
            _obs_profile.record_gemm_sample(x2.shape[0], w.shape[1], k, backend=systolic_ops.BACKEND, dtype=x2.dtype,
                                            wall_s=wall, method="eager-wall")
    else:
        y2 = systolic_ops.matmul(x2, w, out_dtype=out_dtype)
    return y2.reshape(*lead, w.shape[1])


def _quant_matmul(x: torch.Tensor, w: QArray, *, out_dtype: torch.dtype | None) -> torch.Tensor:
    """Quantized projection dispatch (a QArray weight).

      w8a16  activations wide: the weight dequantizes to ``x.dtype`` and the
             fp path (the systolic kernel) runs as usual.
      w8a8   under ``quant.use_act_quant``: activations quantize per token x
             per 128-k block and go to the block-scaled kernel.
    """
    act_qd = quant.act_qdtype()
    out_dtype = out_dtype or x.dtype
    if act_qd is None:
        return matmul(x, w.dequantize(x.dtype), out_dtype=out_dtype)
    k = x.shape[-1]
    xq = quant.quantize_act(x.reshape(-1, k), act_qd)
    y2 = systolic_ops.quant_matmul(xq, w, out_dtype=out_dtype)
    return y2.reshape(*x.shape[:-1], w.shape[1])


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, rows: torch.Tensor | None = None) -> torch.Tensor:
    """Per-expert batched matmul (E, C, K) @ (E, K, N) -> (E, C, N) in x's dtype.

    Also takes dispatch-grouped input (G, E, C, K) -> (G, E, C, N): every
    group shares ``w``, so the groups fold exactly into one launch over
    (E, G * C, K) rows (a copy when G > 1) and the result unfolds as a view.
    ``rows``: each expert's number of leading rows of x that can be nonzero,
    (E,) or, for grouped input, (G, E) int32 (``moe._dispatch_group``), or
    None.  It lets the kernel skip the empty rows; the result is the same.
    The fold interleaves the groups' rows, so it is forwarded for G = 1
    only.
    """
    if x.ndim != 4:
        return grouped_ops.grouped_matmul(x, w, rows=rows)
    g, e, c, k = x.shape
    y = grouped_ops.grouped_matmul(x.transpose(0, 1).reshape(e, g * c, k), w,
                                   rows=rows[0] if rows is not None and g == 1 else None)
    return y.reshape(e, g, c, y.shape[-1]).transpose(0, 1)


def einsum(spec: str, *args: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """fp32-accumulating einsum: operands widened to fp32 (exact for bf16),
    the result cast to ``out_dtype`` (default: the first operand's dtype)."""
    out_dtype = out_dtype or args[0].dtype
    return torch.einsum(spec, *(a.float() for a in args)).to(out_dtype)
