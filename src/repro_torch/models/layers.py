"""Common layers: norms, rotary embeddings, embeddings, SwiGLU FFN.

The counterpart of ``repro.models.layers``.  Everything is functional:
``init_*`` returns a dict of tensors, the other functions apply it.  All
dense projections route through ``repro_torch.core.ops.matmul``.

Projection weights are (d_in, d_out), as in the reference (the systolic
kernel's B operand is the weight as stored).  They are created in the compute
dtype once, at init or load, where the reference keeps fp32 and casts on
every call: the cast values are the same.  The leaves of ``FP32_KEYS`` stay
fp32, as in the reference, which uses them in fp32 arithmetic.  Every GEMM
takes its weight through ``wcast``, which passes a quantized ``QArray``
(``repro_torch.quant.quantize_params``) straight to ``ops.matmul``, so one
layer code serves fp, w8a16 and w8a8 weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.quant.qarray import QArray

# Leaves kept fp32 whatever the compute dtype: RMSNorm scales, and the
# recurrent blocks' conv taps and bias, decay and step parameters, skip
# weights, gate biases and sLSTM's recurrence (``models/ssm.py``).  The
# reference serves its fp32 masters and casts only GEMM weights at use, so
# each of these enters its arithmetic in fp32 (``exp(a_log)``, the fp32
# recurrence einsum with ``r_h``, ...).
FP32_KEYS = frozenset({"scale", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "b_if", "b", "r_h"})


def wcast(w: torch.Tensor | QArray, dtype: torch.dtype) -> torch.Tensor | QArray:
    """Cast a (possibly quantized) projection weight for a GEMM: fp weights
    to the compute dtype; a ``QArray`` passes through unchanged (its compute
    dtype is decided at the GEMM by ``core.ops.matmul``)."""
    if isinstance(w, QArray):
        return w
    return w.to(dtype)


def _dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
                lead: tuple[int, ...] = ()) -> torch.Tensor:
    """(*lead, d_in, d_out) weights: drawn in fp32 one tensor at a time, scaled
    by d_in^-0.5, created in ``dtype`` (so a bf16 model never holds its fp32
    draw whole)."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * d_in**-0.5).to(dtype)


# -- RMSNorm -----------------------------------------------------------------


def init_rmsnorm(d: int, device: torch.device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"]
    return y.to(dtype)


# -- Rotary position embeddings ----------------------------------------------


def rope_freqs(head_dim: int, theta: float, device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies for the (even) rotary dims."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    rot = hd - hd % 2
    inv = rope_freqs(rot, theta, x.device)  # (rot/2,)
    ang = positions[..., None].float() * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# -- Embedding ---------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> dict:
    t = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=torch.float32)
    return {"table": (t * 0.02).to(dtype)}


def embed(params: dict, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[tokens]


class _MatmulF32Out(torch.autograd.Function):
    """x @ w of bf16 operands with an fp32 output (``aten::mm.dtype``, CUDA),
    differentiable: the op has no autograd formula of its own.  The backward
    is two library products in fp32: the fp32 cotangent widens the other
    operand, as JAX's dot transpose promotes (``kernels/systolic/ops.py``'s
    ``_Matmul`` does the same), and each gradient is cast to its operand's
    dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.float()
        dx = torch.mm(dy, w.float().t()).to(x.dtype) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x.float().t(), dy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> fp32, a library product outside any kernel (the
    reference's head einsums): on the card bf16 operands write fp32 (no fp32
    copy of the weight); elsewhere the operands are widened to fp32 (exact
    for bf16)."""
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        return _MatmulF32Out.apply(x, w)
    return torch.mm(x.float(), w.float())


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied head: fp32 logits ``x @ table.T`` on the systolic kernel, which
    reads the (V, d) table K-major where it lies: no transposed copy."""
    return ops.matmul(x, params["table"].to(x.dtype).T, out_dtype=torch.float32)


# -- SwiGLU FFN ---------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype) -> dict:
    return {
        "w_gate": _dense_init(gen, d, d_ff, dtype),
        "w_up": _dense_init(gen, d, d_ff, dtype),
        "w_down": _dense_init(gen, d_ff, d, dtype),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    gate = ops.matmul(x, wcast(params["w_gate"], dt))
    up = ops.matmul(x, wcast(params["w_up"], dt))
    return ops.matmul(F.silu(gate.float()).to(dt) * up, wcast(params["w_down"], dt))


# -- Dense (bias-free) projection ---------------------------------------------


def init_dense(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype) -> dict:
    return {"w": _dense_init(gen, d_in, d_out, dtype)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return ops.matmul(x, wcast(params["w"], x.dtype))
