"""Modality frontends: the audio codec's embeddings and heads, and the vit
projector.

The counterpart of ``repro.models.frontends``.  As there, the modality
encoders themselves are stubs that the inputs stand in for:

  musicgen-medium  EnCodec: the batch supplies ``n_codebooks`` parallel token
                   streams (B, S, n_codebooks); the backbone embeds each
                   stream, sums them, and reads one output head per stream.
  internvl2-1b     InternViT: the batch supplies precomputed patch
                   embeddings (B, n_patches, vit_dim); the 2-layer MLP
                   projector (InternVL's ``mlp1``) maps them to backbone
                   tokens, which go before the text.

The projector's two GEMMs run on the systolic kernel (``core.ops.matmul``),
as the reference's run on its Pallas kernel.  The codebook heads are an
einsum outside any kernel in the reference, and a library product here:
bf16 operands, fp32 output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def init_vit_projector(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """InternVL-style mlp1: RMSNorm, then a 2-layer MLP vit_dim -> d_model."""
    return {
        "norm": layers.init_rmsnorm(cfg.vit_dim, gen.device),
        "w1": layers._dense_init(gen, cfg.vit_dim, cfg.d_model, dtype),
        "w2": layers._dense_init(gen, cfg.d_model, cfg.d_model, dtype),
    }


def vit_project(params: dict, patch_embeds: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(B, P, vit_dim) -> (B, P, d_model) backbone tokens, in patch_embeds'
    dtype.  ``jax.nn.gelu`` is the tanh form, so this one is too."""
    x = layers.rmsnorm(params["norm"], patch_embeds, cfg.norm_eps)
    h = ops.matmul(x, layers.wcast(params["w1"], x.dtype))
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return ops.matmul(h, layers.wcast(params["w2"], x.dtype))


def init_audio_embed(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """One embedding table per codebook: (n_codebooks, V, d)."""
    t = torch.randn((cfg.n_codebooks, cfg.vocab_size, cfg.d_model), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return {"tables": (t * 0.02).to(dtype)}


def audio_embed(params: dict, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """tokens (B, S, n_codebooks) -> (B, S, d): one gather per codebook,
    summed in the compute dtype in the reference's order."""
    tabs = params["tables"].to(compute_dtype)
    parts = [tabs[i][tokens[..., i]] for i in range(tabs.shape[0])]
    return sum(parts)


def init_audio_heads(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    """n_codebooks parallel output heads: w (n_codebooks, d, V)."""
    return {"w": layers._dense_init(gen, cfg.d_model, cfg.vocab_size, dtype, lead=(cfg.n_codebooks,))}


def audio_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, n_codebooks, V) fp32 logits.  On the card a bf16
    product per codebook writes fp32 (no fp32 copy of the heads); elsewhere
    the operands are widened to fp32 (exact for bf16)."""
    w = params["w"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        y = torch.stack([layers.matmul_f32_out(x2, w[c]) for c in range(w.shape[0])], dim=1)
    else:
        y = torch.einsum("md,cdv->mcv", x2.float(), w.float())
    return y.reshape(*x.shape[:-1], *y.shape[1:])
