"""Architecture configuration schema.

A copy of ``repro.models.config`` kept JAX-free for the PyTorch port (importing
``repro`` loads JAX).  One frozen dataclass tree describes every assigned
architecture; the concrete instances live in ``repro_torch/configs/<arch>.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.001
    # Independent dispatch groups: argsort/scatter stay local to a batch
    # shard; launchers set this to the global batch so the only EP traffic
    # is the (G, E, C, d) all-to-all.  1 = single global group (tests).
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    variant: Literal["xlstm", "mamba2"] = "mamba2"
    state_size: int = 64  # N (mamba2) / per-head qk dim (mLSTM)
    head_dim: int = 64  # P (mamba2)
    expand: int = 2  # d_inner = expand * d_model
    conv_kernel: int = 4
    chunk_size: int = 256  # SSD chunk length
    n_groups: int = 1
    # xLSTM only: ratio of sLSTM blocks (1 sLSTM per `slstm_every` blocks).
    slstm_every: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "audio", "vlm", "ssm", "hybrid"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default: d_model // n_heads
    # attention flavour
    attention: Literal["gqa", "mla", "swa", "none"] = "gqa"
    window: int | None = None  # SWA window size
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2): one shared attention+MLP block applied every
    # `attn_every` SSM blocks, weights shared across applications.
    attn_every: int | None = None
    # modality frontends (STUBS: input_specs provide precomputed embeddings
    # or codec tokens; see DESIGN.md §5)
    frontend: Literal[None, "audio_codec", "vit"] = None
    n_codebooks: int = 1  # musicgen EnCodec streams
    vit_dim: int = 1024  # stubbed InternViT output width
    n_patches: int = 256  # stubbed patch count per image
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Can this arch decode a 500k context with bounded state?
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ArchConfig":
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.family == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: moe family needs MoEConfig")
        if self.attention == "mla" and self.mla is None:
            raise ValueError(f"{self.name}: mla attention needs MLAConfig")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: ssm/hybrid family needs SSMConfig")
        if self.attention == "swa" and not self.window:
            raise ValueError(f"{self.name}: swa needs window")
        return self

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced copy for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the assigned shapes)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def count_params(cfg: ArchConfig) -> int:
    """Analytical parameter count (used for 6ND model-FLOPs and reports)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.n_heads, cfg.n_kv_heads
    embed = cfg.vocab_size * d * (cfg.n_codebooks if cfg.frontend == "audio_codec" else 1)
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d * (
        cfg.n_codebooks if cfg.frontend == "audio_codec" else 1
    )

    if cfg.attention == "mla":
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = (
            d * m.q_lora_rank
            + m.q_lora_rank * n_q * qk_head
            + d * (m.kv_lora_rank + m.qk_rope_head_dim)
            + m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
            + n_q * m.v_head_dim * d
        )
    elif cfg.attention == "none":
        attn = 0
    else:
        attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d

    if cfg.moe is not None:
        ff = cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert + d * cfg.moe.n_experts
        ff += cfg.moe.n_shared_experts * 3 * d * cfg.moe.d_ff_expert
    elif cfg.d_ff:
        ff = 3 * d * cfg.d_ff  # SwiGLU
    else:
        ff = 0

    per_layer = attn + ff + 2 * d  # two RMSNorm scales

    if cfg.family == "ssm" and cfg.ssm.variant == "xlstm":
        di = cfg.ssm.expand * d
        # mLSTM block: up/gate proj, q/k/v, gates, out
        mblk = 2 * d * di + 3 * di * di // 1 + 3 * di + di * d
        # sLSTM block: 4 gates input + recurrent + gated MLP 4/3
        sblk = 4 * d * d + 4 * d * d + 2 * d * int(4 * d / 3) + int(4 * d / 3) * d
        n_s = cfg.n_layers // cfg.ssm.slstm_every
        per_layer = 0
        total_blocks = (cfg.n_layers - n_s) * mblk + n_s * sblk + cfg.n_layers * 2 * d
        return embed + head + total_blocks + d
    if cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * d
        nh_ssm = di // s.head_dim
        mamba = (
            d * (2 * di + 2 * s.n_groups * s.state_size + nh_ssm)  # in_proj
            + s.conv_kernel * (di + 2 * s.n_groups * s.state_size)
            + nh_ssm  # A_log
            + nh_ssm  # D
            + di * d  # out_proj
            + di  # norm
        )
        n_attn = cfg.n_layers // (cfg.attn_every + 1)
        n_mamba = cfg.n_layers - n_attn
        shared = attn + ff + 2 * d  # one shared block
        return embed + head + n_mamba * (mamba + d) + shared + d

    return embed + head + cfg.n_layers * per_layer + d


def active_params(cfg: ArchConfig) -> int:
    """Active (per-token) parameter count -- MoE uses top_k experts only."""
    if cfg.moe is None:
        return count_params(cfg)
    d = cfg.d_model
    full = count_params(cfg)
    all_expert = cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert * cfg.n_layers
    active_expert = (
        (cfg.moe.top_k + cfg.moe.n_shared_experts)
        * 3
        * d
        * cfg.moe.d_ff_expert
        * cfg.n_layers
    )
    return full - all_expert + active_expert
