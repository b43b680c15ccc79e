"""qwen3-moe-30b-a3b  [hf:Qwen/Qwen3-30B-A3B; hf]

48L d_model=2048 32H (GQA kv=4, head_dim=128, qk-norm) MoE 128 experts
top-8, d_ff_expert=768, vocab=151936.
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    attention="gqa",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
)
