"""qwen3-moe-235b-a22b  [hf:Qwen/Qwen3-235B-A22B; hf]

94L d_model=4096 64H (GQA kv=4, head_dim=128, qk-norm) MoE 128 experts
top-8, d_ff_expert=1536, vocab=151936.
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    attention="gqa",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96),
)
