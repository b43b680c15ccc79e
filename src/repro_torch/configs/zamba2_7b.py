"""zamba2-7b  [arXiv:2411.15242; unverified]

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64 --
Mamba2 backbone with ONE shared attention+MLP block applied every
attn_every=6 Mamba2 layers (weights shared across its 11 applications,
KV caches per application).  Mamba2: expand=2 -> d_inner=7168, head_dim=64
-> 112 SSM heads, state N=64.  Bounded state => long_500k runnable.
"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    attention="gqa",
    attn_every=6,
    ssm=SSMConfig(
        variant="mamba2",
        state_size=64,
        head_dim=64,
        expand=2,
        conv_kernel=4,
        chunk_size=256,
        n_groups=1,
    ),
    subquadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=5,  # 1 group of 2 mamba + shared, + 2 tail mamba
    attn_every=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm=SSMConfig(
        variant="mamba2",
        state_size=16,
        head_dim=16,
        expand=2,
        conv_kernel=4,
        chunk_size=16,
        n_groups=1,
    ),
)
