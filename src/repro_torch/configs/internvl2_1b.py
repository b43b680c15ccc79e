"""internvl2-1b  [arXiv:2404.16821; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 -- Qwen2-0.5B backbone
behind a stubbed InternViT (input_specs provide precomputed patch embeddings
(B, 256, 1024)); the 2-layer MLP projector is implemented for real.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    attention="gqa",
    frontend="vit",
    vit_dim=1024,
    n_patches=256,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    vit_dim=32,
    n_patches=8,
)
