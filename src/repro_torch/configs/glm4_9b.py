"""glm4-9b  [hf:THUDM/glm-4-9b; hf]

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 -- RoPE, GQA.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    attention="gqa",
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256
)
