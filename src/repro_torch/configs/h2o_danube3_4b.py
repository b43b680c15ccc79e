"""h2o-danube-3-4b  [arXiv:2401.16818; unverified]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 -- llama+mistral mix
with sliding-window attention (window 4096), which is what makes the
long_500k decode cell runnable (bounded KV ring buffer).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attention="swa",
    window=4096,
    subquadratic=True,  # SWA: O(window) state
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    window=32,
)
