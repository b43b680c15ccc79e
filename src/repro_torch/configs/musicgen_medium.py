"""musicgen-medium  [arXiv:2306.05284; hf]

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 -- decoder-only over
EnCodec tokens, 4 parallel codebook streams.  The EnCodec frontend is a STUB
(input_specs provide the 4-stream token ids directly); the 4 embedding
tables + 4 output heads ARE implemented (they are backbone compute).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    attention="gqa",
    frontend="audio_codec",
    n_codebooks=4,
    subquadratic=False,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    n_codebooks=2,
)
