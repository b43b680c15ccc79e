"""xlstm-125m  [arXiv:2405.04517; unverified]

12L d_model=768 4H d_ff=0 vocab=50304 -- alternating sLSTM + mLSTM blocks
(1 sLSTM per slstm_every=2 blocks), expand=2.  Attention-free: O(1)
recurrent state makes every decode cell (incl. long_500k) runnable.
"""

from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    attention="none",
    ssm=SSMConfig(variant="xlstm", expand=2, conv_kernel=4, slstm_every=2),
    subquadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    vocab_size=256,
    ssm=SSMConfig(variant="xlstm", expand=2, conv_kernel=4, slstm_every=2),
)
