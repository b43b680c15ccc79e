"""Optimizer substrate (plain PyTorch over the port's trees): AdamW,
schedules, global-norm clipping and int8 gradient compression.

The counterpart of ``repro.optim``."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
from repro_torch.optim.compress import compress_int8, compress_tree, decompress_int8  # noqa: F401
from repro_torch.optim.schedule import cosine_with_warmup, linear_warmup_constant  # noqa: F401
