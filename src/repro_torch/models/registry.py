"""ArchConfig -> bound model functions.

The counterpart of ``repro.models.registry``: a ``Model`` is the transformer
module's functions partially applied to one config.  ``init`` takes a seed
and a device (default: the card) where the reference takes a PRNG key.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, active_params, count_params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    prefill: Callable[..., Any]
    prefill_chunk: Callable[..., Any]
    loss_fn: Callable[..., Any]

    @property
    def n_params(self) -> int:
        return count_params(self.cfg)

    @property
    def n_active_params(self) -> int:
        return active_params(self.cfg)


def get_model(cfg: ArchConfig) -> Model:
    transformer.check_supported(cfg)
    return Model(
        cfg=cfg,
        init=functools.partial(transformer.init_model, cfg),
        forward=functools.partial(transformer.forward, cfg=cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg=cfg),
        prefill=functools.partial(transformer.prefill, cfg=cfg),
        prefill_chunk=functools.partial(transformer.prefill_chunk, cfg=cfg),
        loss_fn=functools.partial(transformer.loss_fn, cfg=cfg),
    )
