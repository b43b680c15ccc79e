"""Checkpoints: npz per host, atomic save, async writer, restore into a
template (the counterpart of ``repro.checkpoint``)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
