"""Training loop substrate (the counterpart of ``repro.train``)."""

from repro_torch.train.loop import TrainConfig, Trainer, make_grad_fn, make_train_step  # noqa: F401
