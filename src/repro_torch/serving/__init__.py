from repro_torch.serving.engine import ServeConfig, ServeEngine  # noqa: F401
from repro_torch.serving.kvpool import clear_slots  # noqa: F401
