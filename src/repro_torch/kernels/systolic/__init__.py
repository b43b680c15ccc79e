from repro_torch.kernels.systolic import ops, ref  # noqa: F401
from repro_torch.kernels.systolic.ops import matmul  # noqa: F401
