from repro_torch.kernels.grouped import ops, ref  # noqa: F401
from repro_torch.kernels.grouped.ops import grouped_matmul  # noqa: F401
