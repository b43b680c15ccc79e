"""Hand-written Hopper kernels of the port, one package per TPU kernel it replaces.

Each package has ``ref.py`` (the plain PyTorch version), ``kernel.py`` (the
ctypes binding of a CUDA source in ``repro_torch/csrc``, with its launch
count) and ``ops.py`` (checks and dispatch: plain version for CPU tensors,
kernel for CUDA tensors).
"""
