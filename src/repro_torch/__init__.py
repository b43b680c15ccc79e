"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro`` module for module.  Imports ``torch`` and never ``jax`` or
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain PyTorch
version, on CUDA tensors it launches the hand-written kernel or raises.
"""
