"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips on hosts without an NVIDIA card.
This file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances as in the CPU tests against the JAX package: GEMM 2e-2 in bf16
(one bf16 ulp at the outputs' scale) and rtol 1e-5 with atol 1e-5 * sqrt(K)
in fp32 (summation order); attention 3e-2 in bf16 and 2e-4 in fp32.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.systolic import kernel as mm_kernel
from repro_torch.kernels.systolic import ops as mm_ops
from repro_torch.kernels.systolic.ref import ACTIVATIONS, matmul_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GEMM_SHAPES = [
    (128, 128, 128),
    (256, 384, 512),
    (8, 128, 128),
    (100, 130, 70),
    (33, 257, 129),
    (512, 128, 1024),
    (4, 2048, 2048),  # decode projection
    (4, 1024, 2048),
    (4, 2048, 8192),  # decode, contraction split across blocks
    (16, 1024, 2048),
    (1, 300, 1000),  # split-K with ragged N and K
    (9, 70, 4000),
]
ATTN_CASES = [
    (128, 128, True, None),
    (128, 256, False, None),
    (256, 256, True, 64),
    (100, 200, True, None),
    (190, 190, True, 64),
    (130, 230, True, 32),
    (512, 512, True, None),  # prefill shape
    (500, 500, True, 128),
]


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _gemm_tol(dtype, k, out_dtype=torch.float32):
    """bf16 tolerance wherever a bf16 rounding is involved (inputs or output)."""
    if dtype == "bfloat16" or out_dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-5, atol=1e-5 * k**0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full fp32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_systolic_kernel_matches_plain(cuda, m, n, k, dtype):
    a = _rand((m, k), 1).to(cuda, DTYPES[dtype])
    b = _rand((k, n), 2).to(cuda, DTYPES[dtype])
    bias = _rand((n,), 3).to(cuda)
    before = mm_kernel.launches
    for act in ACTIVATIONS:
        for out_dtype in DTYPES.values():
            got = mm_ops.matmul(a, b, bias, activation=act, out_dtype=out_dtype)
            want = matmul_ref(a, b, bias, activation=act, out_dtype=out_dtype)
            assert got.dtype == out_dtype
            torch.testing.assert_close(got.float(), want.float(), **_gemm_tol(dtype, k, out_dtype))
    torch.cuda.synchronize()
    assert mm_kernel.launches == before + 2 * len(ACTIVATIONS)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,causal,window", ATTN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_kernel_matches_plain(cuda, sq, skv, causal, window, dtype, d):
    q, k, v = (_rand((2, 2, s, d), i).to(cuda, DTYPES[dtype]) for i, s in enumerate((sq, skv, skv)))
    before = attn_kernel.launches
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(
        q.reshape(4, sq, d), k.reshape(4, skv, d), v.reshape(4, skv, d), causal=causal, window=window
    ).reshape(got.shape)
    torch.cuda.synchronize()
    assert attn_kernel.launches == before + 1
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
