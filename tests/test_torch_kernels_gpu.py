"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips on hosts without an NVIDIA card.
This file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances as in the CPU tests against the JAX package: GEMM 2e-2 in bf16
(one bf16 ulp at the outputs' scale) and rtol 1e-5 with atol 1e-5 * sqrt(K)
in fp32 (summation order); attention 3e-2 in bf16 and 2e-4 in fp32, its plain
version repeating K/V to the query heads.  The
block-scaled GEMM against its dequantize-then-fp32 plain version: atol
1e-5 * (max|ref| + 1), the reference's own (same quantized values, other
summation order), with max|ref| taken before the activation (the
activations are at most 1.1-Lipschitz, so the sums' error carries through),
plus rtol 2^-7 where the output is bf16 (the two round fp32 sums that differ
in the last bits, so they may land one bf16 ulp apart).  The grouped expert
GEMM takes the GEMM's tolerances.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import attention_ref, flash_attention_call_ref
from repro_torch.kernels.grouped import kernel as grouped_kernel
from repro_torch.kernels.grouped import ops as grouped_ops
from repro_torch.kernels.grouped.ref import grouped_matmul_ref
from repro_torch.kernels.systolic import kernel as mm_kernel
from repro_torch.kernels.systolic import ops as mm_ops
from repro_torch.kernels.systolic.ref import ACTIVATIONS, matmul_ref, quant_matmul_ref
from repro_torch.quant import k_major, quantize, quantize_act, quantize_weight

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


# K-major B (the transpose of an (N, K) row-major tensor, as a tied head
# reads its embedding table): internvl2-1b's tied head at decode and over a
# forward's rows, and ragged shapes on each tile that reads B so.
KMAJOR_SHAPES = [
    (4, 151655, 896),
    (1, 151655, 896),
    (1024, 151655, 896),
    (1, 300, 1000),  # decode tile, split-K, ragged N and K
    (9, 70, 4000),
    (100, 130, 70),  # WMMA tile, ragged
    (17, 264, 200),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", KMAJOR_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_systolic_kernel_reads_k_major_b(cuda, m, n, k, dtype):
    """B handed over as table.T with no copy: the launch is on a *_kmajor
    path, counted under it, and matches the plain version (fp32 out, as the
    tied head writes it; bf16 out and an epilogue at the small shapes)."""
    a = _rand((m, k), 1).to(cuda, DTYPES[dtype])
    table = _rand((n, k), 2).to(cuda, DTYPES[dtype])
    b = table.T
    before = dict(mm_kernel.launches_by_path)
    got = mm_ops.matmul(a, b, out_dtype=torch.float32)
    paths = {p: c - before.get(p, 0) for p, c in mm_kernel.launches_by_path.items() if c != before.get(p, 0)}
    want = matmul_ref(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, **_gemm_tol(dtype, k))
    assert len(paths) == 1 and next(iter(paths)).endswith("_kmajor") and sum(paths.values()) == 1
    if n * k < 10**6:
        bias = _rand((n,), 3).to(cuda)
        for act in ACTIVATIONS:
            got = mm_ops.matmul(a, b, bias, activation=act, out_dtype=torch.bfloat16)
            want = matmul_ref(a, b, bias, activation=act, out_dtype=torch.bfloat16)
            torch.testing.assert_close(got.float(), want.float(), **_gemm_tol(dtype, k, torch.bfloat16))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_k_major_decode_tile_equals_the_row_major_one(cuda):
    """The decode tile sums the same products in the same order whichever
    way B is stored: K-major and row-major give the same bits."""
    a = _rand((4, 896), 1).to(cuda, torch.bfloat16)
    table = _rand((4096, 896), 2).to(cuda, torch.bfloat16)
    got = mm_ops.matmul(a, table.T, out_dtype=torch.float32)
    want = mm_ops.matmul(a, table.T.contiguous(), out_dtype=torch.float32)
    assert torch.equal(got, want)


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


# The systolic GEMM's wgmma tiles: every served prefill shape (M, N, K),
# then ragged M, N and K (multiples of 8, TMA zero-fills the rest of each
# tile) on each of the three tiles the path rule picks.
WGMMA_SHAPES = [
    (2048, 2048, 2048), (2048, 1024, 2048), (2048, 8192, 2048), (2048, 2048, 8192),  # internlm2-1.8b
    (2048, 4096, 2048), (2048, 512, 2048), (2048, 2048, 4096), (2048, 128, 2048),  # qwen3-moe-30b-a3b
    (2048, 768, 2560), (2048, 3840, 768), (2048, 288, 2560), (2048, 5120, 256),  # minicpm3-4b: wq_a, wq_b, wkv_a,
    (2048, 2560, 2560), (2048, 6400, 2560), (2048, 2560, 6400), (411, 5120, 256),  # wkv_b; wo, the SwiGLU, a chunk's wkv_b
    (2000, 8184, 2040),  # 128x256, ragged everywhere
    (1000, 2040, 1000),  # 128x128
    (300, 264, 200), (17, 8, 8), (129, 1032, 1000),  # 64x128
]


def _path(cuda, m, n, k):
    return mm_kernel.gemm_path(m, n, k, torch.bfloat16, True, mm_kernel._sm_count(cuda.index))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", WGMMA_SHAPES)
def test_wgmma_gemm_matches_plain(cuda, m, n, k):
    """Every activation, with and without the bias, bf16 and fp32 out, on the
    wgmma tile the path rule picks for the shape."""
    a = _rand((m, k), 1).to(cuda, torch.bfloat16)
    b = _rand((k, n), 2).to(cuda, torch.bfloat16)
    bias = _rand((n,), 3).to(cuda)
    path = _path(cuda, m, n, k)
    assert path.startswith("wgmma")
    before = mm_kernel.launches_by_path[path]
    for bv in (None, bias):
        for act in ACTIVATIONS:
            for out_dtype in DTYPES.values():
                got = mm_ops.matmul(a, b, bv, activation=act, out_dtype=out_dtype)
                want = matmul_ref(a, b, bv, activation=act, out_dtype=out_dtype)
                assert got.dtype == out_dtype
                torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    torch.cuda.synchronize()
    assert mm_kernel.launches_by_path[path] == before + 4 * len(ACTIVATIONS)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["wgmma_128x256", "wgmma_128x128", "wgmma_64x128"])
@pytest.mark.parametrize("m,n,k", [(300, 264, 200), (129, 1032, 1000), (2048, 512, 2048)])
def test_each_wgmma_tile_matches_plain(cuda, path, m, n, k):
    """Each wgmma tile through the C entry directly, whatever the rule would
    pick: ragged shapes cover every tile's edges."""
    lib, fn = mm_kernel._entry("systolic_mmm")
    a = _rand((m, k), 4).to(cuda, torch.bfloat16)
    b = _rand((k, n), 5).to(cuda, torch.bfloat16)
    bias = _rand((n,), 6).to(cuda)
    for act in ("none", "gelu"):
        for out_dtype in DTYPES.values():
            out = torch.empty((m, n), dtype=out_dtype, device=cuda)
            code = fn(a.data_ptr(), b.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k, 1,
                      mm_kernel.DTYPE_CODES[out_dtype], mm_kernel.ACTIVATION_CODES[act], mm_kernel.PATHS.index(path),
                      0, None, 0, torch.cuda.current_stream().cuda_stream)
            assert code == 0
            want = matmul_ref(a, b, bias, activation=act, out_dtype=out_dtype)
            torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2)


# internlm2-1.8b's projections (N, K) at continuous serving's M: batch-1
# prefills at prompt lengths 5, 17, 63 and 200, and the decode step over 8
# slots, on whatever path the rule picks (decode tile up to M = 16, then the
# wgmma tiles).
@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 8, 17, 63, 200])
@pytest.mark.parametrize("n,k", [(2048, 2048), (1024, 2048), (8192, 2048), (2048, 8192)])
def test_gemm_at_continuous_serving_shapes(cuda, m, n, k):
    a = _rand((m, k), 20).to(cuda, torch.bfloat16)
    b = _rand((k, n), 21).to(cuda, torch.bfloat16)
    path = _path(cuda, m, n, k)
    assert path == "decode" if m <= 16 else path.startswith("wgmma")
    before = mm_kernel.launches_by_path[path]
    got = mm_ops.matmul(a, b)
    torch.cuda.synchronize()
    assert mm_kernel.launches_by_path[path] == before + 1
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(), rtol=2e-2, atol=2e-2)


# minicpm3-4b's projections (N, K) -- MLA's wq_a, wq_b, wkv_a (N 288: the
# last column tile ragged), wkv_b (K 256: four k tiles of the TMA ring), wo
# and the SwiGLU -- at decode (4, 8 slots), batch-1 prefill (17, 200), a
# chunk's whole cache (411) and the synchronized prefill (2048).
MLA_PROJECTIONS = [(768, 2560), (3840, 768), (288, 2560), (5120, 256), (2560, 2560), (6400, 2560), (2560, 6400)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 8, 17, 200, 411, 2048])
@pytest.mark.parametrize("n,k", MLA_PROJECTIONS)
def test_gemm_at_mla_serving_shapes(cuda, m, n, k):
    a = _rand((m, k), 22).to(cuda, torch.bfloat16)
    b = _rand((k, n), 23).to(cuda, torch.bfloat16)
    path = _path(cuda, m, n, k)
    assert path == "decode" if m <= 16 else path.startswith("wgmma")
    before = mm_kernel.launches_by_path[path]
    got = mm_ops.matmul(a, b)
    torch.cuda.synchronize()
    assert mm_kernel.launches_by_path[path] == before + 1
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(), rtol=2e-2, atol=2e-2)


# The recurrent families' projections (N, K, output dtype): xlstm-125m's
# mLSTM w_up, wq / wk / wv, w_if (N 8, fp32 gates), w_down, sLSTM's w_x (fp32
# pre-activations) and SwiGLU; zamba2-7b's Mamba2 in_proj (N 14576) and
# out_proj (K 7168) and its shared block's attention and SwiGLU.  At M = 1
# (continuous batch-1 prefill steps), 4 (every synchronized step), 8 (decode
# over 8 slots), a ragged 1000 and 2048 (forward over 4 x 512, the wgmma
# tiles); each also in fp32 at M = 512 (the fp32 forward).
RECURRENT_PROJECTIONS = [(3072, 768, torch.bfloat16), (1536, 1536, torch.bfloat16), (8, 1536, torch.float32),
                         (768, 1536, torch.bfloat16), (3072, 768, torch.float32), (1024, 768, torch.bfloat16),
                         (768, 1024, torch.bfloat16), (14576, 3584, torch.bfloat16), (3584, 7168, torch.bfloat16),
                         (3584, 3584, torch.bfloat16), (14336, 3584, torch.bfloat16), (3584, 14336, torch.bfloat16)]


def _randn_cuda(shape, seed, cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=cuda, dtype=torch.float32).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8, 1000, 2048])
@pytest.mark.parametrize("n,k,out_dtype", RECURRENT_PROJECTIONS)
def test_gemm_at_recurrent_serving_shapes(cuda, m, n, k, out_dtype):
    a = _randn_cuda((m, k), 24, cuda, torch.bfloat16)
    b = _randn_cuda((k, n), 25, cuda, torch.bfloat16)
    path = _path(cuda, m, n, k)
    assert path == "decode" if m <= 16 else path.startswith("wgmma")
    before = mm_kernel.launches_by_path[path]
    got = mm_ops.matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert mm_kernel.launches_by_path[path] == before + 1 and got.dtype == out_dtype
    torch.testing.assert_close(got.float(), matmul_ref(a, b, out_dtype=out_dtype).float(), rtol=2e-2, atol=2e-2)


# The fp32 forward's rows, the weights at the models' scale (N(0, 1) x
# K^-0.5, ``layers._dense_init``): the outputs are O(1), as the model's are.
# (With N(0, 1) weights they grow as sqrt(K), and so does the rounding of
# every partial sum: past atol 1e-5 x sqrt(K) at K = 14336.)
@pytest.mark.gpu
@pytest.mark.parametrize("n,k,out_dtype", RECURRENT_PROJECTIONS)
def test_fp32_gemm_at_the_recurrent_forward_rows(cuda, n, k, out_dtype):
    a = _randn_cuda((512, k), 26, cuda, torch.float32)
    b = _randn_cuda((k, n), 27, cuda, torch.float32) * k**-0.5
    got = mm_ops.matmul(a, b)
    torch.testing.assert_close(got, matmul_ref(a, b, out_dtype=torch.float32), **_gemm_tol("float32", k))


# zamba2-7b's shared attention: 32 / 32 heads of 112, S 512, causal, in the
# model's (B, S, H, D) layout; batch 1 (forward's row) and 4.
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_at_zamba2_heads(cuda, b, dtype):
    dt = DTYPES[dtype]
    q, k, v = (_flash_operand(cuda, dt, b, 512, 32, 112, "bshd", seed) for seed in (28, 29, 30))
    before = attn_kernel.launches_by_heads()[(32, 32)]
    got = attn_ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=112**-0.5,
                                    causal=True, window=None, kv_valid=512).transpose(1, 2)
    torch.cuda.synchronize()
    assert attn_kernel.launches_by_heads()[(32, 32)] == before + 1
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_unaligned_operand_takes_the_wmma_tile(cuda):
    """A base off 16 bytes cannot be a TMA source: the shape goes to the WMMA
    tile (a choice by shape and alignment, made before the launch)."""
    m = n = k = 256
    a = _rand((m * k + 1,), 7).to(cuda, torch.bfloat16)[1:].view(m, k)
    b = _rand((k, n), 8).to(cuda, torch.bfloat16)
    assert a.is_contiguous() and a.data_ptr() % 16
    before = mm_kernel.launches_by_path["wmma"]
    got = mm_ops.matmul(a, b)
    torch.testing.assert_close(got.float(), matmul_ref(a, b).float(), rtol=2e-2, atol=2e-2)
    assert mm_kernel.launches_by_path["wmma"] == before + 1


@pytest.mark.gpu
def test_wgmma_gemm_is_deterministic(cuda):
    a = _rand((2048, 2048), 9).to(cuda, torch.bfloat16)
    b = _rand((2048, 8192), 10).to(cuda, torch.bfloat16)
    assert torch.equal(mm_ops.matmul(a, b), mm_ops.matmul(a, b))


FLASH_HEADS = [(8, 8), (8, 4), (8, 1)]  # (H, Hkv): GQA ratios 1, 2 and 8
# (Sq, Skv, causal, window, kv_valid): S not a multiple of 64, windows, a
# masked tail, non-causal.
FLASH_MASKS = [
    (200, 200, True, None, None),
    (130, 230, True, 32, None),
    (100, 100, False, None, 70),
    (190, 190, True, 64, 150),
]


def _flash_operand(cuda, dtype, b, s, h, d, layout, seed):
    """A (B, H, S, D) operand: contiguous ("bhsd"), the transposed view of a
    (B, S, H, D) tensor ("bshd", as the model holds it), or that of every
    other head of a wider one ("sliced": head and sequence strides both
    uneven)."""
    if layout == "bhsd":
        return _rand((b, h, s, d), seed).to(cuda, dtype)
    if layout == "bshd":
        return _rand((b, s, h, d), seed).to(cuda, dtype).transpose(1, 2)
    return _rand((b, s, 2 * h, d), seed).to(cuda, dtype)[:, :, ::2].transpose(1, 2)


@pytest.mark.gpu
def test_untied_head_backward_is_the_widened_products(cuda):
    """The untied head (``layers.matmul_f32_out``: bf16 operands, fp32 out,
    a library product outside any kernel): its gradients are the products
    of the fp32 cotangent with the other operand widened to fp32, as JAX's
    dot transpose promotes, each cast to its operand's bf16 -- bit for bit
    what autograd gives through the product of the widened operands."""
    from repro_torch.models.layers import matmul_f32_out

    x = _rand((64, 96), 27).to(cuda, torch.bfloat16).requires_grad_()
    w = _rand((96, 300), 28).to(cuda, torch.bfloat16).requires_grad_()
    dy = _rand((64, 300), 29).to(cuda)
    y = matmul_f32_out(x, w)
    y.backward(dy)
    x2, w2 = (t.detach().float().requires_grad_() for t in (x, w))
    want = x2 @ w2
    want.backward(dy)
    assert y.dtype == torch.float32 and x.grad.dtype == w.grad.dtype == torch.bfloat16
    torch.testing.assert_close(y, want.detach(), **_gemm_tol("float32", 96))
    assert torch.equal(x.grad, x2.grad.bfloat16()) and torch.equal(w.grad, w2.grad.bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,causal,window,kv_valid", FLASH_MASKS)
@pytest.mark.parametrize("h,hkv", FLASH_HEADS)
@pytest.mark.parametrize("layout", ["bhsd", "bshd", "sliced"])
@pytest.mark.parametrize("d", [16, 64, 120, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_gqa_layouts_match_plain(cuda, sq, skv, causal, window, kv_valid, h, hkv, layout, d, dtype):
    dt = DTYPES[dtype]
    q = _flash_operand(cuda, dt, 2, sq, h, d, layout, 11)
    k = _flash_operand(cuda, dt, 2, skv, hkv, d, layout, 12)
    v = _flash_operand(cuda, dt, 2, skv, hkv, d, layout, 13)
    before = attn_kernel.launches_by_heads()[(h, hkv)]
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
    kw = dict(scale=d**-0.5, causal=causal, window=window, kv_valid=skv if kv_valid is None else kv_valid)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)
    torch.cuda.synchronize()
    assert attn_kernel.launches_by_heads()[(h, hkv)] == before + 1
    assert got.dtype == dt and got.shape == q.shape and got.transpose(1, 2).is_contiguous()
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# Continuous serving prefills one request at a time: internlm2-1.8b's flash
# call at batch 1, S = the prompt length (below one 64-row tile, ragged, and
# not a multiple of 128), (H, Hkv) = (16, 8), D = 128, causal.
@pytest.mark.gpu
@pytest.mark.parametrize("s", [4, 17, 100])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_at_batch1_prompt_lengths(cuda, s, dtype):
    dt = DTYPES[dtype]
    q = _flash_operand(cuda, dt, 1, s, 16, 128, "bshd", 17)
    k = _flash_operand(cuda, dt, 1, s, 8, 128, "bshd", 18)
    v = _flash_operand(cuda, dt, 1, s, 8, 128, "bshd", 19)
    before = attn_kernel.launches_by_heads()[(16, 8)]
    got = attn_ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=128**-0.5,
                                    causal=True, window=None, kv_valid=s).transpose(1, 2)
    torch.cuda.synchronize()
    assert attn_kernel.launches_by_heads()[(16, 8)] == before + 1
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_kernel_is_deterministic(cuda):
    q = _rand((4, 512, 32, 128), 14).to(cuda, torch.bfloat16)
    k, v = (_rand((4, 512, 4, 128), i).to(cuda, torch.bfloat16) for i in (15, 16))
    kw = dict(scale=128**-0.5, causal=True, window=None, kv_valid=512)
    assert torch.equal(attn_kernel.flash_attention_call(q, k, v, **kw), attn_kernel.flash_attention_call(q, k, v, **kw))


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_cannot_read(cuda):
    q = torch.zeros(1, 16, 2, 12, device=cuda, dtype=torch.bfloat16)  # rows of 24 bytes
    with pytest.raises(ValueError, match="16-byte"):
        attn_kernel.flash_attention_call(q, q, q, scale=1.0, causal=True, window=None, kv_valid=16)
    q = torch.zeros(1, 16, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):  # last dimension strided
        attn_kernel.flash_attention_call(q[..., ::2], q[..., ::2], q[..., ::2], scale=1.0, causal=True, window=None,
                                         kv_valid=16)
    kv = torch.zeros(1, 16, 3, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dividing"):  # 3 KV heads for 2 query heads
        attn_kernel.flash_attention_call(q, kv, kv, scale=1.0, causal=True, window=None, kv_valid=16)


QGEMM_SHAPES = [
    (4, 2048, 2048),  # decode projections (M, N, K), contraction split across blocks
    (4, 1024, 2048),
    (4, 8192, 2048),
    (4, 2048, 8192),
    (2048, 2048, 2048),  # prefill projections
    (2048, 8192, 2048),
    (8, 128, 128),  # ragged and small
    (72, 130, 100),
    (300, 257, 515),
    (33, 257, 129),
    (1, 1000, 300),
    (9, 4000, 70),
]
QDTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# The w8a8 projections (M, N, K) of minicpm3-4b (every MLA projection but
# wkv_b, which stays wide, and the SwiGLU; wkv_a's N = 288 leaves the
# m64n128k32 tile's last column tile ragged) and qwen3-moe-30b-a3b's
# attention, at decode (M 4) and prefill (M 2048), weights K-major as served.
W8A8_SHAPES = [(m, n, k) for m in (4, 2048) for n, k in
               [(768, 2560), (3840, 768), (288, 2560), (2560, 2560), (6400, 2560), (2560, 6400),
                (4096, 2048), (512, 2048), (2048, 4096)]]


def _qgemm_check(got, qa, qb, act, out_dtype):
    want = quant_matmul_ref(qa, qb, activation=act, out_dtype=torch.float32)
    assert got.dtype == out_dtype
    pre = quant_matmul_ref(qa, qb, out_dtype=torch.float32)  # the sums, before the activation
    atol = 1e-5 * (pre.abs().max().item() + 1.0)
    rtol = 2**-7 if out_dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", QGEMM_SHAPES)
@pytest.mark.parametrize("qd", list(QDTYPES))
def test_quant_kernel_matches_plain(cuda, m, n, k, qd):
    """Per-token x 128-k activations, 128-k x per-column weights (the serving
    layout), every activation, bf16 and fp32 outputs."""
    qa = quantize_act(_rand((m, k), 1).to(cuda), qd)
    qb = quantize_weight(_rand((k, n), 2).to(cuda), qd)
    assert qa.values.dtype == QDTYPES[qd]
    before, shape_before = mm_kernel.quant_launches, mm_kernel.quant_launches_by_shape[(m, k, n)]
    for act in ACTIVATIONS:
        for out_dtype in DTYPES.values():
            got = mm_ops.quant_matmul(qa, qb, out_dtype=out_dtype, activation=act)
            _qgemm_check(got, qa, qb, act, out_dtype)
    torch.cuda.synchronize()
    assert mm_kernel.quant_launches == before + 2 * len(ACTIVATIONS)
    assert mm_kernel.quant_launches_by_shape[(m, k, n)] == shape_before + 2 * len(ACTIVATIONS)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", W8A8_SHAPES)
def test_quant_kernel_at_served_w8a8_shapes(cuda, m, n, k):
    """int8, per-token x 128-k activations, 128-k x per-column weights laid
    out K-major once (``quant.k_major``, no copy at the call), bf16 out: the
    path the rule picks, one launch, within the tolerance."""
    qa = quantize_act(_rand((m, k), 3).to(cuda), "int8")
    qb = k_major({"w": quantize_weight(_rand((k, n), 4).to(cuda), "int8")})["w"]
    assert mm_kernel.is_k_major(qb.values)
    path = mm_kernel.qgemm_path(m, n, k, 128, torch.int8, True)
    assert path == ("decode" if m <= 16 else "wgmma")
    before = mm_kernel.quant_launches_by_path[path]
    got = mm_ops.quant_matmul(qa, qb, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert mm_kernel.quant_launches_by_path[path] == before + 1
    _qgemm_check(got, qa, qb, "none", torch.bfloat16)


QK_CASES = [(128, 128), (64, 64), (32, 32), (16, 16), (0, 0), (128, 64), (64, 128), (32, 0),
            (0, 128), (48, 32), (96, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("qk_a,qk_b", QK_CASES)
@pytest.mark.parametrize("m,n,k", [(4, 300, 1000), (100, 130, 520), (256, 256, 2048)])
@pytest.mark.parametrize("qd", list(QDTYPES))
def test_quant_kernel_scale_steps_match_plain(cuda, m, n, k, qd, qk_a, qk_b):
    """Scale blocks of 128, 64, 32, 16 and whole-K (0), mixed between the
    operands (steps of gcd(qk_a, qk_b)), with a partial last block along K."""
    qa = quantize(_rand((m, k), 3).to(cuda), qd, block=(1, qk_a))
    qb = quantize(_rand((k, n), 4).to(cuda), qd, block=(qk_b, 1))
    got = mm_ops.quant_matmul(qa, qb, out_dtype=torch.float32, activation="silu")
    _qgemm_check(got, qa, qb, "silu", torch.float32)


@pytest.mark.gpu
def test_quant_kernel_raises_on_a_step_off_the_16_grid(cuda):
    qa = quantize(_rand((8, 96), 5).to(cuda), "int8", block=(1, 24))
    qb = quantize(_rand((96, 16), 6).to(cuda), "int8", block=(0, 1))
    with pytest.raises(ValueError, match="multiple of 16"):
        mm_ops.quant_matmul(qa, qb)


GROUPED_SHAPES = [
    (128, 160, 2048, 768),  # prefill gate / up (E, C, K, N): the 192-row wgmma tile
    (128, 160, 768, 2048),  # prefill down
    (128, 8, 2048, 768),  # decode: the 16-row tile
    (128, 8, 768, 2048),
    (1, 160, 2048, 768),  # one expert
    (4, 1, 70, 130),  # ragged C, K and N
    (4, 13, 70, 130),
    (3, 100, 70, 130),
    (2, 16, 64, 64),  # the largest C of the small tile
    (2, 17, 64, 64),  # the smallest of the wgmma tiles
    (8, 64, 96, 160),
]


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", GROUPED_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grouped_kernel_matches_plain(cuda, e, c, k, n, dtype):
    x = _rand((e, c, k), 1).to(cuda, DTYPES[dtype])
    w = _rand((e, k, n), 2).to(cuda, DTYPES[dtype])
    before, shape_before = grouped_kernel.launches, grouped_kernel.launches_by_shape[(e, c, k, n)]
    got = grouped_ops.grouped_matmul(x, w)
    want = grouped_matmul_ref(x, w)
    assert got.dtype == x.dtype and tuple(got.shape) == (e, c, n)
    torch.testing.assert_close(got.float(), want.float(), **_gemm_tol(dtype, k, x.dtype))
    torch.cuda.synchronize()
    assert grouped_kernel.launches == before + 1
    assert grouped_kernel.launches_by_shape[(e, c, k, n)] == shape_before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("c", [8, 100])  # the decode and a wgmma tile
def test_grouped_kernel_experts_independent(cuda, c):
    """Zeroing one expert's weights zeroes only its slice."""
    x = _rand((3, c, 32), 3).to(cuda, torch.bfloat16)
    w = _rand((3, 32, 48), 4).to(cuda, torch.bfloat16)
    w[1] = 0
    y = grouped_ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert bool((y[1] == 0).all())
    assert not bool((y[0] == 0).all()) and not bool((y[2] == 0).all())
    torch.testing.assert_close(y[2].float(), (x[2].float() @ w[2].float()).bfloat16().float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_grouped_kernel_shape_errors(cuda):
    x = torch.ones(2, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        grouped_ops.grouped_matmul(x, torch.ones(3, 8, 4, device=cuda))
    with pytest.raises(ValueError):
        grouped_ops.grouped_matmul(x, torch.ones(2, 9, 4, device=cuda))
    with pytest.raises(TypeError):
        grouped_kernel.grouped_matmul_call(x, torch.ones(2, 8, 4, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        grouped_kernel.grouped_matmul_call(x.transpose(1, 2), torch.ones(2, 4, 4, device=cuda))


# The grouped GEMM's wgmma tiles: both served prefill shapes at C of 100,
# 160 and 200 (one, one and two row tiles), and K and N not multiples of 64
# (multiples of 8: TMA zero-fills the rest).  Each with ``rows`` of every
# kind: None (all rows), all C, none, partial counts (inside the first tile,
# on a tile edge, past it), and the decode routing (most experts empty).
GROUPED_WGMMA_SHAPES = [(e, c, k, n) for c in (100, 160, 200) for e, k, n in ((16, 2048, 768), (16, 768, 2048))]
GROUPED_WGMMA_SHAPES += [(5, 160, 200, 136), (5, 100, 72, 264), (5, 200, 520, 8), (3, 40, 8, 1000)]


def _rows_patterns(e, c):
    full = [c] * e
    partial = [(7 * i + 3) % (c + 1) for i in range(e)]
    edges = [min(c, v) for v in (0, 1, 63, 64, 65, 127, 128, 129, 191, 192)][:e] + [c] * max(0, e - 10)
    decode = [1 if i % 4 == 0 else 0 for i in range(e)]
    return {"none": None, "all": full, "empty": [0] * e, "partial": partial, "edges": edges, "decode": decode}


def _grouped_case(cuda, e, c, k, n, rows, seed):
    x = _rand((e, c, k), seed).to(cuda, torch.bfloat16)
    w = _rand((e, k, n), seed + 1).to(cuda, torch.bfloat16)
    r = None
    if rows is not None:
        r = torch.tensor(rows, dtype=torch.int32, device=cuda)
        for i, v in enumerate(rows):
            x[i, v:] = 0  # the dispatch leaves rows past an expert's count zero
    return x, w, r


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["none", "all", "empty", "partial", "edges", "decode"])
@pytest.mark.parametrize("e,c,k,n", GROUPED_WGMMA_SHAPES)
def test_grouped_wgmma_tile_matches_plain(cuda, e, c, k, n, pattern):
    x, w, r = _grouped_case(cuda, e, c, k, n, _rows_patterns(e, c)[pattern], 21)
    path = grouped_kernel.grouped_path(c, k, n, torch.bfloat16, True)
    assert path.startswith("wgmma")
    before = grouped_kernel.launches_by_path[path]
    got = grouped_ops.grouped_matmul(x, w, rows=r)
    want = grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert grouped_kernel.launches_by_path[path] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    if r is not None:  # skipped tiles and computed ones give the same bits as no rows at all
        assert torch.equal(got, grouped_ops.grouped_matmul(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["all", "empty", "partial", "decode"])
@pytest.mark.parametrize("e,c,k,n,dtype", [(128, 8, 2048, 768, "bfloat16"), (128, 8, 768, 2048, "bfloat16"),
                                           (6, 13, 70, 130, "bfloat16"), (6, 100, 70, 130, "bfloat16"),
                                           (6, 100, 72, 136, "float32"), (6, 8, 72, 136, "float32")])
def test_grouped_other_tiles_skip_rows(cuda, e, c, k, n, dtype, pattern):
    """rows on the decode, WMMA and FMA tiles: the same result as without."""
    rows = _rows_patterns(e, c)[pattern]
    x, w, r = _grouped_case(cuda, e, c, k, n, rows, 23)
    x, w = x.to(DTYPES[dtype]), w.to(DTYPES[dtype])
    got = grouped_ops.grouped_matmul(x, w, rows=r)
    torch.testing.assert_close(got.float(), grouped_matmul_ref(x, w).float(), **_gemm_tol(dtype, k, x.dtype))
    assert torch.equal(got, grouped_ops.grouped_matmul(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["wgmma_64x128", "wgmma_128x128", "wgmma_192x128"])
@pytest.mark.parametrize("e,c,k,n", [(4, 100, 200, 136), (4, 17, 64, 8), (4, 250, 520, 264)])
def test_each_grouped_wgmma_tile_matches_plain(cuda, path, e, c, k, n):
    """Each wgmma tile through the C entry directly, whatever the rule would
    pick, with partial rows."""
    lib, fn = mm_kernel._entry("grouped_mmm")
    x, w, r = _grouped_case(cuda, e, c, k, n, [c, 0, c // 2, 1], 25)
    for rows in (None, r):
        y = torch.empty((e, c, n), dtype=torch.bfloat16, device=cuda)
        code = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), e, c, k, n, 1, None if rows is None else rows.data_ptr(),
                  grouped_kernel.PATHS.index(path), torch.cuda.current_stream().cuda_stream)
        assert code == 0
        torch.testing.assert_close(y.float(), grouped_matmul_ref(x, w).float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_grouped_wgmma_is_deterministic(cuda):
    x = _rand((128, 160, 2048), 26).to(cuda, torch.bfloat16)
    w = _rand((128, 2048, 768), 27).to(cuda, torch.bfloat16)
    assert torch.equal(grouped_ops.grouped_matmul(x, w), grouped_ops.grouped_matmul(x, w))


@pytest.mark.gpu
def test_grouped_binding_checks_rows(cuda):
    x = torch.ones(2, 32, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(2, 8, 8, device=cuda, dtype=torch.bfloat16)
    for bad in (torch.zeros(2, device=cuda), torch.zeros(3, dtype=torch.int32, device=cuda),
                torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows"):
            grouped_kernel.grouped_matmul_call(x, w, bad)


# The block-scaled GEMM's int8 wgmma tile on K-major B (the kernel's one
# layout, as the w8a8 weights are served) at the four served prefill shapes
# and ragged ones (K a multiple of 16, N of 8), every activation, bf16 and
# fp32 out, then every scale block (steps of whole K or multiples of 128 on
# the wgmma tile, finer ones on the WMMA tile); bit-identical to the WMMA
# tile on the same operands (exact int32 sums, the same retire order), which
# an unaligned A forces.  fp8 takes the WMMA tile.
QGEMM_WGMMA_SHAPES = [
    (2048, 2048, 2048), (2048, 1024, 2048), (2048, 8192, 2048), (2048, 2048, 8192),  # (M, N, K)
    (300, 264, 528), (17, 8, 16), (129, 1032, 1040), (2000, 1032, 2064),
]
QK_WGMMA = [(128, 128), (64, 64), (32, 32), (0, 0), (128, 64), (32, 0), (0, 128), (96, 64), (256, 256), (48, 32)]


def _kmajor_pair(cuda, m, n, k, qd, qk, seed):
    qa = quantize(_rand((m, k), seed).to(cuda), qd, block=(1, qk[0]))
    qb = quantize(_rand((k, n), seed + 1).to(cuda), qd, block=(qk[1], 1))
    return qa, qb, k_major({"w": qb})["w"]


def _unaligned(q):
    """The same QArray with its values one byte past a 16-byte boundary: TMA
    cannot load them, so the kernel takes its WMMA tile."""
    buf = torch.empty(q.values.numel() + 1, dtype=q.values.dtype, device=q.values.device)
    values = buf[1:].view(q.values.shape)
    values.copy_(q.values)
    assert values.data_ptr() % 16 != 0
    return dataclasses.replace(q, values=values)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", QGEMM_WGMMA_SHAPES)
@pytest.mark.parametrize("qd", list(QDTYPES))
def test_quant_prefill_tiles_on_k_major_b_match_plain(cuda, m, n, k, qd):
    qa, qb, qbk = _kmajor_pair(cuda, m, n, k, qd, (128, 128), 31)
    path = "wgmma" if qd == "int8" else "wmma"
    before = mm_kernel.quant_launches_by_path[path]
    for act in ACTIVATIONS:
        for out_dtype in DTYPES.values():
            got = mm_ops.quant_matmul(qa, qbk, out_dtype=out_dtype, activation=act)
            _qgemm_check(got, qa, qb, act, out_dtype)
            if qd == "int8":
                assert torch.equal(got, mm_ops.quant_matmul(_unaligned(qa), qbk, out_dtype=out_dtype, activation=act))
    torch.cuda.synchronize()
    assert mm_kernel.quant_launches_by_path[path] == before + 2 * len(ACTIVATIONS)  # unaligned A: the WMMA tile


@pytest.mark.gpu
@pytest.mark.parametrize("qk_a,qk_b", QK_WGMMA)
@pytest.mark.parametrize("m,n,k", [(100, 136, 512), (300, 264, 528), (256, 256, 2048)])
@pytest.mark.parametrize("qd", list(QDTYPES))
def test_quant_prefill_tiles_scale_steps_match_plain(cuda, m, n, k, qd, qk_a, qk_b):
    qa, qb, qbk = _kmajor_pair(cuda, m, n, k, qd, (qk_a, qk_b), 33)
    step = mm_kernel.scale_step(*(q if q < k else 0 for q in (qk_a, qk_b)), k)
    whole = not any(0 < q < k for q in (qk_a, qk_b))
    path = "wgmma" if qd == "int8" and (whole or step % mm_kernel.WGMMA_QK == 0) else "wmma"
    before = mm_kernel.quant_launches_by_path[path]
    got = mm_ops.quant_matmul(qa, qbk, out_dtype=torch.float32, activation="silu")
    assert mm_kernel.quant_launches_by_path[path] == before + 1
    _qgemm_check(got, qa, qb, "silu", torch.float32)
    if qd == "int8":
        assert torch.equal(got, mm_ops.quant_matmul(_unaligned(qa), qbk, out_dtype=torch.float32, activation="silu"))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(4, 2048, 2048), (4, 1024, 2048), (4, 8192, 2048), (4, 2048, 8192),
                                   (1, 1000, 300), (9, 4000, 70), (16, 136, 520), (100, 130, 520)])
@pytest.mark.parametrize("qd", list(QDTYPES))
def test_quant_wmma_tiles_take_k_major_b(cuda, m, n, k, qd):
    """The decode tile (split-K) and the WMMA prefill tile read K-major B
    within the tolerance; a row-major weight, which quant_matmul lays out
    K-major for the call, gives the same bits."""
    for qk in ((128, 128), (48, 32), (0, 0)):
        qa, qb, qbk = _kmajor_pair(cuda, m, n, k, qd, qk, 35)
        for out_dtype in DTYPES.values():
            got = mm_ops.quant_matmul(qa, qbk, out_dtype=out_dtype, activation="gelu")
            _qgemm_check(got, qa, qb, "gelu", out_dtype)
            assert torch.equal(got, mm_ops.quant_matmul(qa, qb, out_dtype=out_dtype, activation="gelu"))


@pytest.mark.gpu
def test_quant_wgmma_is_deterministic(cuda):
    qa, _, qbk = _kmajor_pair(cuda, 2048, 8192, 2048, "int8", (128, 128), 37)
    assert torch.equal(mm_ops.quant_matmul(qa, qbk), mm_ops.quant_matmul(qa, qbk))


# -- chunked prefill and the kv8 pool on the card ---------------------------------------
# Logits of the bf16 SMOKE model on the kernels, chunked against monolithic,
# within 5e-2 of the largest logit (bf16 activations rounded at other
# points, and chunk attention is plain where monolithic runs the flash
# kernel); quantize_kv's bits equal the CPU's (IEEE division, round half to
# even, exact absmax).


@pytest.mark.gpu
@pytest.mark.parametrize("arch,n,chunk", [("internlm2-1.8b", 200, 64), ("internlm2-1.8b", 77, 16),
                                          ("h2o-danube-3-4b", 90, 16)])
def test_chunked_prefill_logits_match_monolithic_on_the_card(cuda, arch, n, chunk):
    from repro_torch import configs
    from repro_torch.data.synthetic import make_prompt
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import chunk_schedule

    model = get_model(configs.get_smoke(arch))
    params = model.init(0, cuda)
    prompt = make_prompt(model.cfg, seq=n, seed=3, device=cuda)["tokens"]
    max_len = n + 4
    size = min(max_len, model.cfg.window) if model.cfg.attention == "swa" else max_len
    cache = model.init_cache(1, max_len, torch.bfloat16, cuda)
    with torch.no_grad():
        for off, length in chunk_schedule(n, chunk):
            got, cache = model.prefill_chunk(params, {"tokens": prompt[:, off : off + length]}, cache=cache,
                                             offset=off, wrapped=off + length > size)
        want, mono = model.prefill(params, {"tokens": prompt}, max_len=max_len)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max() <= 5e-2 * want.abs().max()
    for lc, mc in zip(cache["layers"], mono["layers"]):
        assert torch.equal(lc["pos"], mc["pos"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_kv_on_the_card_equals_the_cpu(cuda, dtype):
    from repro_torch.serving.kvpool import dequantize_kv, quantize_kv

    k = _rand((4, 300, 8, 128), 40) * _rand((1, 1, 8, 1), 41).abs() * 5
    k[1] = 0  # a freed slot
    tree = {"layers": [{"k": k.to(DTYPES[dtype]), "v": _rand((4, 300, 8, 128), 42).to(DTYPES[dtype]),
                        "pos": torch.arange(4 * 300, dtype=torch.int32).reshape(4, 300)}]}
    on_card = quantize_kv({"layers": [{n: t.to(cuda) for n, t in tree["layers"][0].items()}]})
    on_cpu = quantize_kv(tree)
    for name in ("k", "v"):
        for part in ("qv", "qs"):
            assert torch.equal(on_card["layers"][0][name][part].cpu(), on_cpu["layers"][0][name][part])
    back = dequantize_kv(on_card, DTYPES[dtype])
    assert torch.equal(back["layers"][0]["k"].cpu(), dequantize_kv(on_cpu, DTYPES[dtype])["layers"][0]["k"])


@pytest.mark.gpu
def test_kv8_pool_on_the_card_holds_int8(cuda):
    """Full-width internlm2-1.8b's pool over 8 slots of 411 positions (the
    continuous phase of chip_smoke.py): int8 K/V, fp32 scales per slot and
    head, int32 positions -- exactly 161,939,712 bytes, half the bf16 pool's
    323,539,200 but for the scales."""
    from repro_torch import configs
    from repro_torch.models.registry import get_model
    from repro_torch.serving.kvpool import KVPool

    model = get_model(configs.get_config("internlm2-1.8b"))
    pool = KVPool(model, 8, 411, quantize_kv_cache=True, device=cuda)
    assert pool.bytes_resident() == 8 * 411 * 24 * 2 * 8 * 128 + 8 * 24 * 2 * 8 * 4 + 8 * 411 * 24 * 4 == 161_939_712
    assert KVPool(model, 8, 411, device=cuda).bytes_resident() == 323_539_200
    layer = pool.cache["layers"][0]
    assert layer["k"].dtype == torch.bfloat16 and layer["k"].device.type == "cuda" and (layer["pos"] == -1).all()


# -- the paged KV pool on the card --------------------------------------------------------
# The page gather, scatter and copy-on-write are index copies: on the card
# they must move the same bits as on the CPU, duplicate indices (the null
# page, shared prefix pages) included; and a paged serving run gives the
# slot pool's tokens.


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv8", [("internlm2-1.8b", False), ("minicpm3-4b", False), ("internlm2-1.8b", True)])
def test_paged_pool_on_the_card_equals_the_cpu(cuda, arch, kv8):
    from repro_torch import configs
    from repro_torch.models.registry import get_model
    from repro_torch.serving.paged import PagedKVPool

    model = get_model(configs.get_smoke(arch))
    pools = [PagedKVPool(model, 3, 30, quantize_kv_cache=kv8, page_size=8, n_pages=10, prefix_cache=True,
                         device=dev) for dev in ("cpu", cuda)]
    tokens = np.arange(24, dtype=np.int32)
    for step, pool in enumerate(pools):
        a = pool.alloc()
        pool.prepare_write(a, 0, 20)
        view = pool.gather_slot(a)
        for i, layer in enumerate(view["layers"]):
            for name, t in layer.items():
                if name == "pos":
                    t[0, :20] = torch.arange(20, dtype=torch.int32)
                else:
                    t[0, :20] = _rand((20, *t.shape[2:]), 60 + i).to(t.dtype)
        pool.write_slot(a, view, next_pos=20)
        pool.register_prefix(a, tokens, 20)
        hit, pids = pool.lookup_prefix(tokens)
        assert hit == 16
        b = pool.alloc()
        pool.attach_prefix(b, pids)
        pool.prepare_write(b, 12, 22)  # copy-on-write of the shared second page
        cache = pool.cache  # both slots, the null page behind the unmapped rows
        for i, layer in enumerate(cache["layers"]):
            for name, t in layer.items():
                if name == "pos":
                    t[b, 12:22] = torch.arange(12, 22, dtype=torch.int32)
                else:
                    t[b, 12:22] = _rand((10, *t.shape[2:]), 70 + i).to(t.dtype)
        pool.cache = cache
        pool.positions[b] = 22
        assert pool.validate() == []
    cpu, card = pools
    for got, want in zip(card.cache["layers"], cpu.cache["layers"]):
        for name in got:
            assert torch.equal(got[name].cpu(), want[name]), name
    for got, want in zip(card._resident()["layers"], cpu._resident()["layers"]):
        for name, t in got.items():
            parts = t.items() if isinstance(t, dict) else [("", t)]
            for part, x in parts:
                assert torch.equal(x.cpu(), (want[name][part] if part else want[name])), (name, part)
                assert (x[-1] == (-1 if name == "pos" else 1 if part == "qs" else 0)).all()  # the null page


@pytest.mark.gpu
def test_paged_serving_on_the_card_gives_the_slot_pools_tokens(cuda):
    from repro_torch import configs
    from repro_torch.data.synthetic import make_shared_prefix_trace
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace

    model = get_model(configs.get_smoke("internlm2-1.8b"))
    params = model.init(0, cuda)
    engine = ServeEngine(model, params, ServeConfig(max_len=48, batch=3), device=cuda)
    trace = make_shared_prefix_trace(model.cfg, n_requests=6, prefix_len=33, suffix_len=5, gen=10, n_groups=2,
                                     rate=0.8, seed=3, device=cuda)
    want = ContinuousScheduler(engine).run(requests_from_trace(trace))
    sched = ContinuousScheduler(engine, paged=True, page_size=8)
    got = sched.run(requests_from_trace(trace))
    assert sched.pool.validate() == [] and sched.pool.pages_in_use == 0
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    prefix = ContinuousScheduler(engine, paged=True, page_size=8, prefix_cache=True)
    hit = prefix.run(requests_from_trace(trace))
    assert prefix.stats.summary()["prefix_hits"] >= 1 and prefix.pool.validate() == []
    assert all(len(hit[rid]) == len(want[rid]) for rid in want)


# Training (K1's backward GEMMs and K3's logsumexp output).  internlm2-1.8b's
# projections at 4 x 512 tokens (M, K, N) -- each forward's backward is dA at
# (M, N, K) with B = W^T and dB at (K, M, N) with A = X^T -- and ragged ones.
TRAIN_SHAPES = [(2048, 2048, 2048), (2048, 2048, 1024), (2048, 2048, 8192), (2048, 8192, 2048),
                (100, 130, 70), (33, 257, 129), (4, 2048, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_systolic_backward_matches_plain_autograd(cuda, m, k, n, dtype):
    """dA and dB are two more K1 launches, each on the path ``gemm_path``
    picks for its row-major operands (W^T and X^T are copied), and match
    autograd through the plain version."""
    dt = DTYPES[dtype]
    a = _rand((m, k), 21).to(cuda, dt).requires_grad_()
    b = (_rand((k, n), 22) * k**-0.5).to(cuda, dt).requires_grad_()
    dc = _rand((m, n), 23).to(cuda, dt)
    before = mm_kernel.launches
    paths = dict(mm_kernel.launches_by_path)
    mm_ops.matmul(a, b).backward(dc)
    torch.cuda.synchronize()
    assert mm_kernel.launches == before + 3
    new = {p for p, c in mm_kernel.launches_by_path.items() if c != paths.get(p, 0)}
    assert not any(p.endswith("_kmajor") for p in new)
    a2, b2 = a.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()
    matmul_ref(a2, b2).backward(dc)
    torch.testing.assert_close(a.grad.float(), a2.grad.float(), **_gemm_tol(dtype, n))
    torch.testing.assert_close(b.grad.float(), b2.grad.float(), **_gemm_tol(dtype, m))


@pytest.mark.gpu
def test_systolic_backward_of_a_k_major_b_and_fp32_out(cuda):
    """A tied head's B (table.T, K-major) with fp32 out: the cotangent is
    fp32, so both backward GEMMs run in fp32 (FMA tiles), as JAX's dot
    transpose promotes, and the table's gradient matches."""
    x = _rand((64, 96), 24).to(cuda, torch.bfloat16).requires_grad_()
    table = _rand((300, 96), 25).to(cuda, torch.bfloat16).requires_grad_()
    dy = _rand((64, 300), 26).to(cuda)
    mm_ops.matmul(x, table.T, out_dtype=torch.float32).backward(dy)
    x2, t2 = x.detach().clone().requires_grad_(), table.detach().clone().requires_grad_()
    matmul_ref(x2, t2.T, out_dtype=torch.float32).backward(dy)
    torch.testing.assert_close(x.grad.float(), x2.grad.float(), **_gemm_tol("bfloat16", 300))
    torch.testing.assert_close(table.grad.float(), t2.grad.float(), **_gemm_tol("bfloat16", 64))


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,causal,window,kv_valid", FLASH_MASKS)
@pytest.mark.parametrize("h,hkv", FLASH_HEADS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_logsumexp_matches_plain(cuda, sq, skv, causal, window, kv_valid, h, hkv, d, dtype):
    """The kernel's lse output (fp32 (B, H, Sq)) against the plain version's
    logsumexp of the same masked scores; the output is the one the kernel
    writes without it, bit for bit."""
    dt = DTYPES[dtype]
    q = _rand((2, sq, h, d), 31).to(cuda, dt)
    k, v = (_rand((2, skv, hkv, d), s).to(cuda, dt) for s in (32, 33))
    kw = dict(scale=d**-0.5, causal=causal, window=window, kv_valid=skv if kv_valid is None else kv_valid)
    out, lse = attn_kernel.flash_attention_call(q, k, v, return_lse=True, **kw)
    plain = attn_kernel.flash_attention_call(q, k, v, **kw)
    _, want = flash_attention_call_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (2, h, sq) and torch.equal(out, plain)
    torch.testing.assert_close(lse, want, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_mha_on_the_card_matches_plain_autograd(cuda, dtype):
    """``flash_mha`` (the kernel forward with lse, the plain block backward,
    dk / dv summed over each GQA group) against autograd through the plain
    attention, internlm2-1.8b's heads at a small sequence."""
    from repro_torch.models.attention import flash_mha

    dt = DTYPES[dtype]
    q = _rand((2, 200, 16, 128), 34).to(cuda, dt).requires_grad_()
    k, v = (_rand((2, 200, 8, 128), s).to(cuda, dt).requires_grad_() for s in (35, 36))
    do = _rand((2, 200, 16, 128), 37).to(cuda, dt)
    before = attn_kernel.launches
    o = flash_mha(q, k, v, causal=True, bq=64, bkv=128)
    o.backward(do)
    assert attn_kernel.launches == before + 1
    q2, k2, v2 = (t.detach().float().clone().requires_grad_() for t in (q, k, v))
    want = flash_attention_call_ref(q2, k2, v2, scale=128**-0.5, causal=True, window=None, kv_valid=200)
    want.backward(do.float())
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    for got, ref in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol * ref.abs().max().item())


# K4's backward (``grouped_ops._GroupedMatmul``): dX = dY W^T at (E, C, N) @
# (E, N, K) and dW = X^T dY at (E, K, C) @ (E, C, N), the contraction of dW
# the capacity C.  qwen3-moe-30b-a3b's training shapes (E 128, C 160: 2.5 of
# the wgmma tile's 64-deep k stages) and ragged ones (C 40, not a multiple of
# 64 either; K and N not multiples of 64).
GROUPED_TRAIN_SHAPES = [(128, 160, 2048, 768), (128, 160, 768, 2048), (8, 40, 2048, 768), (5, 40, 200, 136),
                        (3, 100, 72, 264)]


def _grouped_grads(x, w, dy, rows=None, plain=False):
    x, w = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y = grouped_matmul_ref(x, w) if plain else grouped_ops.grouped_matmul(x, w, rows=rows)
    y.backward(dy)
    return y.detach(), x.grad, w.grad


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", GROUPED_TRAIN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grouped_backward_matches_plain_autograd(cuda, e, c, k, n, dtype):
    """One forward, one dX and one dW launch, each on the path
    ``grouped_path`` picks for its shape, against autograd through the
    plain version."""
    dt = DTYPES[dtype]
    x = _rand((e, c, k), 41).to(cuda, dt)
    w = (_rand((e, k, n), 42) * k**-0.5).to(cuda, dt)
    dy = _rand((e, c, n), 43).to(cuda, dt)
    before = collections.Counter(grouped_kernel.launches_by_shape)
    paths = collections.Counter(grouped_kernel.launches_by_path)
    y, dx, dw = _grouped_grads(x, w, dy)
    torch.cuda.synchronize()
    want_shapes = collections.Counter([(e, c, k, n), (e, c, n, k), (e, k, c, n)])
    assert collections.Counter(grouped_kernel.launches_by_shape) - before == want_shapes
    want_paths = collections.Counter(grouped_kernel.grouped_path(cc, kk, nn, dt, True)
                                     for _, cc, kk, nn in want_shapes.elements())
    assert collections.Counter(grouped_kernel.launches_by_path) - paths == want_paths
    wy, wdx, wdw = _grouped_grads(x, w, dy, plain=True)
    assert dx.dtype == dw.dtype == dt
    torch.testing.assert_close(y.float(), wy.float(), **_gemm_tol(dtype, k, dt))
    torch.testing.assert_close(dx.float(), wdx.float(), **_gemm_tol(dtype, n, dt))
    torch.testing.assert_close(dw.float(), wdw.float(), **_gemm_tol(dtype, c, dt))


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", ["all", "empty", "partial", "edges", "decode"])
@pytest.mark.parametrize("e,c,k,n", [(16, 160, 2048, 768), (16, 160, 768, 2048), (5, 40, 200, 136)])
def test_grouped_backward_with_rows_below_capacity(cuda, e, c, k, n, pattern):
    """x's and dY's rows past each expert's count zero, as the dispatch and
    the combine leave them: dX (launched with ``rows``) is zero past the
    counts and matches the plain gradients, dW too (every row)."""
    rows = _rows_patterns(e, c)[pattern]
    x, w, r = _grouped_case(cuda, e, c, k, n, rows, 44)
    dy = _rand((e, c, n), 46).to(cuda, torch.bfloat16)
    for i, v in enumerate(rows):
        dy[i, v:] = 0
    seen = []
    real = grouped_kernel.grouped_matmul_call

    def spy(a, b, rows=None, **kw):
        seen.append((tuple(a.shape), rows is not None))
        return real(a, b, rows, **kw)

    try:
        grouped_kernel.grouped_matmul_call = spy
        y, dx, dw = _grouped_grads(x, w, dy, rows=r)
    finally:
        grouped_kernel.grouped_matmul_call = real
    torch.cuda.synchronize()
    assert seen == [((e, c, k), True), ((e, c, n), True), ((e, k, c), False)]
    _, wdx, wdw = _grouped_grads(x, w, dy, plain=True)
    torch.testing.assert_close(dx.float(), wdx.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(dw.float(), wdw.float(), rtol=2e-2, atol=2e-2)
    for i, v in enumerate(rows):
        assert not bool(dx[i, v:].any())
        if v == 0:
            assert not bool(dw[i].any())


def _one_step(arch, dtype, device, params=None, replay=None):
    """(grads, metrics, launches) of one training step of ``arch``'s SMOKE
    config in ``dtype`` from seed 0 at 2 x 32 tokens; ``replay``: a list of
    each MoE layer's top-k experts, recorded when empty and replayed when
    full (rounding moves routing; the paths must dispatch alike)."""
    from unittest import mock

    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models import moe
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import TrainConfig, make_grad_fn

    model = get_model(dataclasses.replace(configs.get_smoke(arch), dtype=dtype))
    params = params if params is not None else model.init(0, device, dtype=torch.float32)
    batch = make_batch(model.cfg, batch=2, seq=32, kind="train", seed=0, device=device)
    real, replaying, recorded = moe._topk_shardable, bool(replay), iter(list(replay or []))

    def topk(probs, k):
        if replaying:
            e = next(recorded)
            return probs.gather(-1, e), e
        w, e = real(probs, k)
        if replay is not None:
            replay.append(e.clone())
        return w, e

    counts = (mm_kernel.launches, attn_kernel.launches, grouped_kernel.launches)
    with mock.patch.object(moe, "_topk_shardable", topk):
        grads, metrics = make_grad_fn(model, TrainConfig())(params, batch)
    after = (mm_kernel.launches, attn_kernel.launches, grouped_kernel.launches)
    return model, params, grads, metrics, [b - a for a, b in zip(counts, after)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "xlstm-125m", "zamba2-7b"])
def test_one_training_step_of_each_family_on_the_card(cuda, arch):
    """The SMOKE config in fp32 on the card (K1's, K4's and K3's fp32
    kernels) against the port's CPU path (the plain versions), routed alike:
    the loss within 1e-5 relative and every gradient leaf within 1e-4 of its largest
    value (summation order only); an MoE step makes 3 forward and 6
    backward K4 launches a layer."""
    from repro_torch.core.tree import leaves, tree_map

    routing: list = []  # the CPU's routing, replayed on the card (a near-tie may round the other way)
    model, cpu_params, want, want_m, _ = _one_step(arch, "float32", "cpu", replay=routing)
    card = tree_map(lambda t: t.to(cuda), cpu_params)
    routing = [e.to(cuda) for e in routing]
    _, _, got, got_m, (k1, k3, k4) = _one_step(arch, "float32", cuda, params=card, replay=routing)
    torch.cuda.synchronize()
    cfg = model.cfg
    assert k4 == (9 * cfg.n_layers if cfg.moe is not None else 0) and k1 > 0
    assert (k3 > 0) == (cfg.family != "ssm")
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]), rtol=1e-5)
    for g, w in zip(leaves(got), leaves(want)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * max(w.abs().max().item(), 1e-12))


@pytest.mark.gpu
def test_bf16_moe_step_kernel_vs_plain_routed_alike(cuda):
    """The bf16 MoE SMOKE step on the kernels (K4 on a wgmma tile: C = 24,
    a ragged contraction for dW) against the plain versions on the card,
    the plain path routed to the kernel path's experts: loss 1e-2, every
    leaf 1e-1 relative L2, as ``chip_smoke.py`` holds full width."""
    from unittest import mock

    from repro_torch.core.tree import leaves

    routing: list = []
    model, params, got, got_m, (_, _, k4) = _one_step("qwen3-moe-30b-a3b", "bfloat16", cuda, replay=routing)
    paths = collections.Counter(grouped_kernel.launches_by_path)
    assert k4 == 9 * model.cfg.n_layers
    with mock.patch.object(grouped_kernel, "grouped_matmul_call", lambda x, w, rows=None, **_: grouped_matmul_ref(x, w)), \
            mock.patch.object(mm_kernel, "systolic_matmul_call",
                              lambda a, b, bias, *, out_dtype, activation="none", **_: matmul_ref(
                                  a, b, bias, activation=activation, out_dtype=out_dtype)), \
            mock.patch.object(attn_kernel, "flash_attention_call", flash_attention_call_ref):
        _, _, want, want_m, _ = _one_step("qwen3-moe-30b-a3b", "bfloat16", cuda, params=params, replay=routing)
    assert collections.Counter(grouped_kernel.launches_by_path) == paths  # the plain run launched nothing
    loss, want_loss = float(got_m["loss"]), float(want_m["loss"])
    assert abs(loss - want_loss) <= 1e-2 * abs(want_loss)
    for g, w in zip(leaves(got), leaves(want)):
        assert ((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item() <= 1e-1


# ---------------------------------------------------------------------------
# Tuned tiles: each path forced through a plan, the decode tile's k_chunk,
# refused paths, the shared-memory accounting, the plan cache's dispatch.
# ---------------------------------------------------------------------------

K1_FORCED = [  # (path, dtype, (m, n, k) shapes the path takes)
    ("fma", "float32", [(100, 130, 70), (4, 2048, 2048)]),
    ("decode", "bfloat16", [(4, 2048, 2048), (16, 1024, 2048), (1, 300, 1000)]),
    ("wmma", "bfloat16", [(256, 384, 512), (100, 130, 70), (4, 2048, 2048)]),
    ("wgmma_128x128", "bfloat16", [(256, 384, 512), (200, 264, 136), (4, 2048, 2048)]),
    ("wgmma_64x128", "bfloat16", [(256, 384, 512), (200, 264, 136)]),
    ("wgmma_128x256", "bfloat16", [(256, 384, 512), (200, 264, 136), (2048, 2560, 2560)]),
]


def _plan(m, n, k, tile):
    from repro_torch.core.blocking import BlockPlan

    return BlockPlan(m, n, k, *tile)


@pytest.mark.gpu
@pytest.mark.parametrize("path,dtype,shapes", K1_FORCED, ids=[p for p, _, _ in K1_FORCED])
def test_systolic_forced_path_matches_plain(cuda, path, dtype, shapes):
    """A plan names one K1 path; the launch runs it, counted as explicit."""
    for m, n, k in shapes:
        a = _rand((m, k), 11).to(cuda, DTYPES[dtype])
        b = (_rand((k, n), 12) * k**-0.5).to(cuda, DTYPES[dtype])
        tile = mm_kernel.block_of(path, m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
        before = collections.Counter(mm_kernel.launches_by_plan)
        got = mm_ops.matmul(a, b, plan=_plan(m, n, k, tile))
        new = mm_kernel.launches_by_plan - before
        assert [key[3] for key in new] == [path] and [key[5] for key in new] == ["explicit"]
        torch.testing.assert_close(got.float(), matmul_ref(a, b).float(), **_gemm_tol(dtype, k, DTYPES[dtype]))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(4, 2048, 8192), (4, 8192, 2048), (1, 300, 1000), (16, 1024, 2048)])
def test_decode_k_chunk_gives_the_same_product(cuda, m, n, k):
    """Every contraction chunk of the decode tile (its split-K) agrees with
    the plain version and with the rule's chunk."""
    from repro_torch.core import dse

    a = _rand((m, k), 13).to(cuda, torch.bfloat16)
    b = (_rand((k, n), 14) * k**-0.5).to(cuda, torch.bfloat16)
    want = matmul_ref(a, b)
    rule = mm_ops.matmul(a, b)
    for chunk in dse.decode_chunks(k, torch.cuda.get_device_properties(0).multi_processor_count, n):
        before = collections.Counter(mm_kernel.launches_by_plan)
        got = mm_ops.matmul(a, b, plan=_plan(m, n, k, (16, 64, chunk)))
        assert [key[3:5] for key in mm_kernel.launches_by_plan - before] == [("decode", chunk)]
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(got.float(), rule.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(4, 2048, 2048), (4, 1024, 2048), (4, 8192, 2048), (4, 2048, 8192),
                                   (1, 300, 1000), (16, 64, 4096), (4, 2560, 2560)])
def test_plan_split_twin_is_the_c_rule(cuda, m, n, k):
    """``kernel.plan_split`` decides the rule's decode chunk that the tuner
    and PERF.md report; the binary's split-K workspace (splits x M x N fp32)
    holds it to csrc/common.cuh's rule, at the rule's chunk and at given ones."""
    lib, _ = mm_kernel._entry("systolic_mmm")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k_chunk in (0, 128, 512):
        splits, _ = mm_kernel.plan_split(m, n, k, sms, k_chunk)
        assert lib.split_workspace(m, n, k, 1, k_chunk) == (splits * m * n * 4 if splits > 1 else 0), k_chunk


@pytest.mark.gpu
def test_forced_paths_the_operands_cannot_take_raise(cuda):
    a = torch.ones(32, 256, device=cuda, dtype=torch.bfloat16)
    b = torch.ones(256, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode tile takes M <= 16"):
        mm_ops.matmul(a, b, plan=_plan(32, 256, 256, (16, 64, 128)))
    unaligned = torch.ones(32 * 256 + 4, device=cuda, dtype=torch.bfloat16)[4:].view(32, 256)
    with pytest.raises(ValueError, match="TMA"):
        mm_ops.matmul(unaligned, b, plan=_plan(32, 256, 256, mm_kernel.TILES["wgmma_128x128"]))
    with pytest.raises(ValueError, match="does not take"):
        mm_ops.matmul(a.float(), b.float(), plan=_plan(32, 256, 256, mm_kernel.TILES["wgmma_128x128"]))
    with pytest.raises(ValueError, match="no systolic tile"):
        mm_ops.matmul(a, b, plan=_plan(32, 256, 256, (256, 256, 64)))
    with pytest.raises(ValueError, match="k_chunk"):
        mm_kernel.systolic_matmul_call(a, b, None, out_dtype=torch.bfloat16, path="wmma", k_chunk=128)
    qa = quantize_act(_rand((32, 256), 15).to(cuda), "fp8")
    qb = k_major({"w": quantize_weight(_rand((256, 256), 16).to(cuda), "fp8")})["w"]
    with pytest.raises(ValueError, match="no block-scaled tile"):
        mm_ops.quant_matmul(qa, qb, plan=_plan(32, 256, 256, (128, 128, 128)))
    x = torch.ones(2, 100, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(2, 64, 128, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="decode tile takes C <= 16"):
        grouped_ops.grouped_matmul(x, w, plan=_plan(100, 128, 64, grouped_kernel.TILES["decode"]))


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quant_forced_path_matches_plain(cuda, qdtype):
    tiles = mm_kernel.qtiles(torch.int8 if qdtype == "int8" else torch.float8_e4m3fn)
    for path, (m, n, k) in [("decode", (4, 384, 512)), ("wmma", (256, 384, 512)), ("wgmma", (256, 384, 512))]:
        if path not in tiles:
            continue
        qa = quantize_act(_rand((m, k), 17).to(cuda), qdtype)
        qb = quantize_weight(_rand((k, n), 18).to(cuda), qdtype)
        before = collections.Counter(mm_kernel.quant_launches_by_plan)
        got = mm_ops.quant_matmul(qa, k_major({"w": qb})["w"], plan=_plan(m, n, k, tiles[path]))
        assert [key[3:5] for key in mm_kernel.quant_launches_by_plan - before] == [(path, "explicit")]
        want = quant_matmul_ref(qa, qb, out_dtype=torch.bfloat16)
        atol = 1e-5 * (quant_matmul_ref(qa, qb, out_dtype=torch.float32).abs().max().item() + 1.0)
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(grouped_kernel.TILES))
def test_grouped_forced_path_matches_plain(cuda, path):
    dt = torch.float32 if path == "fma" else torch.bfloat16
    c = 8 if path == "decode" else 100
    x = _rand((3, c, 136), 19).to(cuda, dt)
    w = (_rand((3, 136, 264), 20) * 136**-0.5).to(cuda, dt)
    before = collections.Counter(grouped_kernel.launches_by_plan)
    got = grouped_ops.grouped_matmul(x, w, plan=_plan(c, 264, 136, grouped_kernel.TILES[path]))
    assert [key[4:6] for key in grouped_kernel.launches_by_plan - before] == [(path, "explicit")]
    torch.testing.assert_close(got.float(), grouped_matmul_ref(x, w).float(),
                               **_gemm_tol("float32" if path == "fma" else "bfloat16", 136, dt))


@pytest.mark.gpu
def test_block_plan_smem_is_what_each_wgmma_tile_allocates(cuda):
    """core/blocking.py's accounting against the binaries' WgTile / QTile
    shared memory, per wgmma path of K1, K4 and K5, as each library's launch
    query reports it."""
    from repro_torch.core.blocking import BlockPlan

    bf16 = torch.bfloat16
    for p, _, _ in mm_kernel.WGMMA_TILES:
        got, _ = mm_kernel.launch_query(p, 2048, 2048, 2048, bf16, bf16)
        assert got.dyn_smem == BlockPlan(1, 1, 1, *mm_kernel.TILES[p]).smem_bytes()
    for p in grouped_kernel.WGMMA_ROWS:
        got, _ = grouped_kernel.launch_query(p, 8, 256, 2048, 768, bf16)
        assert got.dyn_smem == BlockPlan(1, 1, 1, *grouped_kernel.TILES[p]).smem_bytes()
    q = BlockPlan(1, 1, 1, *mm_kernel.qtiles(torch.int8)["wgmma"], in_dtype="int8", quant_block_k=128)
    assert mm_kernel.qlaunch_query("wgmma", 2048, 2048, 2048, 128, 128, torch.int8, bf16)[0].dyn_smem == q.smem_bytes()
    assert mm_kernel.launch_query("wmma", 2048, 2048, 2048, bf16, bf16)[0].dyn_smem == 0


@pytest.mark.gpu
def test_autotune_on_the_card_then_dispatch_follows_the_cache(cuda, tmp_path, monkeypatch):
    """A miss measures K1's tiles with CUDA events and stores the winner; a
    second call is a pure hit; ops.matmul then launches the cached path, and
    an unaligned view of the same problem gives way to the rule."""
    from repro_torch.tune import autotune
    from repro_torch.tune import cache as tune_cache

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    tune_cache.reset_default_cache()
    try:
        res = autotune(256, 384, 512, top_k=None, repeats=1)
        assert not res.cache_hit and res.winner.method == "cuda-events" and len(res.records) == 4
        n0 = mm_kernel.launches
        assert autotune(256, 384, 512).cache_hit and mm_kernel.launches == n0
        path, _ = mm_kernel.path_of_block(*res.block)
        a = _rand((256, 512), 21).to(cuda, torch.bfloat16)
        b = _rand((512, 384), 22).to(cuda, torch.bfloat16)
        before = collections.Counter(mm_kernel.launches_by_plan)
        mm_ops.matmul(a, b)
        assert [(key[3], key[5]) for key in mm_kernel.launches_by_plan - before] == [(path, "tuned")]
        if path.startswith("wgmma"):
            raw = torch.empty(256 * 512 + 4, device=cuda, dtype=torch.bfloat16)[4:].view(256, 512).copy_(a)
            before = collections.Counter(mm_kernel.launches_by_plan)
            mm_ops.matmul(raw, b)
            assert [(key[3], key[5]) for key in mm_kernel.launches_by_plan - before] == [("wmma", "tuned_refused")]
    finally:
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
        tune_cache.reset_default_cache()


# -- observability: recording, sampled windows, the drift probe ----------------------


def _plan_counts():
    from repro_torch.obs import metrics

    c = metrics.get_registry().snapshot()["counters"]
    return (c.get('tune.plan.hit{backend="cuda-systolic"}', 0.0), c.get('tune.plan.miss{backend="cuda-systolic"}', 0.0),
            c.get('gemm.calls{backend="cuda-systolic",dtype="bfloat16"}', 0.0))


@pytest.mark.gpu
def test_record_gemm_adds_no_launch_and_records_what_launched(cuda, tmp_path, monkeypatch):
    """Recording is host bookkeeping: a record launches nothing, each K1
    launch is recorded once, and a tuned path the operands refuse (an
    unaligned view) is recorded as the miss the rule's launch is."""
    from repro_torch.obs import attribution, metrics
    from repro_torch.tune import cache as tune_cache

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    tune_cache.reset_default_cache()
    metrics.reset()
    try:
        n0 = mm_kernel.launches
        totals = attribution.GemmTotals()
        with attribution.collecting(totals):
            attribution.record_gemm(4, 2048, 2048, dtype="bfloat16", backend="cuda-systolic", plan_source="rule")
        assert mm_kernel.launches == n0 and totals.calls == 1
        m, n, k = 256, 384, 512
        tune_cache.default_cache().store(
            tune_cache.CacheKey("cuda-systolic", "h100", m, n, k, "bfloat16"),
            tune_cache.TunedPlan(*mm_kernel.TILES["wgmma_128x128"], mean_us=1.0, best_us=1.0, method="cuda-events"))
        a = _rand((m, k), 31).to(cuda, torch.bfloat16)
        b = _rand((k, n), 32).to(cuda, torch.bfloat16)
        raw = torch.empty(m * k + 4, device=cuda, dtype=torch.bfloat16)[4:].view(m, k).copy_(a)
        metrics.reset()
        before = collections.Counter(mm_kernel.launches_by_plan)
        with attribution.collecting(totals):
            mm_ops.matmul(a, b)
            mm_ops.matmul(raw, b)
            mm_ops.matmul(a[:64], b)
        torch.cuda.synchronize()
        assert sorted(key[5] for key in mm_kernel.launches_by_plan - before) == ["rule", "tuned", "tuned_refused"]
        assert _plan_counts() == (1.0, 2.0, 3.0)
        assert mm_kernel.launches == n0 + 3 and totals.calls == 4
    finally:
        metrics.reset()
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
        tune_cache.reset_default_cache()


@pytest.mark.gpu
def test_sampled_windows_time_each_k1_call(cuda):
    """At sampling rate 1.0 every K1 call through ``core.ops.matmul`` gets
    one ``eager-wall`` window (host clock to the card's finishing it), and
    the windows add no launch."""
    from repro_torch import obs
    from repro_torch.core import ops
    from repro_torch.obs import metrics

    metrics.reset()
    x = _rand((2, 4, 512), 33).to(cuda, torch.bfloat16)
    w = _rand((512, 256), 34).to(cuda, torch.bfloat16)
    n0 = mm_kernel.launches
    try:
        with obs.sampling(1.0):
            for _ in range(5):
                ops.matmul(x, w)
        hists = metrics.get_registry().snapshot()["histograms"]
        (series, h), = hists.items()
        assert obs.parse_series(series)[1] == {"backend": "cuda-systolic", "dtype": "bfloat16", "method": "eager-wall",
                                               "problem": "8x256x512"}
        assert h["count"] == mm_kernel.launches - n0 == 5 and h["min"] > 0
    finally:
        metrics.reset()


@pytest.mark.gpu
def test_drift_probe_times_each_decode_gemm_with_cuda_events(cuda, tmp_path, monkeypatch):
    """The drift probe on an engine on the card: one ``cuda-events``
    ``profile.gemm_us`` sample per decode problem, on the shape rule's path
    (an empty plan cache), none failing."""
    from repro_torch import configs, obs
    from repro_torch.models.registry import get_model
    from repro_torch.obs import drift, metrics
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.serving.engine import decode_gemm_problems
    from repro_torch.tune import cache as tune_cache

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    tune_cache.reset_default_cache()
    metrics.reset()
    try:
        cfg = configs.get_smoke("internlm2-1.8b")
        model = get_model(cfg)
        engine = ServeEngine(model, model.init(0, "cuda"), ServeConfig(max_len=32, batch=4), device="cuda")
        rows = drift.probe_decode_plans(engine, repeats=1)
        problems = decode_gemm_problems(cfg, 4)
        assert len(rows) == len(problems) and all("error" not in r for r in rows)
        assert all(r["method"] == "cuda-events" and r["mean_us"] > 0 and r["path"] == "decode" and not r["cached"]
                   for r in rows)
        hists = {obs.parse_series(s)[1]["problem"]: h for s, h in metrics.get_registry().snapshot()["histograms"].items()
                 if obs.parse_series(s)[0] == "profile.gemm_us"}
        want = collections.Counter(f"{m}x{n}x{k}" for _, m, n, k in problems)
        assert {p: h["count"] for p, h in hists.items()} == dict(want)
    finally:
        metrics.reset()
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
        tune_cache.reset_default_cache()


# -- the launch queries and the card audit (repro_torch.check) ----------------------

SERVED_GEMMS = [  # (M, N, K): internlm2-1.8b's decode and prefill projections, the tied head, ragged ones
    (4, 2048, 2048), (4, 8192, 2048), (4, 2048, 8192), (4, 2560, 2048), (2048, 2048, 2048), (2048, 8192, 2048),
    (2048, 2048, 8192), (1024, 151655, 896), (100, 130, 70), (1, 300, 1000),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", SERVED_GEMMS)
def test_systolic_launch_query_is_the_python_accounting(cuda, m, n, k):
    """Each K1 path's launch as the binary reports it (grid, threads, dynamic
    shared memory, split and chunk) equals ``launch_of``, and the split-K
    workspace equals ``plan_split``'s splits x M x N x 4 bytes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = mm_kernel._entry("systolic_mmm")[0]
    for path in mm_kernel.PATHS:
        dt = torch.float32 if path.startswith("fma") else torch.bfloat16
        if mm_kernel.path_refusal(path, m, n, k, dt, True, path.endswith("_kmajor")):
            continue
        for chunk in ((0, 128, 512) if path.startswith("decode") and k > 64 else (0,)):
            got, compiled = mm_kernel.launch_query(path, m, n, k, dt, dt, chunk)
            assert got == mm_kernel.launch_of(path, m, n, k, sms, chunk), (path, chunk)
            assert compiled.regs > 0 and compiled.max_threads >= got.threads
            ws = lib.split_workspace(m, n, k, int(path.startswith("decode")), chunk)
            assert ws == (got.splits * m * n * 4 if got.splits > 1 else 0)
            if path.startswith("decode"):
                assert (got.splits, got.k_chunk or k) == mm_kernel.plan_split(m, n, k, sms, chunk)
                assert mm_kernel.block_of(path, m, n, k, sms, chunk)[2] == (got.k_chunk or -(-k // 64) * 64)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(4, 2048, 2048), (4, 2048, 8192), (2048, 2048, 2048), (2048, 8192, 2048),
                                   (100, 130, 96)])
@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn])
def test_quant_launch_query_is_the_python_accounting(cuda, m, n, k, qdtype):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = mm_kernel._entry("systolic_qmm")[0]
    for path in mm_kernel.qtiles(qdtype):
        step = mm_kernel.launch_step(128, 128, k)
        if mm_kernel.qpath_refusal(path, m, n, k, step, qdtype, True):
            continue
        got, _ = mm_kernel.qlaunch_query(path, m, n, k, 128, 128, qdtype, torch.bfloat16)
        assert got == mm_kernel.qlaunch_of(path, m, n, k, qdtype, sms), path
        assert lib.split_workspace(m, n, k, 1, 0) == (got.splits * m * n * 4 if got.splits > 1 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("e,c,k,n", [(128, 160, 2048, 768), (128, 8, 2048, 768), (8, 100, 768, 2048),
                                     (4, 200, 136, 264)])
def test_grouped_launch_query_is_the_python_accounting(cuda, e, c, k, n):
    for path in grouped_kernel.PATHS:
        dt = torch.float32 if path == "fma" else torch.bfloat16
        if grouped_kernel.path_refusal(path, c, k, n, dt, True):
            continue
        got, _ = grouped_kernel.launch_query(path, e, c, k, n, dt)
        assert got == grouped_kernel.launch_of(path, e, c, k, n), path


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,s,d", [(4, 16, 8, 512, 128), (1, 32, 4, 8192, 128), (4, 14, 2, 512, 64),
                                         (4, 32, 32, 512, 112), (2, 4, 1, 100, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_launch_query_is_the_python_accounting(cuda, b, h, hkv, s, d, dtype):
    got, _ = attn_kernel.launch_query(b, h, hkv, s, s, d, dtype)
    assert got == attn_kernel.launch_of(b, h, s, d, dtype)


@pytest.mark.gpu
def test_no_compiled_path_spills(cuda):
    """Every path of every library, at both output dtypes, keeps its fp32
    accumulator in registers: no local-memory spill (judged by
    ``localSizeBytes``, not ``numRegs``: setmaxnreg moves registers after the
    launch)."""
    from repro_torch.check import audit

    report = audit.kernel_report("cuda")
    assert report and [r for r in report if r["local_bytes"]] == []
    assert {r["library"] for r in report} == {"systolic_mmm", "systolic_qmm", "grouped_mmm", "flash_attn"}


@pytest.mark.gpu
def test_card_audit_of_the_dispatch_paths_is_clean(cuda):
    from repro_torch.check import audit

    findings, stats = audit.audit_dispatch_paths("cuda")
    assert findings == [], [f.render() for f in findings]
    assert all(stats["paths"][p] >= 1 for p in ("systolic", "quant", "grouped", "attention", "collective_matmul"))
    assert stats["binary_checks_not_made"] == []


@pytest.mark.gpu
def test_card_audit_catches_a_corrupt_plan(cuda):
    """Shared memory declared below the binary's block (dynamic + static),
    on a wgmma tile and on a WMMA tile, whose shared memory the CPU cannot
    see (static)."""
    from repro_torch.check import audit
    from repro_torch.core.blocking import BlockPlan

    wg = BlockPlan(2048, 2048, 2048, 128, 256, 64)
    assert audit.audit_matmul_plan(wg, device="cuda") == []
    assert "smem-underdeclared" in {f.rule for f in audit.audit_matmul_plan(wg, device="cuda",
                                                                            declared_smem_bytes=1000)}
    wmma = BlockPlan(2048, 2048, 2048, 128, 128, 32)
    assert audit.audit_matmul_plan(wmma, device="cpu", declared_smem_bytes=1000) == []
    assert "smem-underdeclared" in {f.rule for f in audit.audit_matmul_plan(wmma, device="cuda",
                                                                            declared_smem_bytes=1000)}


@pytest.mark.gpu
def test_card_audit_catches_a_wrong_output(cuda, monkeypatch):
    """An audited launch whose output is wrong (K1's or K3's zeroed after
    the kernel) is caught by the launch the audit makes against the plain
    version."""
    from repro_torch.check import audit

    gemm, flash = (512, 512, 512, "wmma", 0, "explicit", True), (1, 128, 128, 2, 2, 64, "bfloat16")
    assert audit.audit_launches(systolic=[gemm], attention=[flash], device="cuda")[0] == []
    mm_call, flash_call = mm_kernel.systolic_matmul_call, attn_kernel.flash_attention_call
    monkeypatch.setattr(mm_kernel, "systolic_matmul_call", lambda *a, **kw: mm_call(*a, **kw).zero_())
    monkeypatch.setattr(attn_kernel, "flash_attention_call", lambda *a, **kw: flash_call(*a, **kw).zero_())
    findings, _ = audit.audit_launches(systolic=[gemm], attention=[flash], device="cuda")
    assert sorted(f.rule for f in findings) == ["output-mismatch", "output-mismatch"], [f.render() for f in findings]


# ---------------------------------------------------------------------------
# Tensor parallelism: the collective matmul's ring (each step one K1 launch)
# and the TP-served decoder, over NCCL with one rank a card (two cards or
# more; they skip with fewer), and over Gloo with two ranks sharing one card
# (each hop through host memory).
# ---------------------------------------------------------------------------


@pytest.fixture
def cards2(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two cards or more, {n} visible")
    return min(n, 4)


def _tp_collective_rank(rank, world, cards):
    """This rank's all_gather_matmul / reduce_scatter_matmul at (2048, 2048)
    x (2048, 8192) bf16, both directions, overlap on and off, against K1 on
    the whole problem; -> (worst error share of the tolerance, K1 launches)."""
    from repro_torch.distributed import collective_matmul as cm
    from repro_torch.launch.mesh import Mesh

    torch.cuda.set_device(rank % cards)
    mesh = Mesh((world,), ("model",))
    a = _rand((2048, 2048), 11).to("cuda", torch.bfloat16)
    b = (_rand((2048, 8192), 12) * 2048**-0.5).to("cuda", torch.bfloat16)
    whole = mm_ops.matmul(a, b)
    m, n, k = 2048 // world, 8192 // world, 2048 // world
    worst, launches = 0.0, []
    for direction in ("plus", "minus"):
        for overlap in (True, False):
            before = mm_kernel.launches
            ag = cm.all_gather_matmul(a[rank * m:(rank + 1) * m], b[:, rank * n:(rank + 1) * n].contiguous(),
                                      mesh=mesh, direction=direction, overlap=overlap)
            launches.append(mm_kernel.launches - before)
            before = mm_kernel.launches
            rs = cm.reduce_scatter_matmul(a[:, rank * k:(rank + 1) * k].contiguous(), b[rank * k:(rank + 1) * k],
                                          mesh=mesh, direction=direction, overlap=overlap)
            launches.append(mm_kernel.launches - before)
            for got, want in ((ag, whole[:, rank * n:(rank + 1) * n]), (rs, whole[rank * m:(rank + 1) * m])):
                d = (got.float() - want.float()).abs() / (2e-2 + 2e-2 * want.float().abs())
                worst = max(worst, d.max().item())
    return worst, launches


def _check_collective(results, world):
    for worst, launches in results:
        assert worst <= 1.0, worst
        assert launches == [world, world, 1, 1] * 2  # ring: one K1 launch a step


@pytest.mark.gpu
def test_collective_matmul_over_nccl_matches_k1(cards2, tmp_path):
    from repro_torch.launch.mesh import run_ranks

    _check_collective(run_ranks(_tp_collective_rank, cards2, str(tmp_path), backend="nccl", args=(cards2,),
                                timeout_s=180), cards2)


@pytest.mark.gpu
def test_collective_matmul_over_gloo_on_one_card_matches_k1(cuda, tmp_path):
    """Two ranks on one card over Gloo: card tensors hop through host copies."""
    from repro_torch.launch.mesh import run_ranks

    _check_collective(run_ranks(_tp_collective_rank, 2, str(tmp_path), backend="gloo", args=(1,), timeout_s=180), 2)


def _tp_serve_rank(rank, world, cards):
    """SMOKE internlm2-1.8b in bf16 served TP-sharded on this rank's card;
    -> (its tokens, the TP prefill logits' gap to the single-card path's as a
    share of the largest logit, K1 and flash launches of the TP prefill)."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServeConfig, ServeEngine

    torch.cuda.set_device(rank % cards)
    cfg = configs.get_smoke("internlm2-1.8b")
    model = get_model(cfg)
    params = model.init(0, "cuda")
    batch = make_batch(cfg, batch=4, seq=32, kind="prefill", seed=0, device="cuda")
    scfg = ServeConfig(max_len=40, batch=4)
    engine = ServeEngine(model, params, scfg, device="cuda", mesh=Mesh((1, world), ("data", "model")))
    with torch.no_grad():
        want, _ = model.prefill(params, batch, max_len=40)
        k1, fl = mm_kernel.launches, attn_kernel.launches
        got, _ = engine.layout.prefill(engine.params, batch, 40)
        k1, fl = mm_kernel.launches - k1, attn_kernel.launches - fl
    gap = ((got - want).abs().max() / want.abs().max()).item()
    return engine.generate(batch, 6).cpu(), gap, k1, fl


@pytest.mark.gpu
def test_tp_serving_over_nccl_matches_one_card(cards2, tmp_path):
    from repro_torch.launch.mesh import run_ranks

    results = run_ranks(_tp_serve_rank, cards2, str(tmp_path), backend="nccl", args=(cards2,), timeout_s=180)
    for tokens, gap, k1, fl in results:
        assert torch.equal(tokens, results[0][0]) and tokens.shape == (4, 6)
        assert gap <= 5e-2, gap
        assert (k1, fl) == (2 * 7 * cards2, 2)  # 2 layers x 7 sharded GEMMs x tp ring steps; flash once a layer


# ---------------------------------------------------------------------------
# Data-parallel training: ZeRO-1 moments over the "data" axis, two ranks
# sharing one card over Gloo (the exchange through host memory).
# ---------------------------------------------------------------------------


def _dp_train_rank(rank, world):
    """Three Trainer steps of SMOKE internlm2-1.8b (fp32 masters, bf16
    compute) at dp ``world`` on card 0 -> (the first and the third step's
    metrics, its initial and final parameters on the host, K1 and flash
    launches of the third step)."""
    from repro_torch import configs
    from repro_torch.core.tree import leaves
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import TrainConfig, Trainer

    torch.cuda.set_device(0)
    cfg = configs.get_smoke("internlm2-1.8b")
    model = get_model(cfg)
    mesh = None if world == 1 else Mesh((world, 1), ("data", "model"))
    trainer = Trainer(model, TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4),
                      model.init(0, "cuda", dtype=torch.float32), mesh)
    start = [t.cpu() for t in leaves(trainer.params)]
    batch = make_batch(cfg, batch=4, seq=32, kind="train", seed=0, device="cuda")
    first = trainer.run(iter([batch]), 1, log_every=0)  # step 1 at lr 0 (the warmup), metrics at the initial weights
    first = {k: float(v) for k, v in first.items()}
    trainer.run(iter([batch]), 1, log_every=0)  # the first update, at lr 1e-3
    k1, fl = mm_kernel.launches, attn_kernel.launches
    m = trainer.run(iter([batch]), 1, log_every=0)  # metrics after that update
    k1, fl = mm_kernel.launches - k1, attn_kernel.launches - fl
    return first, {k: float(v) for k, v in m.items()}, start, [t.cpu() for t in leaves(trainer.params)], k1, fl


@pytest.mark.gpu
def test_data_parallel_training_over_gloo_on_one_card_matches_one_card(cuda, tmp_path):
    """dp 2 on one card against the one-card Trainer, three steps (the first
    at lr 0): the third step's loss within 1e-2 and gradient norm within
    5e-2 (bf16 compute at 2 rows a rank against 4), each limit below what a
    dropped update reads (the one-card run's first step against its third);
    every parameter leaf's change from the initial weights within 0.5
    relative L2 of the one-card change (a skipped or misplaced update reads
    1 or more); both ranks' parameters bit for bit equal; each rank's step
    K1 21 x 2 layers at its rows and K3 once a layer."""
    from repro_torch.launch.mesh import run_ranks

    one_first, one_m, start, one_p, one_k1, one_fl = _dp_train_rank(0, 1)
    assert (one_k1, one_fl) == (42, 2)
    for k, tol in (("loss", 1e-2), ("grad_norm", 5e-2)):
        assert abs(one_first[k] - one_m[k]) > tol * abs(one_m[k]), (k, one_first[k], one_m[k])
    results = run_ranks(_dp_train_rank, 2, str(tmp_path), backend="gloo", args=(), timeout_s=180)
    for _, m, p_start, p, k1, fl in results:
        assert all(torch.equal(a, b) for a, b in zip(p_start, start, strict=True))
        assert abs(m["loss"] - one_m["loss"]) <= 1e-2 * abs(one_m["loss"])
        assert abs(m["grad_norm"] - one_m["grad_norm"]) <= 5e-2 * one_m["grad_norm"]
        gaps = [((a - b).norm() / (b - p0).norm().clamp_min(1e-30)).item()
                for a, b, p0 in zip(p, one_p, start, strict=True)]
        assert max(gaps) <= 0.5, max(gaps)
        assert all(torch.equal(a, b) for a, b in zip(p, results[0][3], strict=True))
        assert (k1, fl) == (42, 2)


# ---------------------------------------------------------------------------
# Tensor-parallel training: the rings under autograd and the vocab-parallel
# loss, two ranks sharing one card over Gloo at tp 2.
# ---------------------------------------------------------------------------

TP_TRAIN_LAYERS = 1


def _tp_train_rank(rank, world):
    """Three Trainer steps of full-width glm4-9b at TP_TRAIN_LAYERS layer(s)
    (fp32 masters, bf16 compute) on card 0, at tp ``world`` on a (1, world)
    mesh -> (the first and the third step's metrics, the whole parameters
    after them on the host (rank 0; None elsewhere), this rank's leaves
    replicated over "model", K1 and flash launches of the third step)."""
    from repro_torch import configs
    from repro_torch.core.tree import leaves
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.tp_layout import TPLayout
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_model
    from repro_torch.train.loop import TrainConfig, Trainer

    torch.cuda.set_device(0)
    cfg = configs.get_config("glm4-9b").scaled(n_layers=TP_TRAIN_LAYERS)
    model = get_model(cfg)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    if world == 1:
        trainer = Trainer(model, tcfg, model.init(0, "cuda", dtype=torch.float32))
    else:
        mesh = Mesh((1, world), ("data", "model"))
        trainer = Trainer(model, tcfg, TPLayout(cfg, mesh).init_shards(model, 0, "cuda"), mesh)
    batch = make_batch(cfg, batch=4, seq=64, kind="train", seed=0, device="cuda")
    first = {k: float(v) for k, v in trainer.run(iter([batch]), 1, log_every=0).items()}  # lr 0
    trainer.run(iter([batch]), 1, log_every=0)  # the first update
    k1, fl = mm_kernel.launches, attn_kernel.launches
    m = trainer.run(iter([batch]), 1, log_every=0)
    k1, fl = mm_kernel.launches - k1, attn_kernel.launches - fl
    state = trainer.state()
    whole = None if state is None else [t.cpu() for t in leaves(state["params"])]
    repl = [] if world == 1 else [t.cpu() for t, sh in zip(leaves(trainer.params), trainer.layout.model_sharded)
                                  if not sh]
    return first, {k: float(v) for k, v in m.items()}, whole, repl, k1, fl


@pytest.mark.gpu
def test_tp_training_over_gloo_on_one_card_matches_one_card(cuda, tmp_path):
    """tp 2 on one card against the one-card Trainer, full-width glm4-9b at
    one layer, three steps (the first at lr 0): the third step's loss and
    gradient norm within 1e-2, each limit below what a dropped update reads;
    every parameter leaf's change from the initial weights within 0.3
    relative L2 of the one-card change; the leaves replicated over "model"
    bit for bit equal on both ranks; each rank's step 35 K1 launches a layer
    (7 rings of 2 steps forward, 7 backward, 7 dW) and K3 once a layer."""
    from repro_torch import configs
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.registry import get_model

    one_first, one_m, one_p, _, one_k1, one_fl = _tp_train_rank(0, 1)
    model = get_model(configs.get_config("glm4-9b").scaled(n_layers=TP_TRAIN_LAYERS))
    start = [t.cpu() for t in leaves(model.init(0, "cuda", dtype=torch.float32))]
    assert (one_k1, one_fl) == (21 * TP_TRAIN_LAYERS, TP_TRAIN_LAYERS)
    for k in ("loss", "grad_norm"):
        assert abs(one_first[k] - one_m[k]) > 1e-2 * abs(one_m[k]), (k, one_first[k], one_m[k])
    results = run_ranks(_tp_train_rank, 2, str(tmp_path), backend="gloo", args=(), timeout_s=300)
    for _, m, _, repl, k1, fl in results:
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - one_m[k]) <= 1e-2 * abs(one_m[k]), (k, m[k], one_m[k])
        assert all(torch.equal(a, b) for a, b in zip(repl, results[0][3], strict=True))
        assert (k1, fl) == (35 * TP_TRAIN_LAYERS, TP_TRAIN_LAYERS)
    got = results[0][2]
    assert got is not None and results[1][2] is None
    gaps = [((a - b).norm() / (b - p0).norm().clamp_min(1e-30)).item() for a, b, p0 in zip(got, one_p, start,
                                                                                             strict=True)]
    assert max(gaps) <= 0.3, max(gaps)


# ---------------------------------------------------------------------------
# Expert parallelism: the experts cut over "model", the routing pooled, each
# kept slot's row exchanged with its expert's rank; two ranks sharing one card
# over Gloo.
# ---------------------------------------------------------------------------

EP_LAYERS = 1


def _ep_rank(rank, world):
    """Full-width qwen3-moe-30b-a3b at EP_LAYERS layer(s) on card 0, on one
    card (``world`` 1) or over a (1, world) mesh: the bf16 prefill's logits
    of 4 x 64 prompts, then three Trainer steps (fp32 masters, the first at
    lr 0) -> (the logits on the host, the first and third step's metrics,
    the whole parameters after them (rank 0; None elsewhere), K4 launches
    of the prefill and of the third step, this rank's experts)."""
    from repro_torch import configs
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data.synthetic import make_batch
    from repro_torch.distributed.tp_layout import TPLayout
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServeConfig, ServeEngine
    from repro_torch.train.loop import TrainConfig, Trainer

    torch.cuda.set_device(0)
    cfg = configs.get_config("qwen3-moe-30b-a3b").scaled(n_layers=EP_LAYERS)
    model = get_model(cfg)
    mesh = None if world == 1 else Mesh((1, world), ("data", "model"))
    served = tree_map(lambda t: t.to(torch.bfloat16), model.init(0, "cuda", dtype=torch.float32))
    engine = ServeEngine(model, served, ServeConfig(max_len=72, batch=4), device="cuda", mesh=mesh)
    del served
    prompt = make_batch(cfg, batch=4, seq=64, kind="prefill", seed=0, device="cuda")
    k4 = grouped_kernel.launches
    with torch.no_grad():
        logits = engine._prefill(engine.params, prompt, max_len=72)[0].float().cpu()
    k4_prefill = grouped_kernel.launches - k4
    del engine
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    if world == 1:
        trainer = Trainer(model, tcfg, model.init(0, "cuda", dtype=torch.float32))
    else:
        trainer = Trainer(model, tcfg, TPLayout(cfg, mesh).init_shards(model, 0, "cuda"), mesh)
    batch = make_batch(cfg, batch=4, seq=64, kind="train", seed=0, device="cuda")
    first = {k: float(v) for k, v in trainer.run(iter([batch]), 1, log_every=0).items()}  # lr 0
    trainer.run(iter([batch]), 1, log_every=0)  # the first update
    k4 = grouped_kernel.launches
    m = trainer.run(iter([batch]), 1, log_every=0)
    k4_step = grouped_kernel.launches - k4
    state = trainer.state()
    whole = None if state is None else [t.cpu() for t in leaves(state["params"])]
    experts = trainer.params["layers"][0]["ffn"]["w_gate"].shape[0]
    return logits, first, {k: float(v) for k, v in m.items()}, whole, k4_prefill, k4_step, experts


@pytest.mark.gpu
def test_expert_parallel_serving_and_training_over_gloo_on_one_card_match_one_card(cuda, tmp_path):
    """tp 2 on one card against one card, full-width qwen3-moe-30b-a3b at one
    layer: the prefill's logits within 1e-1 of the largest logit (each path
    routing freely in bf16), 3 K4 launches a layer at 64 of the 128 experts
    a rank; three training steps (the first at lr 0), the third's loss and
    gradient norm within 1e-2 of one card's, each limit below what a
    dropped update reads, every parameter leaf's change from the initial
    weights within 0.3 relative L2 of one card's, K4 launches a step as one
    card's."""
    from repro_torch import configs
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.registry import get_model

    one_logits, one_first, one_m, one_p, one_k4p, one_k4s, one_e = _ep_rank(0, 1)
    model = get_model(configs.get_config("qwen3-moe-30b-a3b").scaled(n_layers=EP_LAYERS))
    start = [t.cpu() for t in leaves(model.init(0, "cuda", dtype=torch.float32))]
    assert one_k4p == 3 * EP_LAYERS and one_e == 128
    for k in ("loss", "grad_norm"):
        assert abs(one_first[k] - one_m[k]) > 1e-2 * abs(one_m[k]), (k, one_first[k], one_m[k])
    results = run_ranks(_ep_rank, 2, str(tmp_path), backend="gloo", args=(), timeout_s=600)
    scale = one_logits.abs().max().item()
    for logits, _, m, _, k4p, k4s, experts in results:
        assert (logits - one_logits).abs().max().item() <= 1e-1 * scale
        assert (k4p, k4s, experts) == (3 * EP_LAYERS, one_k4s, 64)
        for k in ("loss", "grad_norm"):
            assert abs(m[k] - one_m[k]) <= 1e-2 * abs(one_m[k]), (k, m[k], one_m[k])
    got = results[0][3]
    assert got is not None and results[1][3] is None
    gaps = [((a - b).norm() / (b - p0).norm().clamp_min(1e-30)).item() for a, b, p0 in zip(got, one_p, start,
                                                                                             strict=True)]
    assert max(gaps) <= 0.3, max(gaps)
