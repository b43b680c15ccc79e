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
                      None, 0, torch.cuda.current_stream().cuda_stream)
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
    before = attn_kernel.launches_by_heads[(h, hkv)]
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
    kw = dict(scale=d**-0.5, causal=causal, window=window, kv_valid=skv if kv_valid is None else kv_valid)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw).transpose(1, 2)
    torch.cuda.synchronize()
    assert attn_kernel.launches_by_heads[(h, hkv)] == before + 1
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
    before = attn_kernel.launches_by_heads[(16, 8)]
    got = attn_ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_call_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=128**-0.5,
                                    causal=True, window=None, kv_valid=s).transpose(1, 2)
    torch.cuda.synchronize()
    assert attn_kernel.launches_by_heads[(16, 8)] == before + 1
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
