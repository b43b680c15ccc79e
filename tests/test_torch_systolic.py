"""The port's systolic GEMM against the JAX package's Pallas kernel.

On the CPU the port's ``ops.matmul`` runs its plain version; the JAX side
runs the Pallas kernel in interpret mode.  Inputs are drawn with numpy and
given to both.  Tolerances start from the reference's own
(``tests/kernels/test_systolic.py``: rtol = atol = 1e-5 in fp32, 2e-2 in
bf16).  In fp32 the absolute part is 1e-5 * sqrt(K): the reference compares
its kernel with an XLA dot that sums in the same order, while torch sums K
products of unit-variance inputs in another order, and that rounding grows
with sqrt(K) (measured: 9e-5 at K = 512 and 1.1e-4 at K = 1024, against the
exact fp64 product the Pallas result is off by the same amounts).  In bf16,
2e-2 is one bf16 ulp at the outputs' scale, where the two round the fp32 sum.

``tests/test_torch_kernels_gpu.py`` holds the CUDA kernels against these
plain versions on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.systolic import ops as jax_ops
from repro_torch import configs
from repro_torch.kernels.systolic import kernel as t_kernel
from repro_torch.core.hw import H100, dtype_bytes
from repro_torch.kernels.systolic import ops

SHAPES = [
    (128, 128, 128),  # single block
    (256, 384, 512),  # multi-block divisible
    (8, 128, 128),  # minimum sublane
    (100, 130, 70),  # non-divisible edges
    (33, 257, 129),  # awkward primes
    (512, 128, 1024),  # deep contraction
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ACTS = ["none", "relu", "gelu", "silu", "tanh"]


def _tol(name, k):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=1e-5, atol=1e-5 * k**0.5)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matmul_matches_pallas(m, n, k, dtype):
    jdt, tdt = DTYPES[dtype]
    a, b = _rand((m, k), m * n + k), _rand((k, n), m + n * k)
    want = jax_ops.matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt), interpret=True)
    got = ops.matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype, k))


@pytest.mark.parametrize("activation", ACTS)
def test_fused_bias_activation_matches_pallas(activation):
    a, b, bias = _rand((64, 96), 1), _rand((96, 160), 2), _rand((160,), 3)
    want = jax_ops.matmul(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias), activation=activation, interpret=True
    )
    got = ops.matmul(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bias), activation=activation
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_out_dtype_override():
    a = torch.ones((16, 128), dtype=torch.bfloat16)
    b = torch.ones((128, 128), dtype=torch.bfloat16)
    got = ops.matmul(a, b, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), 128.0)


@pytest.mark.parametrize("a_shape,b_shape,act", [
    ((4, 8), (9, 4), "none"),  # contraction mismatch
    ((4, 8, 1), (8, 4), "none"),  # not 2D
    ((4, 8), (8, 4), "softplus"),  # unknown activation
])
def test_errors_match_reference(a_shape, b_shape, act):
    with pytest.raises(ValueError):
        jax_ops.matmul(jnp.ones(a_shape), jnp.ones(b_shape), activation=act, interpret=True)
    with pytest.raises(ValueError):
        ops.matmul(torch.ones(a_shape), torch.ones(b_shape), activation=act)


def test_kernel_call_refuses_cpu_tensors():
    """The raw binding never computes on the CPU: only ops.matmul picks the
    plain version, and only for CPU tensors."""
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.systolic_matmul_call(
            torch.ones(4, 8), torch.ones(8, 4), None, out_dtype=torch.float32
        )


@pytest.mark.parametrize("m,bound_by", [(4, "bytes"), (2048, "operations")])
def test_h100_bound_of_a_projection(m, bound_by):
    """A decode projection is bound by reading the weight, a prefill one by
    the tensor cores (989e12 bf16 FLOP/s, 3.35e12 B/s datasheet)."""
    k = n = 2048
    flops = 2 * m * n * k
    nbytes = (m * k + k * n + m * n) * dtype_bytes(torch.bfloat16)
    secs, by = H100.bound_s(flops, nbytes, "bfloat16")
    assert by == bound_by
    assert secs == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))


@pytest.mark.parametrize("m,bound_by", [(4, "bytes"), (2048, "operations")])
@pytest.mark.parametrize("dtype", ["int8", "float8_e4m3fn"])
def test_h100_bound_of_a_quantized_projection(m, bound_by, dtype):
    """A block-scaled projection (1-byte values, fp32 scales per 128 k, bf16
    out): at decode it is bound by reading the weight, at prefill by the
    tensor cores at 1979e12 int8 / fp8 op/s (datasheet, dense)."""
    k = n = 2048
    kb = k // 128
    flops = 2 * m * n * k
    nbytes = (m * k + k * n) * dtype_bytes(dtype) + 4 * (m * kb + kb * n) + m * n * dtype_bytes(torch.bfloat16)
    secs, by = H100.bound_s(flops, nbytes, dtype)
    assert by == bound_by
    assert secs == pytest.approx(max(flops / 1979e12, nbytes / 3.35e12))
    if m == 2048:
        assert secs == pytest.approx(8.68e-6, rel=1e-3)  # 2 * 2048^3 / 1979e12
    else:
        assert secs == pytest.approx(1.30e-6, rel=1e-2)


BF16 = torch.bfloat16


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    # internlm2-1.8b's prefill projections (M = 4 x 512 tokens)
    (2048, 2048, 2048, BF16, True, "wgmma_128x256"),  # q, o: 128 tiles of 128x256
    (2048, 2048, 1024, BF16, True, "wgmma_128x128"),  # k, v: 128 tiles of 128x128
    (2048, 2048, 8192, BF16, True, "wgmma_128x256"),  # gate, up
    (2048, 8192, 2048, BF16, True, "wgmma_128x256"),  # down
    # qwen3-moe-30b-a3b's
    (2048, 2048, 4096, BF16, True, "wgmma_128x256"),  # q
    (2048, 2048, 512, BF16, True, "wgmma_64x128"),  # k, v
    (2048, 4096, 2048, BF16, True, "wgmma_128x256"),  # o
    (2048, 2048, 128, BF16, True, "wgmma_64x128"),  # the router: 32 tiles of 64 rows
    # minicpm3-4b's (MLA)
    (2048, 2560, 768, BF16, True, "wgmma_128x128"),  # wq_a
    (2048, 768, 3840, BF16, True, "wgmma_128x256"),  # wq_b: K = q_lora 768
    (2048, 2560, 288, BF16, True, "wgmma_64x128"),  # wkv_a: N = 288, a ragged last column tile
    (2048, 256, 5120, BF16, True, "wgmma_128x256"),  # wkv_b: K = kv_lora 256, four k tiles
    (411, 256, 5120, BF16, True, "wgmma_128x256"),  # wkv_b over a chunk's whole batch-1 cache
    # shapes TMA cannot take keep the WMMA tile
    (2048, 2044, 2048, BF16, True, "wmma"),  # K % 8: rows of A not 16-byte multiples
    (2048, 2048, 2044, BF16, True, "wmma"),  # N % 8: rows of B
    (2048, 2048, 2048, BF16, False, "wmma"),  # an operand's base off 16 bytes
    (100, 130, 70, BF16, True, "wmma"),
    (2048, 0, 2048, BF16, True, "wmma"),  # no contraction: nothing to load
    # decode keeps the split-K tile, fp32 the FMA tile
    (16, 2048, 2048, BF16, True, "decode"),
    (4, 8192, 2048, BF16, True, "decode"),
    (17, 8, 8, BF16, True, "wgmma_64x128"),  # the smallest M past the decode tile
    (2048, 2048, 2048, torch.float32, True, "fma"),
    (4, 2048, 2048, torch.float32, True, "fma"),
])
def test_gemm_path_choice(m, k, n, dtype, aligned, want):
    assert t_kernel.gemm_path(m, n, k, dtype, aligned, sms=132) == want


@pytest.mark.parametrize("m,k,n,dtype,aligned,want", [
    (4, 896, 151655, BF16, True, "decode_kmajor"),  # internvl2-1b's tied head at decode
    (1, 896, 151655, BF16, True, "decode_kmajor"),
    (1024, 896, 151655, BF16, True, "wmma_kmajor"),  # a tied forward's rows
    (2048, 2048, 2048, BF16, True, "wmma_kmajor"),  # no wgmma tile reads B K-major
    (2048, 2044, 2044, BF16, False, "wmma_kmajor"),
    (4, 64, 256, torch.float32, True, "fma_kmajor"),
    (2048, 64, 256, torch.float32, True, "fma_kmajor"),
])
def test_gemm_path_choice_k_major(m, k, n, dtype, aligned, want):
    """A K-major B picks its tile by shape among the tiles that read it so."""
    assert t_kernel.gemm_path(m, n, k, dtype, aligned, sms=132, k_major=True) == want


def test_k_major_operand_reaches_the_kernel_uncopied(monkeypatch):
    """ops.matmul hands a K-major B (a transposed contiguous tensor) to the
    kernel binding as it is, and any other layout contiguous."""
    seen = []
    monkeypatch.setattr(t_kernel, "systolic_matmul_call", lambda a, b, bias, **kw: seen.append(b))
    table = torch.ones(10, 4)
    a = torch.ones(3, 4)
    fake_cuda = a.to("meta")  # not a CPU tensor: the wrapper goes to the binding
    ops.matmul(fake_cuda, table.to("meta").T)
    ops.matmul(fake_cuda, torch.ones(20, 4, device="meta")[::2].T)  # strided both ways: copied
    assert seen[0].stride() == (1, 4) and not seen[0].is_contiguous()
    assert seen[1].is_contiguous()
    assert t_kernel.is_k_major(table.T) and not t_kernel.is_k_major(torch.ones(4, 10))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b", "minicpm3-4b"])
def test_every_served_prefill_projection_takes_wgmma(arch):
    """At batch 4 x 512 tokens every projection of the served models (q, k,
    v, o -- MLA's wq_a, wq_b, wkv_a, wkv_b, wo --, then the MLP or the
    router) is a wgmma shape on a 132-SM card."""
    cfg = configs.get_config(arch)
    d, hd, h = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads
    if cfg.attention == "mla":
        m = cfg.mla
        kn = [(d, m.q_lora_rank), (m.q_lora_rank, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
              (d, m.kv_lora_rank + m.qk_rope_head_dim), (m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
              (h * m.v_head_dim, d)]
    else:
        kn = [(d, h * hd), (d, cfg.n_kv_heads * hd), (h * hd, d)]
    kn += [(d, cfg.d_ff), (cfg.d_ff, d)] if cfg.moe is None else [(d, cfg.moe.n_experts)]
    for k, n in kn:
        assert t_kernel.gemm_path(4 * 512, n, k, BF16, True, sms=132).startswith("wgmma"), (k, n)


def test_path_numbers_follow_the_kernel():
    """The binding passes PATHS.index(path) to csrc/systolic_mmm.cu: its Path
    enum must number the paths in the same order."""
    src = (Path(t_kernel.__file__).resolve().parents[2] / "csrc" / "systolic_mmm.cu").read_text()
    enum = re.search(r"enum Path \{([^}]*)\}", src).group(1)
    numbered = {name.strip(): int(num) for name, num in (item.split("=") for item in enum.split(","))}
    c_names = {"P_FMA": "fma", "P_DECODE": "decode", "P_WMMA": "wmma", "P_WGMMA_128": "wgmma_128x128",
               "P_WGMMA_64": "wgmma_64x128", "P_WGMMA_256": "wgmma_128x256", "P_FMA_KMAJOR": "fma_kmajor",
               "P_DECODE_KMAJOR": "decode_kmajor", "P_WMMA_KMAJOR": "wmma_kmajor"}
    assert {c_names[name]: num for name, num in numbered.items()} == {p: i for i, p in enumerate(t_kernel.PATHS)}
    assert {p for p, _, _ in t_kernel.WGMMA_TILES} <= set(t_kernel.PATHS)


@pytest.mark.parametrize("name", sorted(t_kernel._ARGTYPES))
def test_c_entry_argtypes_match_the_sources(name):
    """The ctypes argument list of each C entry point has one type per
    parameter of ``extern "C" int <name>(...)`` in ``csrc/<name>.cu``: a
    mismatch shows only on the card, as a TypeError at the first launch."""
    src = (Path(t_kernel.__file__).resolve().parents[2] / "csrc" / f"{name}.cu").read_text()
    params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1)
    assert len(t_kernel._ARGTYPES[name]) == params.count(",") + 1
