"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's ``flash_attention`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode.  Inputs are drawn with numpy
and given to both.  Tolerances are the reference's own
(``tests/kernels/test_attention.py``): 2e-4 in fp32 (online vs direct
softmax sum in other orders) and 3e-2 in bf16 (P is rounded to bf16 before
P @ V, at other points in the two versions).  The port's wrapper also takes
K/V at fewer heads than Q (grouped-query attention) and transposed views; the
reference takes K/V repeated to the query heads, which is what it is given
here, and the model layer ``gqa_fwd`` is held against the reference's at
one, two and four query heads per KV head.

``tests/test_torch_kernels_gpu.py`` holds the CUDA kernels against these
plain versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels.attention import ops as jax_ops
from repro.models import attention as jax_attn
from repro_torch import configs
from repro_torch.kernels.attention import kernel as t_kernel
from repro_torch.kernels.attention import ops
from repro_torch.models import attention as t_attn

CASES = [
    (128, 128, True, None),
    (256, 256, True, None),
    (128, 256, False, None),  # cross-attention style
    (256, 256, True, 64),  # sliding window
    (100, 200, True, None),  # ragged lengths
    (128, 128, True, 32),  # window smaller than block
    (100, 100, True, 48),  # SWA + ragged: padded tail masked, window trims the other side
    (190, 190, True, 64),  # SWA + ragged, window crosses block edges
    (130, 230, True, 32),  # SWA + ragged + longer KV stream
]
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, h, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,skv,causal,window", CASES)
def test_flash_matches_pallas(sq, skv, causal, window):
    q, k, v = _qkv(2, 1, sq, skv, 64)
    want = jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal=causal, window=window, bq=128, bkv=128, interpret=True,
    )
    got = ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, window=window
    )
    tol = TOL["float32"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_dtypes_match_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(2, 2, 128, 128, 64, seed=1)
    want = jax_ops.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), causal=True, interpret=True
    )
    got = ops.flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    )
    assert got.dtype == tdt
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_kv_valid_masks_the_tail():
    """kv_valid=n over a longer K/V stream equals attention over the first n keys."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 60, 100, 32, seed=2))
    got = ops.flash_attention(q, k, v, causal=False, kv_valid=70)
    want = ops.flash_attention(q, k[:, :, :70], v[:, :, :70], causal=False)
    torch.testing.assert_close(got, want, rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("kw", [dict(kv_valid=0), dict(kv_valid=129), dict(window=0)])
def test_bad_arguments_raise(kw):
    q = torch.zeros(1, 1, 8, 16)
    k = torch.zeros(1, 1, 128, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, **kw)


def test_kernel_call_refuses_cpu_tensors():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.flash_attention_call(q, q, q, scale=0.25, causal=True, window=None, kv_valid=8)


# (H, Hkv): KV heads equal to, half and an eighth of the query heads.
GQA_HEADS = [(8, 8), (8, 4), (8, 1)]
# (Sq, Skv, causal, window): the served case, a window, and non-causal.
GQA_CASES = [(100, 100, True, None), (130, 130, True, 32), (60, 90, False, None)]


def _torch_layout(x: np.ndarray, layout: str, dtype) -> torch.Tensor:
    """A (B, H, S, D) array as a contiguous tensor ("bhsd") or as the
    (B, H, S, D) view of a (B, S, H, D) tensor ("bshd"), as a model hands it over."""
    if layout == "bhsd":
        return torch.from_numpy(x).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("h,hkv", GQA_HEADS)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sq,skv,causal,window", GQA_CASES)
def test_gqa_flash_matches_pallas_on_repeated_kv(h, hkv, layout, dtype, sq, skv, causal, window):
    """K/V at Hkv heads (query head h reads KV head h // (H // Hkv)), given
    as contiguous tensors or as transposed views, equal the reference's flash
    attention on K/V repeated to the H query heads."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(h * 10 + hkv)
    q = rng.standard_normal((2, h, sq, 32)).astype(np.float32)
    k = rng.standard_normal((2, hkv, skv, 32)).astype(np.float32)
    v = rng.standard_normal((2, hkv, skv, 32)).astype(np.float32)
    rep = h // hkv
    want = jax_ops.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(np.repeat(k, rep, axis=1), jdt), jnp.asarray(np.repeat(v, rep, axis=1), jdt),
        causal=causal, window=window, interpret=True,
    )
    qt, kt, vt = (_torch_layout(x, layout, tdt) for x in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("hkv", [3, 0])
def test_kv_heads_must_divide_query_heads(hkv):
    q = torch.zeros(1, 8, 16, 16)
    k = torch.zeros(1, hkv, 16, 16)
    with pytest.raises(ValueError, match="KV heads"):
        ops.flash_attention(q, k, k)


@pytest.mark.parametrize("n_kv_heads", [4, 2, 1])  # 1, 2 and 4 query heads per KV head
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gqa_fwd_matches_jax(n_kv_heads, dtype):
    """The model's prefill attention (projections, rope, flash with K/V at
    the model's KV heads, output projection) against the reference's
    ``gqa_fwd`` on its flash path, on the internlm2 SMOKE config with 4
    query heads; the K/V it returns for the cache too."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_get_smoke("internlm2-1.8b"), n_kv_heads=n_kv_heads, dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"), n_kv_heads=n_kv_heads, dtype=dtype)
    assert tcfg.q_per_kv == 4 // n_kv_heads
    jparams = jax_attn.init_gqa(jax.random.PRNGKey(0), jcfg)
    tparams = {name: torch.from_numpy(np.array(w, np.float32)) for name, w in jparams.items()}
    b, s = 2, 40
    x = np.random.default_rng(n_kv_heads).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    with jax_attn.use_attn_impl("flash"):
        jy, (jk, jv) = jax_attn.gqa_fwd(jparams, jnp.asarray(x, jdt), jcfg, jnp.arange(s))
    ty, (tk, tv) = t_attn.gqa_fwd(tparams, torch.from_numpy(x).to(tdt), tcfg, torch.arange(s))
    assert tuple(ty.shape) == (b, s, tcfg.d_model) and tuple(tk.shape) == (b, s, n_kv_heads, tcfg.resolved_head_dim)
    tol = TOL[dtype]
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
