"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's ``flash_attention`` runs its plain version; the JAX
side runs the Pallas kernel in interpret mode.  Inputs are drawn with numpy
and given to both.  Tolerances are the reference's own
(``tests/kernels/test_attention.py``): 2e-4 in fp32 (online vs direct
softmax sum in other orders) and 3e-2 in bf16 (P is rounded to bf16 before
P @ V, at other points in the two versions).

``tests/test_torch_kernels_gpu.py`` holds the CUDA kernels against these
plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as jax_ops
from repro_torch.kernels.attention import kernel as t_kernel
from repro_torch.kernels.attention import ops

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
