"""The training path's differentiable pieces against JAX on the CPU, and the
kernel wrappers' refusals under grad.

* ``models.attention.chunked_mha`` (output and logsumexp) and ``flash_mha``
  (output and the gradients of q, k and v) against the reference's
  ``chunked_mha`` / ``flash_mha``: causal, a sliding window, a padded tail
  (S not a multiple of the block), non-causal, and K/V at fewer heads than Q
  (the port reads them so; the reference's caller repeats them first, and
  JAX's gradient of that repeat sums each group, as the port's backward
  does).  Small blocks force several of each.  fp32, within 1e-5 (1e-4 for
  gradients, of their largest magnitude).
* ``kernels.systolic.ops.matmul``'s autograd Function (the code whose
  backward launches K1 on the card; here its plain version) against autograd
  through ``matmul_ref``: dA and dB, a K-major B, an fp32 output of bf16
  operands.
* Refusals: under grad, with an operand that requires grad, the kernel
  wrappers without a backward (K3's ``flash_attention``, K5's
  ``quant_matmul``, K1 with a bias or an activation) raise on the kernel
  route instead of dropping the gradient; a quantized weight is refused on
  every device.  K4's ``grouped_matmul`` has a backward: under grad it
  takes the kernel route through its autograd Function.  ``meta`` tensors
  stand in for the card's: they take the kernel route and the check comes
  first.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.core import ops as core_ops
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.attention.ref import flash_attention_call_ref
from repro_torch.kernels.grouped import kernel as grouped_kernel
from repro_torch.kernels.grouped import ops as grouped_ops
from repro_torch.kernels.systolic import ops as mm_ops
from repro_torch.kernels.systolic.ref import matmul_ref
from repro_torch.models import attention
from repro_torch.quant import quantize, quantize_act

TOL = 1e-5
GRAD_TOL = 1e-4
# (S, T, H, Hkv, causal, window, bq, bkv)
CASES = [
    (16, 16, 4, 4, True, None, 8, 8),
    (20, 20, 4, 2, True, None, 8, 8),  # padded tail, GQA
    (24, 24, 4, 1, True, 6, 8, 8),  # window, MQA
    (12, 20, 2, 2, False, None, 8, 16),  # non-causal, S != T, one kv block
    (33, 33, 6, 3, True, 5, 16, 8),
]


def _qkv(s, t, h, hkv, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, s, h, d)).astype(np.float32)
    k = rng.standard_normal((2, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, t, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("s,t,h,hkv,causal,window,bq,bkv", CASES)
def test_chunked_mha_and_stats_match_jax(s, t, h, hkv, causal, window, bq, bkv):
    q, k, v = _qkv(s, t, h, h)
    kw = dict(causal=causal, window=window, bq=bq, bkv=bkv, return_stats=True)
    jo, jl = jax_attn.chunked_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    to, tl = attention.chunked_mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    # the plain flash version's logsumexp (the kernel's oracle) agrees
    _, rl = flash_attention_call_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=8**-0.5,
                                     causal=causal, window=window, kv_valid=t, return_lse=True)
    np.testing.assert_allclose(rl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,t,h,hkv,causal,window,bq,bkv", CASES)
def test_flash_mha_and_grads_match_jax(s, t, h, hkv, causal, window, bq, bkv):
    q, k, v = _qkv(s, t, h, hkv, seed=1)
    do = np.random.default_rng(2).standard_normal((2, s, h, 8)).astype(np.float32)
    rep = h // hkv

    def jf(q_, k_, v_):
        return jax_attn.flash_mha(q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2), causal=causal,
                                  window=window, bq=bq, bkv=bkv)

    jo, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jg = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = attention.flash_mha(tq, tk, tv, causal=causal, window=window, bq=bq, bkv=bkv)
    to.backward(torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_TOL * np.abs(want).max())


def test_flash_mha_refuses_kv_heads_that_do_not_divide():
    q, k, v = (torch.zeros(1, 4, h, 8) for h in (4, 3, 3))
    with pytest.raises(ValueError, match="dividing"):
        attention.flash_mha(q, k, v)


@pytest.mark.parametrize("k_major", [False, True])
@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_function_matches_plain_autograd(k_major, out_dtype):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((9, 12)).astype(np.float32)).bfloat16()
    bt = torch.from_numpy(rng.standard_normal((7, 12)).astype(np.float32)).bfloat16()
    b = bt.T if k_major else bt.T.contiguous()
    dc = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32)).to(out_dtype or torch.bfloat16)
    grads = []
    for fn in (mm_ops.matmul, matmul_ref):
        a_, b_ = a.clone().requires_grad_(), b.detach().clone().requires_grad_()
        y = fn(a_, b_, out_dtype=out_dtype)
        assert y.dtype == (out_dtype or torch.bfloat16) and y.grad_fn is not None
        y.backward(dc)
        grads.append((a_.grad, b_.grad))
    (ga, gb), (wa, wb) = grads
    assert ga.dtype == gb.dtype == torch.bfloat16
    torch.testing.assert_close(ga.float(), wa.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(gb.float(), wb.float(), rtol=1e-2, atol=1e-2)


def test_matmul_function_only_under_grad():
    a, b = torch.ones(2, 3, requires_grad=True), torch.ones(3, 4)
    assert type(mm_ops.matmul(a, b).grad_fn).__name__ == "_MatmulBackward"
    with torch.no_grad():
        assert mm_ops.matmul(a, b).grad_fn is None
    assert mm_ops.matmul(a.detach(), b).grad_fn is None
    b2 = torch.ones(3, 4, requires_grad=True)
    mm_ops.matmul(a.detach(), b2).sum().backward()  # only dB is asked for
    assert torch.equal(b2.grad, torch.full((3, 4), 2.0))


def _meta(*shape, grad=True):
    return torch.empty(shape, device="meta").requires_grad_(grad)


def test_kernel_wrappers_refuse_grad_on_the_kernel_route():
    q = _meta(1, 2, 4, 8)
    with pytest.raises(RuntimeError, match="K3.*no backward"):
        flash_attention(q, q, q)
    # K4 has a backward: under grad it reaches the kernel (which wants the card), not a refusal
    launched = []
    with mock.patch.object(grouped_kernel, "grouped_matmul_call", lambda *a, **kw: launched.append(a) or a[0][..., :3]):
        y = grouped_ops.grouped_matmul(_meta(2, 4, 8), _meta(2, 8, 3, grad=False))
    assert len(launched) == 1 and type(y.grad_fn).__name__ == "_GroupedMatmulBackward"
    with pytest.raises(RuntimeError, match="K2"):
        mm_ops.matmul(_meta(4, 8), _meta(8, 3), _meta(3, grad=False))
    with pytest.raises(RuntimeError, match="K2"):
        mm_ops.matmul(_meta(4, 8), _meta(8, 3), activation="silu")
    x = torch.randn(4, 128, requires_grad=True)
    w = quantize(torch.randn(128, 8), block=(128, 1))
    qa = quantize_act(x, w.values.dtype)
    assert qa.scales.requires_grad  # the activation's scales carry x's graph
    meta = lambda q, s: dataclasses.replace(q, values=q.values.to("meta"), scales=s)
    with pytest.raises(RuntimeError, match="K5.*no backward"):
        mm_ops.quant_matmul(meta(qa, _meta(*qa.scales.shape)), meta(w, w.scales.to("meta")))


def test_quantized_weight_is_refused_under_grad_and_plain_versions_stay_differentiable():
    x = torch.randn(4, 128, requires_grad=True)
    w = quantize(torch.randn(128, 8), block=(128, 1))
    with pytest.raises(RuntimeError, match="quantized"):
        core_ops.matmul(x, w)
    with torch.no_grad():
        assert core_ops.matmul(x, w).shape == (4, 8)
    # on the CPU the plain versions are differentiable by autograd
    y = flash_attention(*(torch.randn(1, 2, 4, 8, requires_grad=True) for _ in range(3)))
    assert y.grad_fn is not None
    g = grouped_ops.grouped_matmul(torch.randn(2, 4, 8, requires_grad=True), torch.randn(2, 8, 3))
    assert g.grad_fn is not None
    assert mm_ops.matmul(x, torch.randn(128, 8), torch.randn(8), activation="silu").grad_fn is not None
