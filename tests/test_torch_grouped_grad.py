"""The grouped GEMM's autograd Function (``_GroupedMatmul``, K4's backward)
against the JAX package on the CPU.

* ``kernels.grouped.ops.grouped_matmul`` under grad: its value and both
  gradients against ``jax.vjp`` of the reference's grouped product
  (``repro.kernels.grouped.ref.grouped_matmul_ref``, the einsum the
  reference's Pallas kernel is tested against), on the same numpy draws and
  cotangent: fp32 and bf16, E of 1 and 8, C of 16 and 40 (a tail past the
  8-row grain), ``rows`` below C with x's and dy's rows past it zero (as
  the MoE dispatch and combine leave them).  On the CPU the Function's
  backward runs its two products through the plain version, so these tests
  run the backward code the card runs.
* Dispatch-grouped (G, E, C, K) input through ``core.ops.grouped_matmul``
  (the fold into one (E, G * C, K) product stays outside the Function)
  against ``jax.vjp`` of ``repro.core.ops.grouped_matmul`` on its einsum
  backend.
* Each ``needs_input_grad`` combination: the products the backward runs,
  one dX (``rows`` forwarded) and one dW (every row live) per product, and
  the launches recorded (the forward's only).
* The MoE block: an expert no token reaches gets an exactly zero gradient;
  dX's rows past an expert's count are read by nothing (poisoned, every
  gradient the same).

Tolerances: fp32 atol 1e-5 x sqrt(contraction), rtol 1e-5 (summation
order, growing with the root of each product's contraction: K for y, N
for dX, C for dW); bf16 atol = rtol = 2e-2 (the reference's bf16 GEMM
tolerance: one bf16 ulp where two fp32 sums round apart).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jax_ops
from repro.core.ops import use_backend
from repro.kernels.grouped.ref import grouped_matmul_ref as jax_grouped_ref
from repro_torch import configs
from repro_torch.core import ops
from repro_torch.core.tree import leaves
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels.grouped import ops as grouped_ops
from repro_torch.models import moe
from repro_torch.models.registry import get_model
from repro_torch.obs import attribution
from repro_torch.train.loop import TrainConfig, make_grad_fn

MOE_ARCH = "qwen3-moe-30b-a3b"
K, N = 24, 40
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tol(dtype, contraction):
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-5, atol=1e-5 * contraction**0.5)


def _torch_vjp(fn, x, w, dy, tdt, x_grad=True, w_grad=True):
    xt = torch.from_numpy(x).to(tdt).requires_grad_(x_grad)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(w_grad)
    y = fn(xt, wt)
    y.backward(torch.from_numpy(dy).to(tdt))
    return y, xt.grad, wt.grad


def _jax_vjp(fn, x, w, dy, jdt):
    y, vjp = jax.vjp(fn, jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    dx, dw = vjp(jnp.asarray(dy, jdt))
    return y, dx, dw


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _zero_past(a, rows):
    """a (E, C, ...) with each expert's rows at and past rows[e] zeroed."""
    a = a.copy()
    for e, r in enumerate(rows):
        a[e, r:] = 0
    return a


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e", [1, 8])
@pytest.mark.parametrize("c", [16, 40])
def test_grouped_grads_match_jax_vjp(dtype, e, c):
    tdt, jdt = DTYPES[dtype]
    x, w, dy = _x((e, c, K), 1), _x((e, K, N), 2), _x((e, c, N), 3)
    y, dx, dw = _torch_vjp(grouped_ops.grouped_matmul, x, w, dy, tdt)
    jy, jdx, jdw = _jax_vjp(jax_grouped_ref, x, w, dy, jdt)
    assert type(y.grad_fn).__name__ == "_GroupedMatmulBackward"
    assert y.dtype == dx.dtype == dw.dtype == tdt
    _close(y.detach(), jy, **_tol(dtype, K))
    _close(dx, jdx, **_tol(dtype, N))
    _close(dw, jdw, **_tol(dtype, c))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_grouped_grads_with_rows_below_capacity_match_jax(dtype):
    """Each expert's rows past its count zero in x and in dy, as the
    dispatch and the combine leave them; ``rows`` handed to the Function
    (the plain version ignores it, the card skips the tiles past it)."""
    tdt, jdt = DTYPES[dtype]
    e, c, counts = 4, 40, [0, 9, 40, 17]
    x, w, dy = _zero_past(_x((e, c, K), 4), counts), _x((e, K, N), 5), _zero_past(_x((e, c, N), 6), counts)
    rows = torch.tensor(counts, dtype=torch.int32)
    y, dx, dw = _torch_vjp(lambda a, b: grouped_ops.grouped_matmul(a, b, rows=rows), x, w, dy, tdt)
    jy, jdx, jdw = _jax_vjp(jax_grouped_ref, x, w, dy, jdt)
    _close(y.detach(), jy, **_tol(dtype, K))
    _close(dx, jdx, **_tol(dtype, N))
    _close(dw, jdw, **_tol(dtype, c))
    assert torch.equal(dw[0], torch.zeros_like(dw[0]))  # no token: dW exactly zero
    for i, r in enumerate(counts):
        assert not dx[i, r:].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dispatch_grouped_4d_grads_match_jax(dtype):
    """(G, E, C, K) input, G = 2: the fold into (E, G * C, K) stays outside
    the Function, so its gradient flows back through the reshape; the
    reference vmaps an einsum over G."""
    tdt, jdt = DTYPES[dtype]
    g, e, c = 2, 4, 24
    x, w, dy = _x((g, e, c, K), 7), _x((e, K, N), 8), _x((g, e, c, N), 9)
    y, dx, dw = _torch_vjp(ops.grouped_matmul, x, w, dy, tdt)
    assert tuple(y.shape) == (g, e, c, N) and tuple(dx.shape) == (g, e, c, K)
    with use_backend("xla"):
        jy, jdx, jdw = _jax_vjp(jax_ops.grouped_matmul, x, w, dy, jdt)
    _close(y.detach(), jy, **_tol(dtype, K))
    _close(dx, jdx, **_tol(dtype, N))
    _close(dw, jdw, **_tol(dtype, g * c))


@pytest.mark.parametrize("x_grad,w_grad", [(True, True), (True, False), (False, True)])
def test_backward_products_per_needs_input_grad(x_grad, w_grad):
    """One dX product ((E, C, N) @ (E, N, K), ``rows`` forwarded) when x
    needs a gradient, one dW product ((E, K, C) @ (E, C, N), every row
    live) when w does; each against JAX's; neither recorded."""
    e, c = 3, 40
    counts = [40, 5, 0]
    x, w, dy = _zero_past(_x((e, c, K), 10), counts), _x((e, K, N), 11), _zero_past(_x((e, c, N), 12), counts)
    rows = torch.tensor(counts, dtype=torch.int32)
    calls = []
    real = grouped_ops._grouped_matmul

    def spy(a, b, rows=None, *, plan=None, record=True):
        calls.append((tuple(a.shape), tuple(b.shape), rows, record))
        return real(a, b, rows, plan=plan, record=record)

    with mock.patch.object(grouped_ops, "_grouped_matmul", spy):
        _, dx, dw = _torch_vjp(lambda a, b: grouped_ops.grouped_matmul(a, b, rows=rows), x, w, dy, torch.float32,
                               x_grad, w_grad)
    want = [((e, c, K), (e, K, N), rows, True)]
    if x_grad:
        want.append(((e, c, N), (e, N, K), rows, False))
    if w_grad:
        want.append(((e, K, c), (e, c, N), None, False))
    assert calls == want
    _, jdx, jdw = _jax_vjp(jax_grouped_ref, x, w, dy, jnp.float32)
    assert (dx is not None) == x_grad and (dw is not None) == w_grad
    if x_grad:
        _close(dx, jdx, **_tol("float32", N))
    if w_grad:
        _close(dw, jdw, **_tol("float32", c))


def test_backward_launches_are_not_recorded():
    """The forward's launch is recorded (M = E * C), the backward's two are
    not, as K1's backward launches are not."""
    recorded = []
    with mock.patch.object(attribution, "record_launch", lambda *a, **kw: recorded.append(a[:3])), \
            mock.patch.object(grouped_ops._metrics, "_enabled", True):
        x, w = torch.randn(2, 16, 8, requires_grad=True), torch.randn(2, 8, 4, requires_grad=True)
        grouped_ops.grouped_matmul(x, w).sum().backward()
    assert recorded == [(32, 4, 8)]


def test_wider_cotangent_promotes_and_grads_keep_the_operands_dtypes():
    x, w = torch.randn(2, 16, 8).bfloat16().requires_grad_(), torch.randn(2, 8, 4).bfloat16().requires_grad_()
    y = grouped_ops.grouped_matmul(x, w)
    dy = torch.randn(2, 16, 4, dtype=torch.float64).float()
    y.float().backward(dy)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    want_dx = torch.bmm(dy, w.detach().float().transpose(1, 2))  # the cotangent kept fp32, not rounded first
    torch.testing.assert_close(x.grad.float(), want_dx, rtol=2e-2, atol=2e-2)


# -- the MoE block -------------------------------------------------------------------


def _moe_model(dtype="float32", **over):
    cfg = configs.get_smoke(MOE_ARCH)
    return get_model(dataclasses.replace(cfg, dtype=dtype, **over))


def _route_around(expert: int):
    """Route every token's top-k among the experts but ``expert`` (its
    router probability masked), weighted by the router's own probabilities."""
    real = moe._topk_shardable

    def topk(probs, k):
        masked = probs.clone()
        masked[..., expert] = -1.0
        _, e = real(masked, k)
        return probs.gather(-1, e), e

    return mock.patch.object(moe, "_topk_shardable", topk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_no_token_reaches_has_exactly_zero_gradient(dtype):
    model = _moe_model(dtype)
    params = model.init(0, "cpu", dtype=torch.float32)
    batch = make_batch(model.cfg, batch=2, seq=16, kind="train", seed=0, device="cpu")
    idle = model.cfg.moe.n_experts - 1
    with _route_around(idle):
        grads, metrics = make_grad_fn(model, TrainConfig())(params, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert len(grads["layers"]) == model.cfg.n_layers
    for layer in grads["layers"]:
        for key in ("w_gate", "w_up", "w_down"):
            g = layer["ffn"][key]  # (E, K, N)
            assert g.dtype == torch.float32
            assert torch.equal(g[idle], torch.zeros_like(g[idle]))
            assert g[:idle].abs().sum() > 0  # the experts that tokens reach learn


def test_dx_rows_past_each_count_are_read_by_nothing():
    """dX's rows past an expert's count (which the card writes as zeros
    where a whole tile lies past it) poisoned with NaN at the dispatched
    buffer: the dispatch's backward reads only kept rows, so every gradient
    and the loss are unchanged."""
    model = _moe_model("float32")
    params = model.init(0, "cpu", dtype=torch.float32)
    batch = make_batch(model.cfg, batch=2, seq=16, kind="train", seed=1, device="cpu")
    real = moe._dispatch_group
    poisoned = []

    def dispatch(xf, top_e, top_w, cap, cfg):
        xdisp, *rest = real(xf, top_e, top_w, cap, cfg)
        rows = rest[-1]

        def poison(g):
            g = g.clone()
            live = torch.arange(cap)[None, None, :] < rows[..., None]  # (G, E, C)
            g[~live] = float("nan")
            poisoned.append(int((~live).sum()))
            return g

        if xdisp.requires_grad:
            xdisp.register_hook(poison)
        return (xdisp, *rest)

    grad_fn = make_grad_fn(model, TrainConfig())
    want, want_m = grad_fn(params, batch)
    with mock.patch.object(moe, "_dispatch_group", dispatch):
        got, got_m = grad_fn(params, batch)
    assert len(poisoned) == model.cfg.n_layers and all(poisoned)
    assert float(got_m["loss"]) == float(want_m["loss"])
    for a, b in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b)
