"""The port's MoE block, grouped GEMM and served MoE model against the JAX package on the CPU.

Inputs come from a numpy seed and go to both packages; model parameters come
from the JAX ``model.init(PRNGKey(0))`` through ``params_from_jax``.  The
port runs on CPU tensors, i.e. through the plain version of the grouped
kernel; the JAX side runs its default XLA path and, where stated, its Pallas
kernels in interpret mode.

Tolerances:
  * routing (capacity, top-k experts, dispatch slots, drops) must be equal:
    it is discrete;
  * grouped GEMM against Pallas: the reference's own (``tests/kernels/
    test_grouped.py``), bf16 2e-2 and fp32 1e-5, plus fp32 atol
    1e-5 * sqrt(K) where the contraction is longer (torch and XLA sum in
    other orders, ``tests/test_torch_systolic.py``);
  * fp32 block outputs and logits 1e-4 (summation order) with identical
    greedy tokens; bf16 logits within 5e-2 of the largest logit (each package
    rounds to bf16 at its own points).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import ops as jax_ops
from repro.core.ops import use_backend
from repro.data.synthetic import make_batch as jax_make_batch
from repro.kernels.grouped import ops as jax_grouped
from repro.models import moe as jax_moe
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core import ops
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels.grouped import grouped_matmul
from repro_torch.kernels.grouped.ref import grouped_matmul_ref
from repro_torch.models import moe
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine

ARCH = "qwen3-moe-30b-a3b"
CPU = "cpu"
FP32_TOL = 1e-4
BF16_TOL = 5e-2


def _cfgs(dtype="float32", **moe_overrides):
    """(reference, port) SMOKE configs with the same overrides."""
    out = []
    for get in (jax_get_smoke, configs.get_smoke):
        cfg = get(ARCH)
        out.append(dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe_overrides)))
    return out


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(x):
    return np.asarray(x, np.float32)


# -- capacity and routing -------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("e,k", [(8, 2), (4, 1), (128, 8), (6, 3)])
def test_capacity_equals_reference(e, k, cf):
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    for t in list(range(1, 70)) + [512, 2048, 2049]:
        assert moe.capacity(t, tcfg) == jax_moe.capacity(t, jcfg), t


def test_capacity_of_the_served_shapes():
    """qwen3-moe-30b-a3b at batch 4: 160 slots per expert at prefill (2048
    tokens), 8 at decode (4 tokens)."""
    cfg = configs.get_config(ARCH)
    assert (moe.capacity(2048, cfg), moe.capacity(4, cfg)) == (160, 8)


def _probs(t, e, seed, ties=False):
    p = np.random.default_rng(seed).dirichlet(np.ones(e), size=t).astype(np.float32)
    if ties:  # equal probabilities among the top choices of every row
        p[:, 1] = p[:, 3] = p[:, 5] = p.max(axis=1)
        p[0, :] = 1.0 / e  # one row with every expert tied
    return p


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_topk_equals_reference(k, ties):
    p = _probs(33, 8, seed=k, ties=ties)
    want_w, want_e = jax_moe._topk_shardable(jnp.asarray(p), k)
    got_w, got_e = moe._topk_shardable(torch.from_numpy(p), k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    if ties:  # ties go to the lowest index
        assert got_e[0].tolist() == list(range(k))


def _routing(t, e, k, seed, ties=False):
    p = _probs(t, e, seed, ties)
    w, ex = jax_moe._topk_shardable(jnp.asarray(p), k)
    w = np.array(w / jnp.sum(w, axis=-1, keepdims=True))
    return np.array(ex, np.int32), w


@pytest.mark.parametrize("cf", [1.25, 0.5])  # 0.5 drops slots
@pytest.mark.parametrize("ties", [False, True])
def test_dispatch_and_combine_equal_reference(cf, ties):
    e, k, t, d = 8, 2, 40, 16
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    cap = moe.capacity(t, tcfg)
    top_e, top_w = _routing(t, e, k, seed=3, ties=ties)
    xf = _x((t, d), 1)
    jd = jax_moe._dispatch_group(jnp.asarray(xf), jnp.asarray(top_e), jnp.asarray(top_w), cap, jcfg)
    xdisp, se, pos, order, sw, _ = moe._dispatch_group(
        torch.from_numpy(xf)[None], torch.from_numpy(top_e)[None], torch.from_numpy(top_w)[None], cap, tcfg
    )
    np.testing.assert_array_equal(xdisp[0].numpy(), np.asarray(jd[0]))
    np.testing.assert_array_equal(se[0].numpy(), np.asarray(jd[1]))
    np.testing.assert_array_equal(pos[0].numpy(), np.asarray(jd[2]))
    np.testing.assert_array_equal((order[0] // k).numpy(), np.asarray(jd[3]))
    np.testing.assert_array_equal(sw[0].numpy(), np.asarray(jd[4]))
    if cf < 1:
        assert int((pos >= cap).sum()) > 0, "the test must drop slots"

    out = _x((e, cap, d), 2)
    want = jax_moe._combine_group(jnp.asarray(out), *jd[1:], t, cap, jnp.float32)
    got = moe._combine_group(torch.from_numpy(out)[None], se, pos, order, sw, t, cap, torch.float32)
    np.testing.assert_allclose(got[0].numpy(), _np(want), rtol=0, atol=1e-5)


def test_dispatch_groups_equal_reference_per_group():
    """Two groups dispatched at once equal the reference vmapped over them."""
    e, k, t, d, g = 8, 2, 24, 8, 2
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=0.75)
    cap = moe.capacity(t, tcfg)
    top_e, top_w = _routing(g * t, e, k, seed=5)
    xf = _x((g, t, d), 4)
    top_e, top_w = top_e.reshape(g, t, k), top_w.reshape(g, t, k)
    jd = jax.vmap(lambda a, b, c: jax_moe._dispatch_group(a, b, c, cap, jcfg))(
        jnp.asarray(xf), jnp.asarray(top_e), jnp.asarray(top_w)
    )
    td = moe._dispatch_group(torch.from_numpy(xf), torch.from_numpy(top_e), torch.from_numpy(top_w), cap, tcfg)
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd[0]))
    np.testing.assert_array_equal(td[2].numpy(), np.asarray(jd[2]))
    np.testing.assert_array_equal((td[3] // k).numpy(), np.asarray(jd[3]))
    out = _x((g, e, cap, d), 6)
    want = jax.vmap(lambda o, *a: jax_moe._combine_group(o, *a, t, cap, jnp.float32))(jnp.asarray(out), *jd[1:])
    got = moe._combine_group(torch.from_numpy(out), td[1], td[2], td[3], td[4], t, cap, torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cf", [1.25, 0.5, 2.0])  # 0.5 drops slots
@pytest.mark.parametrize("groups", [1, 2])
def test_dispatch_rows_are_each_experts_kept_slots(cf, groups):
    """rows = min(bincount(experts), cap) per group, and equals the number of
    kept slots the reference's dispatch places in each expert (positions
    below capacity), on the same routing; rows past it are zero in xdisp."""
    e, k, t, d = 8, 2, 24, 8
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    cap = moe.capacity(t, tcfg)
    top_e, top_w = _routing(groups * t, e, k, seed=7)
    top_e, top_w = top_e.reshape(groups, t, k), top_w.reshape(groups, t, k)
    xf = _x((groups, t, d), 8)
    xdisp, _, _, _, _, rows = moe._dispatch_group(torch.from_numpy(xf), torch.from_numpy(top_e),
                                                  torch.from_numpy(top_w), cap, tcfg)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (groups, e)
    for gi in range(groups):
        counts = np.bincount(top_e[gi].reshape(-1), minlength=e)
        np.testing.assert_array_equal(rows[gi].numpy(), np.minimum(counts, cap))
        jd = jax_moe._dispatch_group(jnp.asarray(xf[gi]), jnp.asarray(top_e[gi]), jnp.asarray(top_w[gi]), cap, jcfg)
        se, pos = np.asarray(jd[1]), np.asarray(jd[2])
        np.testing.assert_array_equal(rows[gi].numpy(), [int(((se == x) & (pos < cap)).sum()) for x in range(e)])
        for x in range(e):
            assert not xdisp[gi, x, int(rows[gi, x]):].any()


@pytest.mark.parametrize(
    "overrides", [{}, {"dispatch_groups": 2}, {"capacity_factor": 0.5}, {"capacity_factor": 4.0}],
    ids=["plain", "groups2", "dropping", "roomy"],
)
def test_moe_fwd_with_and_without_rows_identical(overrides):
    """The MoE block with ``rows`` handed to the grouped GEMMs and with them
    withheld: bit-identical, and both within the existing tolerance of the
    JAX package."""
    jcfg, tcfg = _cfgs(**overrides)
    jp = jax_moe.init_moe(jax.random.PRNGKey(11), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = _x((2, 12, tcfg.d_model), 5)
    seen = []
    real = ops.grouped_matmul

    def spy(xd, w, *, rows=None):
        seen.append(rows)
        return real(xd, w, rows=rows)

    with mock.patch.object(ops, "grouped_matmul", spy):
        with_rows, _ = moe.moe_fwd(tp, torch.from_numpy(x), tcfg)
    with mock.patch.object(ops, "grouped_matmul", lambda xd, w, *, rows=None: real(xd, w)):
        without, _ = moe.moe_fwd(tp, torch.from_numpy(x), tcfg)
    assert len(seen) == 3 and all(r is not None for r in seen)
    assert torch.equal(with_rows, without)
    want, _ = jax_moe.moe_fwd(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(with_rows.numpy(), _np(want), rtol=0, atol=FP32_TOL)


def test_core_grouped_matmul_forwards_rows_for_one_group():
    """rows reach the grouped GEMM for (E, C, K) and (1, E, C, K) input, and
    are withheld for G > 1 (the fold interleaves the groups' rows); the
    result does not change either way."""
    from repro_torch.kernels.grouped import ops as gops

    seen = []
    real = gops.grouped_matmul

    def spy(x, w, *, rows=None):
        seen.append(rows)
        return real(x, w, rows=rows)

    w = torch.from_numpy(_x((4, 32, 40), 2))
    with mock.patch.object(gops, "grouped_matmul", spy):
        for shape, r in (((4, 24, 32), torch.tensor([3, 0, 24, 9], dtype=torch.int32)),
                         ((1, 4, 24, 32), torch.tensor([[3, 0, 24, 9]], dtype=torch.int32)),
                         ((2, 4, 24, 32), torch.zeros(2, 4, dtype=torch.int32))):
            x = torch.from_numpy(_x(shape, 1))
            torch.testing.assert_close(ops.grouped_matmul(x, w, rows=r), ops.grouped_matmul(x, w), rtol=0, atol=0)
    assert seen[0] is not None and seen[2] is not None and seen[4] is None
    assert torch.equal(seen[2], torch.tensor([3, 0, 24, 9], dtype=torch.int32))


# -- grouped GEMM ---------------------------------------------------------------


@pytest.mark.parametrize("e,c,k,n", [(4, 128, 128, 128), (8, 64, 96, 160), (2, 8, 128, 128), (3, 100, 70, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_matmul_matches_pallas(e, c, k, n, dtype):
    """The reference's shapes and tolerances (tests/kernels/test_grouped.py)."""
    x, w = _x((e, c, k), 1), _x((e, k, n), 2)
    want = jax_grouped.grouped_matmul(jnp.asarray(x, dtype), jnp.asarray(w, dtype), interpret=True)
    tdt = getattr(torch, dtype)
    got = grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (e, c, n)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-5 * k**0.5)
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


def test_grouped_matmul_out_dtype_and_shape_errors():
    x, w = torch.from_numpy(_x((2, 4, 8))), torch.from_numpy(_x((2, 8, 4)))
    assert grouped_matmul(x.bfloat16(), w.bfloat16()).dtype == torch.bfloat16  # the output takes x's dtype
    torch.testing.assert_close(grouped_matmul(x, w), grouped_matmul_ref(x, w))
    # The plain version ignores rows: the same result with or without them.
    assert torch.equal(grouped_matmul(x, w, rows=torch.tensor([1, 0], dtype=torch.int32)), grouped_matmul(x, w))
    with pytest.raises(ValueError):
        grouped_matmul(torch.ones(2, 4, 8), torch.ones(3, 8, 4))
    with pytest.raises(ValueError):
        grouped_matmul(torch.ones(2, 4, 8), torch.ones(2, 9, 4))
    with pytest.raises(ValueError):
        grouped_matmul(torch.ones(4, 8), torch.ones(8, 4))


@pytest.mark.parametrize("g", [1, 3])
def test_core_grouped_matmul_4d_matches_jax(g):
    """Dispatch-grouped (G, E, C, K) input: folded into one (E, G*C, K)
    product here, vmapped over G in the reference (both its backends)."""
    x, w = _x((g, 4, 24, 32), 1), _x((4, 32, 40), 2)
    got = ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(got.shape) == (g, 4, 24, 40)
    for backend in ("xla", "pallas-systolic"):
        with use_backend(backend):
            want = jax_ops.grouped_matmul(jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5 * 32**0.5)


# -- the MoE block -----------------------------------------------------------------


@pytest.mark.parametrize(
    "overrides",
    [{}, {"n_shared_experts": 1}, {"dispatch_groups": 2}, {"capacity_factor": 0.5}],
    ids=["plain", "shared", "groups2", "dropping"],
)
def test_moe_fwd_matches_jax(overrides):
    jcfg, tcfg = _cfgs(**overrides)
    jp = jax_moe.init_moe(jax.random.PRNGKey(7), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = _x((2, 12, tcfg.d_model), 3)
    want_y, want_aux = jax_moe.moe_fwd(jp, jnp.asarray(x), jcfg)
    got_y, got_aux = moe.moe_fwd(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    assert ("shared" in tp) == bool(overrides.get("n_shared_experts"))


# -- the served SMOKE model --------------------------------------------------------


def _pair(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair("float32")


def _prompts(model, batch=2, seq=16, seed=1):
    jb = jax_make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed)
    tb = make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed, device=CPU)
    return jb, tb


def test_converted_moe_tree(fp32_pair):
    jmodel, jparams, tmodel, tparams = fp32_pair
    cfg, m = tmodel.cfg, tmodel.cfg.moe
    lp = tparams["layers"][1]
    assert len(tparams["layers"]) == cfg.n_layers
    assert tuple(lp["ffn"]["router"].shape) == (cfg.d_model, m.n_experts)
    assert tuple(lp["ffn"]["w_gate"].shape) == (m.n_experts, cfg.d_model, m.d_ff_expert)
    assert tuple(lp["ffn"]["w_down"].shape) == (m.n_experts, m.d_ff_expert, cfg.d_model)
    np.testing.assert_array_equal(lp["ffn"]["w_up"].numpy(), np.asarray(jparams["layers"]["ffn"]["w_up"][1]))
    assert lp["attn"]["q_norm"]["scale"].dtype == torch.float32 and lp["attn"]["k_norm"]["scale"].shape == (16,)
    bf = params_from_jax(jax.tree.map(np.asarray, jparams), dataclasses.replace(cfg, dtype="bfloat16"), device=CPU)
    assert bf["layers"][0]["ffn"]["w_gate"].dtype == torch.bfloat16
    assert bf["layers"][0]["attn"]["k_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"])
def test_param_counts_equal_reference(arch):
    from repro.configs import get_config as jax_get_config

    for port_cfg, ref_cfg in ((configs.get_config(arch), jax_get_config(arch)),
                              (configs.get_smoke(arch), jax_get_smoke(arch))):
        port, ref = get_model(port_cfg), jax_get_model(ref_cfg)
        assert (port.n_params, port.n_active_params) == (ref.n_params, ref.n_active_params)


def test_init_model_builds_the_moe_tree():
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="bfloat16")
    p = get_model(cfg).init(0, CPU)
    ffn = p["layers"][0]["ffn"]
    assert set(ffn) == {"router", "w_gate", "w_up", "w_down"}
    assert ffn["w_gate"].dtype == torch.bfloat16 and tuple(ffn["w_gate"].shape) == (8, 64, 64)
    assert p["layers"][0]["attn"]["q_norm"]["scale"].dtype == torch.float32
    shared = get_model(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared_experts=2))).init(0, CPU)
    assert tuple(shared["layers"][0]["ffn"]["shared"]["w_gate"].shape) == (64, 128)


@pytest.mark.parametrize("jax_path", ["default", "pallas-systolic"])
def test_served_smoke_moe_matches_jax_fp32(fp32_pair, jax_path):
    """Prefill logits and two decode steps within 1e-4, then 8 greedy tokens
    through both ServeEngines, identical (runs the qk-norm branch too)."""
    jmodel, jparams, tmodel, tparams = fp32_pair
    jb, tb = _prompts(jmodel)
    with use_backend("pallas-systolic" if jax_path != "default" else "xla"):
        want, jcache = jmodel.prefill(jparams, jb, max_len=24)
        got, tcache = tmodel.prefill(tparams, tb, max_len=24)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)
        tok = np.array([[3], [7]], np.int32)
        for pos in (16, 17):
            want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), cache=jcache, pos=pos)
            got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=pos)
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)
        want_tok = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=24, batch=2)).generate(jb, 8)
    got_tok = ServeEngine(tmodel, tparams, ServeConfig(max_len=24, batch=2), device=CPU).generate(tb, 8)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))


def test_served_smoke_moe_close_bf16():
    jmodel, jparams, tmodel, tparams = _pair("bfloat16")
    assert tparams["layers"][0]["ffn"]["w_gate"].dtype == torch.bfloat16
    jb, tb = _prompts(jmodel, seed=2)
    want, jcache = jmodel.prefill(jparams, jb, max_len=24)
    got, tcache = tmodel.prefill(tparams, tb, max_len=24)
    tok = np.array([[5], [9]], np.int32)
    for step in range(3):
        want = _np(want)
        assert np.abs(got.numpy() - want).max() <= BF16_TOL * max(1.0, np.abs(want).max()), step
        if step < 2:
            want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), cache=jcache, pos=16 + step)
            got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=16 + step)


@pytest.mark.parametrize(
    "c,k,n,dtype,aligned,want",
    [
        (160, 2048, 768, torch.bfloat16, True, "wgmma_192x128"),  # prefill: one tile covers C
        (160, 768, 2048, torch.bfloat16, True, "wgmma_192x128"),
        (8, 2048, 768, torch.bfloat16, True, "decode"),  # decode capacity
        (16, 64, 64, torch.bfloat16, True, "decode"),
        (17, 64, 64, torch.bfloat16, True, "wgmma_64x128"),
        (64, 64, 64, torch.bfloat16, True, "wgmma_64x128"),
        (100, 72, 136, torch.bfloat16, True, "wgmma_128x128"),
        (128, 64, 64, torch.bfloat16, True, "wgmma_128x128"),
        (200, 64, 64, torch.bfloat16, True, "wgmma_128x128"),  # two row tiles either way: fewer padding rows
        (320, 64, 64, torch.bfloat16, True, "wgmma_192x128"),
        (160, 70, 64, torch.bfloat16, True, "wmma"),  # rows TMA cannot read
        (160, 64, 130, torch.bfloat16, True, "wmma"),
        (160, 64, 64, torch.bfloat16, False, "wmma"),
        (160, 0, 64, torch.bfloat16, True, "wmma"),
        (160, 2048, 768, torch.float32, True, "fma"),
        (8, 2048, 768, torch.float32, True, "fma"),
    ],
)
def test_grouped_path_by_shape(c, k, n, dtype, aligned, want):
    from repro_torch.kernels.grouped import kernel

    assert kernel.grouped_path(c, k, n, dtype, aligned) == want
    assert want in kernel.PATHS


def test_kernel_binding_refuses_cpu_tensors():
    """The CUDA wrapper never runs on the CPU: ``ops`` sends CPU tensors to
    the plain version, and the binding itself refuses them before any build."""
    from repro_torch.kernels.grouped import kernel

    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.grouped_matmul_call(torch.ones(2, 4, 8), torch.ones(2, 8, 4))
    grouped_matmul(torch.ones(2, 4, 8), torch.ones(2, 8, 4))
    assert kernel.launches == before
