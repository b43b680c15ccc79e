"""The port's recurrent blocks (``repro_torch.models.ssm``: mLSTM, sLSTM,
Mamba2) against the JAX package's ``repro.models.ssm`` on the CPU.

Each function against its counterpart on the same parameters (one block of
the JAX ``model.init(PRNGKey(0))`` of an fp32 SMOKE config, carried over by
``params_from_jax``) and the same inputs and states from a numpy seed, the
new states held as well as the outputs; then the reference's own
equivalences (tests/test_ssm.py: chunked = quadratic, recurrent = parallel,
the SSD's final state = the recurrence, long-decay stability) as
parametrised cases on the port alone; then the dtype rule: a bf16 model
keeps the recurrent blocks' fp32 leaves in fp32.

Tolerances: the reference's, rtol = atol = 1e-4 for mLSTM and sLSTM and
2e-4 for Mamba2.  Configs: the SMOKE xlstm-125m (one mLSTM, one sLSTM; two
heads of 64) and zamba2-7b (eight SSM heads on one group: rep 8), plus a
Mamba2 config with two groups (rep 4, where ``repeat_interleave`` and
``repeat`` differ) and xLSTM / Mamba2 configs with small chunks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import ssm as jssm
from repro.models.registry import get_model as jax_get_model
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.models import layers, ssm
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import cast_params

CPU = "cpu"
DEV = torch.device(CPU)
TOL = {"mlstm": 1e-4, "slstm": 1e-4, "mamba": 2e-4}
# The leaves each block keeps fp32 whatever the compute dtype.
FP32_LEAVES = {"mlstm": {"conv_w", "b_if"}, "slstm": {"r_h", "b"},
               "mamba": {"conv_w", "conv_b", "a_log", "dt_bias", "d_skip"}}


def _cfgs(arch, dtype="float32", **ssm_over):
    """(JAX config, port config): the SMOKE config in ``dtype``, its
    ``SSMConfig`` fields overridden."""
    out = []
    for cfg in (jax_get_smoke(arch), configs.get_smoke(arch)):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        if ssm_over:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm_over))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def block():
    """block(kind, **ssm_over) -> (JAX config, port config, JAX block, port
    block) of layer 0 of the ``kind`` stack ("mlstm", "slstm", "mamba") of
    an fp32 SMOKE model, built once per module."""
    built = {}

    def get(kind, **ssm_over):
        key = (kind, tuple(sorted(ssm_over.items())))
        if key not in built:
            arch = "zamba2-7b" if kind == "mamba" else "xlstm-125m"
            jcfg, tcfg = _cfgs(arch, **ssm_over)
            jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
            jblock = jax.tree.map(lambda a: a[0], jparams[kind])["core"]
            built[key] = (jcfg, tcfg, jblock, tparams[kind][0]["core"])
        return built[key]

    return get


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


def _close_state(tstate, jstate, tol):
    assert set(tstate) == set(jstate)
    for name in jstate:
        assert tuple(tstate[name].shape) == tuple(jstate[name].shape), name
        _close(tstate[name], jstate[name], tol)


def _random_state(jinit, tinit, jcfg, tcfg, b, seed):
    """A state of the init's shapes and dtypes filled from a numpy seed (the
    stabiliser ``m`` finite, as after a first step), on both sides."""
    ref = jinit(jcfg, b, jnp.float32)
    np_state = {k: _x(np.asarray(v).shape, seed + i) for i, (k, v) in enumerate(sorted(ref.items()))}
    if "n" in np_state and "h" in np_state:  # sLSTM: a normaliser far from the 1e-6 floor
        np_state["n"] = np.abs(np_state["n"]) + 0.5
    tstate = {k: torch.from_numpy(v.copy()) for k, v in np_state.items()}
    assert set(tstate) == set(tinit(tcfg, b, torch.float32, DEV))
    return {k: jnp.asarray(v) for k, v in np_state.items()}, tstate


# -- init -----------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "mamba"])
def test_init_has_the_references_leaves(block, kind):
    """The port's own init draws the tree the reference's builds (keys,
    shapes; norms fp32 ones), with the fp32 leaves fp32 and the projection
    weights in the compute dtype; the carried tree has the same layout."""
    jcfg, tcfg, jblock, carried = block(kind)
    init = {"mlstm": ssm.init_mlstm, "slstm": ssm.init_slstm, "mamba": ssm.init_mamba2}[kind]
    gen = torch.Generator(device=DEV).manual_seed(0)
    own = init(gen, tcfg, torch.bfloat16)
    for tree in (own, carried):
        assert set(tree) == set(jblock)
        for key, leaf in jblock.items():
            if isinstance(leaf, dict):
                for k2, v2 in leaf.items():
                    assert tuple(tree[key][k2].shape) == tuple(v2.shape), (key, k2)
                continue
            assert tuple(tree[key].shape) == tuple(leaf.shape), key
            if key in FP32_LEAVES[kind]:
                assert tree[key].dtype == torch.float32, key
    for key in FP32_LEAVES[kind]:  # the deterministic leaves equal the reference's values
        if key not in ("conv_w", "r_h"):
            np.testing.assert_allclose(own[key].numpy(), np.asarray(jblock[key]), rtol=1e-6, atol=1e-7)
    assert own["w_x" if kind == "slstm" else "in_proj" if kind == "mamba" else "wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("init", ["mlstm", "slstm", "mamba2"])
def test_init_state_equals_jax(init):
    """Shapes and dtypes (fp32 state, the conv window in the compute dtype)
    and values: -inf stabilisers, zeros elsewhere."""
    jcfg, tcfg = _cfgs("zamba2-7b" if init == "mamba2" else "xlstm-125m", dtype="bfloat16")
    jstate = getattr(jssm, f"init_{init}_state")(jcfg, 3, jnp.bfloat16)
    tstate = getattr(ssm, f"init_{init}_state")(tcfg, 3, torch.bfloat16, DEV)
    assert set(tstate) == set(jstate)
    for k, v in jstate.items():
        assert tuple(tstate[k].shape) == tuple(v.shape), k
        assert str(tstate[k].dtype)[6:] == str(v.dtype), k
        np.testing.assert_array_equal(tstate[k].float().numpy(), np.asarray(v, np.float32))


# -- functions against JAX --------------------------------------------------------------------


def test_causal_conv_equals_jax():
    x, w = _x((2, 9, 12), 1), _x((4, 12), 2)
    _close(ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)), 1e-6)


@pytest.mark.parametrize("fn,t,chunk", [("mlstm_fwd", 12, 256), ("mlstm_fwd_chunked", 24, 8),
                                        ("mlstm_auto", 24, 8), ("mlstm_auto", 12, 256)],
                         ids=["quadratic", "chunked", "auto-chunked", "auto-quadratic"])
def test_mlstm_parallel_equals_jax(block, fn, t, chunk):
    jcfg, tcfg, jp, tp = block("mlstm", chunk_size=chunk)
    x = _x((2, t, tcfg.d_model), 3)
    _close(getattr(ssm, fn)(tp, torch.from_numpy(x), tcfg), getattr(jssm, fn)(jp, jnp.asarray(x), jcfg),
           TOL["mlstm"])


@pytest.mark.parametrize("fresh", [True, False], ids=["first-step", "carried-state"])
def test_mlstm_step_equals_jax(block, fresh):
    """One step from the initial state (m = -inf: the empty memory carries
    nothing, no NaN) and from a random carried state; output and every
    state leaf."""
    jcfg, tcfg, jp, tp = block("mlstm")
    if fresh:
        jstate = jssm.init_mlstm_state(jcfg, 2, jnp.float32)
        tstate = ssm.init_mlstm_state(tcfg, 2, torch.float32, DEV)
    else:
        jstate, tstate = _random_state(jssm.init_mlstm_state, ssm.init_mlstm_state, jcfg, tcfg, 2, 4)
    x = _x((2, 1, tcfg.d_model), 5)
    jy, jnew = jssm.mlstm_step(jp, jnp.asarray(x), jcfg, jstate)
    ty, tnew = ssm.mlstm_step(tp, torch.from_numpy(x), tcfg, tstate)
    assert bool(torch.isfinite(ty).all())
    _close(ty, jy, TOL["mlstm"])
    _close_state(tnew, jnew, TOL["mlstm"])


def test_slstm_cell_fwd_and_step_equal_jax(block):
    jcfg, tcfg, jp, tp = block("slstm")
    jstate, tstate = _random_state(jssm.init_slstm_state, ssm.init_slstm_state, jcfg, tcfg, 2, 6)
    xt = _x((2, 4 * tcfg.d_model), 7)
    _close_state(ssm._slstm_cell(tp, torch.from_numpy(xt), tstate, tcfg.n_heads),
                 jssm._slstm_cell(jp, jnp.asarray(xt), jstate, jcfg.n_heads), TOL["slstm"])
    x = _x((2, 10, tcfg.d_model), 8)
    _close(ssm.slstm_fwd(tp, torch.from_numpy(x), tcfg), jssm.slstm_fwd(jp, jnp.asarray(x), jcfg), TOL["slstm"])
    for jst, tst in ((jssm.init_slstm_state(jcfg, 2, jnp.float32), ssm.init_slstm_state(tcfg, 2, torch.float32, DEV)),
                     (jstate, tstate)):
        jy, jnew = jssm.slstm_step(jp, jnp.asarray(x[:, :1]), jcfg, jst)
        ty, tnew = ssm.slstm_step(tp, torch.from_numpy(x[:, :1]), tcfg, tst)
        _close(ty, jy, TOL["slstm"])
        _close_state(tnew, jnew, TOL["slstm"])


def test_segsum_equals_jax():
    a = _x((2, 3, 7), 9)
    got, want = ssm._segsum(torch.from_numpy(a)).numpy(), np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], rtol=1e-6, atol=1e-6)


def test_ssd_chunked_equals_jax():
    b, t, h, p, n = 2, 24, 4, 8, 6
    xh, bmat, cmat = _x((b, t, h, p), 10), _x((b, t, h, n), 11), _x((b, t, h, n), 12)
    dt = np.log1p(np.exp(_x((b, t, h), 13))).astype(np.float32)
    a = -np.exp(_x((h,), 14, 0.3))
    jy, jfinal = jssm._ssd_chunked(*(jnp.asarray(u) for u in (xh, dt, a, bmat, cmat)), 8)
    ty, tfinal = ssm._ssd_chunked(*(torch.from_numpy(u) for u in (xh, dt, a, bmat, cmat)), 8)
    _close(ty, jy, TOL["mamba"])
    _close(tfinal, jfinal, TOL["mamba"])


# n_groups 1 on eight heads (rep 8), and two groups (rep 4); t a multiple of the chunk, and not.
MAMBA_CASES = [dict(t=20, over={}), dict(t=32, over=dict(chunk_size=8)),
               dict(t=13, over=dict(n_groups=2, chunk_size=8))]


@pytest.mark.parametrize("case", MAMBA_CASES, ids=["smoke-padded", "two-chunks", "two-groups"])
def test_mamba2_fwd_and_step_equal_jax(block, case):
    jcfg, tcfg, jp, tp = block("mamba", **case["over"])
    x = _x((2, case["t"], tcfg.d_model), 15)
    _close(ssm.mamba2_fwd(tp, torch.from_numpy(x), tcfg), jssm.mamba2_fwd(jp, jnp.asarray(x), jcfg), TOL["mamba"])
    jstate, tstate = _random_state(jssm.init_mamba2_state, ssm.init_mamba2_state, jcfg, tcfg, 2, 16)
    jy, jnew = jssm.mamba2_step(jp, jnp.asarray(x[:, :1]), jcfg, jstate)
    ty, tnew = ssm.mamba2_step(tp, torch.from_numpy(x[:, :1]), tcfg, tstate)
    _close(ty, jy, TOL["mamba"])
    _close_state(tnew, jnew, TOL["mamba"])


def test_two_groups_repeat_interleave_not_tile(block):
    """With two groups, head i reads group i // rep (``jnp.repeat``): tiling
    the groups instead would give another output."""
    _, tcfg, _, tp = block("mamba", n_groups=2, chunk_size=8)
    conv = torch.from_numpy(_x((2, tcfg.ssm.expand * tcfg.d_model + 2 * 2 * tcfg.ssm.state_size), 17))
    _, bmat, _ = ssm._mamba2_split(conv, tcfg)
    nh = bmat.shape[1]
    n = tcfg.ssm.state_size
    di = tcfg.ssm.expand * tcfg.d_model
    groups = conv[:, di : di + 2 * n].reshape(2, 2, n)
    for head in range(nh):
        assert torch.equal(bmat[:, head], groups[:, head // (nh // 2)])


# -- the reference's equivalences (tests/test_ssm.py), on the port alone ----------------------


def _steps(step, init, p, x, cfg):
    state = init(cfg, x.shape[0], torch.float32, DEV)
    outs = []
    for i in range(x.shape[1]):
        y, state = step(p, x[:, i : i + 1], cfg, state)
        outs.append(y[:, 0])
    return torch.stack(outs, 1)


def _mamba_recurrent_equals_chunked(block, t, chunk):
    _, cfg, _, p = block("mamba", chunk_size=chunk)
    x = torch.from_numpy(_x((2, t, cfg.d_model), 4))
    return _steps(ssm.mamba2_step, ssm.init_mamba2_state, p, x, cfg), ssm.mamba2_fwd(p, x, cfg), TOL["mamba"]


def _mlstm_chunked_equals_quadratic(block):
    _, cfg, _, p = block("mlstm", chunk_size=8)
    x = torch.from_numpy(_x((2, 48, cfg.d_model), 1))
    return ssm.mlstm_fwd_chunked(p, x, cfg), ssm.mlstm_fwd(p, x, cfg), TOL["mlstm"]


def _mlstm_recurrent_equals_parallel(block):
    _, cfg, _, p = block("mlstm")
    x = torch.from_numpy(_x((2, 12, cfg.d_model), 2))
    return _steps(ssm.mlstm_step, ssm.init_mlstm_state, p, x, cfg), ssm.mlstm_fwd(p, x, cfg), TOL["mlstm"]


def _slstm_recurrent_equals_scan(block):
    _, cfg, _, p = block("slstm")
    x = torch.from_numpy(_x((2, 10, cfg.d_model), 3))
    return _steps(ssm.slstm_step, ssm.init_slstm_state, p, x, cfg), ssm.slstm_fwd(p, x, cfg), TOL["slstm"]


def _ssd_final_state_matches_recurrence(block):
    _, cfg, _, _ = block("mamba", chunk_size=8)
    s = cfg.ssm
    b, t = 1, 24
    nh = s.expand * cfg.d_model // s.head_dim
    xh = torch.from_numpy(_x((b, t, nh, s.head_dim), 5, 0.3))
    dt = torch.nn.functional.softplus(torch.from_numpy(_x((b, t, nh), 6, 1.0)))
    a = -torch.exp(torch.from_numpy(_x((nh,), 7, 0.3)))
    bmat = torch.from_numpy(_x((b, t, nh, s.state_size), 8, 0.3))
    cmat = torch.ones((b, t, nh, s.state_size))
    _, final = ssm._ssd_chunked(xh, dt, a, bmat, cmat, 8)
    st = torch.zeros((b, nh, s.head_dim, s.state_size))
    for i in range(t):
        da = torch.exp(dt[:, i] * a)[..., None, None]
        st = st * da + (dt[:, i, :, None] * xh[:, i])[..., None] * bmat[:, i][..., None, :]
    return final, st, 1e-4


EQUIVALENCES = {
    "mlstm_chunked_equals_quadratic": _mlstm_chunked_equals_quadratic,
    "mlstm_recurrent_equals_parallel": _mlstm_recurrent_equals_parallel,
    "slstm_recurrent_equals_scan": _slstm_recurrent_equals_scan,
    "mamba2_recurrent_equals_chunked-32-16": lambda block: _mamba_recurrent_equals_chunked(block, 32, 16),
    "mamba2_recurrent_equals_chunked-48-16": lambda block: _mamba_recurrent_equals_chunked(block, 48, 16),
    "mamba2_recurrent_equals_chunked-16-16": lambda block: _mamba_recurrent_equals_chunked(block, 16, 16),
    "mamba2_ssd_final_state_matches_recurrence": _ssd_final_state_matches_recurrence,
}


@pytest.mark.parametrize("case", list(EQUIVALENCES))
def test_reference_equivalences(block, case):
    got, want, tol = EQUIVALENCES[case](block)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_mlstm_long_decay_stability(block):
    """Exp-gates over a long sequence stay finite (the stabiliser works)."""
    _, cfg, _, p = block("mlstm", chunk_size=16)
    x = torch.from_numpy(_x((1, 128, cfg.d_model), 6, 2.0))
    assert bool(torch.isfinite(ssm.mlstm_fwd_chunked(p, x, cfg)).all())


# -- dtypes -------------------------------------------------------------------------------------


@pytest.mark.parametrize("arch,stacks", [("xlstm-125m", ("mlstm", "slstm")), ("zamba2-7b", ("mamba",))])
def test_bf16_model_keeps_the_fp32_leaves_fp32(arch, stacks):
    """A bf16 model -- drawn by the port's init, cast by ``cast_params`` from
    fp32 masters, or carried from JAX -- keeps conv_w, conv_b, a_log,
    dt_bias, d_skip, b_if, b and r_h in fp32 (as every norm scale), and its
    projection weights in bf16."""
    _, tcfg = _cfgs(arch, dtype="bfloat16")
    model = get_model(tcfg)
    jparams = jax_get_model(_cfgs(arch, dtype="bfloat16")[0]).init(jax.random.PRNGKey(0))
    trees = {"init": model.init(0, CPU), "cast": cast_params(model.init(0, CPU, dtype=torch.float32), torch.bfloat16),
             "carried": params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)}
    assert set().union(*FP32_LEAVES.values()) | {"scale"} == set(layers.FP32_KEYS)
    for name, params in trees.items():
        for stack in stacks:
            for block in params[stack]:
                core = block["core"]
                for key in FP32_LEAVES[stack]:
                    assert core[key].dtype == torch.float32, (name, stack, key)
                for key, leaf in core.items():
                    if isinstance(leaf, torch.Tensor) and key not in FP32_LEAVES[stack]:
                        assert leaf.dtype == torch.bfloat16, (name, stack, key)
                assert block["norm"]["scale"].dtype == torch.float32
        assert params["lm_head"]["w"].dtype == torch.bfloat16


def test_bf16_blocks_close_to_jax():
    """bf16 blocks on bf16 inputs: within 5e-2 of the largest output (each
    package rounds activations to bf16 at its own points)."""
    for kind, fn in (("mlstm", "mlstm_fwd"), ("slstm", "slstm_fwd"), ("mamba", "mamba2_fwd")):
        arch = "zamba2-7b" if kind == "mamba" else "xlstm-125m"
        jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
        jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
        jp, tp = jax.tree.map(lambda a: a[0], jparams[kind])["core"], tparams[kind][0]["core"]
        x = _x((2, 12, tcfg.d_model), 20)
        want = np.asarray(getattr(jssm, fn)(jp, jnp.asarray(x, jnp.bfloat16), jcfg), np.float32)
        got = getattr(ssm, fn)(tp, torch.from_numpy(x).to(torch.bfloat16), tcfg)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 5e-2 * max(1.0, np.abs(want).max()), (kind, err)
