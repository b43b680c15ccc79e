"""The port's optimizer substrate against the JAX package's on the CPU.

``repro_torch.optim`` (AdamW, global-norm clipping, the schedules, int8
compression with error feedback) on the same numpy inputs as ``repro.optim``,
and the reference's own optimizer tests (``tests/test_optim.py``) rebuilt on
the port.  AdamW is compared on the *same* gradients over several steps, the
reference's tree stacked as ``init_model`` stacks it (a list of layers in the
port is a leading axis there, so a layer's 1-D leaf is 2-D there and decayed
by both), and over three ``Trainer`` steps of every family's fp32 SMOKE
model at the default weight decay (every parameter within 1e-5)
(its first step moves every weight by about +-lr, so a gradient near zero
would flip a parameter's move: parameters after a step are not compared
across models, only across optimizers).  Tolerances: 1e-6 relative (fp32,
the same operations in another order at most).
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.registry import get_model as jax_get_model
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import Trainer as JaxTrainer
from repro.optim import compress as jax_compress
from repro.optim import schedule as jax_schedule
from repro_torch import configs, optim
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves, leaves_with_path, tree_map
from repro_torch.kernels.grouped import ops as grouped_ops
from repro_torch.kernels.systolic import ops as mm_ops
from repro_torch.models.registry import get_model
from repro_torch.optim import compress, schedule
from repro_torch.train.loop import TrainConfig, Trainer

RTOL = 1e-6


def _tree(seed):
    """A small parameter-like tree: 2-D weights, 1-D scales, a list of layers."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "scale": rng.standard_normal((5,)).astype(np.float32),
            "layers": [{"a": rng.standard_normal((3, 4)).astype(np.float32),
                        "b": rng.standard_normal((4,)).astype(np.float32)} for _ in range(2)]}


def _jax_tree(t, stacked=False):
    """The same values in JAX: the list of layers kept a list, or, with
    ``stacked``, stacked on a leading axis as the reference's ``init_model``
    stacks a model's layers (a layer's 1-D leaf is then 2-D, which the
    reference's AdamW decays; the port decays its counterpart too)."""
    if stacked:
        t = dict(t, layers={k: np.stack([layer[k] for layer in t["layers"]]) for k in t["layers"][0]})
    return jax.tree.map(jnp.asarray, t)


def _unstacked(jt):
    """A JAX tree with its layers as a list, stacked or not."""
    if isinstance(jt["layers"], dict):
        n = len(next(iter(jt["layers"].values())))
        jt = dict(jt, layers=[{k: v[i] for k, v in jt["layers"].items()} for i in range(n)])
    return jt


def _torch_tree(t):
    return tree_map(lambda a: torch.from_numpy(a.copy()), t)


def _assert_same(jt, tt, rtol=RTOL, atol=1e-7):
    jt = _unstacked(jt)
    np.testing.assert_allclose(np.asarray(jt["w"]), tt["w"].numpy(), rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(jt["scale"]), tt["scale"].numpy(), rtol=rtol, atol=atol)
    for jl, tl in zip(jt["layers"], tt["layers"]):
        for k in ("a", "b"):
            np.testing.assert_allclose(np.asarray(jl[k]), tl[k].numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("lr_type", [float, torch.tensor])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax_over_steps(lr_type, weight_decay):
    """The learning rate as a float or as the schedule's scalar tensor; the
    update writes into the old tensors and returns them."""
    p0 = _tree(0)
    jp, tp = _jax_tree(p0, stacked=True), _torch_tree(p0)
    js, ts = jax_optim.adamw_init(jp), optim.adamw_init(tp)
    for step in range(4):
        g = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, js = jax_optim.adamw_update(_jax_tree(g, stacked=True), js, jp, lr=lr, weight_decay=weight_decay)
        tp_new, ts_new = optim.adamw_update(_torch_tree(g), ts, tp, lr=lr_type(lr), weight_decay=weight_decay)
        assert tp_new["w"] is tp["w"] and ts_new is ts and ts.mu["w"] is ts_new.mu["w"]
        _assert_same(jp, tp)
        _assert_same(js.mu, ts.mu)
        _assert_same(js.nu, ts.nu)
        assert int(js.step) == int(ts.step) == step + 1
    assert ts.step.dtype == torch.int32 and all(m.dtype == torch.float32 for m in leaves(ts.mu))


def test_adamw_first_step_is_signed_lr():
    """With bias correction, step 1 moves each weight by ~lr*sign(g) (+wd)."""
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    grads = {"w": torch.full((4, 4), 0.5), "b": torch.full((4,), -0.5)}
    new, state = optim.adamw_update(grads, optim.adamw_init(params), params, lr=1e-2, weight_decay=0.0)
    np.testing.assert_allclose(new["w"].numpy(), 1.0 - 1e-2, rtol=1e-4)
    np.testing.assert_allclose(new["b"].numpy(), 1e-2, rtol=1e-4)
    assert int(state.step) == 1


def test_adamw_weight_decay_2d_only():
    params = {"w": torch.ones((4, 4)), "scale": torch.ones((4,))}
    grads = tree_map(torch.zeros_like, params)
    new, _ = optim.adamw_update(grads, optim.adamw_init(params), params, lr=1e-2, weight_decay=0.1)
    assert float(new["w"][0, 0]) < 1.0  # decayed
    assert float(new["scale"][0]) == 1.0  # exempt


def test_adamw_decays_what_the_stacked_reference_decays():
    """A leaf under a list of layers has one dimension more in the
    reference's tree: a layer's norm scale is decayed, the final one not."""
    params = {"final_norm": torch.ones((4,)),
              "layers": [{"scale": torch.ones((4,)), "w": torch.ones((4, 4))} for _ in range(2)]}
    assert optim.adamw.reference_ndims(params) == [1, 2, 3, 2, 3]
    grads = tree_map(torch.zeros_like, params)
    new, _ = optim.adamw_update(grads, optim.adamw_init(params), params, lr=1e-2, weight_decay=0.1)
    assert float(new["final_norm"][0]) == 1.0
    assert all(float(layer[k].flatten()[0]) < 1.0 for layer in new["layers"] for k in ("scale", "w"))


MODELS = {
    "dense": ("internlm2-1.8b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "mla": ("minicpm3-4b", {}),
    "audio": ("musicgen-medium", {}),
    "vlm": ("internvl2-1b", {}),
    "tied": ("internlm2-1.8b", dict(tie_embeddings=True)),
    "ssm": ("xlstm-125m", {}),
    "hybrid": ("zamba2-7b", {}),
}


@contextlib.contextmanager
def _function_calls():
    """Count the forward and backward calls of K4's and K1's autograd
    Functions (``_GroupedMatmul``, ``_Matmul``)."""
    calls = {}
    with contextlib.ExitStack() as stack:
        for name, fn in (("grouped", grouped_ops._GroupedMatmul), ("systolic", mm_ops._Matmul)):
            calls[name] = {"forward": 0, "backward": 0}
            for method in ("forward", "backward"):
                def counted(ctx, *args, _real=getattr(fn, method), _c=calls[name], _m=method):
                    _c[_m] += 1
                    return _real(ctx, *args)

                stack.enter_context(mock.patch.object(fn, method, staticmethod(counted)))
        yield calls


@pytest.mark.parametrize("name", list(MODELS))
def test_trainer_steps_match_jax_with_weight_decay(name):
    """Three ``Trainer`` steps at weight decay 0.1 in both packages from the
    same parameters and batches: every parameter within 1e-5 of JAX's (the
    port's per-layer norm scales were exempt from the decay, 1.6e-4 apart
    after three steps of the dense model).  The expert GEMMs run through
    K4's autograd Function, three products a MoE layer, each differentiated
    once a step; every projection through K1's."""
    arch, over = MODELS[name]
    jmodel = jax_get_model(dataclasses.replace(jax_get_smoke(arch), dtype="float32", **over))
    model = get_model(dataclasses.replace(configs.get_smoke(arch), dtype="float32", **over))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg, device="cpu")
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
    jbatches = [jax_make_batch(jmodel.cfg, batch=2, seq=12, kind="train", seed=s) for s in range(3)]
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in jbatches]
    jtrainer = JaxTrainer(jmodel, JaxTrainConfig(**kw), jparams, donate=False)
    jtrainer.run(iter(jbatches), n_steps=3, log_every=0)
    trainer = Trainer(model, TrainConfig(**kw), params)
    with _function_calls() as calls:
        trainer.run(iter(batches), n_steps=3, log_every=0)
    per_step = 3 * model.cfg.n_layers if model.cfg.moe is not None else 0
    assert calls["grouped"] == {"forward": 3 * per_step, "backward": 3 * per_step}
    assert calls["systolic"]["forward"] > 0 and calls["systolic"]["backward"] == calls["systolic"]["forward"]
    want = params_from_jax(jax.tree.map(np.asarray, jtrainer.params), model.cfg, device="cpu")
    got = dict(leaves_with_path(trainer.params))
    assert list(got) == [k for k, _ in leaves_with_path(want)]
    for key, w in leaves_with_path(want):
        torch.testing.assert_close(got[key], w, rtol=0, atol=1e-5, msg=key)


def test_adamw_converges_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = optim.adamw_init(params)
    for _ in range(300):
        params, state = optim.adamw_update({"x": 2 * params["x"]}, state, params, lr=5e-2, weight_decay=0.0)
    assert float(params["x"].square().sum()) < 1e-2


def test_clip_by_global_norm():
    g = {"a": torch.full((3,), 4.0), "b": torch.full((4,), 3.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), (3 * 16 + 4 * 9) ** 0.5, rtol=1e-5)
    np.testing.assert_allclose(float(optim.global_norm(clipped)), 1.0, rtol=1e-4)
    same, _ = optim.clip_by_global_norm(g, 100.0)
    np.testing.assert_allclose(same["a"].numpy(), g["a"].numpy(), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_jax(max_norm):
    g = _tree(3)
    jc, jn = jax_optim.clip_by_global_norm(_jax_tree(g), max_norm)
    tc, tn = optim.clip_by_global_norm(_torch_tree(g), max_norm)
    np.testing.assert_allclose(float(jn), float(tn), rtol=RTOL)
    np.testing.assert_allclose(float(jax_optim.global_norm(_jax_tree(g))), float(optim.global_norm(_torch_tree(g))),
                               rtol=RTOL)
    _assert_same(jc, tc)
    bf = {"w": torch.from_numpy(g["w"]).bfloat16()}
    assert optim.clip_by_global_norm(bf, max_norm)[0]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("warmup,total", [(1, 8), (10, 100), (0, 50), (100, 1000)])
def test_schedules_match_jax(warmup, total):
    for step in [0, 1, 2, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, total + 5]:
        kw = dict(peak_lr=3e-4, warmup_steps=warmup)
        want = jax_schedule.cosine_with_warmup(step, total_steps=total, **kw)
        got = schedule.cosine_with_warmup(step, total_steps=total, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(float(schedule.linear_warmup_constant(step, **kw)),
                                   float(jax_schedule.linear_warmup_constant(step, **kw)), rtol=RTOL)


def test_compress_int8_matches_jax_with_error_feedback():
    rng = np.random.default_rng(4)
    g1, g2 = (rng.standard_normal((64, 8)).astype(np.float32) for _ in range(2))
    jq, js, jr = jax_compress.compress_int8(jnp.asarray(g1))
    tq, ts, tr = compress.compress_int8(torch.from_numpy(g1))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_allclose(float(js), float(ts), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=RTOL, atol=1e-7)
    jq2, js2, jr2 = jax_compress.compress_int8(jnp.asarray(g2), jr)  # the residual carried
    tq2, ts2, tr2 = compress.compress_int8(torch.from_numpy(g2), tr)
    np.testing.assert_array_equal(np.asarray(jq2), tq2.numpy())
    np.testing.assert_allclose(np.asarray(jr2), tr2.numpy(), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(np.asarray(jax_compress.decompress_int8(jq2, js2)),
                               compress.decompress_int8(tq2, ts2).numpy(), rtol=RTOL)
    zq, zs, _ = compress.compress_int8(torch.zeros(3))
    assert float(zs) == 1.0 and not zq.any()  # an all-zero gradient keeps scale 1


def test_compress_tree_matches_jax():
    g = _tree(5)
    jq, js, jr = jax_compress.compress_tree(_jax_tree(g), None)
    tq, ts, tr = compress.compress_tree(_torch_tree(g))
    np.testing.assert_array_equal(np.asarray(jq["w"]), tq["w"].numpy())
    np.testing.assert_allclose(float(js["scale"]), float(ts["scale"]), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(jr["w"]), tr["w"].numpy(), rtol=RTOL, atol=1e-7)
    tq2, _, tr2 = compress.compress_tree(_torch_tree(g), tr)
    assert tq2["w"].dtype == torch.int8 and tr2["w"].shape == (6, 5)
