"""Quantized serving of the MoE and MLA families (w8a16 / w8a8), and the
launcher's layer-by-layer quantized init, against the JAX package on the
CPU.

The SMOKE qwen3-moe-30b-a3b (MoE) and minicpm3-4b (MLA) in fp32, their
parameters from the JAX ``model.init(PRNGKey(0))``, are quantized in JAX and
carried over (``params_from_jax``), or carried over as fp32 masters and
quantized in the port.  The reference quantizes only dense projections: a
MoE layer's router and experts stay wide (``quantize_params`` skips any
subtree with a ``router``), and so does MLA's ``wkv_b`` (an einsum).

Gates: on the same quantized parameters, prefill and two decode steps give
logits within 1e-4 of the largest and identical greedy tokens, and eight
greedy tokens through both ``ServeEngine``s are identical.  The quantized-
vs-fp32 bound of the reference's own test is not used: it misses on the MoE
model on this JAX (quantization noise flips routing).
``launch/serve.py::init_params`` builds the quantized tree one layer at a
time; it must equal the whole model's fp32 masters quantized and cast, bit
for bit.
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.core import ops as core_ops
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import serve
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import cast_params
from repro_torch.quant.qarray import QArray
from repro_torch.serving import ServeConfig, ServeEngine

CPU = "cpu"
ARCHS = ["qwen3-moe-30b-a3b", "minicpm3-4b"]
LOGITS_TOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def quantized():
    """Per arch: the JAX model and its quantized tree, the port's model, and
    the port's parameters quantized in JAX or in the port."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        jmodel, tmodel = jax_get_model(jcfg), get_model(tcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jq = jquant.quantize_params(jparams)
        masters = params_from_jax(_np_tree(jparams), tcfg, device=CPU, dtype=torch.float32)
        out[arch] = dict(jmodel=jmodel, jq=jq, tmodel=tmodel, sources={
            "quantized-in-jax": params_from_jax(_np_tree(jq), tcfg, device=CPU),
            "quantized-in-port": quant.quantize_params(masters),
        })
    return out


def _contexts(mode):
    if mode == "w8a8":
        return jquant.use_act_quant("int8"), quant.use_act_quant("int8")
    return contextlib.nullcontext(), contextlib.nullcontext()


@pytest.mark.parametrize("source", ["quantized-in-jax", "quantized-in-port"])
@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_prefill_and_decode_match_jax(quantized, arch, mode, source):
    """Prefill, then two decode steps from the same cache: logits within 1e-4
    of the largest, greedy tokens identical."""
    q = quantized[arch]
    jmodel, jq, tmodel, tparams = q["jmodel"], q["jq"], q["tmodel"], q["sources"][source]
    if mode == "w8a8":
        tparams = quant.k_major(tparams)  # as the launcher serves them
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=16, kind="prefill", seed=11)
    tb = make_batch(tmodel.cfg, batch=2, seq=16, kind="prefill", seed=11, device=CPU)
    jctx, tctx = _contexts(mode)
    with jctx:
        jl, jcache = jmodel.prefill(jq, jb, max_len=24)
        jlogits, jtoks = [np.asarray(jl)], [np.asarray(jnp.argmax(jl, -1))]
        for step in range(2):
            jl, jcache = jmodel.decode_step(jq, jnp.asarray(jtoks[-1], jnp.int32), cache=jcache, pos=16 + step)
            jlogits.append(np.asarray(jl))
            jtoks.append(np.asarray(jnp.argmax(jl, -1)))
    with tctx:
        tl, tcache = tmodel.prefill(tparams, tb, max_len=24)
        tlogits, ttoks = [tl.numpy()], [tl.argmax(-1).numpy()]
        for step in range(2):
            tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(ttoks[-1]).to(torch.int32), cache=tcache,
                                            pos=16 + step)
            tlogits.append(tl.numpy())
            ttoks.append(tl.argmax(-1).numpy())
    for got, want in zip(tlogits, jlogits):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL * max(1.0, np.abs(want).max()))
    for got, want in zip(ttoks, jtoks):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_greedy_tokens_equal_jax(quantized, arch, mode):
    """Eight greedy tokens through both ServeEngines, parameters quantized in
    JAX and carried over."""
    q = quantized[arch]
    jmodel, jq, tmodel = q["jmodel"], q["jq"], q["tmodel"]
    tparams = q["sources"]["quantized-in-jax"]
    if mode == "w8a8":
        tparams = quant.k_major(tparams)
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=12, kind="prefill", seed=5)
    tb = make_batch(tmodel.cfg, batch=2, seq=12, kind="prefill", seed=5, device=CPU)
    jctx, tctx = _contexts(mode)
    with jctx:
        want = JaxServeEngine(jmodel, jq, JaxServeConfig(max_len=20, batch=2)).generate(jb, 8)
    with tctx:
        got = ServeEngine(tmodel, tparams, ServeConfig(max_len=20, batch=2), device=CPU).generate(tb, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_carried_quantized_tree_keeps_wide_what_the_reference_keeps_wide(quantized, arch):
    """MoE: attention and the head quantized, the router and the experts
    wide; MLA: every projection but wkv_b quantized.  The carried values are
    JAX's bit for bit, and the port's own quantization of the same masters
    gives the same tree."""
    q = quantized[arch]
    jq = q["jq"]
    for source, tree in q["sources"].items():
        assert isinstance(tree["lm_head"]["w"], QArray), source
        for i, layer in enumerate(tree["layers"]):
            for key, leaf in layer["attn"].items():
                if isinstance(leaf, dict):
                    continue
                assert isinstance(leaf, QArray) == (key != "wkv_b"), (source, key)
                if isinstance(leaf, QArray):
                    jleaf = jq["layers"]["attn"][key]
                    np.testing.assert_array_equal(leaf.values.numpy(), np.asarray(jleaf.values)[i])
                    np.testing.assert_array_equal(leaf.scales.numpy(), np.asarray(jleaf.scales)[i])
            ffn = layer["ffn"]
            if "router" in ffn:
                assert not any(isinstance(v, QArray) for v in ffn.values()), source
            else:
                assert all(isinstance(ffn[k], QArray) for k in ("w_gate", "w_up", "w_down")), source


def test_w8a8_moe_quantizes_activations_only_for_quantized_weights(quantized):
    """Under w8a8 the MoE model quantizes the activations of its attention
    projections alone (q, k, v, o per layer): the router and the experts,
    whose weights stay wide, see no quantize_act."""
    q = quantized["qwen3-moe-30b-a3b"]
    tmodel, tparams = q["tmodel"], quant.k_major(q["sources"]["quantized-in-port"])
    calls = []
    real = quant.quantize_act

    def rec(x, *args, **kw):
        calls.append(tuple(x.shape))
        return real(x, *args, **kw)

    tb = make_batch(tmodel.cfg, batch=2, seq=8, kind="prefill", seed=1, device=CPU)
    with quant.use_act_quant("int8"), mock.patch.object(quant, "quantize_act", rec):
        tmodel.prefill(tparams, tb, max_len=10)
    cfg = tmodel.cfg
    assert len(calls) == 4 * cfg.n_layers
    assert all(shape[0] == 2 * 8 for shape in calls)  # the tokens, never an expert's capacity rows
    x = torch.randn(3, cfg.d_model)
    router = tparams["layers"][0]["ffn"]["router"]
    with quant.use_act_quant("int8"), mock.patch.object(quant, "quantize_act", rec):
        before = len(calls)
        core_ops.matmul(x, router, out_dtype=torch.float32)
        assert len(calls) == before


# -- the launcher's quantized init, one layer at a time ---------------------------------


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "minicpm3-4b", "qwen3-moe-30b-a3b"])
def test_layer_by_layer_init_equals_whole_model_quantize(arch, mode):
    """``init_params`` draws each layer's fp32 masters from the stream the
    whole model's init uses, quantizes and casts it, and drops it: the tree
    equals the whole model's masters quantized and cast, bit for bit (w8a8
    also laid out K-major), and serving it raises nothing."""
    model = get_model(configs.get_smoke(arch))
    got, ctx = serve.init_params(model, 3, torch.device(CPU), mode)
    dtype = getattr(torch, model.cfg.dtype)
    want = cast_params(quant.quantize_params(model.init(3, CPU, dtype=torch.float32)), dtype)
    if mode == "w8a8":
        want = quant.k_major(want)
    got_leaves, want_leaves = [], []

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        elif isinstance(a, QArray):
            assert a.block == b.block and a.qdtype == b.qdtype, path
            assert a.values.stride() == b.values.stride(), path
            got_leaves.append((path, a.values, a.scales))
            want_leaves.append((path, b.values, b.scales))
        else:
            got_leaves.append((path, a))
            want_leaves.append((path, b))

    walk(got, want, "")
    assert any(isinstance(t, QArray) for t in [got["lm_head"]["w"]])
    for g, w in zip(got_leaves, want_leaves):
        for x, y in zip(g[1:], w[1:]):
            assert x.dtype == y.dtype and torch.equal(x, y), g[0]
    tb = make_batch(model.cfg, batch=1, seq=6, kind="prefill", seed=0, device=CPU)
    with ctx:
        logits, _ = model.prefill(got, tb, max_len=8)
    assert bool(torch.isfinite(logits).all())


def test_init_params_quantized_moe_no_longer_raises():
    model = get_model(configs.get_smoke("qwen3-moe-30b-a3b"))
    params, _ = serve.init_params(model, 0, torch.device(CPU), "w8a8")
    ffn = params["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.bfloat16 and ffn["w_up"].dtype == torch.bfloat16
    assert isinstance(params["layers"][0]["attn"]["wq"], QArray)
