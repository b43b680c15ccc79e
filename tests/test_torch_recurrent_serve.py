"""The port's recurrent families -- xlstm-125m (SSM) and zamba2-7b (hybrid)
-- served through the continuous and chunked schedulers, the slot pool and
quantized weights, against the JAX package on the CPU.

The fp32 SMOKE models of ``test_torch_recurrent.py`` (parameters from the
JAX ``model.init(PRNGKey(0))`` through ``params_from_jax``; request traces
from the same numpy seed in both packages).  Gates: the continuous
scheduler (both policies) and the chunked scheduler (the staged path,
chunk budgets 1 and 2) give JAX's tokens and tick-count statistics and the
port's isolated ``generate()``; ``KVPool.bytes_report`` equals JAX's; kv8
and the paged pool warn and are disabled as JAX's are; w8a16 and w8a8
greedy tokens equal JAX's on the same quantized parameters; and
``launch/serve.py::init_params``' layer-by-layer quantized build equals the
whole model's masters quantized and cast, bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.data.synthetic import make_request_trace as jax_make_request_trace
from repro.models.registry import get_model as jax_get_model
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import KVPool as JaxKVPool
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch, make_prompt, make_request_trace
from repro_torch.launch import serve
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import cast_params
from repro_torch.quant.qarray import QArray
from repro_torch.serving import ContinuousScheduler, KVPool, ServeConfig, ServeEngine, requests_from_trace

CPU = "cpu"
SERVED = {"xlstm": "xlstm-125m", "zamba2": "zamba2-7b"}
TRACE = dict(n_requests=5, mean_prompt=6, mean_gen=4, rate=0.7, seed=3, min_prompt=3, max_prompt=9, max_gen=6)
SLOTS = 2
TICK_STATS = ("ticks", "decode_steps", "idle_ticks", "tokens_out", "mean_occupancy", "requests_finished")
@pytest.fixture(scope="module")
def pair():
    """pair(name) -> (JAX model, its parameters, the port's model, the
    carried parameters) of the fp32 SMOKE config, built once per module."""
    built = {}

    def get(name):
        if name not in built:
            jmodel = jax_get_model(dataclasses.replace(jax_get_smoke(SERVED[name]), dtype="float32"))
            tmodel = get_model(dataclasses.replace(configs.get_smoke(SERVED[name]), dtype="float32"))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            built[name] = (jmodel, jparams, tmodel,
                           params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU))
        return built[name]

    return get


def _prompts(model, batch=2, seq=10, seed=1):
    jb = jax_make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed)
    return jb, make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed, device=CPU)


def _max_len(trace):
    return max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)


def _traces(pair, name):
    jmodel, _, tmodel, _ = pair(name)
    return jax_make_request_trace(jmodel.cfg, **TRACE), make_request_trace(tmodel.cfg, device=CPU, **TRACE)


def _port_run(tmodel, tparams, trace, **kw):
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=_max_len(trace), batch=SLOTS), device=CPU)
    sched = ContinuousScheduler(engine, **kw)
    return sched, sched.run(requests_from_trace(trace))


def _jax_run(jmodel, jparams, trace, **kw):
    engine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=_max_len(trace), batch=SLOTS))
    sched = JaxScheduler(engine, **kw)
    return sched, {rid: np.asarray(t) for rid, t in sched.run(jax_requests_from_trace(trace)).items()}


@pytest.fixture(scope="module")
def isolated(pair):
    """isolated(name, trace) -> {rid: the port's greedy tokens of the request
    served alone through generate()}, computed once per model."""
    built = {}

    def get(name, trace):
        if name not in built:
            _, _, tmodel, tparams = pair(name)
            built[name] = {t["rid"]: ServeEngine(tmodel, tparams, ServeConfig(max_len=_max_len(trace), batch=1),
                                                 device=CPU).generate(t["prompt"], t["max_new_tokens"])[0].numpy()
                           for t in trace}
        return built[name]

    return get


SCHEDULES = [dict(policy="continuous"), dict(policy="gang"),
             dict(policy="continuous", chunked_prefill=True, chunk_size=4, chunk_budget=1),
             dict(policy="continuous", chunked_prefill=True, chunk_size=4, chunk_budget=2)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["continuous", "gang", "chunked-budget1", "chunked-budget2"])
@pytest.mark.parametrize("name", list(SERVED))
def test_scheduler_equals_jax_and_isolated(pair, isolated, name, kw):
    """Per request, the port scheduler's greedy tokens equal the JAX
    scheduler's and the port's isolated generate(); the tick-count
    statistics and resident bytes equal JAX's.  Chunked runs take the staged
    path (the state is carried on the request and written once)."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jt, tt = _traces(pair, name)
    tsched, got = _port_run(tmodel, tparams, tt, **kw)
    jsched, want = _jax_run(jmodel, jparams, jt, **kw)
    assert tsched.engine.chunk_prefill_staged
    alone = isolated(name, tt)
    for t in tt:
        np.testing.assert_array_equal(got[t["rid"]], want[t["rid"]])
        np.testing.assert_array_equal(got[t["rid"]], alone[t["rid"]])
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    assert {k: ts[k] for k in (*TICK_STATS, "prefill_chunks")} == {k: js[k] for k in (*TICK_STATS, "prefill_chunks")}
    assert ts["kv_bytes_resident"] == js["kv_bytes_resident"]
    assert tsched.pool.n_free == SLOTS and (tsched.pool.positions == -1).all()


@pytest.mark.parametrize("name", list(SERVED))
def test_bytes_report_equals_jax(pair, name):
    """Reserved and live bytes as JAX's through a slot's life: the states
    count whole per live slot, the shared block's KV rows up to each slot's
    position; a freed slot's float state is zero (mLSTM's m too, as in the
    reference) and its positions -1."""
    jmodel, jparams, tmodel, tparams = pair(name)
    pool, jpool = KVPool(tmodel, 3, 20, device=CPU), JaxKVPool(jmodel, 3, 20)
    assert pool.bytes_report() == jpool.bytes_report() == {"reserved": pool.bytes_resident(), "live": 0}
    slots = []
    for seq, seed in ((5, 1), (9, 2)):
        slot, jslot = pool.alloc(), jpool.alloc()
        prompt = make_prompt(tmodel.cfg, seq=seq, seed=seed, device=CPU)
        pool.write_prefill(slot, tmodel.prefill(tparams, prompt, max_len=20)[1], seq)
        jpool.positions[jslot] = seq  # the report reads positions and shapes only
        pool.advance([slot])
        jpool.advance([jslot])
        slots.append(slot)
        assert pool.bytes_report() == jpool.bytes_report()
    pool.free(slots[0])
    jpool.free(slots[0])
    assert pool.bytes_report() == jpool.bytes_report()
    for stack in pool.cache.values():
        for per_layer in stack:
            for leaf in per_layer.values():
                assert bool((leaf[slots[0]] == (0 if leaf.is_floating_point() else -1)).all())


@pytest.mark.parametrize("name", list(SERVED))
def test_kv8_and_paged_warn_and_are_disabled_as_jax(pair, name):
    jmodel, jparams, tmodel, tparams = pair(name)
    for kw, match in ((dict(quantize_kv=True), "kv8 disabled"),
                      (dict(paged=True, prefix_cache=True), "paged KV disabled")):
        engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=16, batch=2), device=CPU)
        jengine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=16, batch=2))
        with pytest.warns(UserWarning) as rec:
            sched = ContinuousScheduler(engine, **kw)
        with pytest.warns(UserWarning) as jrec:
            jsched = JaxScheduler(jengine, **kw)
        assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
        assert match in " ".join(str(w.message) for w in rec)
        assert (sched.quantize_kv, sched.paged) == (jsched.quantize_kv, jsched.paged) == (False, False)
        assert isinstance(sched.pool, KVPool)


# -- quantized serving --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("name", list(SERVED))
def test_quantized_greedy_tokens_equal_jax(pair, name, mode):
    """Parameters quantized in JAX and carried over: the mLSTM projections,
    the SwiGLU and shared-attention weights and the head int8; Mamba2's
    in_proj / out_proj and sLSTM's w_x wide, as the reference leaves them.
    Eight greedy tokens through both ServeEngines, identical."""
    jmodel, jparams, tmodel, _ = pair(name)
    jq = jquant.quantize_params(jparams)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), tmodel.cfg, device=CPU)
    if name == "xlstm":
        core = tq["mlstm"][0]["core"]
        assert all(isinstance(core[k], QArray) for k in ("w_up", "wq", "wk", "wv", "w_if", "w_down"))
        assert isinstance(tq["slstm"][0]["core"]["mlp"]["w_gate"], QArray)
        assert not isinstance(tq["slstm"][0]["core"]["w_x"], QArray)
    else:
        assert all(not isinstance(tq["mamba"][0]["core"][k], QArray) for k in ("in_proj", "out_proj"))
        assert isinstance(tq["shared"]["attn"]["wq"], QArray) and isinstance(tq["shared"]["ffn"]["w_up"], QArray)
    jb, tb = _prompts(jmodel, seq=8, seed=5)
    if mode == "w8a8":
        tq = quant.k_major(tq)
        with jquant.use_act_quant("int8"):
            want = JaxServeEngine(jmodel, jq, JaxServeConfig(max_len=16, batch=2)).generate(jb, 8)
        with quant.use_act_quant("int8"):
            got = ServeEngine(tmodel, tq, ServeConfig(max_len=16, batch=2), device=CPU).generate(tb, 8)
    else:
        want = JaxServeEngine(jmodel, jq, JaxServeConfig(max_len=16, batch=2)).generate(jb, 8)
        got = ServeEngine(tmodel, tq, ServeConfig(max_len=16, batch=2), device=CPU).generate(tb, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_layer_by_layer_init_equals_whole_model_quantize(arch, mode):
    """``init_params`` quantizes and casts each top-level piece (every layer,
    the shared block) as it is drawn: the tree equals the whole model's fp32
    masters quantized and cast, bit for bit, its fp32 leaves fp32."""
    model = get_model(configs.get_smoke(arch))
    got, ctx = serve.init_params(model, 3, torch.device(CPU), mode)
    want = cast_params(quant.quantize_params(model.init(3, CPU, dtype=torch.float32)), torch.bfloat16)
    if mode == "w8a8":
        want = quant.k_major(want)

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
            assert a.block == b.block and a.qdtype == b.qdtype and a.values.stride() == b.values.stride(), path
            assert torch.equal(a.values, b.values) and torch.equal(a.scales, b.scales), path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(got, want, "")
    stack = "mamba" if arch == "zamba2-7b" else "mlstm"
    assert got[stack][0]["core"]["conv_w"].dtype == torch.float32
    tb = make_batch(model.cfg, batch=1, seq=4, kind="prefill", seed=0, device=CPU)
    with ctx:
        logits, _ = model.prefill(got, tb, max_len=6)
    assert bool(torch.isfinite(logits).all())
