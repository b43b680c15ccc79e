"""The port's continuous batching (``KVPool``, ``ContinuousScheduler``, the
engine's per-slot primitives, ``make_request_trace``) against the JAX
package on the CPU.

Parameters come from the JAX ``model.init(PRNGKey(0))`` through
``params_from_jax``; request traces come from the same numpy seed in both
packages.  Configs: the fp32 SMOKE internlm2-1.8b (GQA), h2o-danube-3-4b
(SWA, its trace long enough to wrap the ring cache) and minicpm3-4b (MLA, a
latent cache), the three cache layouts of the reference's
tests/test_continuous.py.

Gates: greedy tokens equal token for token -- the port's scheduler, the
port's isolated ``generate()`` and the JAX scheduler -- and the tick-count
statistics (ticks, decode steps, idle ticks, tokens, admissions, evictions,
mean occupancy) equal JAX's; wall-clock statistics are not compared.  Sampled
tokens cannot match JAX (torch's RNG is not JAX's): sampling is checked for
shape, dtype and determinism.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_request_trace as jax_make_request_trace
from repro.models.registry import get_model as jax_get_model
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import KVPool as JaxKVPool
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro.serving.kvpool import check_next_pos as jax_check_next_pos
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_prompt, make_request_trace
from repro_torch.models.registry import get_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.serving import (
    ContinuousScheduler,
    KVPool,
    PagedKVPool,
    Request,
    ServeConfig,
    ServeEngine,
    requests_from_trace,
)
from repro_torch.serving.kvpool import _tensors, check_next_pos
from repro_torch.serving.scheduler import DECODING, FINISHED, QUEUED

CPU = "cpu"
ARCHS = ["internlm2-1.8b", "h2o-danube-3-4b", "minicpm3-4b"]
# Traces in the style of tests/test_continuous.py; danube's prompts are long
# enough that some prompt + generation outgrows its 32-slot SWA ring.
TRACES = {
    "internlm2-1.8b": dict(n_requests=8, mean_prompt=8, mean_gen=5, rate=0.7, seed=11, max_prompt=12, max_gen=8),
    "h2o-danube-3-4b": dict(n_requests=8, mean_prompt=20, mean_gen=8, rate=0.7, seed=11, max_prompt=30, max_gen=12),
    "minicpm3-4b": dict(n_requests=8, mean_prompt=8, mean_gen=5, rate=0.7, seed=11, max_prompt=12, max_gen=8),
}
SLOTS = 3
TICK_STATS = ("ticks", "decode_steps", "idle_ticks", "tokens_out", "mean_occupancy", "requests_finished")


def _pair(arch):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
    return jmodel, jparams, tmodel, tparams


def _max_len(trace):
    return max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)


def _port_run(tmodel, tparams, trace, policy="continuous", slots=SLOTS, **scfg):
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=_max_len(trace), batch=slots, **scfg), device=CPU)
    sched = ContinuousScheduler(engine, policy=policy)
    return sched, sched.run(requests_from_trace(trace))


def _jax_run(jmodel, jparams, trace, policy="continuous", slots=SLOTS):
    engine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=_max_len(trace), batch=slots))
    sched = JaxScheduler(engine, policy=policy)
    return sched, {rid: np.asarray(t) for rid, t in sched.run(jax_requests_from_trace(trace)).items()}


@pytest.fixture(scope="module")
def served():
    """Per arch: the models, both packages' traces, and each package's runs
    under both policies (the JAX runs are the slow part; shared)."""
    out = {}
    for arch in ARCHS:
        jmodel, jparams, tmodel, tparams = _pair(arch)
        jt = jax_make_request_trace(jmodel.cfg, **TRACES[arch])
        tt = make_request_trace(tmodel.cfg, device=CPU, **TRACES[arch])
        runs = {}
        for policy in ("continuous", "gang"):
            runs[("jax", policy)] = _jax_run(jmodel, jparams, jt, policy)
            runs[("port", policy)] = _port_run(tmodel, tparams, tt, policy)
        out[arch] = dict(jmodel=jmodel, jparams=jparams, tmodel=tmodel, tparams=tparams, jt=jt, tt=tt, runs=runs)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_request_trace_equals_jax(served, arch):
    jt, tt = served[arch]["jt"], served[arch]["tt"]
    assert len(jt) == len(tt)
    for j, t in zip(jt, tt):
        assert (j["rid"], j["arrival"], j["max_new_tokens"]) == (t["rid"], t["arrival"], t["max_new_tokens"])
        assert t["prompt"]["tokens"].dtype == torch.int32 and t["prompt"]["tokens"].device.type == CPU
        np.testing.assert_array_equal(np.asarray(j["prompt"]["tokens"]), t["prompt"]["tokens"].numpy())
    if arch == "h2o-danube-3-4b":
        assert _max_len(tt) > served[arch]["tmodel"].cfg.window  # the ring wraps


@pytest.mark.parametrize("policy", ["continuous", "gang"])
@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_tokens_equal_isolated_and_jax(served, arch, policy):
    """Per request, the port scheduler's greedy tokens equal the port's
    isolated generate() and the JAX scheduler's, token for token; the
    tick-count statistics equal JAX's."""
    s = served[arch]
    tsched, got = s["runs"][("port", policy)]
    jsched, want = s["runs"][("jax", policy)]
    max_len = _max_len(s["tt"])
    for t in s["tt"]:
        engine = ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=max_len, batch=1), device=CPU)
        alone = engine.generate(t["prompt"], t["max_new_tokens"])[0].numpy()
        np.testing.assert_array_equal(got[t["rid"]], alone)
        np.testing.assert_array_equal(got[t["rid"]], want[t["rid"]])
        assert got[t["rid"]].dtype == np.int32 and len(got[t["rid"]]) == t["max_new_tokens"]
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    assert {k: ts[k] for k in TICK_STATS} == {k: js[k] for k in TICK_STATS}
    assert tsched.stats.registry.counter_value("sched.admitted") == jsched.stats.registry.counter_value("sched.admitted")
    assert ts["kv_bytes_resident"] == js["kv_bytes_resident"]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_occupancy_beats_gang(served, arch):
    runs = served[arch]["runs"]
    (gang, g_out), (cont, c_out) = runs[("port", "gang")], runs[("port", "continuous")]
    for rid in g_out:
        np.testing.assert_array_equal(g_out[rid], c_out[rid])
    assert cont.stats.mean_occupancy() > gang.stats.mean_occupancy()


def test_w8a8_scheduler_tokens_equal_jax():
    """The SMOKE internlm2 quantized from the same fp32 masters in each
    package, served w8a8 through both schedulers: identical greedy tokens."""
    jmodel, jparams, tmodel, tparams = _pair("internlm2-1.8b")
    jq = jquant.quantize_params(jparams)
    tq = quant.k_major(quant.quantize_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU, dtype=torch.float32)))
    kw = TRACES["internlm2-1.8b"]
    jt, tt = jax_make_request_trace(jmodel.cfg, **kw), make_request_trace(tmodel.cfg, device=CPU, **kw)
    with jquant.use_act_quant("int8"):
        _, want = _jax_run(jmodel, jq, jt)
    with quant.use_act_quant("int8"):
        _, got = _port_run(tmodel, tq, tt)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_lifecycle_states_and_slot_rotation(served):
    s = served["internlm2-1.8b"]
    trace = make_request_trace(s["tmodel"].cfg, device=CPU, n_requests=4, mean_prompt=8, mean_gen=5, rate=0.7,
                               seed=5, max_prompt=12, max_gen=8)
    engine = ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=_max_len(trace), batch=1), device=CPU)
    sched = ContinuousScheduler(engine)
    reqs = requests_from_trace(trace)
    for r in reqs:
        sched.submit(r)
        assert r.state == QUEUED
    seen_decoding = False
    while sched.pending():
        sched.step()
        seen_decoding |= any(r.state == DECODING for r in reqs)
    assert seen_decoding
    for r in reqs:
        assert r.state == FINISHED and r.slot == -1 and len(r.out) == r.max_new_tokens
        assert r.admitted_tick >= r.arrival - 1 and r.finished_tick >= r.admitted_tick
    assert sched.pool.n_free == 1  # one slot: requests went through it one after another
    assert sched.stats.tokens_out == sum(r.max_new_tokens for r in reqs)
    assert (sched.pool.positions == -1).all()


def test_eos_eviction_frees_slot_early(served):
    s = served["internlm2-1.8b"]
    t = s["tt"][0]
    max_len = _max_len([t])
    alone = ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=max_len, batch=1),
                        device=CPU).generate(t["prompt"], t["max_new_tokens"])[0].numpy()
    assert len(alone) >= 3
    eos = int(alone[1])
    sched = ContinuousScheduler(ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=max_len, batch=1),
                                            device=CPU))
    req = Request(rid=0, prompt=t["prompt"], max_new_tokens=t["max_new_tokens"], eos_id=eos)
    got = sched.run([req])[0]
    np.testing.assert_array_equal(got, alone[: int(np.argmax(alone == eos)) + 1])
    assert req.state == FINISHED and sched.pool.n_free == 1


def test_admission_respects_arrival_and_capacity_and_budget(served):
    s = served["internlm2-1.8b"]
    trace = s["tt"][:3]
    engine = ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=_max_len(trace), batch=2), device=CPU)
    sched = ContinuousScheduler(engine)
    reqs = requests_from_trace(trace)
    late = reqs[-1]
    late.arrival = 1e6  # never arrives within this test
    for r in reqs:
        sched.submit(r)
    for _ in range(40):
        sched.step()
        assert late.state == QUEUED and sched.pool.n_active <= 2
        if all(r.state == FINISHED for r in reqs[:-1]):
            break
    assert all(r.state == FINISHED for r in reqs[:-1]) and sched.pool.n_active == 0
    big = Request(rid=9, prompt=trace[0]["prompt"], max_new_tokens=100)
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(big)
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(Request(rid=10, prompt=trace[0]["prompt"], max_new_tokens=0))


# -- the KV pool -------------------------------------------------------------------


def _pools(arch, served, n_slots=3, max_len=40):
    s = served[arch]
    return (KVPool(s["tmodel"], n_slots, max_len, device=CPU), JaxKVPool(s["jmodel"], n_slots, max_len))


def test_kvpool_lifo_alloc_free(served):
    pool, jpool = _pools("internlm2-1.8b", served)
    for p in (pool, jpool):
        got = [p.alloc() for _ in range(3)]
        assert got == [0, 1, 2] and p.alloc() is None and p.n_free == 0 and p.occupancy() == 1.0
        p.free(1)
        p.free(0)
        assert p.alloc() == 0 and p.alloc() == 1  # the most recently freed first
        with pytest.raises(ValueError):
            p.free(5)
    pool.free(2)
    with pytest.raises(ValueError, match="already-free"):
        pool.free(2)
    assert (pool.n_active, pool.n_free) == (2, 1)


def _leaves(tree):
    return list(_tensors(tree))


def _prefill_one(tmodel, tparams, seq, seed, max_len):
    return tmodel.prefill(tparams, make_prompt(tmodel.cfg, seq=seq, seed=seed, device=CPU), max_len=max_len)[1]


def test_kvpool_gather_is_a_copy_and_scatter_round_trips(served):
    s = served["h2o-danube-3-4b"]
    pool, _ = _pools("h2o-danube-3-4b", served)
    slot = pool.alloc()
    one = _prefill_one(s["tmodel"], s["tparams"], 36, 1, 40)  # longer than the 32-slot ring
    pool.write_prefill(slot, one, 36)
    view = pool.gather_slot(slot)
    for a, b in zip(_leaves(view), _leaves(one)):
        assert torch.equal(a, b)
    before = [t.clone() for t in _leaves(view)]
    pool.free(slot)  # clears the pool's rows, not the copy
    assert all(torch.equal(a, b) for a, b in zip(_leaves(view), before))
    assert (pool.cache["layers"][0]["pos"][slot] == -1).all() and (pool.cache["layers"][0]["k"][slot] == 0).all()
    pool.write_slot(2, view, next_pos=None)  # a mid-prefill write: rows land, the slot stays masked
    assert pool.positions[2] == -1 and torch.equal(pool.cache["layers"][1]["k"][2], view["layers"][1]["k"][0])
    with pytest.raises(ValueError, match="batch-1"):
        pool.write_slot(0, pool.cache, next_pos=3)


@pytest.mark.parametrize("value", [None, 0, 5, -1, 7.0, -2, 2.5, float("nan")])
def test_check_next_pos_equals_jax(value):
    results = []
    for fn in (jax_check_next_pos, check_next_pos):
        try:
            results.append(fn(value))
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_report_equals_jax(served, arch):
    """The same admissions into both packages' pools: equal reserved and live
    bytes after each (danube's ring caps a slot's live rows at 32)."""
    s = served[arch]
    pool, jpool = _pools(arch, served)
    assert pool.bytes_report() == jpool.bytes_report() == {"reserved": pool.bytes_resident(), "live": 0}
    for seq, seed in ((12, 1), (36, 2), (5, 3)):
        slot, jslot = pool.alloc(), jpool.alloc()
        assert slot == jslot
        pool.write_prefill(slot, _prefill_one(s["tmodel"], s["tparams"], seq, seed, 40), seq)
        jpool.positions[jslot] = seq  # the report reads positions and shapes only
        pool.advance([slot])
        jpool.advance([jslot])
        assert pool.bytes_report() == jpool.bytes_report()
    pool.free(1)
    jpool.positions[1] = -1
    jpool._free.append(1)
    assert pool.bytes_report() == jpool.bytes_report()


@pytest.mark.parametrize("arch,max_len,want", [("internlm2-1.8b", 40, 40), ("h2o-danube-3-4b", 40, 32),
                                               ("h2o-danube-3-4b", 20, 20), ("minicpm3-4b", 40, 40)])
def test_attn_cache_len_is_the_ring_for_swa(served, arch, max_len, want):
    s = served[arch]
    engine = ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=max_len, batch=1), device=CPU)
    jengine = JaxServeEngine(s["jmodel"], s["jparams"], JaxServeConfig(max_len=max_len, batch=1))
    assert engine.attn_cache_len() == jengine.attn_cache_len() == want
    assert KVPool(s["tmodel"], 1, max_len, device=CPU).cache["layers"][0]["pos"].shape[1] == want


# -- sampling ------------------------------------------------------------------------


def _engine(served, temperature, seed=0, batch=SLOTS, max_len=24):
    s = served["internlm2-1.8b"]
    return ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=max_len, batch=batch, temperature=temperature,
                                                              seed=seed), device=CPU)


def test_temperature_sampling_shape_dtype_and_determinism(served):
    logits = torch.randn(4, 1, 256, generator=torch.Generator().manual_seed(0))
    draws = [_engine(served, 1.0, seed=3)._sample(logits) for _ in range(2)]
    assert draws[0].shape == (4, 1) and draws[0].dtype == torch.int32
    assert torch.equal(draws[0], draws[1])  # one seed, one draw
    eng = _engine(served, 1.0, seed=3)
    seq = torch.stack([eng._sample(logits) for _ in range(32)])
    assert torch.equal(seq[0], draws[0]) and not (seq == seq[0]).all()  # the generator advances
    assert ((seq >= 0) & (seq < 256)).all()
    assert torch.equal(_engine(served, 0.0)._sample(logits), logits.argmax(-1).to(torch.int32))
    cold = _engine(served, 1e-4, seed=5)._sample(logits * 100)  # T -> 0 concentrates on the argmax
    assert torch.equal(cold, logits.argmax(-1).to(torch.int32))


def test_sampled_run_is_deterministic_and_warmup_leaves_the_generator(served):
    s = served["internlm2-1.8b"]
    trace = s["tt"]
    outs = [_port_run(s["tmodel"], s["tparams"], trace, temperature=0.8, seed=7)[1] for _ in range(2)]
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid], outs[1][rid])
        assert len(outs[0][rid]) == trace[rid]["max_new_tokens"]
    eng = _engine(served, 0.8, seed=7, max_len=_max_len(trace))
    sched = ContinuousScheduler(eng)
    for r in requests_from_trace(trace):
        sched.submit(r)
    state = eng._gen.get_state()
    sched.warmup()
    assert torch.equal(eng._gen.get_state(), state)
    assert sched.pool.n_free == SLOTS and (sched.pool.positions == -1).all()


# -- telemetry -------------------------------------------------------------------------


def test_snapshot_and_trace_pass_the_reference_validators(served):
    s = served["internlm2-1.8b"]
    tracer = ttrace.get_tracer()
    tracer.clear()
    tmetrics.reset()
    sched, _ = _port_run(s["tmodel"], s["tparams"], s["tt"])
    doc = tmetrics.snapshot_doc(tmetrics.get_registry(), sched.stats.registry, extra=sched.stats.summary())
    assert jmetrics.validate_snapshot(doc) == []
    steps = {k: v for k, v in doc["counters"].items() if k.startswith("engine.steps")}
    n_prefill = len(s["tt"]) + len({t["prompt"]["tokens"].shape[1] for t in s["tt"]})  # + warmup's
    assert steps == {'engine.steps{phase="decode"}': 1 + sched.stats.decode_steps,
                     'engine.steps{phase="prefill_request"}': n_prefill}
    chrome = tracer.export_chrome()
    assert jtrace.validate_chrome_trace(chrome) == []
    for t in s["tt"]:
        assert jtrace.validate_request_timeline(chrome, t["rid"]) == []
    names = {e["name"] for e in chrome["traceEvents"]}
    assert {"serve.warmup", "engine.prefill_request", "engine.decode_slots", "serve.decode_tick"} <= names


def test_slo_budgets_count_violations_and_dump_valid_postmortems(served, tmp_path):
    """Budgets no request can meet: every request misses TTFT, goodput is 0,
    and the flight recorder's bundles pass the reference's validator."""
    from repro.obs import slo as jslo
    from repro_torch.obs import slo as tslo

    s = served["internlm2-1.8b"]
    engine = ServeEngine(s["tmodel"], s["tparams"], ServeConfig(max_len=_max_len(s["tt"]), batch=SLOTS), device=CPU)
    sched = ContinuousScheduler(engine, slo=tslo.SLOSpec(ttft_ms=1e-6, itl_ms=1e-6))
    sched.flight_recorder = tslo.FlightRecorder(tmp_path, registries=(sched.stats.registry,), max_bundles=3)
    sched.run(requests_from_trace(s["tt"]))
    st = sched.stats.summary()
    assert st["requests_finished"] == len(s["tt"]) and st["requests_conformant"] == 0 and st["goodput_toks"] == 0
    assert st["slo_violations"] >= len(s["tt"])
    fr = sched.flight_recorder
    assert len(fr.paths) == 3 and fr.suppressed == len(s["tt"]) - 3  # one bundle per offending request
    for path in fr.paths:
        assert jslo.validate_postmortem(json.loads(open(path).read())) == []


# -- options once unported, and what raises ------------------------------------------


@pytest.mark.parametrize("option,item", [("paged", "5"), ("prefix_cache", "5")])
def test_unported_options_raise(served, option, item):
    """ROADMAP item 5 (the paged pool and the prefix cache) is ported, so
    neither option raises any more: ``paged`` builds the paged pool, and
    ``prefix_cache`` alone warns that it needs the paged pool and serves
    without it, as the reference does (tests/test_torch_paged*.py hold both
    against JAX)."""
    assert item == "5"
    if option == "paged":
        sched = ContinuousScheduler(_engine(served, 0.0), paged=True)
        assert sched.paged and isinstance(sched.pool, PagedKVPool) and sched.pool.prefix is None
    else:
        with pytest.warns(UserWarning, match="requires the paged pool"):
            sched = ContinuousScheduler(_engine(served, 0.0), prefix_cache=True)
        assert not sched.paged and isinstance(sched.pool, KVPool)


def test_unknown_policy_raises(served):
    with pytest.raises(ValueError, match="policy"):
        ContinuousScheduler(_engine(served, 0.0), policy="fifo")


def test_prompt_on_another_device_is_refused(served):
    eng = _engine(served, 0.0)
    with pytest.raises(ValueError, match="engine on cpu"):  # the meta device stands in for a card
        eng.prefill_request({"tokens": torch.zeros((1, 4), dtype=torch.int32, device="meta")})
