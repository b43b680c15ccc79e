"""The port's chunked prefill (``chunk_schedule``, ``gqa_prefill_chunk``,
``transformer.prefill_chunk``, ``ServeEngine.prefill_chunk`` and the chunked
``ContinuousScheduler``) and ``make_adversarial_trace`` against the JAX
package on the CPU.

Parameters come from the JAX ``model.init(PRNGKey(0))`` through
``params_from_jax``; inputs, caches and request traces from the same numpy
seed in both packages.  Configs: the fp32 SMOKE internlm2-1.8b (GQA),
h2o-danube-3-4b (SWA, a 32-slot ring that chunks wrap), minicpm3-4b (MLA: a
latent cache, chunks attending in the expanded form) and qwen3-moe-30b-a3b.

Tolerances: a chunk's attention output and the composed chunks' last logits
within atol 1e-5 * sqrt(K) of JAX's (K = d_model; fp32 sums in another
order), as the port's other fp32 gates.  Greedy tokens and the tick-count
statistics (prefill chunks, decode steps, idle ticks) equal JAX's exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_adversarial_trace as jax_make_adversarial_trace
from repro.data.synthetic import make_request_trace as jax_make_request_trace
from repro.models import attention as jattn
from repro.models.registry import get_model as jax_get_model
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import chunk_schedule as jax_chunk_schedule
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_adversarial_trace, make_prompt, make_request_trace
from repro_torch.models import attention as tattn
from repro_torch.models.registry import get_model
from repro_torch.serving import ContinuousScheduler, Request, ServeConfig, ServeEngine, requests_from_trace
from repro_torch.serving.engine import chunk_schedule
from repro_torch.serving.kvpool import KVPool, _tensors
from repro_torch.serving.scheduler import DECODING, FINISHED, PREFILLING

CPU = "cpu"
ARCHS = ["internlm2-1.8b", "h2o-danube-3-4b", "minicpm3-4b"]
SLOTS = 3
CHUNK = 4
# Traces in the style of tests/test_chunked_prefill.py; danube's prompts
# outgrow its 32-slot ring, so some chunks take the wrapped path.
TRACES = {
    "internlm2-1.8b": dict(n_requests=6, mean_prompt=8, mean_gen=5, rate=0.7, seed=3, max_prompt=14, max_gen=8),
    "h2o-danube-3-4b": dict(n_requests=6, mean_prompt=20, mean_gen=6, rate=0.7, seed=3, max_prompt=40, max_gen=8),
    "minicpm3-4b": dict(n_requests=6, mean_prompt=8, mean_gen=5, rate=0.7, seed=3, max_prompt=14, max_gen=8),
}
CHUNK_STATS = ("prefill_chunks", "decode_steps", "idle_ticks", "ticks", "tokens_out", "mean_occupancy")


def _tol(cfg):
    return 1e-5 * cfg.d_model**0.5


def _pair(arch):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def models():
    return {arch: _pair(arch) for arch in (*ARCHS, "qwen3-moe-30b-a3b")}


def _max_len(trace):
    return max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)


# -- the bucketing rule ------------------------------------------------------------


@pytest.mark.parametrize("n,chunk", [(1, 128), (7, 8), (10, 4), (300, 128), (128, 128), (129, 128), (31, 5),
                                     (8192, 512), (128, 512), (45, 8), (1000, 7), (63, 64)])
def test_chunk_schedule_equals_jax(n, chunk):
    got = chunk_schedule(n, chunk)
    assert got == jax_chunk_schedule(n, chunk)
    assert sum(length for _, length in got) == n and all(1 <= length <= chunk for _, length in got)


@pytest.mark.parametrize("n,chunk", [(0, 8), (8, 0), (-1, 4), (4, -2)])
def test_chunk_schedule_raises_where_jax_raises(n, chunk):
    with pytest.raises(ValueError) as want:
        jax_chunk_schedule(n, chunk)
    with pytest.raises(ValueError) as got:
        chunk_schedule(n, chunk)
    assert str(got.value) == str(want.value)


# -- one chunk's attention ---------------------------------------------------------


def _layer(jparams, tparams, i=0):
    return jax.tree.map(lambda a: a[i], jparams["layers"])["attn"], tparams["layers"][i]["attn"]


def _filled_cache(cfg, size, positions, seed):
    """A batch-1 cache of ``size`` slots with random K/V everywhere (masked
    slots hold garbage too) and ``positions`` written at their ring slots."""
    rng = np.random.default_rng(seed)
    shape = (1, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pos = np.full((1, size), -1, np.int32)
    for p in positions:
        pos[0, p % size] = p
    return k, v, pos


@pytest.mark.parametrize("arch,max_len,offset,length,wrapped,prior", [
    ("internlm2-1.8b", 24, 10, 6, False, range(10)),
    ("internlm2-1.8b", 24, 0, 8, False, ()),
    ("h2o-danube-3-4b", 60, 40, 8, True, range(8, 40)),  # the ring already wrapped once
    ("h2o-danube-3-4b", 60, 28, 8, True, range(28)),  # the chunk itself crosses the window
    ("h2o-danube-3-4b", 60, 16, 8, False, range(16)),
])
def test_gqa_prefill_chunk_equals_jax(models, arch, max_len, offset, length, wrapped, prior):
    jmodel, jparams, tmodel, tparams = models[arch]
    cfg = tmodel.cfg
    jp, tp = _layer(jparams, tparams)
    size = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    assert (offset + length > size) == wrapped
    k, v, pos = _filled_cache(cfg, size, prior, seed=offset)
    x = np.random.default_rng(1).standard_normal((1, length, cfg.d_model)).astype(np.float32)
    jy, jc = jattn.gqa_prefill_chunk(jp, jnp.asarray(x), jmodel.cfg,
                                     {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)},
                                     jnp.int32(offset), wrapped=wrapped)
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()), "pos": torch.from_numpy(pos.copy())}
    ty, tc2 = tattn.gqa_prefill_chunk(tp, torch.from_numpy(x), cfg, tc, offset, wrapped=wrapped)
    assert tc2 is tc  # updated in place
    tol = _tol(cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=0, atol=tol)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# -- composed chunks ---------------------------------------------------------------


def _compose(model, params, tokens, cache, sched, size, torch_side):
    for off, length in sched:
        wrapped = off + length > size
        piece = tokens[:, off : off + length]
        if torch_side:
            logits, cache = model.prefill_chunk(params, {"tokens": piece}, cache=cache, offset=off, wrapped=wrapped)
        else:
            logits, cache = model.prefill_chunk(params, {"tokens": jnp.asarray(piece)}, cache=cache,
                                                offset=jnp.int32(off), wrapped=wrapped)
    return logits, cache


@pytest.mark.parametrize("arch,n,chunk", [("internlm2-1.8b", 13, 4), ("internlm2-1.8b", 20, 8),
                                          ("internlm2-1.8b", 7, 16), ("h2o-danube-3-4b", 45, 8),
                                          ("h2o-danube-3-4b", 30, 16), ("minicpm3-4b", 13, 4),
                                          ("minicpm3-4b", 20, 8)])
def test_prefill_chunk_composed_equals_jax_and_monolithic(models, arch, n, chunk):
    jmodel, jparams, tmodel, tparams = models[arch]
    cfg = tmodel.cfg
    max_len = n + 4
    prompt = make_prompt(cfg, seq=n, seed=n, device=CPU)["tokens"]
    size = min(max_len, cfg.window) if cfg.attention == "swa" else max_len
    sched = chunk_schedule(n, chunk)
    got, cache = _compose(tmodel, tparams, prompt, tmodel.init_cache(1, max_len, torch.float32, CPU), sched, size,
                          True)
    want, jcache = _compose(jmodel, jparams, prompt.numpy(), jmodel.init_cache(1, max_len), sched, size, False)
    mono, mcache = tmodel.prefill(tparams, {"tokens": prompt}, max_len=max_len)
    tol = _tol(cfg)
    assert got.shape == mono.shape == (1, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), mono.numpy(), rtol=0, atol=tol)
    for lc, mc in zip(cache["layers"], mcache["layers"]):
        torch.testing.assert_close(lc["pos"], mc["pos"], rtol=0, atol=0)
        for name in ("c_kv", "k_rope") if cfg.attention == "mla" else ("k",):
            torch.testing.assert_close(lc[name], mc[name], rtol=0, atol=tol)
    jpos = np.asarray(jcache["layers"]["pos"])
    for i, lc in enumerate(cache["layers"]):
        np.testing.assert_array_equal(lc["pos"].numpy(), jpos[i])


def test_moe_prefill_chunk_equals_jax(models):
    """One schedule on the SMOKE MoE model.  Not held against monolithic:
    capacity is per call, so chunking changes which tokens drop in both
    packages."""
    jmodel, jparams, tmodel, tparams = models["qwen3-moe-30b-a3b"]
    n, max_len = 14, 18
    prompt = make_prompt(tmodel.cfg, seq=n, seed=4, device=CPU)["tokens"]
    sched = chunk_schedule(n, 8)
    got, _ = _compose(tmodel, tparams, prompt, tmodel.init_cache(1, max_len, torch.float32, CPU), sched, max_len, True)
    want, _ = _compose(jmodel, jparams, prompt.numpy(), jmodel.init_cache(1, max_len), sched, max_len, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tol(tmodel.cfg))


def test_prefill_chunk_refuses_the_vit_frontend(models):
    from repro_torch.models import transformer

    _, _, tmodel, tparams = models["internlm2-1.8b"]
    cfg = dataclasses.replace(tmodel.cfg, frontend="vit")
    with pytest.raises(ValueError, match="vit frontend"):
        transformer.prefill_chunk(tparams, {"tokens": torch.zeros((1, 2), dtype=torch.int32)}, cfg, None, 0)


# -- the chunked scheduler -----------------------------------------------------------


def _port_run(tmodel, tparams, trace, slots=SLOTS, **kw):
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=_max_len(trace), batch=slots), device=CPU)
    sched = ContinuousScheduler(engine, **kw)
    return sched, sched.run(requests_from_trace(trace))


def _jax_run(jmodel, jparams, trace, slots=SLOTS, **kw):
    engine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=_max_len(trace), batch=slots))
    sched = JaxScheduler(engine, **kw)
    return sched, {rid: np.asarray(t) for rid, t in sched.run(jax_requests_from_trace(trace)).items()}


def _isolated(tmodel, tparams, trace):
    max_len = _max_len(trace)
    out = {}
    for t in trace:
        eng = ServeEngine(tmodel, tparams, ServeConfig(max_len=max_len, batch=1), device=CPU)
        out[t["rid"]] = eng.generate(t["prompt"], t["max_new_tokens"])[0].numpy()
    return out


@pytest.fixture(scope="module")
def traces(models):
    out = {}
    for arch in ARCHS:
        jmodel, jparams, tmodel, tparams = models[arch]
        tt = make_request_trace(tmodel.cfg, device=CPU, **TRACES[arch])
        out[arch] = dict(tt=tt, jt=jax_make_request_trace(jmodel.cfg, **TRACES[arch]),
                         alone=_isolated(tmodel, tparams, tt))
    return out


@pytest.mark.parametrize("budget", [1, 2])
@pytest.mark.parametrize("policy", ["continuous", "gang"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_scheduler_tokens_equal_isolated_and_jax(models, traces, arch, policy, budget):
    """Per request, the chunked scheduler's greedy tokens equal the port's
    isolated generate() (monolithic prefill) and the JAX chunked scheduler's;
    the tick-count statistics equal JAX's."""
    jmodel, jparams, tmodel, tparams = models[arch]
    kw = dict(policy=policy, chunked_prefill=True, chunk_size=CHUNK, chunk_budget=budget)
    tsched, got = _port_run(tmodel, tparams, traces[arch]["tt"], **kw)
    jsched, want = _jax_run(jmodel, jparams, traces[arch]["jt"], **kw)
    for rid, alone in traces[arch]["alone"].items():
        np.testing.assert_array_equal(got[rid], alone)
        np.testing.assert_array_equal(got[rid], want[rid])
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    assert {k: ts[k] for k in CHUNK_STATS} == {k: js[k] for k in CHUNK_STATS}
    assert ts["prefill_chunks"] == sum(len(chunk_schedule(t["prompt"]["tokens"].shape[1], CHUNK))
                                       for t in traces[arch]["tt"])
    assert not tsched._prefilling and tsched.pool.n_free == SLOTS and (tsched.pool.positions == -1).all()


def test_swa_ring_wrap_chunks_match_isolated_and_jax(models):
    """A prompt of window + 13 through chunks of 8: the last chunks wrap the
    ring (attention over [cache before the writes ‖ chunk])."""
    jmodel, jparams, tmodel, tparams = models["h2o-danube-3-4b"]
    cfg = tmodel.cfg
    plen, gen = cfg.window + 13, 6
    trace = [{"rid": 0, "arrival": 0.0, "prompt": make_prompt(cfg, seq=plen, seed=11, device=CPU),
              "max_new_tokens": gen}]
    jtrace = [dict(trace[0], prompt={"tokens": jnp.asarray(trace[0]["prompt"]["tokens"].numpy())})]
    alone = _isolated(tmodel, tparams, trace)[0]
    tsched, got = _port_run(tmodel, tparams, trace, slots=2, chunked_prefill=True, chunk_size=8)
    jsched, want = _jax_run(jmodel, jparams, jtrace, slots=2, chunked_prefill=True, chunk_size=8)
    assert any(off + length > cfg.window for off, length in chunk_schedule(plen, 8))
    np.testing.assert_array_equal(got[0], alone)
    np.testing.assert_array_equal(got[0], want[0])
    assert tsched.stats.prefill_chunks == jsched.stats.prefill_chunks == len(chunk_schedule(plen, 8))


def test_chunked_equals_monolithic_scheduler(models, traces):
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    trace = traces["internlm2-1.8b"]["tt"]
    _, mono = _port_run(tmodel, tparams, trace)
    sched, chunked = _port_run(tmodel, tparams, trace, chunked_prefill=True, chunk_size=CHUNK)
    for rid in mono:
        np.testing.assert_array_equal(mono[rid], chunked[rid])
    assert sched.stats.prefill_chunks >= len(trace)


def test_chunk_size_is_clamped_to_the_ring(models):
    _, _, tmodel, tparams = models["h2o-danube-3-4b"]
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=60, batch=1), device=CPU)
    jmodel, jparams = models["h2o-danube-3-4b"][:2]
    jengine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=60, batch=1))
    assert engine.supports_chunked_prefill and not engine.chunk_prefill_staged
    assert ContinuousScheduler(engine, chunked_prefill=True, chunk_size=128).chunk_size == \
        JaxScheduler(jengine, chunked_prefill=True, chunk_size=128).chunk_size == tmodel.cfg.window


def test_decode_progresses_while_a_long_prompt_prefills(models):
    """While a long prompt trickles in chunk by chunk, the decoding request
    emits one token per tick, and the prefilling slot stays masked (pos -1)."""
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    cfg = tmodel.cfg
    short = Request(rid=0, prompt=make_prompt(cfg, seq=4, seed=1, device=CPU), max_new_tokens=20)
    long_req = Request(rid=1, prompt=make_prompt(cfg, seq=16, seed=2, device=CPU), max_new_tokens=2, arrival=2.0)
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=36, batch=2), device=CPU)
    sched = ContinuousScheduler(engine, chunked_prefill=True, chunk_size=4)
    sched.submit(short)
    sched.submit(long_req)
    sched.warmup()
    tokens_during, prefilling_ticks = 0, 0
    while sched.pending() and long_req.state != FINISHED:
        before = len(short.out)
        sched.step()
        if long_req.state == PREFILLING:
            prefilling_ticks += 1
            tokens_during += len(short.out) - before
            assert sched.pool.positions[long_req.slot] == -1
            assert int(sched.pool.pos_vector()[long_req.slot]) == -1
            assert (sched.pool.cache["layers"][0]["pos"][long_req.slot] >= 0).sum() == 4 * long_req.chunk_idx
        assert sched.tick < 100
    assert prefilling_ticks >= 3 and tokens_during >= 3
    assert long_req.state in (DECODING, FINISHED)


def test_prefilling_slot_progress_is_tracked(models):
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    req = Request(rid=0, prompt=make_prompt(tmodel.cfg, seq=10, seed=3, device=CPU), max_new_tokens=6)
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=16, batch=2), device=CPU)
    sched = ContinuousScheduler(engine, chunked_prefill=True, chunk_size=4)
    sched.submit(req)
    sched.warmup()
    sched.step()  # admits + first chunk
    assert req.state == PREFILLING and req.chunks == chunk_schedule(10, 4) and req.chunk_idx == 1
    assert sched.pool.n_active == 1 and int(sched.pool.pos_vector()[req.slot]) == -1
    while req.state == PREFILLING:
        sched.step()
    # the last-chunk tick also decodes once, so the slot is one past the prompt
    assert req.state == DECODING and int(sched.pool.pos_vector()[req.slot]) == 11
    assert req.chunk_idx == len(req.chunks) and req.staging is None


def test_chunk_budget_controls_prefill_rate_and_ticks_are_not_idle(models):
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    ticks = {}
    for budget in (1, 2):
        req = Request(rid=0, prompt=make_prompt(tmodel.cfg, seq=16, seed=4, device=CPU), max_new_tokens=1)
        engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=20, batch=1), device=CPU)
        sched = ContinuousScheduler(engine, chunked_prefill=True, chunk_size=4, chunk_budget=budget)
        sched.run([req])
        ticks[budget] = sched.stats.ticks
        assert sched.stats.prefill_chunks == 4 and sched.stats.idle_ticks == 0
    assert ticks == {1: 4, 2: 2}


def test_scheduler_rejects_bad_chunk_args(models):
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=8, batch=1), device=CPU)
    with pytest.raises(ValueError, match="chunk_size"):
        ContinuousScheduler(engine, chunked_prefill=True, chunk_size=0)
    with pytest.raises(ValueError, match="chunk_budget"):
        ContinuousScheduler(engine, chunked_prefill=True, chunk_budget=0)


def test_chunked_run_counts_prefill_chunk_steps(models):
    from repro_torch.obs import metrics as tmetrics

    _, _, tmodel, tparams = models["internlm2-1.8b"]
    tmetrics.reset()
    req = Request(rid=0, prompt=make_prompt(tmodel.cfg, seq=11, seed=5, device=CPU), max_new_tokens=3)
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=14, batch=2), device=CPU)
    sched = ContinuousScheduler(engine, chunked_prefill=True, chunk_size=4)
    sched.run([req])
    steps = {k: v for k, v in tmetrics.get_registry().snapshot()["counters"].items() if k.startswith("engine.steps")}
    # chunks 4 + 4 + 2 + 1, and warmup's one dummy chunk for each of the lengths 4, 2 and 1
    assert steps == {'engine.steps{phase="decode"}': 1 + sched.stats.decode_steps,
                     'engine.steps{phase="prefill_chunk"}': 4 + 3}


# -- the KV pool's slot-view primitives -------------------------------------------------


def test_gather_write_slot_round_trip(models):
    _, _, tmodel, _ = models["internlm2-1.8b"]
    pool = KVPool(tmodel, n_slots=3, max_len=8, device=CPU)
    before = [t.clone() for t in _tensors(pool.cache)]
    view = pool.gather_slot(1)
    assert all(t.shape[0] == 1 for t in _tensors(view))
    pool.write_slot(1, view, next_pos=None)
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(pool.cache)))
    assert pool.positions[1] == -1  # next_pos=None keeps the slot masked
    pool.write_slot(1, view, next_pos=5)
    assert pool.positions[1] == 5
    with pytest.raises(ValueError):
        pool.gather_slot(3)
    with pytest.raises(ValueError):
        pool.write_slot(0, pool.cache, next_pos=None)  # not batch-1


# -- the long-prompt trace ------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_short=2, short_prompt=8, short_gen=28, long_prompt=160, seed=0),
    dict(n_short=3, long_prompt=40, n_long=2, seed=4),
    dict(n_short=1, long_prompt=30, n_long=3, shared_prefix=12, long_arrival=5.0, seed=2),
    dict(n_short=2, short_prompt=5, long_prompt=20, shared_prefix=20, seed=9),
])
def test_adversarial_trace_equals_jax(models, kw):
    jmodel, _, tmodel, _ = models["internlm2-1.8b"]
    jt = jax_make_adversarial_trace(jmodel.cfg, **kw)
    tt = make_adversarial_trace(tmodel.cfg, device=CPU, **kw)
    assert len(jt) == len(tt) == kw["n_short"] + kw.get("n_long", 1)
    for j, t in zip(jt, tt):
        assert (j["rid"], j["arrival"], j["max_new_tokens"]) == (t["rid"], t["arrival"], t["max_new_tokens"])
        assert t["prompt"]["tokens"].dtype == torch.int32 and t["prompt"]["tokens"].device.type == CPU
        np.testing.assert_array_equal(np.asarray(j["prompt"]["tokens"]), t["prompt"]["tokens"].numpy())
    if kw.get("shared_prefix"):
        longs = [t["prompt"]["tokens"][0, : kw["shared_prefix"]] for t in tt[kw["n_short"]:]]
        assert all(torch.equal(p, longs[0]) for p in longs)


@pytest.mark.parametrize("kw,match", [(dict(n_short=0), "n_short"), (dict(n_short=1, n_long=0), "n_long"),
                                      (dict(n_short=1, long_prompt=4, shared_prefix=5), "shared_prefix")])
def test_adversarial_trace_refuses_what_jax_refuses(models, kw, match):
    jmodel, _, tmodel, _ = models["internlm2-1.8b"]
    with pytest.raises(ValueError, match=match):
        jax_make_adversarial_trace(jmodel.cfg, **kw)
    with pytest.raises(ValueError, match=match):
        make_adversarial_trace(tmodel.cfg, device=CPU, **kw)


def test_long_prompt_trace_monolithic_equals_chunked_equals_jax(models):
    """``benchmarks/serve_throughput.run_longprompt`` at its own sizes (2
    short requests of 8 tokens generating 28, one of 160 arriving at tick 2,
    chunks of 16, n_short + 1 slots): identical tokens across the prefill
    modes in the port, equal to the JAX chunked run.  No timing is asserted."""
    jmodel, jparams, tmodel, tparams = models["internlm2-1.8b"]
    kw = dict(n_short=2, short_prompt=8, short_gen=28, long_prompt=160, seed=0)
    tt = make_adversarial_trace(tmodel.cfg, device=CPU, **kw)
    jt = jax_make_adversarial_trace(jmodel.cfg, **kw)
    mono_s, mono = _port_run(tmodel, tparams, tt, slots=3)
    chunk_s, chunked = _port_run(tmodel, tparams, tt, slots=3, chunked_prefill=True, chunk_size=16)
    jsched, want = _jax_run(jmodel, jparams, jt, slots=3, chunked_prefill=True, chunk_size=16)
    for rid in want:
        np.testing.assert_array_equal(mono[rid], chunked[rid])
        np.testing.assert_array_equal(chunked[rid], want[rid])
    assert chunk_s.stats.prefill_chunks == jsched.stats.prefill_chunks == 2 + 10
    assert mono_s.stats.prefill_chunks == 0 and mono_s.stats.tokens_out == chunk_s.stats.tokens_out == 2 * 28 + 4
