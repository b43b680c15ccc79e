"""The port's paged continuous scheduler (``ContinuousScheduler(paged=True,
prefix_cache=True, n_pages=...)``) against the JAX package's on the CPU, in
the style of ``tests/test_paged_diff.py``.

fp32 SMOKE configs of the three cache layouts -- internlm2-1.8b (GQA),
h2o-danube-3-4b (the SWA ring: its traces outgrow the 32-row window, so
decode writes wrap into shared prefix pages and copy them first) and
minicpm3-4b (MLA latents) -- with parameters from the JAX ``model.init``
through ``params_from_jax`` and traces from the same numpy seeds.  Gates:

  * paged == unpaged (the slot pool, the bit-exactness oracle) == each
    request alone through ``generate()``, token for token;
  * the port's paged scheduler == the JAX paged scheduler: per-request
    tokens, and ticks, decode steps, prefix hits, hit tokens, preemptions
    and tokens out; monolithic and chunked, on random and shared-prefix
    traces, under kv8 (int8 values and per-page scales equal JAX's bit for
    bit at the end of the run) and in w8a8;
  * an undersized arena forces reclaim and preemption without changing a
    token, and every request's obs timeline validates; an arena smaller
    than one slot fails loudly;
  * ``validate() == []`` and the null page still 0 / -1 after every run.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_adversarial_trace as jax_make_adversarial_trace
from repro.data.synthetic import make_request_trace as jax_make_request_trace
from repro.data.synthetic import make_shared_prefix_trace as jax_make_shared_prefix_trace
from repro.models.registry import get_model as jax_get_model
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_adversarial_trace, make_request_trace, make_shared_prefix_trace
from repro_torch.models.registry import get_model
from repro_torch.obs import trace as ttrace
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace

CPU = "cpu"
ARCHS = ["internlm2-1.8b", "h2o-danube-3-4b", "minicpm3-4b"]
SLOTS = 3
PAGED = dict(paged=True, page_size=8, prefix_cache=True)
CHUNKED = dict(chunked_prefill=True, chunk_size=4)
# Per arch: max_len, a random trace and a shared-prefix trace.  danube's
# prompts and generations outgrow its 32-row ring.
TRACES = {
    "internlm2-1.8b": (24, dict(n_requests=5, mean_prompt=8, mean_gen=4, rate=0.7, min_prompt=4, max_prompt=10,
                                max_gen=6),
                       dict(n_requests=5, prefix_len=10, suffix_len=3, gen=4, n_groups=2, rate=0.8)),
    "h2o-danube-3-4b": (48, dict(n_requests=5, mean_prompt=20, mean_gen=8, rate=0.7, max_prompt=30, max_gen=12),
                        dict(n_requests=5, prefix_len=20, suffix_len=4, gen=16, n_groups=2, rate=0.8)),
    "minicpm3-4b": (24, dict(n_requests=5, mean_prompt=8, mean_gen=4, rate=0.7, min_prompt=4, max_prompt=10,
                             max_gen=6),
                    dict(n_requests=5, prefix_len=10, suffix_len=3, gen=4, n_groups=2, rate=0.8)),
}
COUNTS = ("ticks", "decode_steps", "idle_ticks", "prefill_chunks", "tokens_out", "prefix_hits", "prefix_hit_tokens",
          "preempted", "kv_bytes_resident", "kv_bytes_live", "page_occupancy")

_CTX: dict = {}


def _ctx(arch):
    """(JAX model, JAX params, JAX engine, port model, port params, port
    engine), built once per arch so the JAX runs share their jit caches."""
    if arch not in _CTX:
        jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        jmodel = jax_get_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        tmodel = get_model(tcfg)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
        max_len = TRACES[arch][0]
        _CTX[arch] = (jmodel, jparams, JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=max_len, batch=SLOTS)),
                      tmodel, tparams, ServeEngine(tmodel, tparams, ServeConfig(max_len=max_len, batch=SLOTS),
                                                   device=CPU))
    return _CTX[arch]


def _traces(arch, kind, seed):
    """(port trace, JAX trace) from the same numpy seed."""
    _, random_kw, shared_kw = TRACES[arch]
    cfg = configs.get_smoke(arch)
    if kind == "random":
        return (make_request_trace(cfg, seed=seed, device=CPU, **random_kw),
                jax_make_request_trace(jax_get_smoke(arch), seed=seed, **random_kw))
    return (make_shared_prefix_trace(cfg, seed=seed, device=CPU, **shared_kw),
            jax_make_shared_prefix_trace(jax_get_smoke(arch), seed=seed, **shared_kw))


def _port(engine, trace, **kw):
    sched = ContinuousScheduler(engine, **kw)
    out = sched.run(requests_from_trace(trace))
    if sched.paged:
        _check_pool(sched.pool)
    return sched, out


def _jax(engine, trace, **kw):
    sched = JaxScheduler(engine, **kw)
    out = sched.run(jax_requests_from_trace(trace))
    if kw.get("paged"):
        assert sched.pool.validate() == []
    return sched, {rid: np.asarray(t) for rid, t in out.items()}


def _check_pool(pool):
    assert pool.validate() == []
    for layer in pool.phys["layers"]:
        for name, t in layer.items():
            assert (t[-1] == (-1 if name == "pos" else 0)).all(), f"null page {name}"
    # prefix pages outlive their requests by design; reclaim drains them
    pool.reclaim_prefix_pages(pool.n_pages)
    assert pool.pages_in_use == 0 and pool.validate() == []


def _same(want, got):
    assert set(want) == set(got)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")


def _same_counts(tsched, jsched):
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    for key in COUNTS:
        assert ts[key] == js[key], (key, ts[key], js[key])


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("kind", ["random", "shared"])
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_scheduler_matches_jax_and_the_slot_pool(arch, kind, chunked):
    _, _, jeng, _, _, teng = _ctx(arch)
    ttrace_, jtrace_ = _traces(arch, kind, seed=31)
    mode = CHUNKED if chunked else {}
    _, stripe = _port(teng, ttrace_, **mode)
    tsched, got = _port(teng, ttrace_, **PAGED, **mode)
    jsched, want = _jax(jeng, jtrace_, **PAGED, **mode)
    _same(stripe, got)
    _same(want, got)
    _same_counts(tsched, jsched)
    if kind == "shared":
        # two groups sharing a page-aligned prefix: a later member of a
        # group admitted after the first one's prefill hits its pages
        assert tsched.stats.summary()["prefix_hits"] >= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_scheduler_matches_isolated_generate(arch):
    """Anchor to the model itself: each request alone through the port's
    ``generate()`` gives the paged scheduler's tokens (prefix hits included)."""
    _, _, _, tmodel, tparams, _ = _ctx(arch)
    ttrace_, _ = _traces(arch, "shared", seed=101)
    one = ServeEngine(tmodel, tparams, ServeConfig(max_len=TRACES[arch][0], batch=1), device=CPU)
    teng = _ctx(arch)[5]
    tsched, got = _port(teng, ttrace_, **PAGED)
    assert tsched.stats.summary()["prefix_hits"] >= 1
    for t in ttrace_:
        want = one.generate(t["prompt"], n_steps=t["max_new_tokens"])[0].numpy()
        np.testing.assert_array_equal(got[t["rid"]], want, err_msg=f"rid {t['rid']}")


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "minicpm3-4b"])
def test_kv8_paged_scheduler_matches_jax(arch, chunked):
    """kv8 quantizes per (layer, page[, head]): the port's tokens and counts
    equal JAX's.  The arena after the run: the scale layout is JAX's, the
    int8 values within one step of JAX's and the scales within 1e-6 -- the
    model's fp32 K/V differ from JAX's in the last bits (summation order), so
    a page's absmax may round one ulp apart; on the same inputs the pool is
    JAX's bit for bit (``tests/test_torch_paged.py``)."""
    _, _, jeng, _, _, teng = _ctx(arch)
    ttrace_, jtrace_ = _traces(arch, "shared", seed=7)
    kw = dict(**PAGED, quantize_kv=True, **(CHUNKED if chunked else {}))
    tsched = ContinuousScheduler(teng, **kw)
    got = tsched.run(requests_from_trace(ttrace_))
    jsched, want = _jax(jeng, jtrace_, **kw)
    _same(want, got)
    _same_counts(tsched, jsched)
    assert tsched.stats.summary()["prefix_hits"] >= 1
    jq = jsched.pool._qphys["layers"]
    for l, layer in enumerate(tsched.pool._qphys["layers"]):
        for name, t in layer.items():
            if name == "pos":
                np.testing.assert_array_equal(t.numpy(), np.asarray(jq[name][l]))
                continue
            assert t["qs"].shape[0] == tsched.pool.n_pages + 1  # one scale per page (and head)
            assert t["qs"].shape == jq[name]["qs"][l].shape and t["qv"].dtype == torch.int8
            qv_diff = np.abs(t["qv"].numpy().astype(np.int32) - np.asarray(jq[name]["qv"][l]).astype(np.int32))
            assert qv_diff.max() <= 1, (l, name)
            np.testing.assert_allclose(t["qs"].numpy(), np.asarray(jq[name]["qs"][l]), rtol=1e-6, atol=0,
                                       err_msg=f"layer {l} {name}")
    _check_pool(tsched.pool)


def test_w8a8_paged_scheduler_matches_jax():
    """The paged prefix scheduler over the w8a8 model quantized from the same
    fp32 masters in each package: identical greedy tokens and counts."""
    jmodel, jparams, _, tmodel, _, _ = _ctx("internlm2-1.8b")
    jq = jquant.quantize_params(jparams)
    tq = quant.k_major(quant.quantize_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU, dtype=torch.float32)))
    ttrace_, jtrace_ = _traces("internlm2-1.8b", "shared", seed=5)
    max_len = TRACES["internlm2-1.8b"][0]
    with jquant.use_act_quant("int8"):
        jsched, want = _jax(JaxServeEngine(jmodel, jq, JaxServeConfig(max_len=max_len, batch=SLOTS)), jtrace_,
                            **PAGED)
    with quant.use_act_quant("int8"):
        tsched, got = _port(ServeEngine(tmodel, tq, ServeConfig(max_len=max_len, batch=SLOTS), device=CPU),
                            ttrace_, **PAGED)
    _same(want, got)
    _same_counts(tsched, jsched)


# -- page pressure: reclaim, preemption, and an arena too small ---------------------------

ADVERSARIAL = dict(n_short=3, short_prompt=6, short_gen=20, long_prompt=28, long_gen=3, long_arrival=2.0, n_long=2,
                   shared_prefix=8, seed=0)


@pytest.mark.parametrize("chunked", [False, True])
def test_exhaustion_preempts_without_corrupting_survivors(chunked):
    """An adversarial burst against an undersized arena (ten pages where the
    four slots' stripes would take sixteen): the scheduler reclaims prefix
    pages and preempts by the documented policy (LIFO victim back to the
    queue front), every request still completes with the tokens of an
    unconstrained run -- and of the JAX scheduler, with the same counts --
    and every request's obs timeline validates."""
    jmodel, jparams, _, tmodel, tparams, _ = _ctx("internlm2-1.8b")
    teng = ServeEngine(tmodel, tparams, ServeConfig(batch=4, max_len=32), device=CPU)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(batch=4, max_len=32))
    mode = CHUNKED if chunked else {}
    kw = dict(paged=True, page_size=8, n_pages=10, prefix_cache=True, **mode)
    ttrace.get_tracer().clear()
    sched = ContinuousScheduler(teng, **kw)
    reclaimed = []
    reclaim = sched.pool.reclaim_prefix_pages
    sched.pool.reclaim_prefix_pages = lambda n=1: reclaimed.append(reclaim(n)) or reclaimed[-1]
    trace = make_adversarial_trace(tmodel.cfg, device=CPU, **ADVERSARIAL)
    out = sched.run(requests_from_trace(trace), max_ticks=3000)
    s = sched.stats.summary()
    assert s["preempted"] > 0 and sum(reclaimed) > 0
    doc = ttrace.get_tracer().export_chrome()
    assert "serve.preempt" in {e["name"] for e in doc["traceEvents"]}
    for t in trace:
        assert ttrace.validate_request_timeline(doc, t["rid"]) == []
    _check_pool(sched.pool)
    _, ref = _port(teng, trace, paged=True, page_size=8, **mode)
    _same(ref, out)
    jsched, want = _jax(jeng, jax_make_adversarial_trace(jmodel.cfg, **ADVERSARIAL), **kw)
    _same(want, out)
    for key in ("ticks", "decode_steps", "tokens_out", "prefix_hits", "prefix_hit_tokens", "preempted"):
        assert s[key] == jsched.stats.summary()[key], key


def test_arena_too_small_for_one_request_fails_loudly():
    _, _, _, tmodel, tparams, _ = _ctx("internlm2-1.8b")
    engine = ServeEngine(tmodel, tparams, ServeConfig(batch=2, max_len=32), device=CPU)
    with pytest.raises(ValueError, match="cannot hold even one full slot"):
        ContinuousScheduler(engine, paged=True, page_size=8, n_pages=2)


def test_make_shared_prefix_trace_equals_jax():
    for arch, kw in (("internlm2-1.8b", dict(n_requests=7, prefix_len=33, suffix_len=5, gen=6, n_groups=3, rate=0.4,
                                             seed=9)),
                     ("minicpm3-4b", dict(n_requests=3, prefix_len=4096, suffix_len=64, gen=32, n_groups=2,
                                          rate=0.5, seed=0))):
        got = make_shared_prefix_trace(configs.get_smoke(arch), device=CPU, **kw)
        want = jax_make_shared_prefix_trace(jax_get_smoke(arch), **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["rid"] == w["rid"] and g["arrival"] == w["arrival"] and g["max_new_tokens"] == w["max_new_tokens"]
            assert g["prompt"]["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(g["prompt"]["tokens"].numpy(), np.asarray(w["prompt"]["tokens"]))
        groups = kw["n_groups"]
        for i, g in enumerate(got):  # round-robin groups share their prefix
            ref = got[i % groups]["prompt"]["tokens"][0, : kw["prefix_len"]]
            assert torch.equal(g["prompt"]["tokens"][0, : kw["prefix_len"]], ref)
    with pytest.raises(ValueError):
        make_shared_prefix_trace(configs.get_smoke("internlm2-1.8b"), n_requests=0, prefix_len=4, device=CPU)
