"""The modality frontends and tied embeddings served -- musicgen-medium
(audio), internvl2-1b (vlm) and internvl2-1b with a tied head -- through the
continuous, chunked, kv8 and paged schedulers and quantized, against the JAX
package on the CPU.

The fp32 SMOKE models of ``test_torch_frontends.py`` (parameters from the JAX
``model.init(PRNGKey(0))`` through ``params_from_jax``; request traces from
the same numpy seed in both packages; a vit request's prompt holds its
patches and at least one text token).  Gates: per request, the port
scheduler's greedy tokens (each codebook's for audio) equal the JAX
scheduler's and the port's isolated ``generate()``, and the tick-count
statistics and resident bytes equal JAX's -- continuous, gang, audio chunked,
kv8 and paged (audio with the prefix cache too); the vit frontend's chunked
and prefix-cache requests warn and run monolithically as JAX's do; a vit
request's cache positions and budget count its patches as JAX's do; w8a16 /
w8a8 greedy tokens equal JAX's with the frontends' weights left wide; and
``launch/serve.py``'s layer-by-layer quantized init equals the whole
model's, bit for bit; ``KVPool.active_slots`` is JAX's.
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
from repro.serving import Request as JaxRequest
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch, make_request_trace
from repro_torch.launch import serve
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import cast_params
from repro_torch.quant.qarray import QArray
from repro_torch.serving import ContinuousScheduler, KVPool, PagedKVPool, Request, ServeConfig, ServeEngine
from repro_torch.serving import requests_from_trace

CPU = "cpu"
SERVED = {"audio": ("musicgen-medium", {}), "vlm": ("internvl2-1b", {}),
          "tied-vlm": ("internvl2-1b", dict(tie_embeddings=True))}
TRACE = dict(n_requests=4, mean_prompt=6, mean_gen=4, rate=0.7, seed=3, min_prompt=3, max_prompt=9, max_gen=6)
# A vit prompt of p positions holds the SMOKE model's 8 patches and p - 8 text tokens.
VLM_TRACE = dict(TRACE, mean_prompt=12, min_prompt=9, max_prompt=16)
SLOTS = 2
TICK_STATS = ("ticks", "decode_steps", "idle_ticks", "tokens_out", "mean_occupancy", "requests_finished")


@pytest.fixture(scope="module")
def pair():
    """pair(name) -> (JAX model, its parameters, the port's model, the
    carried parameters) of the fp32 SMOKE config, built once per module."""
    built = {}

    def get(name):
        if name not in built:
            arch, over = SERVED[name]
            jmodel = jax_get_model(dataclasses.replace(jax_get_smoke(arch), dtype="float32", **over))
            tmodel = get_model(dataclasses.replace(configs.get_smoke(arch), dtype="float32", **over))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            built[name] = (jmodel, jparams, tmodel,
                           params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU))
        return built[name]

    return get


def _prefix(cfg):
    return cfg.n_patches if cfg.frontend == "vit" else 0


def _max_len(trace, cfg):
    """The launcher's: the longest request's tokens and generation, and a vit
    request's patches (the reference's launch/serve.py too)."""
    return max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace) + _prefix(cfg)


def _traces(pair, name):
    jmodel, _, tmodel, _ = pair(name)
    kw = VLM_TRACE if tmodel.cfg.frontend == "vit" else TRACE
    return jax_make_request_trace(jmodel.cfg, **kw), make_request_trace(tmodel.cfg, device=CPU, **kw)


def _port_run(tmodel, tparams, trace, **kw):
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=_max_len(trace, tmodel.cfg), batch=SLOTS), device=CPU)
    sched = ContinuousScheduler(engine, **kw)
    return sched, sched.run(requests_from_trace(trace))


def _jax_run(jmodel, jparams, trace, **kw):
    engine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=_max_len(trace, jmodel.cfg), batch=SLOTS))
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
            max_len = _max_len(trace, tmodel.cfg)
            built[name] = {t["rid"]: ServeEngine(tmodel, tparams, ServeConfig(max_len=max_len, batch=1),
                                                 device=CPU).generate(t["prompt"], t["max_new_tokens"])[0].numpy()
                           for t in trace}
        return built[name]

    return get


def _check_equal_runs(tsched, got, jsched, want, trace, alone=None):
    for t in trace:
        np.testing.assert_array_equal(got[t["rid"]], want[t["rid"]])
        assert got[t["rid"]].shape[0] == t["max_new_tokens"]
        if alone is not None:
            np.testing.assert_array_equal(got[t["rid"]], alone[t["rid"]])
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    keys = (*TICK_STATS, "prefill_chunks", "kv_bytes_resident", "prefix_hits", "prefix_hit_tokens", "preempted")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert tsched.pool.n_free == SLOTS


RUNS = [
    ("audio", "continuous", dict(policy="continuous")),
    ("audio", "gang", dict(policy="gang")),
    ("audio", "chunked", dict(chunked_prefill=True, chunk_size=4)),
    ("vlm", "continuous", dict(policy="continuous")),
    ("tied-vlm", "continuous", dict(policy="continuous")),
]


@pytest.mark.parametrize("name,mode,kw", RUNS, ids=[f"{n}-{m}" for n, m, _ in RUNS])
def test_scheduler_equals_jax_and_isolated(pair, isolated, name, mode, kw):
    """Per request, the port scheduler's greedy tokens equal the JAX
    scheduler's and the port's isolated generate(); the tick-count
    statistics, prefill chunks and resident bytes equal JAX's."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jt, tt = _traces(pair, name)
    tsched, got = _port_run(tmodel, tparams, tt, **kw)
    jsched, want = _jax_run(jmodel, jparams, jt, **kw)
    _check_equal_runs(tsched, got, jsched, want, tt, isolated(name, tt))
    if tmodel.cfg.frontend == "audio_codec":
        assert tsched._slot_tok.shape == (SLOTS, 1, tmodel.cfg.n_codebooks)


POOLS = [
    ("audio", "kv8", dict(quantize_kv=True)),
    ("vlm", "kv8", dict(quantize_kv=True)),
    ("audio", "paged", dict(paged=True, page_size=4)),
    ("audio", "paged-prefix-chunked", dict(paged=True, page_size=2, prefix_cache=True, chunked_prefill=True,
                                           chunk_size=4)),
    ("vlm", "paged", dict(paged=True, page_size=4)),
    ("tied-vlm", "kv8", dict(quantize_kv=True)),
]


@pytest.mark.parametrize("name,mode,kw", POOLS, ids=[f"{n}-{m}" for n, m, _ in POOLS])
def test_kv8_and_paged_equal_jax(pair, name, mode, kw):
    """The int8 pool and the paged pool (pages of 4; audio also pages of 2
    with the prefix cache, chunked): tokens, tick statistics, prefix hits and
    resident bytes as JAX's."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jt, tt = _traces(pair, name)
    tsched, got = _port_run(tmodel, tparams, tt, **kw)
    jsched, want = _jax_run(jmodel, jparams, jt, **kw)
    _check_equal_runs(tsched, got, jsched, want, tt)
    assert (tsched.quantize_kv, tsched.paged) == (jsched.quantize_kv, jsched.paged) == (
        kw.get("quantize_kv", False), kw.get("paged", False))
    if tsched.paged:
        assert isinstance(tsched.pool, PagedKVPool) and tsched.pool.validate() == []


def test_audio_prefix_cache_hits_equal_jax(pair):
    """Two audio requests sharing their first six frames (every codebook):
    the second maps the first's pages and prefills only its suffix, in both
    packages, with the same tokens."""
    jmodel, jparams, tmodel, tparams = pair("audio")
    cfg = tmodel.cfg
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, (1, 6, cfg.n_codebooks), dtype=np.int32)
    toks = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, (1, n, cfg.n_codebooks), dtype=np.int32)], 1)
            for n in (3, 2)]
    kw = dict(paged=True, page_size=2, prefix_cache=True)
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=16, batch=SLOTS), device=CPU)
    tsched = ContinuousScheduler(engine, **kw)
    got = tsched.run([Request(rid=i, prompt={"tokens": torch.from_numpy(t)}, max_new_tokens=4, arrival=2.0 * i)
                      for i, t in enumerate(toks)])
    jengine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=16, batch=SLOTS))
    jsched = JaxScheduler(jengine, **kw)
    want = jsched.run([JaxRequest(rid=i, prompt={"tokens": jax.numpy.asarray(t)}, max_new_tokens=4, arrival=2.0 * i)
                       for i, t in enumerate(toks)])
    for i in range(2):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    assert ts["prefix_hits"] == js["prefix_hits"] >= 1
    assert ts["prefix_hit_tokens"] == js["prefix_hit_tokens"] > 0


def test_vit_chunked_and_prefix_cache_warn_and_run_monolithic_as_jax(pair):
    """The vit frontend's prompts are neither chunked nor prefix-cached: the
    options warn as JAX's do, and the run is the monolithic one, JAX's tokens
    and statistics."""
    jmodel, jparams, tmodel, tparams = pair("vlm")
    jt, tt = _traces(pair, "vlm")
    kw = dict(chunked_prefill=True, chunk_size=4, paged=True, page_size=4, prefix_cache=True)
    with pytest.warns(UserWarning) as rec:
        tsched, got = _port_run(tmodel, tparams, tt, **kw)
    with pytest.warns(UserWarning) as jrec:
        jsched, want = _jax_run(jmodel, jparams, jt, **kw)
    assert [str(w.message) for w in rec] == [str(w.message) for w in jrec]
    assert "not chunkable" in str(rec[0].message) and "prefix cache disabled" in str(rec[1].message)
    assert not tsched.chunked_prefill and tsched.pool.prefix is None and tsched.paged
    _check_equal_runs(tsched, got, jsched, want, tt)
    assert tsched.stats.summary()["prefill_chunks"] == 0


def test_vit_positions_and_budget_count_the_patches_as_jax(pair):
    jmodel, jparams, tmodel, tparams = pair("vlm")
    jb = jax_make_batch(jmodel.cfg, batch=1, seq=12, kind="prefill", seed=2)
    tb = make_batch(tmodel.cfg, batch=1, seq=12, kind="prefill", seed=2, device=CPU)
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=15, batch=SLOTS), device=CPU)
    jengine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=15, batch=SLOTS))
    assert engine.prompt_positions(tb) == jengine.prompt_positions(jb) == 12
    # 4 text tokens + 8 patches + 3 generated fit 15 positions; 4 do not
    for gen, fits in ((3, True), (4, False)):
        sched, jsched = ContinuousScheduler(engine), JaxScheduler(jengine)
        req, jreq = Request(rid=0, prompt=tb, max_new_tokens=gen), JaxRequest(rid=0, prompt=jb, max_new_tokens=gen)
        if fits:
            sched.submit(req)
            jsched.submit(jreq)
        else:
            with pytest.raises(ValueError, match="exceeds max_len"):
                sched.submit(req)
            with pytest.raises(ValueError, match="exceeds max_len"):
                jsched.submit(jreq)


# -- quantized serving --------------------------------------------------------------------------


def _wide_frontends(tq, cfg):
    if cfg.frontend == "audio_codec":
        assert not isinstance(tq["embed"]["tables"], QArray) and not isinstance(tq["lm_head"]["w"], QArray)
    if cfg.frontend == "vit":
        assert not any(isinstance(tq["projector"][k], QArray) for k in ("w1", "w2"))
    if cfg.tie_embeddings:
        assert "lm_head" not in tq and not isinstance(tq["embed"]["table"], QArray)
    assert isinstance(tq["layers"][0]["attn"]["wq"], QArray) and isinstance(tq["layers"][0]["ffn"]["w_up"], QArray)


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("name", list(SERVED))
def test_quantized_greedy_tokens_equal_jax(pair, name, mode):
    """Parameters quantized in JAX and carried over: the layers' projections
    (and an untied text head) int8; the codebook tables and heads, the
    projector and a tied table wide, as the reference leaves them.  Eight
    greedy tokens through both ServeEngines, identical."""
    jmodel, jparams, tmodel, _ = pair(name)
    jq = jquant.quantize_params(jparams)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), tmodel.cfg, device=CPU)
    _wide_frontends(tq, tmodel.cfg)
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=12, kind="prefill", seed=5)
    tb = make_batch(tmodel.cfg, batch=2, seq=12, kind="prefill", seed=5, device=CPU)
    max_len = 20 + _prefix(tmodel.cfg)
    if mode == "w8a8":
        tq = quant.k_major(tq)
        with jquant.use_act_quant("int8"):
            want = JaxServeEngine(jmodel, jq, JaxServeConfig(max_len=max_len, batch=2)).generate(jb, 8)
        with quant.use_act_quant("int8"):
            got = ServeEngine(tmodel, tq, ServeConfig(max_len=max_len, batch=2), device=CPU).generate(tb, 8)
    else:
        want = JaxServeEngine(jmodel, jq, JaxServeConfig(max_len=max_len, batch=2)).generate(jb, 8)
        got = ServeEngine(tmodel, tq, ServeConfig(max_len=max_len, batch=2), device=CPU).generate(tb, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("name", list(SERVED))
def test_layer_by_layer_init_equals_whole_model_quantize(name, mode):
    """``init_params`` quantizes and casts each top-level piece as it is
    drawn (the codebook tables and heads, the projector): the tree equals
    the whole model's fp32 masters quantized and cast, bit for bit, the
    frontends' weights wide."""
    arch, over = SERVED[name]
    model = get_model(dataclasses.replace(configs.get_smoke(arch), **over))
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
    _wide_frontends(got, model.cfg)
    tb = make_batch(model.cfg, batch=1, seq=12, kind="prefill", seed=0, device=CPU)
    with ctx:
        logits, _ = model.prefill(got, tb, max_len=16)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-1b"])
def test_launcher_serves_the_frontends(arch, capsys):
    """``launch/serve.py`` on the SMOKE models: synchronized (the cache
    holds a vit prompt's patches beside its generation) and continuous (a
    vit prompt's patches before the trace's text lengths)."""
    cfg = configs.get_smoke(arch)
    sample = serve.main(["--arch", arch, "--smoke", "--device", CPU, "--batch", "2", "--prompt-len", "12",
                         "--gen", "4"])
    assert tuple(sample.shape) == ((2, 4, cfg.n_codebooks) if cfg.frontend == "audio_codec" else (2, 4))
    out = serve.main(["--arch", arch, "--smoke", "--device", CPU, "--continuous", "--requests", "3", "--slots", "2",
                      "--mean-prompt", "5", "--prompt-len", "8", "--gen", "4"])
    assert sorted(out) == [0, 1, 2]
    assert "continuous[continuous] 3 requests" in capsys.readouterr().out


def test_kv_pool_active_slots_equal_jax(pair):
    """``KVPool.active_slots`` (the reference's, uncalled there) lists the
    allocated slots in slot order, as JAX's does through a slot's life."""
    jmodel, _, tmodel, _ = pair("audio")
    pool, jpool = KVPool(tmodel, 3, 8, device=CPU), JaxKVPool(jmodel, 3, 8)
    assert pool.active_slots() == jpool.active_slots() == []
    got = [pool.alloc(), pool.alloc()]
    want = [jpool.alloc(), jpool.alloc()]
    assert got == want and pool.active_slots() == jpool.active_slots() == sorted(got)
    pool.free(got[0])
    jpool.free(want[0])
    assert pool.active_slots() == jpool.active_slots() == [got[1]]
