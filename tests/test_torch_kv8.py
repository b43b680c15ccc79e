"""The port's kv8 pool (``quantize_kv`` / ``dequantize_kv``,
``KVPool(quantize_kv_cache=True)`` and ``ContinuousScheduler(quantize_kv=True)``)
against the JAX package on the CPU.

The port keeps one cache dict per layer with the slot on axis 0; the
reference stacks layers on axis 0 with the slot on axis 1.  Both take one
absmax scale per (layer, slot, KV head) over the sequence and head-dim axes
-- per (layer, slot) on MLA's latent leaves, which have no head axis -- so
the int8 values and fp32 scales compare bit for bit, layer by layer.
Greedy tokens of the kv8 scheduler equal the JAX kv8 scheduler's token for
token (fp32 SMOKE configs, parameters through ``params_from_jax``, traces
from the same numpy seed).  The kv8-vs-fp gates are the reference's own
(``tests/test_quant.py``): K within 0.05 x max|K| after a decode step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_request_trace as jax_make_request_trace
from repro.models.registry import get_model as jax_get_model
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import KVPool as JaxKVPool
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro.serving.kvpool import dequantize_kv as jax_dequantize_kv
from repro.serving.kvpool import quantize_kv as jax_quantize_kv
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_prompt, make_request_trace
from repro_torch.models.registry import get_model
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace
from repro_torch.serving.kvpool import KVPool, _tensors, dequantize_kv, quantize_kv

CPU = "cpu"
SLOTS = 3
TRACE = dict(n_requests=6, mean_prompt=8, mean_gen=5, rate=0.7, seed=11, max_prompt=12, max_gen=8)


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
    return {arch: _pair(arch) for arch in ("internlm2-1.8b", "h2o-danube-3-4b", "minicpm3-4b")}


def _max_len(trace):
    return max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)


def _stacked_cache(cfg, n_slots, size, seed, dtype):
    """A random cache in the reference's stacked form (numpy): K/V
    (L, B, S, Hkv, hd) with one slot all zeros (a freed slot), positions
    (L, B, S)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_slots, size, cfg.n_kv_heads, cfg.resolved_head_dim)
    k = (rng.standard_normal(shape) * rng.uniform(0.1, 8.0, (1, 1, 1, cfg.n_kv_heads, 1))).astype(dtype)
    v = rng.standard_normal(shape).astype(dtype)
    k[:, -1] = 0
    v[:, -1] = 0
    pos = rng.integers(-1, size, (cfg.n_layers, n_slots, size)).astype(np.int32)
    return {"layers": {"k": k, "v": v, "pos": pos}}


def _per_layer(stacked, to_torch):
    la = stacked["layers"]
    return {"layers": [{name: to_torch(la[name][i]) for name in ("k", "v", "pos")} for i in range(len(la["pos"]))]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b"])
def test_quantize_kv_is_bit_identical_to_jax(models, arch, dtype):
    jmodel, _, tmodel, _ = models[arch]
    cfg = tmodel.cfg
    np_dtype = np.float32
    stacked = _stacked_cache(cfg, 4, 20, seed=7, dtype=np_dtype)
    jdt = jnp.dtype(dtype)
    jcache = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt) if a.dtype == np.float32 else jnp.asarray(a), stacked)
    tdt = getattr(torch, dtype)
    tcache = _per_layer(stacked, lambda a: torch.from_numpy(a.copy()).to(tdt) if a.dtype == np.float32
                        else torch.from_numpy(a.copy()))
    jq = jax_quantize_kv(jcache)
    tq = quantize_kv(tcache)
    for i, layer in enumerate(tq["layers"]):
        for name in ("k", "v"):
            assert layer[name]["qv"].dtype == torch.int8 and layer[name]["qs"].dtype == torch.float32
            assert layer[name]["qs"].shape == (4, 1, cfg.n_kv_heads, 1)  # per slot and head
            np.testing.assert_array_equal(layer[name]["qv"].numpy(), np.asarray(jq["layers"][name]["qv"][i]))
            np.testing.assert_array_equal(layer[name]["qs"].numpy(), np.asarray(jq["layers"][name]["qs"][i]))
            assert (layer[name]["qv"][-1] == 0).all() and (layer[name]["qs"][-1] == 1.0).all()  # the zero slot
        assert layer["pos"] is tcache["layers"][i]["pos"]  # exact, not copied
    jd = jax_dequantize_kv(jq, dtype)
    td = dequantize_kv(tq, tdt)
    for i, layer in enumerate(td["layers"]):
        for name in ("k", "v"):
            assert layer[name].dtype == tdt
            np.testing.assert_array_equal(layer[name].float().numpy(),
                                          np.asarray(jd["layers"][name][i]).astype(np.float32))
        assert layer["pos"] is not tq["layers"][i]["pos"] and torch.equal(layer["pos"], tq["layers"][i]["pos"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_mla_is_bit_identical_to_jax(models, dtype):
    """An MLA latent cache in the reference's stacked form -- c_kv (L, B, S,
    kv_lora), k_rope (L, B, S, rope), positions (L, B, S) -- one slot all
    zeros: one scale per (layer, slot), int8 values and scales equal JAX's."""
    cfg = models["minicpm3-4b"][2].cfg
    m, n_slots, size = cfg.mla, 4, 20
    rng = np.random.default_rng(5)
    lead = (cfg.n_layers, n_slots, size)
    c_kv = (rng.standard_normal((*lead, m.kv_lora_rank)) * rng.uniform(0.1, 8.0, (1, n_slots, 1, 1))).astype(np.float32)
    k_rope = rng.standard_normal((*lead, m.qk_rope_head_dim)).astype(np.float32)
    c_kv[:, -1] = 0
    k_rope[:, -1] = 0
    pos = rng.integers(-1, size, lead).astype(np.int32)
    stacked = {"c_kv": c_kv, "k_rope": k_rope, "pos": pos}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq = jax_quantize_kv({"layers": {k: jnp.asarray(a).astype(jdt) if a.dtype == np.float32 else jnp.asarray(a)
                                     for k, a in stacked.items()}})
    tcache = {"layers": [{k: torch.from_numpy(a[i].copy()).to(tdt) if a.dtype == np.float32
                          else torch.from_numpy(a[i].copy()) for k, a in stacked.items()} for i in range(cfg.n_layers)]}
    tq = quantize_kv(tcache)
    for i, layer in enumerate(tq["layers"]):
        for name in ("c_kv", "k_rope"):
            assert layer[name]["qv"].dtype == torch.int8 and layer[name]["qs"].shape == (n_slots, 1, 1)
            np.testing.assert_array_equal(layer[name]["qv"].numpy(), np.asarray(jq["layers"][name]["qv"][i]))
            np.testing.assert_array_equal(layer[name]["qs"].numpy(), np.asarray(jq["layers"][name]["qs"][i]))
            assert (layer[name]["qv"][-1] == 0).all() and (layer[name]["qs"][-1] == 1.0).all()
        assert layer["pos"] is tcache["layers"][i]["pos"]
    jd = jax_dequantize_kv(jq, dtype)
    for i, layer in enumerate(dequantize_kv(tq, tdt)["layers"]):
        for name in ("c_kv", "k_rope"):
            np.testing.assert_array_equal(layer[name].float().numpy(),
                                          np.asarray(jd["layers"][name][i]).astype(np.float32))


def test_quantize_kv_rounds_half_to_even():
    x = torch.tensor([[[[2.5, -0.5, 127.0, 1.5]]]])  # absmax 127: scale 1, x / scale exact
    q = quantize_kv({"k": x})["k"]
    assert q["qv"].flatten().tolist() == [2, 0, 127, 2]
    assert q["qs"].item() == 1.0


def _prefilled(model, params, seq, seed, max_len):
    return model.prefill(params, make_prompt(model.cfg, seq=seq, seed=seed, device=CPU), max_len=max_len)[1]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b", "minicpm3-4b"])
def test_kv8_bytes_report_equals_jax(models, arch):
    jmodel, _, tmodel, tparams = models[arch]
    pool = KVPool(tmodel, 3, 40, quantize_kv_cache=True, device=CPU)
    jpool = JaxKVPool(jmodel, 3, 40, quantize_kv_cache=True)
    cfg = tmodel.cfg
    size = min(40, cfg.window) if cfg.attention == "swa" else 40
    if cfg.attention == "mla":  # int8 latents, one fp32 scale per slot for c_kv and for k_rope
        want = cfg.n_layers * 3 * (size * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) + 2 * 4 + size * 4)
    else:
        want = cfg.n_layers * 3 * (2 * size * cfg.n_kv_heads * cfg.resolved_head_dim + 2 * cfg.n_kv_heads * 4
                                   + size * 4)
    assert pool.bytes_resident() == jpool.bytes_resident() == want
    assert pool.bytes_report() == jpool.bytes_report() == {"reserved": want, "live": 0}
    for seq, seed in ((12, 1), (36, 2), (5, 3)):
        slot, jslot = pool.alloc(), jpool.alloc()
        pool.write_prefill(slot, _prefilled(tmodel, tparams, seq, seed, 40), seq)
        jpool.positions[jslot] = seq  # the report reads positions and shapes only
        pool.advance([slot])
        jpool.advance([jslot])
        assert pool.bytes_report() == jpool.bytes_report()
    fp = KVPool(tmodel, 3, 40, device=CPU)
    assert fp.bytes_resident() > pool.bytes_resident()


def test_kv8_pool_is_narrow_and_a_freed_slot_reads_zeros(models):
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    pool = KVPool(tmodel, 2, 16, quantize_kv_cache=True, device=CPU)
    resident = list(_tensors(pool._qcache))
    assert {t.dtype for t in resident} == {torch.int8, torch.float32, torch.int32}
    assert all((layer["pos"] == -1).all() for layer in pool.cache["layers"])
    slot = pool.alloc()
    pool.write_prefill(slot, _prefilled(tmodel, tparams, 6, 1, 16), 6)
    assert pool.positions[slot] == 6
    assert all((layer["pos"][slot, :6] >= 0).all() and (layer["k"][slot] != 0).any() for layer in pool.cache["layers"])
    pool.free(slot)
    for layer in pool.cache["layers"]:
        assert (layer["pos"][slot] == -1).all()
        assert (layer["k"][slot] == 0).all() and (layer["v"][slot] == 0).all()
    for layer in pool._qcache["layers"]:
        assert (layer["k"]["qv"][slot] == 0).all() and (layer["k"]["qs"][slot] == 1.0).all()


def test_kv8_cache_reads_are_fresh_copies(models):
    """An in-place write into the tree ``cache`` returns does not reach the
    resident pool until it is assigned back."""
    _, _, tmodel, _ = models["internlm2-1.8b"]
    pool = KVPool(tmodel, 2, 8, quantize_kv_cache=True, device=CPU)
    tree = pool.cache
    tree["layers"][0]["k"].fill_(3.0)
    tree["layers"][0]["pos"].fill_(2)
    assert (pool.cache["layers"][0]["k"] == 0).all() and (pool.cache["layers"][0]["pos"] == -1).all()
    pool.cache = tree
    assert (pool.cache["layers"][0]["k"] == 3.0).all() and (pool.cache["layers"][0]["pos"] == 2).all()


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "minicpm3-4b"])
def test_kv8_decode_close_to_fp(models, arch):
    """The reference's payload gate: after one decode step from the same
    prefill, the kv8 pool's K (MLA: the latent c_kv) is within 0.05 x max|K|
    of the fp pool's."""
    _, _, tmodel, tparams = models[arch]
    name = "c_kv" if tmodel.cfg.attention == "mla" else "k"
    eng = ServeEngine(tmodel, tparams, ServeConfig(max_len=32, batch=2), device=CPU)
    prompt = make_prompt(tmodel.cfg, seq=6, seed=8, device=CPU)
    first, cache_one = eng.prefill_request(prompt)
    pools = [KVPool(tmodel, 2, 32, quantize_kv_cache=q, device=CPU) for q in (False, True)]
    for pool in pools:
        pool.write_prefill(pool.alloc(), cache_one, 6)
    toks = first.repeat(2, 1)
    outs = [eng.decode_slots(toks, pool.cache, pool.pos_vector()) for pool in pools]
    for (_, c_fp), (_, c_q) in ((outs[0], outs[1]),):
        for l_fp, l_q in zip(c_fp["layers"], c_q["layers"]):
            k_fp, k_q = l_fp[name], l_q[name]
            assert k_fp.shape == k_q.shape
            assert (k_fp - k_q).abs().max() < 0.05 * (k_fp.abs().max() + 1e-9)
            assert torch.equal(l_fp["pos"], l_q["pos"])


def _port_run(tmodel, tparams, trace, **kw):
    engine = ServeEngine(tmodel, tparams, ServeConfig(max_len=_max_len(trace), batch=SLOTS), device=CPU)
    sched = ContinuousScheduler(engine, **kw)
    return sched, sched.run(requests_from_trace(trace))


def _jax_run(jmodel, jparams, trace, **kw):
    engine = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=_max_len(trace), batch=SLOTS))
    sched = JaxScheduler(engine, **kw)
    return sched, {rid: np.asarray(t) for rid, t in sched.run(jax_requests_from_trace(trace)).items()}


def test_kv8_scheduler_end_to_end(models):
    """The reference's own: a kv8 continuous run drains and gives the full
    token budget."""
    _, _, tmodel, tparams = models["internlm2-1.8b"]
    trace = make_request_trace(tmodel.cfg, n_requests=4, mean_prompt=6, mean_gen=4, rate=1.0, seed=0, max_prompt=8,
                               max_gen=4, device=CPU)
    sched, results = _port_run(tmodel, tparams, trace, quantize_kv=True)
    assert sched.quantize_kv and sched.pool.quantize_kv
    assert len(results) == 4
    for t in trace:
        assert results[t["rid"]].shape[0] == t["max_new_tokens"]
    assert sched.pool.n_free == SLOTS and (sched.pool.positions == -1).all()


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("policy", ["continuous", "gang"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b", "minicpm3-4b"])
def test_kv8_scheduler_tokens_equal_jax(models, arch, policy, chunked):
    jmodel, jparams, tmodel, tparams = models[arch]
    kw = dict(policy=policy, quantize_kv=True, chunked_prefill=chunked, chunk_size=4)
    tsched, got = _port_run(tmodel, tparams, make_request_trace(tmodel.cfg, device=CPU, **TRACE), **kw)
    jsched, want = _jax_run(jmodel, jparams, jax_make_request_trace(jmodel.cfg, **TRACE), **kw)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    for key in ("ticks", "decode_steps", "idle_ticks", "prefill_chunks", "tokens_out", "kv_bytes_resident"):
        assert ts[key] == js[key], key


def test_kv8_w8a8_scheduler_tokens_equal_jax(models):
    """kv8 over the w8a8 model quantized from the same fp32 masters in each
    package: identical greedy tokens."""
    jmodel, jparams, tmodel, _ = models["internlm2-1.8b"]
    jq = jquant.quantize_params(jparams)
    tq = quant.k_major(quant.quantize_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU, dtype=torch.float32)))
    with jquant.use_act_quant("int8"):
        _, want = _jax_run(jmodel, jq, jax_make_request_trace(jmodel.cfg, **TRACE), quantize_kv=True)
    with quant.use_act_quant("int8"):
        _, got = _port_run(tmodel, tq, make_request_trace(tmodel.cfg, device=CPU, **TRACE), quantize_kv=True)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
