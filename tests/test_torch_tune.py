"""The port's autotuner, plan cache and tuned dispatch against the JAX
package's on the CPU.

* ``tune/cache.py``: schema v2 and the key encoding are the reference's, so a
  file the port writes reads back in ``repro.tune.cache.PlanCache`` key for
  key (and the other way); versioning, corruption and merge-on-write as the
  reference's own tests hold them; the port's own environment variable; the
  dispatchers' memoised table holds only plans the card timed, each resolved
  to its path once, and drops on every store and refresh.
* ``tune/candidates.py``: ``generate`` yields only paths the kernels accept,
  the untuned rule's tile among them, in the reference's analytical order.
* The dispatch precedence of K1, K5 and K4 (``tune.cache.plan_path``, then
  each kernel's ``launch_path``): an explicit plan, then a cached plan the
  operands can take, then the shape rule; a cached path the operands refuse
  gives way to the rule, an explicit one raises.
* ``tune/autotune.py``: deterministic under a stub ``measure_fn``; miss then
  hit; the CLI with ``--device cpu --backend reference``.
* The serving engine's ``decode_gemm_problems`` equals the reference's for
  every config of the zoo; ``consult_decode_plans`` and the report.
"""

import dataclasses
import json

import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.serving.engine import decode_gemm_problems as jax_decode_gemm_problems
from repro.tune import cache as jax_cache
from repro_torch import configs
from repro_torch.core import dse
from repro_torch.core.blocking import BlockPlan
from repro_torch.kernels.grouped import kernel as gk
from repro_torch.kernels.systolic import kernel as mk
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.serving.engine import consult_decode_plans, decode_gemm_problems
from repro_torch.tune import autotune, cache, candidates, measure
from repro_torch.tune.__main__ import main as tune_main
from repro_torch.tune.cache import CacheKey, PlanCache, TunedPlan

BF16 = torch.bfloat16


@pytest.fixture
def cache_path(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    cache.reset_default_cache()
    yield path
    cache.reset_default_cache()


def _plan(bm, bn, bk, us=10.0, method="cuda-events"):
    return TunedPlan(bm=bm, bn=bn, bk=bk, mean_us=us, best_us=us, method=method)


# -- the cache ------------------------------------------------------------------


@pytest.mark.parametrize("fields", [("cuda-systolic", "h100", 2048, 8192, 2048, "bfloat16", "none", 1),
                                    ("cuda-grouped", "h100", 160, 768, 2048, "bfloat16", "none", 1),
                                    ("cuda-systolic", "h100", 4, 2048, 2048, "int8", "gelu", 2)])
def test_key_encoding_is_the_references(fields):
    assert CacheKey(*fields).encode() == jax_cache.CacheKey(*fields).encode()


def test_a_file_the_port_writes_reads_back_in_the_reference(tmp_path):
    path = tmp_path / "plans.json"
    keys = [CacheKey("cuda-systolic", "h100", 2048, 8192, 2048, "bfloat16"),
            CacheKey("cuda-systolic", "h100", 4, 2048, 2048, "bfloat16"),
            CacheKey("cuda-systolic", "h100", 2048, 8192, 2048, "int8"),
            CacheKey("cuda-grouped", "h100", 160, 768, 2048, "bfloat16")]
    plans = [_plan(128, 256, 64, 1.5), _plan(16, 64, 256, 10.2),
             _plan(128, 128, 128, method="stub"), dataclasses.replace(_plan(64, 128, 64), tuned_at=123.0)]
    port = PlanCache(path)
    for k, p in zip(keys, plans):
        port.store(k, p)
    assert json.loads(path.read_text())["version"] == jax_cache.SCHEMA_VERSION == cache.SCHEMA_VERSION
    ref = jax_cache.PlanCache(path)
    assert [k for k, _ in ref.items()] == [k for k, _ in port.items()] == sorted(k.encode() for k in keys)
    for k, p in zip(keys, plans):
        got = ref.lookup(jax_cache.CacheKey(k.backend, k.chip, k.m, k.n, k.k, k.dtype, k.activation, k.tp))
        assert dataclasses.asdict(got) == dataclasses.asdict(p)
    # and back: the reference's store reads in the port
    jk = jax_cache.CacheKey("pallas-systolic", "tpu_v5e", 512, 512, 512, "bfloat16")
    ref.store(jk, jax_cache.TunedPlan(256, 256, 512, 3.0, 2.0, "device-wall"))
    assert PlanCache(path).lookup(CacheKey(*dataclasses.astuple(jk))).bm == 256


def test_cache_versioning_corruption_and_merge(tmp_path):
    path = tmp_path / "plans.json"
    key = CacheKey("cuda-systolic", "h100", 64, 64, 64, "bfloat16")
    path.write_text(json.dumps({"version": 1, "entries": {key.encode(): dataclasses.asdict(_plan(1, 2, 3))}}))
    assert PlanCache(path).lookup(key) is None  # another schema reads as empty
    path.write_text("{not json")
    assert len(PlanCache(path)) == 0
    good = dataclasses.asdict(_plan(128, 128, 64))
    path.write_text(json.dumps({"version": 2, "entries": {key.encode(): good, "x|y": {"bm": "?"}}}))
    assert PlanCache(path).lookup(key).bm == 128 and len(PlanCache(path)) == 1
    a, b = PlanCache(path), PlanCache(path)
    a.lookup(key)
    k2 = dataclasses.replace(key, m=128)
    b.store(k2, _plan(64, 128, 64))
    a.store(dataclasses.replace(key, m=256), _plan(128, 256, 64))  # merge-on-write keeps b's entry
    assert len(PlanCache(path)) == 3


def test_the_ports_variable_and_default_path(cache_path, monkeypatch, tmp_path):
    assert cache.default_cache_path() == cache_path and cache.default_cache().path == cache_path
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "reference.json"))
    assert cache.default_cache_path() == cache_path
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert cache.default_cache_path() == tmp_path / "xdg" / "repro-torch-tune" / "plans.json"


def test_dispatch_table_is_memoised_and_dropped_on_store(cache_path):
    assert cache.tuned_path("cuda-systolic", 4, 2048, 2048, "bfloat16") is None
    table = cache._table
    assert cache.tuned_path("cuda-systolic", 4, 2048, 2048, "bfloat16") is None and cache._table is table
    plan = _plan(16, 64, 256)
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", 4, 2048, 2048, "bfloat16"), plan)
    assert cache._table is None
    assert cache.tuned_path("cuda-systolic", 4, 2048, 2048, "bfloat16") == ("decode", 256, plan)
    assert cache.tuned_path("cuda-systolic", 4, 2048, 2048, "bfloat16", "gelu") is None
    PlanCache(cache_path).store(CacheKey("cuda-systolic", "h100", 8, 64, 64, "bfloat16"), _plan(16, 64, 64))
    cache.default_cache().refresh()
    assert cache.tuned_path("cuda-systolic", 8, 64, 64, "bfloat16").plan.bm == 16
    other_chip = CacheKey("cuda-systolic", "h200", 8, 128, 64, "bfloat16")
    cache.default_cache().store(other_chip, _plan(16, 64, 64))
    assert cache.tuned_path("cuda-systolic", 8, 128, 64, "bfloat16") is None  # dispatch serves the h100
    assert cache.default_cache().lookup(other_chip) is not None
    # a geometry no tile runs on its problem is left out of the table, never re-checked per call
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", 8, 64, 64, "bfloat16"), _plan(96, 96, 96))
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", 32, 64, 64, "bfloat16"), _plan(16, 64, 64))
    assert cache.tuned_path("cuda-systolic", 8, 64, 64, "bfloat16") is None
    assert cache.tuned_path("cuda-systolic", 32, 64, 64, "bfloat16") is None  # M > 16 on the decode tile


@pytest.mark.parametrize("method", ["cpu-proxy", "stub", "reference-wall"])
def test_a_plan_the_card_did_not_time_does_not_dispatch(cache_path, method):
    """Only a "cuda-events" plan moves a kernel's tile: a CPU proxy's winner,
    stored under the same key the card's dispatch reads, leaves the rule."""
    key = CacheKey("cuda-systolic", "h100", 2048, 2560, 2560, "bfloat16")
    cache.default_cache().store(key, _plan(128, 128, 64, method=method))
    assert cache.default_cache().lookup(key).method == method
    assert cache.plan_path("cuda-systolic", 2048, 2560, 2560, "bfloat16") == (None, 0, "rule")
    cfg = configs.get_smoke("internlm2-1.8b")
    _, m, n, k = decode_gemm_problems(cfg, 2)[0]
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", m, n, k, cfg.dtype), _plan(16, 64, 64, method=method))
    assert all(p is None for _, p in consult_decode_plans(cfg, 2).values())


def test_a_cpu_proxy_tuning_leaves_the_cards_dispatch_as_it_was(cache_path, capsys):
    res = autotune(256, 256, 256, device="cpu", repeats=1, top_k=2)
    assert res.winner.method == "cpu-proxy" and cache.default_cache().lookup(res.key) == res.winner
    assert cache.plan_path("cuda-systolic", 256, 256, 256, "bfloat16") == (None, 0, "rule")
    argv = ["--m", "128", "--n", "128", "--k", "128", "--device", "cpu", "--repeats", "1", "--top-k", "1"]
    assert tune_main(argv) == 0
    assert "kept for inspection" in capsys.readouterr().out


# -- candidates -------------------------------------------------------------------

PROBLEMS = [  # (backend, dtype, m, n, k)
    ("cuda-systolic", "bfloat16", 2048, 8192, 2048),
    ("cuda-systolic", "bfloat16", 4, 2048, 8192),
    ("cuda-systolic", "bfloat16", 100, 130, 70),
    ("cuda-systolic", "float32", 512, 512, 512),
    ("cuda-systolic", "int8", 2048, 8192, 2048),
    ("cuda-systolic", "int8", 4, 2048, 2048),
    ("cuda-systolic", "float8_e4m3fn", 256, 512, 384),
    ("cuda-grouped", "bfloat16", 160, 768, 2048),
    ("cuda-grouped", "bfloat16", 8, 768, 2048),
    ("cuda-grouped", "float32", 100, 64, 64),
]


@pytest.mark.parametrize("backend,dtype,m,n,k", PROBLEMS)
def test_generate_yields_only_paths_the_kernels_accept(backend, dtype, m, n, k):
    cands = candidates.generate(m, n, k, dtype=dtype, backend=backend, top_k=None)
    assert cands and [c.rank for c in cands] == list(range(len(cands)))
    tdt = getattr(torch, dtype)
    for c in cands:
        r = c.record
        assert r.fits and r.path is not None
        if backend == "cuda-grouped":
            assert gk.path_of_block(*c.block) == r.path and gk.path_refusal(r.path, m, k, n, tdt, True) is None
        elif dtype in dse.QUANT_DTYPES:
            assert mk.qpath_of_block(*c.block, tdt) == r.path
            assert mk.qpath_refusal(r.path, m, n, k, 128 if k > 128 else 0, tdt, True) is None
        else:
            path, k_chunk = mk.path_of_block(*c.block)
            assert path == r.path and mk.path_refusal(path, m, n, k, tdt, True, False, k_chunk) is None
    keys = [(c.record.analytical_us, -c.record.arithmetic_intensity) for c in cands]
    assert keys == sorted(keys)
    rule_path, rule = candidates.rule_block(m, n, k, dtype, backend)
    assert rule in [c.block for c in cands]
    assert len(candidates.generate(m, n, k, dtype=dtype, backend=backend, top_k=1)) == 1


def test_generate_falls_back_to_the_rules_tile():
    """Axes no tile runs leave the rule's tile as the one candidate."""
    cands = candidates.generate(2048, 2048, 2048, bms=(256,), bns=(256,), bks=(64,))
    assert [c.block for c in cands] == [mk.TILES["wgmma_128x256"]] and cands[0].record.fits


def test_rule_block_is_what_the_kernels_rules_run():
    assert candidates.rule_block(2048, 2560, 2560, "bfloat16") == ("wgmma_128x256", (128, 256, 64))
    assert candidates.rule_block(4, 8192, 2048, "bfloat16") == ("decode", (16, 64, 448))
    assert candidates.rule_block(4, 2048, 2048, "bfloat16") == ("decode", (16, 64, 128))
    assert candidates.rule_block(2048, 8192, 2048, "int8") == ("wgmma", (128, 128, 128))
    assert candidates.rule_block(160, 768, 2048, "bfloat16", "cuda-grouped") == ("wgmma_192x128", (192, 128, 64))


# -- dispatch precedence ----------------------------------------------------------------


def test_k1_precedence_explicit_then_cached_then_rule(cache_path):
    problem = ("cuda-systolic", 2048, 2560, 2560, "bfloat16")
    assert cache.plan_path(*problem) == (None, 0, "rule")
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", 2048, 2560, 2560, "bfloat16"), _plan(128, 128, 64))
    assert cache.plan_path(*problem) == ("wgmma_128x128", 0, "tuned")
    explicit = BlockPlan(2048, 2560, 2560, *mk.TILES["wmma"])
    assert cache.plan_path(*problem, plan=explicit) == ("wmma", 0, "explicit")
    assert cache.plan_path(*problem, "gelu") == (None, 0, "rule")  # another activation
    assert cache.plan_path("cuda-systolic", 2048, 2560, 2560, "float32") == (None, 0, "rule")

    def launch(path, source, aligned=True, k_major=False):
        return mk.launch_path(path, 0, source, 2048, 2560, 2560, BF16, aligned, k_major, 132)

    assert launch("wgmma_128x128", "tuned") == ("wgmma_128x128", 0, "tuned")
    assert launch(None, "rule") == ("wgmma_128x256", 0, "rule")
    # the operands at hand cannot take the cached wgmma tile: the rule decides
    assert launch("wgmma_128x128", "tuned", aligned=False) == ("wmma", 0, "tuned_refused")
    assert launch("wgmma_128x128_kmajor", "tuned", k_major=True) == ("wmma_kmajor", 0, "tuned_refused")
    with pytest.raises(ValueError, match="TMA"):
        launch("wgmma_128x128", "explicit", aligned=False)
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", 4, 2048, 2048, "bfloat16"), _plan(16, 64, 256))
    assert cache.plan_path("cuda-systolic", 4, 2048, 2048, "bfloat16") == ("decode", 256, "tuned")
    assert mk.launch_path("decode_kmajor", 256, "tuned", 4, 2048, 2048, BF16, True, True, 132) == \
        ("decode_kmajor", 256, "tuned")
    with pytest.raises(ValueError, match="no systolic tile"):
        cache.plan_path(*problem, plan=BlockPlan(2048, 2560, 2560, 256, 256, 64))


def test_k5_and_k4_precedence(cache_path):
    i8 = torch.int8
    assert cache.plan_path("cuda-systolic", 2048, 8192, 2048, "int8") == (None, 0, "rule")
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", 2048, 8192, 2048, "int8"), _plan(128, 128, 64))
    assert cache.plan_path("cuda-systolic", 2048, 8192, 2048, "int8") == ("wmma", 0, "tuned")
    assert cache.plan_path("cuda-systolic", 2048, 8192, 2048, "int8", plan=BlockPlan(1, 1, 1, 128, 128, 128)) == \
        ("wgmma", 0, "explicit")
    assert mk.qlaunch_path(None, "rule", 2048, 8192, 2048, 128, i8, True) == ("wgmma", "rule")
    assert mk.qlaunch_path("wgmma", "tuned", 256, 512, 384, 128, i8, True) == ("wgmma", "tuned")
    assert mk.qlaunch_path("wgmma", "tuned", 256, 512, 384, 128, i8, False) == ("wmma", "tuned_refused")  # no TMA
    with pytest.raises(ValueError, match="wgmma tile needs"):
        mk.qlaunch_path("wgmma", "explicit", 256, 512, 384, 128, i8, False)
    assert cache.plan_path("cuda-grouped", 160, 768, 2048, "bfloat16") == (None, 0, "rule")
    cache.default_cache().store(CacheKey("cuda-grouped", "h100", 160, 768, 2048, "bfloat16"), _plan(64, 128, 64))
    assert cache.plan_path("cuda-grouped", 160, 768, 2048, "bfloat16") == ("wgmma_64x128", 0, "tuned")
    assert gk.launch_path("wgmma_64x128", "tuned", 160, 2048, 768, BF16, True) == ("wgmma_64x128", "tuned")
    assert gk.launch_path("wgmma_64x128", "tuned", 160, 2048, 768, BF16, False) == ("wmma", "tuned_refused")
    assert gk.launch_path(None, "rule", 160, 2048, 768, BF16, True) == ("wgmma_192x128", "rule")
    assert cache.plan_path("cuda-grouped", 160, 768, 2048, "bfloat16", plan=BlockPlan(1, 1, 1, 128, 128, 32)) == \
        ("wmma", 0, "explicit")


def test_the_binding_refuses_what_the_kernel_does_not_take():
    assert mk.path_refusal("decode", 32, 64, 64, BF16, True) is not None
    assert mk.path_refusal("wgmma_128x128", 32, 64, 66, BF16, True) is not None  # K off 16-byte rows
    assert mk.path_refusal("wgmma_128x128", 32, 64, 64, BF16, False) is not None
    assert mk.path_refusal("fma", 32, 64, 64, BF16, True) is not None
    assert mk.path_refusal("wmma", 32, 64, 64, BF16, True, k_chunk=64) is not None
    assert mk.path_refusal("decode", 4, 64, 256, BF16, True, k_chunk=96) is not None
    assert mk.path_refusal("decode", 4, 64, 256, BF16, True, k_chunk=128) is None
    assert mk.qpath_refusal("wmma", 4, 64, 256, 128, torch.int8, True) is not None  # M <= 16 is the decode tile's
    assert gk.path_refusal("wgmma_64x128", 100, 64, 64, torch.float32, True) is not None
    a = torch.ones(32, 64, dtype=BF16)
    with pytest.raises(ValueError, match="CUDA"):
        mk.systolic_matmul_call(a, a.T.contiguous(), None, out_dtype=BF16, path="wmma")


def test_plan_split_and_blocks_mirror_the_kernel():
    """The Python twin of csrc/common.cuh's plan_split, and the geometry
    each path names."""
    assert mk.plan_split(4, 2048, 2048, 132) == (16, 128)
    assert mk.plan_split(4, 8192, 2048, 132) == (5, 448)
    assert mk.plan_split(32, 2048, 2048, 132) == (1, 2048)
    assert mk.plan_split(4, 2048, 2048, 132, k_chunk=512) == (4, 512)
    assert mk.plan_split(4, 2048, 2048, 132, k_chunk=4096) == (1, 2048)
    assert mk.block_of("decode", 1, 300, 1000, 132) == (16, 64, 64)
    assert mk.block_of("decode_kmajor", 4, 2048, 50, 132) == (16, 64, 64)
    assert mk.block_of("wgmma_64x128", 4, 2048, 50, 132) == (64, 128, 64)
    for path, tile in mk.TILES.items():
        if path != "decode":
            assert mk.path_of_block(*tile) == (path, 0)
    assert mk.path_of_block(16, 64, 512) == ("decode", 512)
    assert len({gk.path_of_block(*t) for t in gk.TILES.values()}) == len(gk.TILES)
    assert {mk.qpath_of_block(*t, torch.int8) for t in mk.qtiles(torch.int8).values()} == set(mk.QPATHS)


# -- autotune and measure ------------------------------------------------------------


def _stub(times: dict, calls: list):
    def fn(rec):
        calls.append(rec.ident)
        t = times.get(rec.ident, 50.0)
        return measure.Measurement(mean_us=t, best_us=t, repeats=1, method="stub")
    return fn


def test_autotune_deterministic_under_stub_then_cache_hit(cache_path):
    calls = []
    times = {"128x128x64": 5.0, "128x256x64": 6.0}
    res = autotune(2048, 2560, 2560, measure_fn=_stub(times, calls), top_k=None)
    assert not res.cache_hit and res.block == (128, 128, 64) and res.winner.method == "stub"
    assert [r.ident for r in res.records][:2] == ["128x128x64", "128x256x64"] and len(calls) == 4
    again = autotune(2048, 2560, 2560, measure_fn=_stub(times, calls))
    assert again.cache_hit and again.winner == res.winner and len(calls) == 4
    forced = autotune(2048, 2560, 2560, measure_fn=_stub({}, calls), force=True)
    # all tie at 50 us: the analytical bound breaks it (the widest tile), then the geometry
    assert not forced.cache_hit and forced.block == (128, 256, 64)
    assert cache.default_cache().lookup(forced.key).bn == 256
    assert cache.tuned_path("cuda-systolic", 2048, 2560, 2560, "bfloat16") is None  # a stub's plan never dispatches


def test_autotune_normalizes_dtype_and_keys_backends(cache_path):
    res = autotune(4, 2048, 2048, dtype=torch.bfloat16, measure_fn=_stub({}, []))
    assert res.key.dtype == "bfloat16" and res.key.chip == "h100" and res.block[:2] == (16, 64)
    q = autotune(2048, 8192, 2048, dtype="int8", measure_fn=_stub({"128x128x64": 1.0}, []))
    assert q.key.dtype == "int8" and q.block == (128, 128, 64)
    assert autotune(64, 64, 64, dtype="fp8", measure_fn=_stub({}, [])).key.dtype == "float8_e4m3fn"
    g = autotune(160, 768, 2048, backend="cuda-grouped", measure_fn=_stub({"64x128x64": 1.0}, []))
    assert g.key.backend == "cuda-grouped" and g.block == (64, 128, 64)
    with pytest.raises(ValueError):
        autotune(64, 64, 64, dtype="int32", measure_fn=_stub({}, []))
    with pytest.raises(ValueError):
        autotune(64, 64, 64, backend="pallas-systolic")


def test_autotune_needs_the_card_or_the_cpu(cache_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune(256, 256, 256)
    res = autotune(256, 256, 256, backend="reference", device="cpu", repeats=1, top_k=2)
    assert res.winner.method == "reference-wall" and len(res.records) == 2
    proxy = autotune(256, 256, 256, device="cpu", repeats=1)
    assert proxy.winner.method == "cpu-proxy" and len(proxy.records) == 4


def test_measure_methods():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.resolve_method("auto", "cuda-systolic")
    assert measure.resolve_method("auto", "cuda-systolic", "cpu")[0] == "cpu-proxy"
    assert measure.resolve_method("auto", "reference", "cpu")[0] == "reference-wall"
    with pytest.raises(ValueError):
        measure.resolve_method("cuda-events", "cuda-systolic", "cpu")
    with pytest.raises(ValueError):
        measure.resolve_method("xla-proxy", "cuda-systolic", "cpu")
    with pytest.raises(ValueError, match="no fused activation"):
        measure.measure_matmul(64, 64, 64, 64, 64, 16, backend="cuda-grouped", activation="gelu", device="cpu")
    with pytest.raises(ValueError, match="dividing blocks"):
        measure.measure_matmul(100, 64, 64, 64, 64, 64, backend="reference", device="cpu")
    m = measure.measure_matmul(256, 256, 256, 128, 128, 64, device="cpu", repeats=2)
    assert m.method == "cpu-proxy" and m.repeats == 2 and 0 < m.best_us <= m.mean_us


def test_cli_miss_then_hit_then_list(cache_path, capsys):
    argv = ["--m", "256", "--n", "256", "--k", "256", "--device", "cpu", "--backend", "reference", "--repeats", "1",
            "--top-k", "2"]
    assert tune_main(argv) == 0
    out = capsys.readouterr().out
    assert "measured 2 fitter survivors [reference-wall]" in out and "winner" in out
    assert tune_main(argv) == 0
    assert "cache hit" in capsys.readouterr().out
    assert tune_main(["--list"]) == 0
    assert "reference|h100|256|256|256|bfloat16|none|tp1" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_main(["--m", "64", "--n", "64", "--k", "64"])


# -- the engine's decode plans ------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
@pytest.mark.parametrize("batch", [1, 4, 8])
def test_decode_gemm_problems_equal_the_references(arch, batch):
    assert decode_gemm_problems(configs.get_config(arch), batch) == \
        jax_decode_gemm_problems(jax_get_config(arch), batch)


def test_consult_decode_plans_and_the_report(cache_path):
    cfg = configs.get_smoke("internlm2-1.8b")
    problems = decode_gemm_problems(cfg, 2)
    assert all(p is None for _, p in consult_decode_plans(cfg, 2).values())
    _, m, n, k = problems[0]
    cache.default_cache().store(CacheKey("cuda-systolic", "h100", m, n, k, cfg.dtype), _plan(16, 64, 64))
    model = get_model(cfg)
    engine = ServeEngine(model, model.init(0, "cpu"), ServeConfig(max_len=8, batch=2), device="cpu")
    hits = [name for name, (_, p) in engine.decode_plans.items() if p is not None]
    assert hits == [name for name, mm, nn, kk in problems if (mm, nn, kk) == (m, n, k)]
    assert engine.decode_plan_report() == f"decode plans: {len(hits)}/{len(problems)} tuned (batch=2)"
