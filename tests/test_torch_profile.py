"""The port's sampled timing windows, drift watchdog and ``obs doctor``
(``repro_torch.obs.{profile,drift,doctor}``) on the CPU, the reference's
``tests/test_profile.py`` case for case, and against the reference.

``check_drift`` / ``record_findings`` of both packages read one snapshot
document and one plan-cache JSON (entries under each package's backend and
chip) and must give the same stale set and cache ratios; the model column is
each package's own chip's roofline and is not compared.  The doctor's exit
codes are 0 / 1 / 2 in both, on the metrics directory of a served run of the
port.  A continuous run at sampling rate 1.0 gives the tokens of a run
without windows, bit for bit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core import hw as jhw
from repro.models.registry import get_model as jax_get_model
from repro.obs import drift as jdrift
from repro.obs import metrics as jmetrics
from repro.obs.__main__ import main as jobs_main
from repro.obs.ledger import Ledger as JLedger
from repro.tune import cache as jtune_cache
from repro_torch import configs, obs
from repro_torch.convert import params_from_jax
from repro_torch.core import ops
from repro_torch.data.synthetic import make_request_trace
from repro_torch.models.registry import get_model
from repro_torch.obs import doctor as obs_doctor
from repro_torch.obs import drift as obs_drift
from repro_torch.obs import metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.__main__ import validate_file
from repro_torch.obs.ledger import Ledger
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace
from repro_torch.serving.engine import decode_gemm_problems
from repro_torch.tune import cache as tune_cache

BACKEND = "cuda-systolic"


@pytest.fixture(autouse=True)
def clean_obs(monkeypatch):
    """Fresh registry / tracer / profiler per test; no ambient env leakage."""
    monkeypatch.delenv("REPRO_PROFILE_RATE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_LEDGER", raising=False)
    metrics.reset()
    obs.get_tracer().clear()
    obs_profile.get_profiler().reset()
    yield
    metrics.reset()
    obs.get_tracer().clear()
    obs_profile.get_profiler().reset()


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    tune_cache.reset_default_cache()
    yield path
    tune_cache.reset_default_cache()


def _by_name(snap_section):
    return {obs.parse_series(k)[0]: v for k, v in snap_section.items()}


# -- profiler -------------------------------------------------------------------


def test_bresenham_sampling_is_deterministic_and_exact():
    p = obs_profile.Profiler(0.25)
    draws = [p.should_sample("s") for _ in range(16)]
    assert sum(draws) == 4
    p2 = obs_profile.Profiler(0.25)  # a fresh profiler replays the same draws: no RNG, no seed
    assert [p2.should_sample("s") for _ in range(16)] == draws
    p3 = obs_profile.Profiler(0.5)
    a = [p3.should_sample("a") for _ in range(4)]
    b = [p3.should_sample("b") for _ in range(4)]
    assert a == b == [False, True, False, True]
    assert all(obs_profile.Profiler(1.0).should_sample("x") for _ in range(5))


def test_profiler_inactive_paths_record_nothing():
    p = obs_profile.Profiler(0.0)
    out, wall = p.timed("s", lambda: 41 + 1)
    assert out == 42 and wall is None
    with metrics.disabled():
        p2 = obs_profile.Profiler(1.0)
        assert not p2.active() and p2.sample_call("s", lambda: "x") == "x"
        obs_profile.record_gemm_sample(8, 8, 8, backend="b", dtype="float32", wall_s=1e-3)
    assert metrics.get_registry().snapshot()["counters"] == {}


def test_sample_call_writes_standard_series():
    r = metrics.Registry()
    out = obs_profile.Profiler(1.0).sample_call("kv.gather", lambda: torch.ones(4), registry=r, pool="stripe",
                                                path="slot")
    assert out.shape == (4,)
    snap = r.snapshot()
    counters = _by_name(snap["counters"])
    assert counters["kv.gather.calls"] == counters["kv.gather.sampled"] == 1 and counters["kv.gather.sampled_us"] > 0
    assert _by_name(snap["histograms"])["kv.gather_us"]["count"] == 1
    assert obs.parse_series(next(iter(snap["counters"])))[1] == {"pool": "stripe", "path": "slot"}


def test_sampling_context_configure_clamp_and_reset(monkeypatch):
    prof = obs_profile.get_profiler()
    obs_profile.configure(0.1)
    with obs.sampling(1.0):
        assert prof.sample_rate == 1.0
        obs_profile.sample_call("t.stream", lambda: torch.zeros(2))
    assert prof.sample_rate == 0.1
    assert metrics.get_registry().counter_value("t.stream.sampled") == 1.0
    obs_profile.configure(7.0)
    assert prof.sample_rate == 1.0
    obs_profile.configure(-3.0)
    assert prof.sample_rate == 0.0
    monkeypatch.setenv("REPRO_PROFILE_RATE", "0.5")
    prof.reset()
    assert prof.sample_rate == 0.5


def test_gemm_window_samples_each_k1_call_once():
    """``core.ops.matmul``'s window: one ``eager-wall`` sample per K1 call at
    rate 1.0, labelled with the problem; none with the profiler off."""
    x, w = torch.randn(3, 5, 16), torch.randn(16, 8)
    ops.matmul(x, w)
    assert metrics.get_registry().snapshot()["histograms"] == {}
    with obs.sampling(1.0):
        y = ops.matmul(x, w)
        ops.matmul(x, w)
    torch.testing.assert_close(y, x @ w)
    (series, h), = metrics.get_registry().snapshot()["histograms"].items()
    assert obs.parse_series(series) == ("profile.gemm_us", {"backend": BACKEND, "dtype": "float32",
                                                            "method": "eager-wall", "problem": "15x8x16"})
    assert h["count"] == 2


# -- drift watchdog --------------------------------------------------------------


def _stash_sample(m, n, k, us, method="cuda-events"):
    obs_profile.record_gemm_sample(m, n, k, backend=BACKEND, dtype="bfloat16", wall_s=us / 1e6, method=method)


def _key(m, n, k):
    return tune_cache.CacheKey(BACKEND, "h100", m, n, k, "bfloat16", "none", 1)


def _plan(mean_us, method="cuda-events", **kw):
    return tune_cache.TunedPlan(bm=16, bn=64, bk=64, mean_us=mean_us, best_us=mean_us, method=method, **kw)


def test_check_drift_without_cache_entry_reports_model_only(tmp_path):
    _stash_sample(4, 2048, 2048, 100.0)
    (f,) = obs_drift.check_drift(metrics.get_registry().snapshot(), cache=tune_cache.PlanCache(tmp_path / "e.json"))
    assert f.problem == "4x2048x2048" and f.samples == 1 and f.sampled_us == pytest.approx(100.0)
    assert f.model_us > 0 and f.model_ratio == pytest.approx(100.0 / f.model_us)
    assert f.cached_us is None and f.cache_ratio is None and not f.stale
    assert f.key is None and f.recommendation == "ok"


def test_check_drift_flags_stale_plans_symmetrically(tmp_path):
    cache = tune_cache.PlanCache(tmp_path / "plans.json")
    cache.store(_key(4, 64, 64), _plan(300.0))  # claims 3x the sampled time
    cache.store(_key(8, 64, 64), _plan(40.0))  # a third of it: stale too
    cache.store(_key(2, 64, 64), _plan(110.0))  # within threshold
    _stash_sample(4, 64, 64, 100.0)
    _stash_sample(8, 64, 64, 120.0)
    _stash_sample(2, 64, 64, 100.0)
    by = {f.problem: f for f in obs_drift.check_drift(metrics.get_registry().snapshot(), cache=cache)}
    assert by["4x64x64"].stale and by["4x64x64"].cache_ratio == pytest.approx(3.0)
    assert by["4x64x64"].key == _key(4, 64, 64).encode() and "re-tune" in by["4x64x64"].recommendation
    assert by["8x64x64"].stale and by["8x64x64"].cache_ratio == pytest.approx(3.0)
    assert not by["2x64x64"].stale and by["2x64x64"].cache_ratio == pytest.approx(1.1)


def test_check_drift_never_compares_across_measurement_methods(tmp_path):
    """An eager-wall window (host clock) held against a plan the card timed
    with CUDA events is not drift."""
    cache = tune_cache.PlanCache(tmp_path / "plans.json")
    cache.store(_key(4, 64, 64), _plan(10.0))
    _stash_sample(4, 64, 64, 100.0, method="eager-wall")
    (f,) = obs_drift.check_drift(metrics.get_registry().snapshot(), cache=cache)
    assert not f.stale and f.cached_us is None and "not comparable" in f.recommendation


def test_record_findings_counters_and_ledger(tmp_path):
    base = dict(problem="4x64x64", backend=BACKEND, dtype="bfloat16", method="cuda-events", sampled_us=100.0,
                samples=3, model_us=10.0, model_ratio=10.0, threshold=0.5)
    stale = obs_drift.DriftFinding(cached_us=300.0, cache_ratio=3.0, stale=True, key="k1",
                                   recommendation="re-tune k1", **base)
    ok = obs_drift.DriftFinding(cached_us=100.0, cache_ratio=1.0, stale=False, key="k2", recommendation="ok", **base)
    ledger = Ledger(str(tmp_path / "ledger.jsonl"))
    assert obs_drift.record_findings([stale, ok], ledger=ledger) == 1
    reg = metrics.get_registry()
    assert reg.counter_value("tune.plan.stale", key="k1") == 1.0 and reg.counter_value("tune.plan.stale", key="k2") == 0
    (e,), bad = ledger.entries()
    assert bad == 0 and e["bench"] == "drift" and e["variant"] == "k1" and e["chip"] == "h100"
    assert e["metrics"]["cache_ratio"] == 3.0 and e["meta"]["recommendation"] == "re-tune k1"


@pytest.mark.parametrize("method", ["cuda-events", "eager-wall"])
def test_check_drift_and_record_findings_equal_the_reference(tmp_path, method):
    """One snapshot document, one cache JSON holding each problem under both
    packages' backend and chip: the same stale set, cache ratios, keys'
    problems and stale counters."""
    samples = {(4, 64, 64): 100.0, (8, 64, 64): 120.0, (2, 64, 64): 100.0, (16, 128, 64): 50.0}
    stored = {(4, 64, 64): 300.0, (8, 64, 64): 40.0, (2, 64, 64): 110.0}
    for (m, n, k), us in samples.items():
        obs_profile.record_gemm_sample(m, n, k, backend=BACKEND, dtype="bfloat16", wall_s=us / 1e6, method=method)
    doc = obs.snapshot_doc(metrics.get_registry())
    path = tmp_path / "plans.json"
    tcache, jcache = tune_cache.PlanCache(path), jtune_cache.PlanCache(path)
    for (m, n, k), us in stored.items():
        tcache.store(_key(m, n, k), _plan(us))
        jcache.store(jtune_cache.CacheKey(BACKEND, jhw.get_chip(None).name, m, n, k, "bfloat16"),
                     jtune_cache.TunedPlan(bm=16, bn=64, bk=64, mean_us=us, best_us=us, method="cuda-events"))
    got = obs_drift.check_drift(doc, cache=tune_cache.PlanCache(path))
    want = jdrift.check_drift(doc, cache=jtune_cache.PlanCache(path))

    def view(fs):
        return [(f.problem, f.stale, f.cached_us, f.cache_ratio, f.sampled_us, f.samples, f.key is None,
                 f.recommendation.split(":")[-1]) for f in fs]

    assert view(got) == view(want)
    assert {f.problem for f in got if f.stale} == ({"4x64x64", "8x64x64"} if method == "cuda-events" else set())
    jmetrics.reset()
    assert obs_drift.record_findings(got) == jdrift.record_findings(want)
    def stale_counts(reg):
        return sorted(v for s, v in reg.snapshot()["counters"].items() if s.startswith("tune.plan.stale"))

    assert stale_counts(metrics.get_registry()) == stale_counts(jmetrics.get_registry())
    jmetrics.reset()


# -- serving integration (CPU) ----------------------------------------------------


def _serve_setup(n=4):
    jcfg = dataclasses.replace(jax_get_smoke("internlm2-1.8b"), dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke("internlm2-1.8b"), dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jax_get_model(jcfg).init(jax.random.PRNGKey(0))), cfg,
                             device="cpu")
    model = get_model(cfg)
    trace = make_request_trace(cfg, n_requests=n, mean_prompt=8, mean_gen=5, rate=0.7, seed=3, min_prompt=4,
                               max_prompt=12, max_gen=8, device="cpu")
    max_len = max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)
    return model, params, ServeEngine(model, params, ServeConfig(max_len=max_len, batch=2), device="cpu"), trace


def test_probe_decode_plans_records_gemm_samples(cache_path):
    """On the CPU the probe times with the CPU proxy (the card's method is
    CUDA events): one sample per decode problem, at the shape rule's path."""
    _, _, engine, _ = _serve_setup()
    rows = obs_drift.probe_decode_plans(engine, repeats=1, warmup=1)
    assert [r["name"] for r in rows] == sorted(name for name, *_ in decode_gemm_problems(engine.cfg, 2))
    assert all(r["mean_us"] > 0 and r["method"] == "cpu-proxy" and not r["cached"] and r["path"] == "fma"
               and r["model_us"] > 0 for r in rows)
    hists = [(obs.parse_series(k), h) for k, h in metrics.get_registry().snapshot()["histograms"].items()
             if obs.parse_series(k)[0] == "profile.gemm_us"]
    assert {lb["problem"] for (_, lb), _ in hists} == {r["problem"] for r in rows}
    assert sum(h["count"] for _, h in hists) == len(rows)
    assert all(lb["backend"] == BACKEND and lb["method"] == "cpu-proxy" for (_, lb), _ in hists)


def test_doctor_end_to_end_serve_report_and_stale_gate(tmp_path, cache_path, capsys):
    """Doctor over a served run's metrics dir: coverage >= 0.9 of the run's
    wall, exit 0 healthy, 1 with a plan cache entry 3x off the probe's
    sampled time, in both packages' doctors; stale findings go to a ledger."""
    _, _, engine, trace = _serve_setup()
    sched = ContinuousScheduler(engine)
    with obs.sampling(1.0):
        sched.run(requests_from_trace(trace))
        rows = obs_drift.probe_decode_plans(engine, repeats=1, warmup=1)
    assert all("mean_us" in r for r in rows)
    mdir = tmp_path / "metrics"
    mdir.mkdir()
    doc = obs.snapshot_doc(metrics.get_registry(), sched.stats.registry, extra=sched.stats.summary())
    (mdir / "snapshot.json").write_text(json.dumps(doc))
    obs.get_tracer().export_chrome(str(mdir / "trace.json"))

    out1 = tmp_path / "report.json"
    assert obs_main(["doctor", str(mdir), "--json", "--out", str(out1)]) == 0
    printed = capsys.readouterr().out
    report = json.loads(out1.read_text())
    assert json.loads(printed) == report
    assert obs_doctor.validate_doctor_report(report) == [] and validate_file(str(out1)) == []
    assert report["wall_basis"] == "sched.run_wall_s" and 0.9 <= report["coverage"] <= 1.0 + 1e-3
    phases = {p["name"]: p for p in report["phases"]}
    assert set(phases) == {"prefill", "decode", "sched_gap", "telemetry"}
    assert phases["decode"]["seconds"] > 0 and phases["prefill"]["seconds"] > 0
    assert report["kv"] and all(r["mean_us"] > 0 for r in report["kv"])
    assert report["residuals"]["gemms"] and report["residuals"]["serve_model_residual_mean"] > 0
    assert report["stale_plans"] == []
    assert "time sinks" in obs_doctor.render_text(report) and "stale plans: none" in obs_doctor.render_text(report)

    g = next(g for g in report["residuals"]["gemms"] if g["method"] == "cpu-proxy")
    m, n, k = (int(x) for x in g["problem"].split("x"))
    stale_cache = tmp_path / "stale_plans.json"
    tune_cache.PlanCache(stale_cache).store(tune_cache.CacheKey(BACKEND, "h100", m, n, k, g["dtype"]),
                                            _plan(g["sampled_us"] * 3.0, method=g["method"]))
    jtune_cache.PlanCache(stale_cache).store(
        jtune_cache.CacheKey(BACKEND, jhw.get_chip(None).name, m, n, k, g["dtype"]),
        jtune_cache.TunedPlan(bm=16, bn=64, bk=64, mean_us=g["sampled_us"] * 3.0, best_us=g["sampled_us"] * 3.0,
                              method=g["method"]))
    out2 = tmp_path / "report2.json"
    args = ["doctor", str(mdir), "--json", "--out", str(out2), "--tune-cache", str(stale_cache)]
    assert obs_main(args) == 1
    capsys.readouterr()
    rep2 = json.loads(out2.read_text())
    (stale,) = rep2["stale_plans"]
    assert stale["key"] == tune_cache.CacheKey(BACKEND, "h100", m, n, k, g["dtype"]).encode()
    assert stale["cache_ratio"] == pytest.approx(3.0, rel=1e-6) and "STALE PLANS (1)" in obs_doctor.render_text(rep2)
    assert jobs_main(["doctor", str(mdir), "--tune-cache", str(stale_cache)]) == 1
    assert jobs_main(["doctor", str(mdir), "--tune-cache", str(tmp_path / "none.json")]) == 0
    capsys.readouterr()

    ledger_path = tmp_path / "ledger.jsonl"
    assert obs_main(["doctor", str(mdir), "--json", "--tune-cache", str(stale_cache),
                     "--ledger", str(ledger_path)]) == 1
    capsys.readouterr()
    (entry,), bad = Ledger(str(ledger_path)).entries()
    assert bad == 0 and entry["bench"] == "drift" and entry["variant"] == stale["key"]
    assert JLedger(str(ledger_path)).entries()[0][0]["variant"] == stale["key"]


def test_doctor_exit_2_on_unreadable_or_invalid_inputs(tmp_path, capsys):
    assert obs_main(["doctor", str(tmp_path / "nope")]) == 2 == jobs_main(["doctor", str(tmp_path / "nope")])
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "snapshot.json").write_text('{"counters": []}')
    assert obs_main(["doctor", str(bad)]) == 2 == jobs_main(["doctor", str(bad)])
    assert "cannot read" in capsys.readouterr().err


def test_serve_run_under_sampling_stays_bit_identical(cache_path):
    """Windows observe only: a continuous run at sampling rate 1.0 gives
    exactly the tokens of a run without, and times one window per K1 call."""
    _, _, engine, trace = _serve_setup()
    base = ContinuousScheduler(engine).run(requests_from_trace(trace))
    metrics.reset()
    with obs.sampling(1.0):
        profiled = ContinuousScheduler(engine).run(requests_from_trace(trace))
    assert base.keys() == profiled.keys()
    for rid in base:
        assert np.array_equal(base[rid], profiled[rid])
    counters = metrics.get_registry().snapshot()["counters"]
    k1 = sum(v for s, v in counters.items() if s.startswith("gemm.calls"))
    windows = sum(v for s, v in counters.items() if s.startswith("profile.gemm.sampled{"))
    assert k1 > 0 and windows == k1


def test_launcher_writes_metrics_dir_and_doctor_reads_it(tmp_path, cache_path, capsys):
    """``launch/serve.py --metrics-dir --profile-sample-rate`` on the CPU:
    the drift probe's rows, a periodic and the final snapshot, the trace;
    the snapshot carries K1's launches, windows and the decode MFU; doctor
    exits 0 on it."""
    from repro_torch.launch import serve

    mdir = tmp_path / "m"
    serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--requests", "4",
                "--slots", "2", "--gen", "6", "--profile-sample-rate", "0.5", "--metrics-dir", str(mdir),
                "--metrics-interval", "4", "--metrics-keep", "2", "--slo-ttft-ms", "1e6"])
    out = capsys.readouterr().out
    assert "drift probe: 6 decode GEMMs re-measured, 0 stale plan(s)" in out and "decode mfu" in out
    names = sorted(p.name for p in mdir.iterdir())
    assert "snapshot.json" in names and "trace.json" in names
    assert 1 <= sum(n.startswith("snapshot-") for n in names) <= 2
    doc = json.loads((mdir / "snapshot.json").read_text())
    assert validate_file(str(mdir / "snapshot.json")) == [] and validate_file(str(mdir / "trace.json")) == []
    counters = doc["counters"]
    calls = sum(v for s, v in counters.items() if s.startswith('gemm.calls{backend="cuda-systolic"'))
    windows = sum(v for s, v in counters.items() if s.startswith("profile.gemm.sampled{") and "eager-wall" in s)
    assert calls > 0 and abs(windows - calls / 2) <= 1  # one Bresenham stream over K1's calls: one in two
    mfu = doc["histograms"]["serve.decode_mfu"]
    assert mfu["count"] == doc["extra"]["decode_steps"] > 0 and mfu["mean"] > 0
    assert obs_main(["doctor", str(mdir)]) == 0
    capsys.readouterr()
