"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

``metrics``, ``trace`` and ``slo`` are copies of the reference's pure-Python
modules: the same operations on both give equal snapshots (timestamps
aside), and the port's documents pass the reference's validators.

``attribution``: the GEMM work the serving engine's totals hold and the
registry's ``gemm.*`` / ``tune.plan.*`` counters, against the reference's on
fp32 SMOKE configs (parameters from JAX ``init`` through ``params_from_jax``):
internlm2-1.8b, its w8a8 model (K5) and qwen3-moe-30b-a3b (K4).  The
reference records when jax traces a step, and its layer stack is one
``lax.scan`` whose body is traced once, so its totals hold ONE layer's GEMMs
(``src/repro/models/transformer.py:43``; unrolling the scan does not change
that); the port records every launch.  So on a one-layer model the two are
equal, and on two layers the port's are twice the reference's.  The port's
totals hold one call's work however many calls follow; the reference's hold
one trace's.  The registry counts executions in the port and traces in the
reference, so its counters are compared after one step.  Backend labels
differ by design (the reference's default is ``xla``, the port's
``cuda-*``), so counters are summed over them.
"""

import contextlib
import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.configs import get_smoke as jax_get_smoke
from repro.core import hw as jhw
from repro.core import ops as jops
from repro.data.synthetic import make_batch as jax_make_batch
from repro.data.synthetic import make_request_trace as jax_make_request_trace
from repro.models.registry import get_model as jax_get_model
from repro.obs import attribution as jattribution
from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.obs import trace as jtrace
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro.tune import cache as jtune_cache
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.core import hw
from repro_torch.core import ops as tops
from repro_torch.kernels.grouped import ops as grouped_ops
from repro_torch.kernels.systolic import ops as systolic_ops
from repro_torch.data.synthetic import make_batch, make_request_trace
from repro_torch.models.registry import get_model
from repro_torch.quant.qarray import quantize_act, quantize_weight
from repro_torch.obs import attribution, metrics, profile, slo, trace
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace
from repro_torch.tune import cache as tune_cache


def _ops(m):
    """One sequence of registry operations, applied to either package."""
    r = m.Registry()
    r.counter("sched.ticks").inc()
    r.counter("sched.ticks").inc(2.5)
    r.counter("serve.slo.violations", kind="ttft").inc()
    r.counter("serve.slo.violations", kind="itl").inc(3)
    r.gauge("sched.queue_depth").set(7)
    r.gauge("sched.queue_depth").inc(-2)
    rng = np.random.default_rng(0)
    for v in rng.exponential(1.0, 257):
        r.histogram("sched.step_latency_s").observe(float(v))
    r.histogram("serve.ttft_s", path='a"b\\c\n').observe(0.25)
    with m.disabled():
        r.inc("gated", 1)  # the gated wrappers record nothing while disabled
    r.inc("gated_on", 2, phase="decode")
    r.set("g", 1.5)
    r.observe("h", 3.0)
    return r


def test_registry_operations_give_equal_snapshots():
    tr, jr = _ops(metrics), _ops(jmetrics)
    assert tr.snapshot() == jr.snapshot()
    assert tr.to_prometheus() == jr.to_prometheus()
    assert list(tr.series()) == list(jr.series())
    assert tr.counter_value("serve.slo.violations", kind="itl") == jr.counter_value("serve.slo.violations", kind="itl")
    td, jd = metrics.snapshot_doc(tr, extra={"x": 1}), jmetrics.snapshot_doc(jr, extra={"x": 1})
    assert td.pop("unix_time") > 0 and jd.pop("unix_time") > 0
    assert td == jd


def test_port_snapshot_passes_the_reference_validator(tmp_path):
    doc = _ops(metrics).write_json(tmp_path / "snap.json", extra={"run": "test"})
    assert jmetrics.validate_snapshot(doc) == []
    assert jmetrics.validate_snapshot(json.loads((tmp_path / "snap.json").read_text())) == []


@pytest.mark.parametrize("doc", [
    None, [], {"schema": 2}, {"schema": 1, "unix_time": "x", "counters": {"a": "b"}, "gauges": [], "histograms": {}},
    {"schema": 1, "unix_time": 1.0, "counters": {}, "gauges": {}, "histograms": {"h": {"count": 1}}},
], ids=["none", "list", "schema", "mistyped", "histogram-fields"])
def test_snapshot_validator_finds_what_the_reference_finds(doc):
    assert metrics.validate_snapshot(doc) == jmetrics.validate_snapshot(doc)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.9, 0.99, 1.0])
@pytest.mark.parametrize("n", [0, 1, 7, 100, 1001])
def test_histogram_quantiles_equal_the_reference(q, n):
    vals = np.random.default_rng(n).standard_normal(n)
    th, jh = metrics.Histogram(maxlen=500), jmetrics.Histogram(maxlen=500)
    for v in vals:
        th.observe(float(v))
        jh.observe(float(v))
    assert th.quantile(q) == jh.quantile(q)
    assert th.snapshot() == jh.snapshot()


@pytest.mark.parametrize("series", ['a.b', 'a.b{x="1",y="z"}', 'serve.slo.violations{kind="ttft"}'])
def test_parse_series_equals_the_reference(series):
    assert metrics.parse_series(series) == jmetrics.parse_series(series)


def test_counter_refuses_to_go_down():
    with pytest.raises(ValueError, match="only go up"):
        metrics.Counter().inc(-1)


def _served_events(t):
    """A request's admit -> prefill -> first token -> decode tick -> evict
    chain, and a second request preempted once, on tracer ``t``."""
    for rid in (1, 2):
        t.instant("serve.admit", cat="serve", rid=rid)
        with trace.request_scope(rid):
            with t.span("serve.prefill", prompt_len=5):
                pass
    t.instant("serve.preempt", cat="serve", rid=2)
    t.instant("serve.admit", cat="serve", rid=2)
    with t.span("serve.prefill", rid=2):
        pass
    for rid in (1, 2):
        t.instant("serve.first_token", cat="serve", rid=rid)
    with t.span("serve.decode_tick", rids=[1, 2], tick=3):
        pass
    t.instant("serve.evict", cat="serve", rid=1)
    t.instant("serve.evict", cat="serve", rid=2)


def test_port_trace_passes_the_reference_validators(tmp_path):
    t = trace.Tracer()
    _served_events(t)
    doc = t.export_chrome(tmp_path / "trace.json")
    assert jtrace.validate_chrome_trace(doc) == [] == trace.validate_chrome_trace(doc)
    assert trace.trace_rids(doc) == jtrace.trace_rids(doc) == {1, 2}
    for rid in (1, 2):
        assert trace.request_timeline(doc, rid) == jtrace.request_timeline(doc, rid)
        assert jtrace.validate_request_timeline(doc, rid) == [] == trace.validate_request_timeline(doc, rid)
    # the scope tags every span in it, and an explicit rid wins
    names = [(e["name"], e["args"].get("rid")) for e in doc["traceEvents"] if e["name"] == "serve.prefill"]
    assert names == [("serve.prefill", 1), ("serve.prefill", 2), ("serve.prefill", 2)]


def test_broken_timelines_fail_both_validators():
    t = trace.Tracer()
    t.instant("serve.admit", rid=5)
    t.instant("serve.evict", rid=5)
    t.instant("serve.first_token", rid=5)
    doc = t.export_chrome()
    assert trace.validate_request_timeline(doc, 5) == jtrace.validate_request_timeline(doc, 5) != []
    assert trace.validate_request_timeline(doc, 9) == jtrace.validate_request_timeline(doc, 9) != []


def test_tracer_ring_drops_the_oldest_and_says_so():
    t = trace.Tracer(capacity=3)
    for i in range(5):
        t.instant("i", n=i)
    doc = t.export_chrome()
    assert [e["args"]["n"] for e in doc["traceEvents"]] == [2, 3, 4]
    assert doc["otherData"] == {"dropped_events": 2, "capacity": 3}
    with metrics.disabled():
        t.instant("off")
    assert len(t.events()) == 3


def test_slo_tracker_and_flight_recorder_match_the_reference(tmp_path):
    spec, jspec = slo.SLOSpec(ttft_ms=10, itl_ms=5), jslo.SLOSpec(ttft_ms=10, itl_ms=5)
    assert spec.describe() == jspec.describe() and spec.active()
    tt, jt = slo.ConformanceTracker(spec), jslo.ConformanceTracker(jspec)
    for rid, kind, v in ((0, "ttft", 0.004), (0, "itl", 0.002), (1, "ttft", 0.02), (1, "itl", 0.009), (2, "queue_wait", 9.0)):
        a, b = tt.check(rid, kind, v), jt.check(rid, kind, v)
        assert (a is None) == (b is None) and (a is None or a.to_dict() == b.to_dict())
    for rid, n in ((0, 4), (1, 7), (2, 3)):
        assert tt.on_finish(rid, n) == jt.on_finish(rid, n)
    assert tt.summary() == jt.summary()
    t = trace.Tracer()
    _served_events(t)
    rec = slo.FlightRecorder(tmp_path, tracer=t, registries=(_ops(metrics),), max_bundles=1)
    path = rec.dump("slo-ttft", rid=1, detail=tt.violations(1)[0].to_dict())
    assert rec.dump("again") is None and rec.suppressed == 1
    doc = json.loads(open(path).read())
    assert jslo.validate_postmortem(doc) == [] == slo.validate_postmortem(doc)
    assert [e["name"] for e in doc["request_timeline"]][0] == "serve.admit"
    with pytest.raises(ValueError):
        slo.SLOSpec(itl_ms=0)


def test_mfu_is_over_the_cards_peak():
    assert attribution.mfu(989e12 * 0.5, 1.0) == pytest.approx(0.5)
    assert attribution.mfu(1979e12, 2.0, dtype="int8") == pytest.approx(0.5)
    assert attribution.mfu(1.0, 0.0) == 0.0
    assert hw.H100.peak_flops("bfloat16") == hw.H100.peak_flops() == 989e12
    totals = attribution.GemmTotals()
    with attribution.collecting(totals):
        assert attribution._COLLECT.get() is totals
    assert attribution._COLLECT.get() is None
    totals.add(10.0, 1e-6, "tuned")
    totals.add(6.0, 1e-6, "heuristic")
    assert (totals.flops, totals.calls, totals.plan_hits, totals.plan_misses) == (16.0, 2, 1, 1)


def test_profiler_is_inactive_by_default_and_samples_deterministically():
    reg = metrics.Registry()
    p = profile.Profiler(0.0)
    assert not p.active() and p.sample_call("kv.gather", lambda: 3, registry=reg) == 3
    assert reg.snapshot()["counters"] == {}
    p.configure(0.25)
    for _ in range(8):
        p.sample_call("kv.gather", lambda: torch.ones(2), registry=reg, pool="stripe")
    counters = reg.snapshot()["counters"]
    assert counters['kv.gather.calls{pool="stripe"}'] == 8
    assert counters['kv.gather.sampled{pool="stripe"}'] == 2  # floor(0.25 * 8)
    with profile.sampling(1.0) as prof:
        assert prof.sample_rate == 1.0 and profile.get_profiler().active()
    assert profile.get_profiler().sample_rate == 0.0


# -- GEMM attribution against the reference ------------------------------------

TOTALS_CASES = [("internlm2-1.8b", "none"), ("internlm2-1.8b", "w8a8"), ("qwen3-moe-30b-a3b", "none")]


@pytest.fixture()
def clean_registries():
    metrics.reset()
    jmetrics.reset()
    yield
    metrics.reset()
    jmetrics.reset()


def _pair(arch, layers, quantize="none"):
    """Both packages' fp32 SMOKE model of ``layers`` layers, the port's
    parameters converted from JAX's init; w8a8 quantizes both from them."""
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32", n_layers=layers)
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32", n_layers=layers)
    jmodel, tmodel = jax_get_model(jcfg), get_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    if quantize == "w8a8":
        jparams, tparams = jquant.quantize_params(jparams), quant.quantize_params(tparams)
    return jmodel, jparams, tmodel, tparams


def _act(quantize, pkg):
    return (pkg.use_act_quant("int8") if quantize == "w8a8" else contextlib.nullcontext())


def _gemm_counters(m) -> tuple[float, float]:
    """gemm.calls and gemm.flops of the default registry, summed over backends."""
    c = m.get_registry().snapshot()["counters"]
    return (sum(v for k, v in c.items() if k.startswith("gemm.calls")),
            sum(v for k, v in c.items() if k.startswith("gemm.flops")))


def _work(t) -> tuple[float, int]:
    return t.flops, t.calls


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("arch,quantize", TOTALS_CASES)
def test_one_step_totals_and_counters_equal_the_reference(clean_registries, arch, quantize, layers):
    """prefill_totals and gemm.* after one prefill, generate_totals after
    one decode step, both unchanged in the port after three more steps."""
    jmodel, jparams, tmodel, tparams = _pair(arch, layers, quantize)
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=8, kind="prefill", seed=0)
    tb = make_batch(tmodel.cfg, batch=2, seq=8, kind="prefill", seed=0, device="cpu")
    je = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=16, batch=2))
    te = ServeEngine(tmodel, tparams, ServeConfig(max_len=16, batch=2), device="cpu")
    with _act(quantize, jquant):
        jfirst = je.prefill(jb)
    with _act(quantize, quant):
        tfirst = te.prefill(tb)
    assert _work(te.prefill_totals) == (layers * je.prefill_totals.flops, layers * je.prefill_totals.calls)
    assert te.prefill_totals.flops > 0 and te.prefill_totals.predicted_s > 0
    jcalls, jflops = _gemm_counters(jmetrics)
    assert _gemm_counters(metrics) == (layers * jcalls, layers * jflops)
    with _act(quantize, jquant):
        je.decode(jfirst, 1)
    with _act(quantize, quant):
        te.decode(tfirst, 1)
    one = _work(te.generate_totals)
    assert one == (layers * je.generate_totals.flops, layers * je.generate_totals.calls)
    with _act(quantize, jquant):
        je.decode(jfirst, 3)
    with _act(quantize, quant):
        te.decode(tfirst, 3)
        te.prefill(tb)
    assert _work(te.generate_totals) == one == (layers * je.generate_totals.flops, layers * je.generate_totals.calls)
    assert _work(te.prefill_totals) == (layers * je.prefill_totals.flops, layers * je.prefill_totals.calls)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("layers", [1, 2])
def test_continuous_totals_equal_the_reference_and_do_not_grow(clean_registries, layers, chunked):
    """decode_totals after the first tick equals it after the third and after
    the run; decode / prefill / chunk totals equal the reference's (one scan
    body: x layers); one serve.decode_mfu and model residual reading a
    decode tick, each in (0, 1] and > 0."""
    jmodel, jparams, tmodel, tparams = _pair("internlm2-1.8b", layers)
    kw = dict(n_requests=5, mean_prompt=8, mean_gen=5, rate=0.7, seed=11, max_prompt=12, max_gen=8)
    jt, tt = jax_make_request_trace(jmodel.cfg, **kw), make_request_trace(tmodel.cfg, device="cpu", **kw)
    max_len = max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in tt)
    opts = dict(chunked_prefill=True, chunk_size=4) if chunked else {}
    je = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=max_len, batch=3))
    JaxScheduler(je, **opts).run(jax_requests_from_trace(jt))
    te = ServeEngine(tmodel, tparams, ServeConfig(max_len=max_len, batch=3), device="cpu")
    sched = ContinuousScheduler(te, **opts)
    seen = []
    sched.run(requests_from_trace(tt), on_tick=lambda s: seen.append(_work(s.engine.decode_totals)))
    assert len(seen) >= 3 and seen[0] == seen[2] == seen[-1] == _work(te.decode_totals)
    assert _work(te.decode_totals) == (layers * je.decode_totals.flops, layers * je.decode_totals.calls)
    assert _work(te.prefill_totals) == (layers * je.prefill_totals.flops, layers * je.prefill_totals.calls)
    assert sorted(te._chunk_totals) == sorted(je._chunk_totals)
    for key, totals in te._chunk_totals.items():
        assert _work(totals) == (layers * je._chunk_totals[key].flops, layers * je._chunk_totals[key].calls)
    st = sched.stats
    hists = st.registry.snapshot()["histograms"]
    mfu, resid = hists["serve.decode_mfu"], hists["serve.model_residual"]
    assert mfu["count"] == resid["count"] == st.summary()["decode_steps"] > 0
    assert 0 < mfu["min"] <= mfu["max"] <= 1 and resid["min"] > 0


def test_registry_counts_executions_and_per_call_increments(clean_registries):
    """Inside a scope the registry learns at the scope's exit exactly what
    one increment per call would have written; outside, when it is read;
    disabled, nothing."""
    calls = [(4, 64, 32, "bfloat16", "cuda-systolic", "rule"), (4, 64, 32, "bfloat16", "cuda-systolic", "tuned"),
             (8, 16, 16, "int8", "cuda-systolic", "tuned_refused"), (12, 8, 8, "bfloat16", "cuda-grouped", "explicit"),
             (4, 64, 32, "bfloat16", "cuda-systolic", "rule")]

    def run(scoped):
        metrics.reset()
        totals = attribution.GemmTotals()
        with attribution.collecting(totals) if scoped else contextlib.nullcontext():
            for m, n, k, dt, b, src in calls:
                attribution.record_gemm(m, n, k, dtype=dt, backend=b, plan_source=src)
        return metrics.get_registry().snapshot()["counters"], totals

    direct, _ = run(False)
    scoped, totals = run(True)
    assert scoped == direct
    assert direct['gemm.calls{backend="cuda-systolic",dtype="bfloat16"}'] == 3
    assert direct['tune.plan.miss{backend="cuda-systolic"}'] == 3  # the rule and a refused tuned plan
    assert direct['tune.plan.hit{backend="cuda-systolic"}'] == 1
    assert (totals.calls, totals.plan_hits, totals.plan_misses) == (5, 1, 3)
    assert totals.flops == sum(2.0 * m * n * k for m, n, k, *_ in calls)
    assert attribution.plan_hit_rate("cuda-systolic") == 0.25
    metrics.reset()
    with metrics.disabled(), attribution.collecting(attribution.GemmTotals()):
        attribution.record_gemm(4, 4, 4, dtype="bfloat16", backend="cuda-systolic", plan_source="rule")
    assert metrics.get_registry().snapshot()["counters"] == {}
    with pytest.raises(ValueError, match="plan_source"):
        attribution.record_gemm(1, 1, 1, dtype="f", backend="b", plan_source="bogus")


def test_records_outside_a_scope_reach_every_read_and_a_reset_drops_them(clean_registries):
    """Outside any scope a record waits in the process's tally, which every
    read of the registry brings in first: each read sees the counters that
    one increment per call would have written, records from several threads
    included, and a reset drops what waited."""
    reg = metrics.get_registry()
    labels = dict(backend="cuda-systolic", dtype="bfloat16")

    def rec(times=1):
        for _ in range(times):
            attribution.record_gemm(4, 64, 32, dtype="bfloat16", backend="cuda-systolic", plan_source="tuned")

    def per_call(calls):
        want = metrics.Registry()
        want.counter("gemm.calls", **labels).inc(calls)
        want.counter("gemm.flops", backend="cuda-systolic").inc(calls * 2.0 * 4 * 64 * 32)
        want.counter("tune.plan.hit", backend="cuda-systolic").inc(calls)
        return want

    rec()
    assert reg.counter_value("gemm.calls", **labels) == 1
    rec()
    assert reg.to_prometheus() == per_call(2).to_prometheus()
    rec()
    assert list(reg.series()) == list(per_call(3).series())
    threads = [threading.Thread(target=rec, args=(500,)) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.snapshot() == per_call(2003).snapshot()
    assert metrics.snapshot_doc(reg)["counters"] == per_call(2003).snapshot()["counters"]
    rec()
    metrics.reset()
    assert reg.snapshot()["counters"] == {}


def _off_alignment(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base is not 16-byte aligned (a view
    a few elements into a larger buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    off = next(i for i in range(1, 16) if (buf.data_ptr() + i * t.element_size()) % 16)
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("case", ["k1-unaligned", "k1-kmajor", "k4-unaligned", "k5-unaligned"])
def test_a_tuned_plan_the_operands_refuse_is_recorded_as_the_rules_miss(clean_registries, both_caches, case):
    """Each wrapper records the source that its kernel's ``launch_path``
    settles on the operands as they will be launched: a cached wgmma tile
    that aligned, row-major operands take is a hit; the same problem with an
    unaligned base or a K-major B (no TMA) runs the rule, a miss."""
    kernel, how = case.split("-")
    g = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16

    def store(backend, m, n, k, dtype, block):
        tune_cache.default_cache().store(
            tune_cache.CacheKey(backend, "h100", m, n, k, dtype),
            tune_cache.TunedPlan(*block, mean_us=1.0, best_us=1.0, method=tune_cache.DISPATCHED_METHOD))

    if kernel == "k1":
        backend, (m, n, k) = "cuda-systolic", (32, 64, 64)
        store(backend, m, n, k, "bfloat16", (128, 128, 64))
        a, b = torch.randn(m, k, generator=g).to(bf16), torch.randn(k, n, generator=g).to(bf16)
        call = systolic_ops.matmul
        refused = (_off_alignment(a), b) if how == "unaligned" else (a, b.t().contiguous().t())
    elif kernel == "k4":
        backend, (e, c, n, k) = "cuda-grouped", (2, 32, 64, 64)
        store(backend, c, n, k, "bfloat16", (64, 128, 64))
        a, b = torch.randn(e, c, k, generator=g).to(bf16), torch.randn(e, k, n, generator=g).to(bf16)
        call = grouped_ops.grouped_matmul
        refused = (_off_alignment(a), b)
    else:
        backend, (m, n, k) = "cuda-systolic", (32, 64, 128)
        store(backend, m, n, k, "int8", (128, 128, 128))
        a = quantize_act(torch.randn(m, k, generator=g), "int8")
        b = quantize_weight(torch.randn(k, n, generator=g), "int8")
        call = systolic_ops.quant_matmul
        refused = (dataclasses.replace(a, values=_off_alignment(a.values)), b)

    def hits_misses():
        return tuple(metrics.get_registry().counter_value(f"tune.plan.{kind}", backend=backend)
                     for kind in ("hit", "miss"))

    call(a, b)
    assert hits_misses() == (1, 0)
    call(*refused)
    assert hits_misses() == (1, 1)


def test_roofline_uses_the_cards_balance_plan():
    flops = 2.0 * 4096**3
    pred = attribution.roofline_seconds(4096, 4096, 4096, "bfloat16")
    assert pred >= flops / hw.H100.peak_flops("bfloat16") * 0.99
    assert attribution.roofline_seconds(3, 5, 7, "bfloat16") > 0
    assert attribution.roofline_seconds(4, 2048, 2048, "bfloat16") >= 2048 * 2048 * 2 / hw.H100.hbm_bw


@pytest.fixture()
def both_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax_plans.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch_plans.json"))
    jtune_cache.reset_default_cache()
    tune_cache.reset_default_cache()
    yield tmp_path
    jtune_cache.reset_default_cache()
    tune_cache.reset_default_cache()


def test_tuned_hits_and_misses_count_as_the_reference(clean_registries, both_caches):
    """One cached problem in each package's cache (the reference's
    ``pallas-systolic`` on its chip, the port's K1 on the card, timed with
    CUDA events): calls at it are hits, calls elsewhere misses, in both."""
    m, n, k = 256, 128, 128
    jtune_cache.default_cache().store(
        jtune_cache.CacheKey("pallas-systolic", jhw.get_chip(None).name, m, n, k, "float32"),
        jtune_cache.TunedPlan(bm=128, bn=128, bk=128, mean_us=1.0, best_us=1.0, method="stub"))
    tune_cache.default_cache().store(
        tune_cache.CacheKey("cuda-systolic", "h100", m, n, k, "float32"),
        tune_cache.TunedPlan(bm=64, bn=64, bk=16, mean_us=1.0, best_us=1.0, method=tune_cache.DISPATCHED_METHOD))
    rng = np.random.default_rng(0)
    shapes = [(m, k, n), (m, k, n), (64, k, n)]
    with jops.use_backend("pallas-systolic"):
        for mm, kk, nn in shapes:
            jops.matmul(jax.numpy.asarray(rng.standard_normal((mm, kk)), jax.numpy.float32),
                        jax.numpy.asarray(rng.standard_normal((kk, nn)), jax.numpy.float32))
    for mm, kk, nn in shapes:
        tops.matmul(torch.randn(mm, kk), torch.randn(kk, nn))

    def plan_counts(reg):
        c = reg.snapshot()["counters"]
        return (sum(v for s, v in c.items() if s.startswith("tune.plan.hit")),
                sum(v for s, v in c.items() if s.startswith("tune.plan.miss")))

    assert plan_counts(jmetrics.get_registry()) == plan_counts(metrics.get_registry()) == (2, 1)
    assert attribution.plan_hit_rate() == jattribution.plan_hit_rate() == pytest.approx(2 / 3)
