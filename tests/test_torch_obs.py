"""The port's telemetry (``repro_torch.obs``) against the JAX package's.

``metrics``, ``trace`` and ``slo`` are copies of the reference's pure-Python
modules: the same operations on both give equal snapshots (timestamps
aside), and the port's documents pass the reference's validators.
``attribution`` and ``profile`` carry only the entry points the serving
stack calls; they are checked on their own.
"""

import json

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import slo as jslo
from repro.obs import trace as jtrace
from repro_torch.core import hw
from repro_torch.obs import attribution, metrics, profile, slo, trace


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
