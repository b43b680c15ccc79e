"""repro_torch.check against repro.check, on the CPU.

Four layers: (1) every lint fixture of the reference's ``tests/test_check.py``
through both linters -- the same rule flagged, or the same clean verdict,
for the five rules the port shares -- plus fixtures of the port's own
rules (``cuda-outside-kernels``, the torch tracing entry points, the
``record_launch`` / ``metrics._enabled`` gate); (2) the findings, the
baseline and the pragma against the reference's; (3) the contract auditor's
static part (``device="cpu"``) against corrupted plans and records, the
paper sweep and the dispatch paths, and the reference's own record audit on
its records (it traces nothing, so it runs here); (4) the CLI's exit codes
and the pools' runtime contracts (the reference's ``tests/test_check.py``
serving checks, held against the port's pools).  Data, where needed, from
numpy seeds.
"""

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from repro.check import audit as ref_audit
from repro.check import lint as ref_lint
from repro.check.findings import Finding as RefFinding
from repro.check.findings import to_json as ref_to_json
from repro.tune import candidates as ref_candidates
from repro_torch.check import audit, baseline, lint
from repro_torch.check.__main__ import main as check_main
from repro_torch.check.findings import Finding, to_json
from repro_torch.core import hw
from repro_torch.core.blocking import BlockPlan
from repro_torch.serving import KVPool, PagedKVPool
from repro_torch.tune import candidates


def _rules(findings) -> set:
    return {f.rule for f in findings}


def _port_lint(src: str, path: str) -> list:
    return lint.lint_source(textwrap.dedent(src), path)


# -- (1) the reference's lint fixtures through both linters -------------------------

# (name, path under src/repro/, source, the rules the reference flags), as in
# the reference's tests/test_check.py.
REF_FIXTURES = [
    ("pallas_outside_kernels", "serving/fastpath.py", """
        from jax.experimental import pallas as pl

        def run(x):
            return pl.pallas_call(lambda r, o: None, out_shape=x)(x)
        """, {"pallas-outside-kernels"}),
    ("pallas_inside_kernels", "kernels/custom/fastpath.py", """
        from jax.experimental import pallas as pl

        def run(x):
            return pl.pallas_call(lambda r, o: None, out_shape=x)(x)
        """, set()),
    ("hardcoded_dtype_bytes", "tune/sweep.py", """
        from repro.core.blocking import BlockPlan

        def plan():
            return BlockPlan(512, 512, 512, 128, 128, 128, in_dtype_bytes=2)
        """, {"hardcoded-dtype-bytes"}),
    ("derived_dtype_bytes", "tune/sweep.py", """
        from repro.core import hw
        from repro.core.blocking import BlockPlan

        def plan():
            b = hw.dtype_bytes("bfloat16")
            return BlockPlan(512, 512, 512, 128, 128, 128, in_dtype_bytes=b)
        """, set()),
    ("hw_table_exempt", "core/hw.py", """
        def table():
            return dict(dtype_bytes=2)
        """, set()),
    ("cache_store_without_pos", "serving/mypool.py", """
        class Pool:
            def overwrite(self, new):
                self.cache = new
        """, {"pos-mask-update"}),
    ("cache_store_with_positions", "serving/mypool.py", """
        class Pool:
            def overwrite(self, new, slot, n):
                self.cache = new
                self.positions[slot] = n
        """, set()),
    ("cache_store_via_preserving_primitive", "serving/mypool.py", """
        from repro.serving.kvpool import clear_slots

        class Pool:
            def reset(self, mask, batch):
                self.cache = clear_slots(self.cache, mask, batch)
        """, set()),
    ("cache_store_outside_serving", "tune/memo.py", """
        class Memo:
            def overwrite(self, new):
                self.cache = new
        """, set()),
    ("unscoped_scheduler_span", "serving/scheduler.py", """
        from repro.obs.trace import span

        def tick(self):
            with span("serve.tick"):
                pass
        """, {"span-scope"}),
    ("span_with_rid", "serving/scheduler.py", """
        from repro.obs.trace import span

        def tick(self, rids):
            with span("serve.tick", rids=rids):
                pass
        """, set()),
    ("span_under_request_scope", "serving/scheduler.py", """
        from repro.obs.trace import request_scope, span

        def admit(self, req):
            with request_scope(req.rid):
                with span("serve.admit"):
                    pass
        """, set()),
    ("span_outside_scheduler", "tune/measure.py", """
        from repro.obs.trace import span

        def measure():
            with span("tune.measure"):
                pass
        """, set()),
    ("wallclock_under_jit", "serving/engine.py", """
        import time
        import jax

        @jax.jit
        def step(x):
            t = time.time()
            return x * t
        """, {"jit-impurity"}),
    ("stateful_rng_under_partial_jit", "serving/engine.py", """
        import functools
        import random
        import jax

        @functools.partial(jax.jit, static_argnames=("n",))
        def step(x, n):
            return x + random.random()
        """, {"jit-impurity"}),
    ("jax_random_under_jit", "serving/engine.py", """
        import jax

        @jax.jit
        def step(key, x):
            key, sub = jax.random.split(key)
            return x + jax.random.normal(sub, x.shape)
        """, set()),
    ("wallclock_outside_jit", "tune/measure.py", """
        import time

        def measure(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        """, set()),
    ("ungated_default_registry_chain", "tune/cache.py", """
        from repro.obs import metrics

        def on_hit():
            metrics.get_registry().counter("tune.cache_hits").inc()
        """, {"ungated-obs-record"}),
    ("ungated_registry_alias", "tune/cache.py", """
        from repro.obs import metrics

        def on_hit():
            reg = metrics.get_registry()
            reg.counter("tune.cache_hits").inc()
        """, {"ungated-obs-record"}),
    ("gated_record", "tune/cache.py", """
        from repro.obs import metrics

        def on_hit():
            if not metrics.enabled():
                return
            metrics.get_registry().counter("tune.cache_hits").inc()
        """, set()),
    ("private_registry", "serving/scheduler_stats.py", """
        def on_hit(self):
            self.registry.counter("sched.admitted").inc()
        """, set()),
    ("pragma_suppresses_rule", "serving/scheduler.py", """
        from repro.obs.trace import span

        def warmup(self):
            # repro-check: allow[span-scope] engine-wide warmup
            with span("serve.warmup"):
                pass
        """, set()),
    ("pragma_does_not_suppress_other_rules", "serving/scheduler.py", """
        from repro.obs.trace import span

        def warmup(self):
            # repro-check: allow[jit-impurity]
            with span("serve.warmup"):
                pass
        """, {"span-scope"}),
]

# The port's idiom for each jax.jit fixture: its tracing entry points.
PORT_JIT = {
    "wallclock_under_jit": """
        import time
        import torch

        @torch.compile
        def step(x):
            t = time.time()
            return x * t
        """,
    "stateful_rng_under_partial_jit": """
        import functools
        import random
        import torch

        @functools.partial(torch.compile, dynamic=False)
        def step(x, n):
            return x + random.random()
        """,
    "jax_random_under_jit": """
        import torch

        @torch.compile
        def step(gen, x):
            return x + torch.randn(x.shape, generator=gen)
        """,
}


def _port_fixture(name: str, src: str) -> str:
    return PORT_JIT.get(name, src.replace("repro.", "repro_torch."))


@pytest.mark.parametrize("name,sub,src,want", REF_FIXTURES, ids=[f[0] for f in REF_FIXTURES])
def test_reference_fixture_same_verdict_in_both_linters(name, sub, src, want):
    """The reference's verdict as its test states it; the port's the same,
    but for a Pallas call, which is no port rule."""
    assert _rules(ref_lint.lint_source(textwrap.dedent(src), f"src/repro/{sub}")) == want
    port = _rules(_port_lint(_port_fixture(name, src), f"src/repro_torch/{sub}"))
    assert port == want - {"pallas-outside-kernels"}


def test_rule_catalog_maps_the_reference_catalog():
    assert set(ref_lint.RULES) - {"pallas-outside-kernels"} == set(lint.RULES) - {"cuda-outside-kernels"}
    assert all(len(v) == 2 and all(isinstance(s, str) and s for s in v) for v in lint.RULES.values())


# -- (1b) the port's own rules --------------------------------------------------------

CUDA_SOURCE = "extern \"C\" int f(int x) { return x; }\n"


@pytest.mark.parametrize("path,flagged", [
    ("src/repro_torch/csrc/new_kernel.cu", False),
    ("src/repro_torch/csrc/helpers.cuh", False),
    ("src/repro_torch/kernels/new/kernel.cu", True),
    ("tools/probe.cu", True),
    ("src/repro_torch/serving/fast.cuh", True),
])
def test_cuda_sources_only_under_csrc(path, flagged):
    assert _rules(lint.lint_source(CUDA_SOURCE, path)) == ({"cuda-outside-kernels"} if flagged else set())


@pytest.mark.parametrize("call", [
    "ctypes.CDLL(path)", "ctypes.cdll.LoadLibrary(path)", "CDLL(path)", "_build.library('systolic_mmm')",
])
@pytest.mark.parametrize("sub,flagged", [("kernels/new/kernel.py", False), ("serving/fast.py", True),
                                         ("tune/measure.py", True)])
def test_kernel_library_loads_only_under_kernels(call, sub, flagged):
    src = f"""
    import ctypes
    from ctypes import CDLL
    from repro_torch.kernels import _build

    def load(path):
        return {call}
    """
    found = _port_lint(src, f"src/repro_torch/{sub}")
    assert _rules(found) == ({"cuda-outside-kernels"} if flagged else set())


def test_the_walk_sees_cuda_sources(tmp_path):
    (tmp_path / "a.cu").write_text(CUDA_SOURCE)
    (tmp_path / "b.cuh").write_text(CUDA_SOURCE)
    (tmp_path / "c.py").write_text("x = 1\n")
    (tmp_path / "d.txt").write_text("x\n")
    names = sorted(p.name for p in lint.iter_source_files([tmp_path]))
    assert names == ["a.cu", "b.cuh", "c.py"]
    assert [f.rule for f in lint.lint_paths([tmp_path])] == ["cuda-outside-kernels"] * 2
    csrc = sorted(p.name for p in lint.iter_source_files([lint.ROOT / "src" / "repro_torch" / "csrc"]))
    assert "systolic_mmm.cu" in csrc and "common.cuh" in csrc


@pytest.mark.parametrize("deco", ["torch.compile", "torch.compile(mode='reduce-overhead')", "torch.jit.script",
                                  "torch.jit.trace", "jit.script"])
def test_impurity_under_each_tracing_entry_flagged(deco):
    src = f"""
    import time
    import torch
    from torch import jit

    @{deco}
    def step(x):
        return x * time.perf_counter()
    """
    assert _rules(_port_lint(src, "src/repro_torch/serving/engine.py")) == {"jit-impurity"}


def test_impurity_outside_tracing_clean():
    src = """
    import time
    import numpy as np

    def step(x):
        return x * time.perf_counter() + np.random.rand()
    """
    assert _port_lint(src, "src/repro_torch/serving/engine.py") == []


@pytest.mark.parametrize("body,flagged", [
    ("_obs.record_launch(m, n, k, 'bfloat16', 'cuda-systolic', 'rule')", True),
    ("if _metrics._enabled:\n        _obs.record_launch(m, n, k, 'bfloat16', 'cuda-systolic', 'rule')", False),
    ("if not metrics.enabled():\n        return\n    record_launch(m, n, k, 'bfloat16', 'cuda-systolic', None)",
     False),
    ("if metrics._enabled:\n        metrics.get_registry().counter('x').inc()", False),
])
def test_record_launch_and_the_enabled_attribute_gate(body, flagged):
    src = f"""
from repro_torch.obs import attribution as _obs
from repro_torch.obs import metrics
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.attribution import record_launch


def dispatch(m, n, k):
    {body}
"""
    found = lint.lint_source(src, "src/repro_torch/kernels/systolic/ops.py")
    assert _rules(found) == ({"ungated-obs-record"} if flagged else set())


def test_the_ports_default_paths_lint_clean():
    assert lint.lint_paths() == []
    files = [p.as_posix() for p in lint.iter_source_files(lint.DEFAULT_PATHS)]
    assert any(f.endswith("tests/test_torch_check.py") for f in files)
    assert any(f.endswith("csrc/flash_attn.cu") for f in files)
    assert not any("/tools/" in f or f.endswith("chip_smoke.py") for f in files)


def test_the_scheduler_warmup_span_carries_the_reference_pragma():
    src = (lint.ROOT / "src" / "repro_torch" / "serving" / "scheduler.py").read_text()
    assert "# repro-check: allow[span-scope] engine-wide warmup serves no request" in src


# -- (2) findings, fingerprints, baseline ----------------------------------------------


@pytest.mark.parametrize("fields", [
    ("lint", "r", "p.py", 10, "f", "msg"),
    ("audit", "smem-underdeclared", "<plan:512x512x512/128x128x64@bfloat16>", 0, "audit_matmul_plan", "m"),
    ("lint", "span-scope", "src/x/scheduler.py", 828, "A.b", "scheduler span() outside"),
])
def test_finding_fingerprint_and_json_are_the_references(fields):
    port, ref = Finding(*fields), RefFinding(*fields)
    assert port.fingerprint == ref.fingerprint and port.render() == ref.render()
    assert port.to_dict() == ref.to_dict()
    assert to_json([port], stats={"a": 1}) == ref_to_json([ref], stats={"a": 1})


def test_fingerprint_is_line_independent():
    a = Finding("lint", "r", "p.py", 10, "f", "msg")
    b = Finding("lint", "r", "p.py", 99, "f", "msg")
    c = Finding("lint", "r", "p.py", 10, "f", "other msg")
    assert a.fingerprint == b.fingerprint != c.fingerprint


def test_pragma_suppresses_only_its_rule():
    src = """
    import time
    import torch

    @torch.compile
    def step(x):
        # repro-check: allow[jit-impurity] deliberate
        a = time.time()
        b = time.time()
        return x * a * b
    """
    found = _port_lint(src, "src/repro_torch/serving/engine.py")
    assert [f.line for f in found] == [9] and _rules(found) == {"jit-impurity"}


def test_baseline_partition_roundtrip(tmp_path):
    f1 = Finding("lint", "r1", "a.py", 1, "f", "m1")
    f2 = Finding("lint", "r2", "b.py", 2, "g", "m2")
    path = tmp_path / "baseline.json"
    baseline.write([f1], path)
    new, old = baseline.partition([f1, f2], baseline.load(path))
    assert new == [f2] and old == [f1]
    assert baseline.load(tmp_path / "absent.json") == set()


def test_shipped_baseline_is_empty():
    assert baseline.DEFAULT_BASELINE.parent.name == "check" and baseline.load() == set()
    assert json.loads(baseline.DEFAULT_BASELINE.read_text()) == {"findings": [], "version": 1}


# -- (3) the contract auditor's static part ------------------------------------------------


def _audit(plan, **kw):
    return _rules(audit.audit_matmul_plan(plan, device="cpu", **kw))


BF16_PLAN = BlockPlan(512, 512, 512, 128, 128, 64, in_dtype="bfloat16")
INT8_PLAN = BlockPlan(512, 512, 512, 128, 128, 128, in_dtype="int8", quant_block_k=128,
                      out_dtype_bytes=hw.dtype_bytes("bfloat16"))


@pytest.mark.parametrize("plan,kw", [
    (BF16_PLAN, {}),
    (INT8_PLAN, {}),
    (BlockPlan(512, 512, 512, 128, 256, 64), {}),
    (BlockPlan(512, 512, 512, 64, 128, 64), {}),
    (BlockPlan(512, 512, 512, 128, 128, 32), {}),
    (BlockPlan(512, 512, 512, 64, 64, 16, in_dtype="float32"), {}),
    (BlockPlan(4, 2048, 2048, 16, 64, 256), {}),  # decode, 8 splits of 256
    (BlockPlan(4, 2048, 2000, 16, 64, 4096), {}),  # decode, bk clamped to K rounded up to the stage
    (BlockPlan(4, 151655, 896, 16, 64, 896), {"k_major": True}),  # the tied head's decode
    (BlockPlan(1024, 151655, 896, 128, 128, 32), {"k_major": True}),
    (BlockPlan(512, 512, 512, 128, 128, 32, in_dtype="float8_e4m3fn", quant_block_k=128,
               out_dtype_bytes=hw.dtype_bytes("bfloat16")), {}),
    (BlockPlan(4, 512, 512, 16, 64, 64, in_dtype="int8", quant_block_k=128,
               out_dtype_bytes=hw.dtype_bytes("bfloat16")), {}),
    (BlockPlan(160, 768, 2048, 192, 128, 64), {"backend": "cuda-grouped", "experts": 8}),
    (BlockPlan(8, 768, 2048, 16, 64, 64), {"backend": "cuda-grouped", "experts": 128}),
], ids=lambda x: str(x) if isinstance(x, dict) else f"{x.m}x{x.n}x{x.k}/{x.bm}x{x.bn}x{x.bk}@{x.in_dtype}")
def test_clean_plans_audit_clean(plan, kw):
    assert audit.audit_matmul_plan(plan, device="cpu", **kw) == []


def test_underdeclared_smem_caught():
    assert _audit(BF16_PLAN, declared_smem_bytes=BF16_PLAN.smem_bytes() // 4) == {"smem-underdeclared"}
    assert _audit(BF16_PLAN, declared_smem_bytes=BF16_PLAN.smem_bytes()) == set()


def test_straddling_scale_step_caught():
    """A 64-k scale step on the int8 wgmma tile, which retires at the end of
    its 128-deep stages: the kernel refuses it, so nothing is audited past
    the straddle (no geometry-drift on top)."""
    bad = dataclasses.replace(INT8_PLAN, quant_block_k=64)
    assert _audit(bad) == {"scale-straddle"}
    wmma = BlockPlan(512, 512, 512, 128, 128, 64, in_dtype="int8", quant_block_k=40,
                     out_dtype_bytes=hw.dtype_bytes("bfloat16"))
    assert _audit(wmma) == {"scale-straddle"}  # not on the WMMA tiles' 16-deep retire
    assert _audit(dataclasses.replace(wmma, quant_block_k=32)) == set()  # inside a stage, on a retire


def test_wrong_dtype_bytes_caught():
    assert _audit(INT8_PLAN, declared_in_dtype_bytes=2) == {"dtype-bytes-mismatch"}
    assert _audit(BF16_PLAN, declared_in_dtype_bytes=4) == {"dtype-bytes-mismatch"}


@pytest.mark.parametrize("block", [(96, 128, 64), (128, 128, 128), (256, 256, 64), (16, 64, 100), (16, 64, 0)])
def test_geometry_no_tile_runs_caught(block):
    """Including a decode k_chunk that is not a multiple of the 64-deep stage."""
    assert _audit(BlockPlan(512, 512, 512, *block)) == {"no-tile"}


def test_plan_the_dispatcher_refuses_caught():
    assert _audit(BlockPlan(512, 2048, 2048, 16, 64, 256)) == {"plan-refused"}  # decode tile at M > 16
    assert _audit(BlockPlan(512, 512, 512, 128, 128, 64), k_major=True) == {"plan-refused"}  # wgmma: no K-major B


def test_wrong_output_width_caught():
    # repro-check: allow[hardcoded-dtype-bytes] deliberately corrupted plan
    assert _audit(dataclasses.replace(BF16_PLAN, out_dtype_bytes=4)) == {"out-dtype-mismatch"}
    # repro-check: allow[hardcoded-dtype-bytes] deliberately corrupted plan
    assert _audit(dataclasses.replace(INT8_PLAN, out_dtype_bytes=1)) == {"out-dtype-mismatch"}


def test_plan_spec_injection_format(tmp_path):
    specs = [{"m": 512, "n": 512, "k": 512, "bm": 128, "bn": 128, "bk": 64},
             {"m": 512, "n": 512, "k": 512, "bm": 128, "bn": 128, "bk": 64, "declared_smem_bytes": 1000},
             {"m": 512, "n": 512, "k": 512, "bm": 128, "bn": 128, "bk": 128, "dtype": "int8",
              "quant_block_k": 64},
             {"m": 160, "n": 768, "k": 2048, "bm": 192, "bn": 128, "bk": 64, "backend": "cuda-grouped",
              "experts": 4}]
    path = tmp_path / "plans.json"
    path.write_text(json.dumps({"plans": specs}))
    assert audit.load_plan_specs(str(path)) == specs
    got = [_rules(audit.audit_plan_spec(s, device="cpu")) for s in specs]
    assert got == [set(), {"smem-underdeclared"}, {"scale-straddle"}, set()]


def _good_record(dtype="int8", path=None):
    return next(c.record for c in candidates.generate(512, 512, 512, dtype=dtype, top_k=None)
                if path is None or c.record.path == path)


def test_record_audit_clean_and_drifts_caught():
    rec = _good_record()
    assert audit.audit_record(rec) == []
    assert _rules(audit.audit_record(dataclasses.replace(rec, smem_kib=1.0))) == {"record-smem-drift"}
    assert _rules(audit.audit_record(dataclasses.replace(rec, fits=not rec.fits))) == {"record-fits-drift"}
    # repro-check: allow[hardcoded-dtype-bytes] deliberately corrupted record
    assert _rules(audit.audit_record(dataclasses.replace(rec, in_dtype_bytes=2))) == {"record-dtype-bytes"}
    assert _rules(audit.audit_record(dataclasses.replace(rec, path="wgmma"))) == {"record-path-drift"}
    wg = _good_record(path="wgmma")
    assert _rules(audit.audit_record(dataclasses.replace(wg, quant_block_k=64))) >= {"record-scale-straddle"}


@pytest.mark.parametrize("drift", ["fits", "dtype_bytes", "straddle"])
def test_reference_record_audit_flags_the_same_drifts(drift):
    """The reference's ``audit_record`` traces nothing, so it runs here; it
    flags the same drifts on its own records as the port's does on the
    port's."""
    [ref_cand] = ref_candidates.generate(512, 512, 512, dtype="int8", top_k=1)
    ref = ref_cand.record
    port = _good_record(path="wgmma")
    if drift == "fits":
        bad_ref, bad_port, rule = (dataclasses.replace(ref, fits=not ref.fits),
                                   dataclasses.replace(port, fits=not port.fits), "record-fits-drift")
    elif drift == "dtype_bytes":
        bad_ref, bad_port, rule = (dataclasses.replace(ref, in_dtype_bytes=2),  # repro-check: allow[hardcoded-dtype-bytes] deliberately corrupted
                                   dataclasses.replace(port, in_dtype_bytes=2),  # repro-check: allow[hardcoded-dtype-bytes] deliberately corrupted
                                   "record-dtype-bytes")
    else:
        bad_ref = dataclasses.replace(ref, bk=ref.quant_block_k * 2, vmem_kib=0.0)
        bad_port = dataclasses.replace(port, quant_block_k=port.bk // 2)
        rule = "record-scale-straddle"
    assert ref_audit.audit_record(ref) == [] and audit.audit_record(port) == []
    assert rule in _rules(ref_audit.audit_record(bad_ref))
    assert rule in _rules(audit.audit_record(bad_port))


def test_paper_sweep_all_plans_verify():
    findings, stats = audit.sweep_paper_candidates("cpu")
    assert findings == [], [f.render() for f in findings]
    assert stats["plans_audited"] > 0 and stats["plans_settled"] == stats["plans_audited"]
    assert [tuple(p) for p in stats["problems"]] == list(ref_audit.PAPER_PROBLEMS)
    assert set(stats["dtypes"]) == set(ref_audit.PAPER_DTYPES)
    assert stats["binary_checks_not_made"] == list(audit.BINARY_CHECKS)


def test_dispatch_paths_all_settled_and_clean():
    findings, stats = audit.audit_dispatch_paths("cpu")
    assert findings == [], [f.render() for f in findings]
    for path in ("systolic", "quant", "grouped", "attention", "collective_matmul"):
        assert stats["paths"][path] >= 1, stats


def test_launched_plan_keys_audit():
    """Counter keys as chip_smoke.py folds them: a rule launch off the rule's
    path at its operands' alignment is drift, a refused tuned path running
    the rule's is not."""
    good = [(4, 2048, 2048, "decode", 0, "rule", True), (2048, 2048, 2048, "wgmma_128x256", 0, "rule", True),
            (2048, 2048, 2048, "wmma", 0, "rule", False),  # an unaligned base
            (2048, 2048, 2048, "wgmma_128x256", 0, "tuned_refused", True),
            (2048, 2048, 2048, "wmma", 0, "tuned_refused", False), (4, 2048, 2048, "decode", 256, "explicit", True),
            (1024, 896, 151655, "wmma_kmajor", 0, "rule", True), (512, 512, 512, "fma", 0, "rule", True)]
    findings, stats = audit.audit_launches(
        systolic=good,
        quant=[(2048, 2048, 2048, "wgmma", "rule", "int8", 128, 128, True),
               (2048, 2048, 2048, "wmma", "rule", "int8", 128, 128, False),
               (4, 2048, 2048, "decode", "rule", "float8_e4m3fn", 0, 0, True)],
        grouped=[(128, 160, 2048, 768, "wgmma_192x128", "rule", True), (128, 8, 2048, 768, "decode", "rule", True)],
        attention=[(4, 512, 512, 16, 8, 128, "bfloat16"), (1, 64, 64, 2, 1, 112, "float32")], device="cpu")
    assert findings == [], [f.render() for f in findings]
    assert stats["coverage"] == 1.0 and stats["launched"] == {"systolic": 8, "quant": 3, "grouped": 2,
                                                              "attention": 2}
    bad, _ = audit.audit_launches(systolic=[(4, 2048, 2048, "decode", 256, "rule", True),
                                            (2048, 2048, 2048, "wgmma_64x128", 0, "rule", True),
                                            (2048, 2048, 2048, "wgmma_64x128", 0, "tuned_refused", True),
                                            (2048, 2048, 2048, "wgmma_64x128", 0, "tuned", True),
                                            (2048, 2048, 2048, "wmma", 0, "rule", True)],  # aligned: the rule's wgmma
                                  quant=[(2048, 2048, 2048, "wmma", "rule", "int8", 128, 128, True)],
                                  grouped=[(128, 160, 2048, 768, "wmma", "rule", True)], device="cpu")
    assert [f.rule for f in bad] == ["path-drift"] * 7
    bad, _ = audit.audit_launches(attention=[(70000, 64, 64, 2, 2, 64, "bfloat16")], device="cpu")
    assert _rules(bad) == {"grid-mismatch"}


def test_flops_recorded_for_each_family_are_2mnk():
    t = audit._Target.of("cpu")
    for g in (audit._Gemm("cuda-systolic", "wgmma_128x128", 256, 384, 512, "bfloat16"),
              audit._Gemm("cuda-systolic", "wmma", 256, 384, 512, "bfloat16", aligned=False),
              audit._Gemm("cuda-systolic", "wgmma", 256, 384, 512, "int8", qk_a=128, qk_b=128),
              audit._Gemm("cuda-grouped", "wgmma_128x128", 100, 64, 32, "bfloat16", batch=3)):
        p = audit._probe(t, g)
        assert p.flops == 2 * g.batch * g.m * g.n * g.k and len(p.recorded) == 1 and p.out_bytes == 2
        assert p.launched == [] and p.max_abs_err is None  # no launch off the card


def test_a_misaligned_operand_is_contiguous_off_its_alignment():
    x = torch.arange(12, dtype=torch.bfloat16).view(3, 4)
    y = audit._misaligned(x)
    assert torch.equal(x, y) and y.is_contiguous() and y.data_ptr() % 16 != 0


def test_the_card_audit_raises_without_a_card():
    assert not torch.cuda.is_available()
    for call in (lambda: audit.audit_dispatch_paths(), lambda: audit.audit_matmul_plan(BF16_PLAN),
                 lambda: audit.sweep_paper_candidates(), lambda: audit.run_audit(),
                 lambda: audit.audit_record(_good_record(), "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- (4) the CLI --------------------------------------------------------------------------


def test_cli_clean_tree_exits_zero(tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("def ok():\n    return 1\n")
    assert check_main([str(clean), "--no-audit"]) == 0


def test_cli_default_run_on_the_cpu_exits_zero(capsys):
    assert check_main(["--device", "cpu", "--no-sweep"]) == 0
    assert "0 new finding(s)" in capsys.readouterr().err


def test_cli_injected_lint_violation_exits_one(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "serving" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("class P:\n    def overwrite(self, new):\n        self.cache = new\n")
    assert check_main([str(bad), "--no-audit"]) == 1
    cu = tmp_path / "stray.cu"
    cu.write_text(CUDA_SOURCE)
    assert check_main([str(cu), "--no-audit"]) == 1


def test_cli_injected_corrupt_plan_exits_one(tmp_path, capsys):
    plans = tmp_path / "plans.json"
    plans.write_text(json.dumps({"plans": [{"m": 512, "n": 512, "k": 512, "bm": 128, "bn": 128, "bk": 64,
                                            "dtype": "bfloat16", "declared_smem_bytes": 1000}]}))
    rc = check_main(["--device", "cpu", "--no-lint", "--no-sweep", "--plans", str(plans), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and [f["rule"] for f in doc["findings"]] == ["smem-underdeclared"]
    assert doc["stats"]["injected_plans"] == 1 and doc["stats"]["device"] == "cpu"


@pytest.mark.parametrize("argv", [["--bogus"], ["--device", "tpu"], ["--plans"]])
def test_cli_usage_error_exits_two(argv):
    with pytest.raises(SystemExit) as e:
        check_main(argv)
    assert e.value.code == 2


def test_cli_write_baseline_then_clean(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "serving" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("class P:\n    def overwrite(self, new):\n        self.cache = new\n")
    base = tmp_path / "baseline.json"
    assert check_main([str(bad), "--no-audit", "--baseline", str(base), "--write-baseline"]) == 0
    assert check_main([str(bad), "--no-audit", "--baseline", str(base)]) == 0
    assert len(baseline.load(base)) == 1
    capsys.readouterr()


def test_cli_asked_for_the_card_without_one_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_main(["--no-lint", "--no-sweep"])


# -- (4b) the pools' runtime contracts (mirror of pos-mask-update) --------------------------


class _StubModel:
    """Two layers of {k, v, pos} block caches, batch first, as the port's
    models lay them out."""

    class _Cfg:
        dtype = "float32"

    cfg = _Cfg()

    def init_cache(self, batch, max_len, dtype, device):
        return [{"k": torch.zeros(batch, max_len, 4, dtype=dtype, device=device),
                 "v": torch.zeros(batch, max_len, 4, dtype=dtype, device=device),
                 "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device)} for _ in range(2)]


def _one_cache(max_len=16, seed=0):
    cache = _StubModel().init_cache(1, max_len, torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    for layer in cache:
        layer["k"].copy_(torch.from_numpy(rng.standard_normal(layer["k"].shape).astype(np.float32)))
    return cache


@pytest.mark.parametrize("bad_pos", [-2, -100, float("nan"), 3.5])
def test_kvpool_write_slot_rejects_bad_pos(bad_pos):
    pool = KVPool(_StubModel(), n_slots=2, max_len=16, device="cpu")
    before = [layer["k"].clone() for layer in pool.cache]
    with pytest.raises(ValueError):
        pool.write_slot(0, _one_cache(), next_pos=bad_pos)
    # the contract is checked BEFORE the scatter: the pool is untouched
    assert all(torch.equal(b, layer["k"]) for b, layer in zip(before, pool.cache))
    assert pool.positions[0] == -1


@pytest.mark.parametrize("bad_pos", [-2, float("nan"), 2.5])
def test_paged_write_slot_rejects_bad_pos(bad_pos):
    pool = PagedKVPool(_StubModel(), 2, 16, page_size=8, device="cpu")
    pool.prepare_write(0, 0, 8)
    before = [layer["k"].clone() for layer in pool.phys]
    with pytest.raises(ValueError):
        pool.write_slot(0, _one_cache(), next_pos=bad_pos)
    assert all(torch.equal(b, layer["k"]) for b, layer in zip(before, pool.phys))
    assert pool.positions[0] == -1


@pytest.mark.parametrize("pool_kind", ["slot", "paged"])
def test_write_slot_accepts_sentinel_and_valid_pos(pool_kind):
    if pool_kind == "slot":
        pool = KVPool(_StubModel(), n_slots=2, max_len=16, device="cpu")
    else:
        pool = PagedKVPool(_StubModel(), 2, 16, page_size=8, device="cpu")
        pool.prepare_write(0, 0, 16)
    pool.write_slot(0, _one_cache(), next_pos=-1)
    assert pool.positions[0] == -1
    pool.write_slot(0, _one_cache(), next_pos=5)
    assert pool.positions[0] == 5
    assert torch.equal(pool.gather_slot(0)[0]["k"], _one_cache()[0]["k"])


@pytest.mark.parametrize("pids", [[float("nan")], [1.5], [-1], [10**9]])
def test_attach_prefix_rejects_bad_pids(pids):
    pool = PagedKVPool(_StubModel(), 2, 16, page_size=8, prefix_cache=True, device="cpu")
    ref_before = pool._ref.copy()
    with pytest.raises(ValueError):
        pool.attach_prefix(0, pids)
    # rejected before any refcount / table change
    np.testing.assert_array_equal(ref_before, pool._ref)
    assert (pool._pt[0] == -1).all()


def test_attach_prefix_rejects_overlong_chain():
    pool = PagedKVPool(_StubModel(), 2, 16, page_size=8, device="cpu")
    with pytest.raises(ValueError):
        pool.attach_prefix(0, [0] * (pool.pages_per_slot + 1))
    assert (pool._pt[0] == -1).all()
