"""The shared-prefix trace of ``chip_smoke.py``'s paged phase, on the CPU.

``make_shared_prefix_trace(n_requests=16, prefix_len=4096, suffix_len=64,
gen=32, n_groups=2, rate=0.5, seed=0)`` over 8 slots, pages of 16 rows,
``max_len`` 4192.  The trace has no EOS, so scheduling depends only on
lengths and arrivals: the ticks, decode steps, prefix hits, hit tokens,
preemptions, tokens out and peak pages of a run are the same for the fp32
SMOKE internlm2-1.8b here as for the full-width model on the card.  The
port's scheduler and the JAX package's, on the same parameters and trace,
must give the same tokens and exactly the counts that ``chip_smoke.py``
gates the card's run with -- for the prefix-cache arm and for the arm whose
556-page arena forces reclaim and preemption -- and the constants there
must be the reference run's numbers.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_shared_prefix_trace as jax_make_shared_prefix_trace
from repro.models.registry import get_model as jax_get_model
from repro.serving import ContinuousScheduler as JaxScheduler
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import requests_from_trace as jax_requests_from_trace
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_shared_prefix_trace
from repro_torch.models.registry import get_model
from repro_torch.serving import ContinuousScheduler, ServeConfig, ServeEngine, requests_from_trace

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ARCH = "internlm2-1.8b"
# The reference scheduler's run of the card trace, arm by arm.
TABLE = {
    "stripe": dict(ticks=81, decode_steps=80, prefix_hits=0, prefix_hit_tokens=0, preempted=0, tokens_out=512,
                   mean_occupancy=0.775),
    "paged": dict(ticks=81, decode_steps=80, prefix_hits=0, prefix_hit_tokens=0, preempted=0, tokens_out=512,
                  mean_occupancy=0.775, peak_pages=2093),
    "prefix": dict(ticks=81, decode_steps=80, prefix_hits=14, prefix_hit_tokens=57_344, preempted=0, tokens_out=512,
                   mean_occupancy=0.775, peak_pages=588),
    "preempt": dict(ticks=81, decode_steps=80, prefix_hits=18, prefix_hit_tokens=73_920, preempted=4, tokens_out=523,
                    mean_occupancy=0.7859, peak_pages=556),
}


def test_chip_smoke_gates_are_the_reference_run():
    assert {arm: gates for arm, (_, gates) in chip_smoke.PAGED_ARMS.items()} == TABLE
    assert chip_smoke.PAGED_TRACE == dict(n_requests=16, prefix_len=4096, suffix_len=64, gen=32, n_groups=2,
                                          rate=0.5, seed=0)
    assert (chip_smoke.PAGED_SLOTS, chip_smoke.PAGE_SIZE, chip_smoke.PAGED_MAX_LEN) == (8, 16, 4192)
    assert chip_smoke.PAGED_ARMS["preempt"][0]["n_pages"] == 556
    # bytes at full width: a page 1,574,400, the slot pool 3,299,942,400; the
    # prefix arm's peak 588 pages hold 0.28 of the slot pool
    assert chip_smoke.PAGE_BYTES == 1_574_400 and chip_smoke.STRIPE_BYTES == 3_299_942_400
    assert 588 * chip_smoke.PAGE_BYTES == 925_747_200
    # minicpm3-4b's latent page at the 16 of its 62 layers the script runs
    assert chip_smoke.MLA_LAYERS == 16 and chip_smoke.MLA_PAGE_BYTES == 148_480


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    return jmodel, jparams, tmodel, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")


def _peak(peaks):
    def on_tick(s):
        peaks.append(s.pool.pages_in_use)

    return on_tick


@pytest.mark.parametrize("arm", ["prefix", "preempt"])
def test_card_trace_counts_port_and_jax(models, arm):
    jmodel, jparams, tmodel, tparams = models
    kw, gates = chip_smoke.PAGED_ARMS[arm]
    scfg = dict(max_len=chip_smoke.PAGED_MAX_LEN, batch=chip_smoke.PAGED_SLOTS)
    tsched = ContinuousScheduler(ServeEngine(tmodel, tparams, ServeConfig(**scfg), device="cpu"), **kw)
    tpeaks = []
    got = tsched.run(requests_from_trace(make_shared_prefix_trace(tmodel.cfg, device="cpu",
                                                                  **chip_smoke.PAGED_TRACE)),
                     on_tick=_peak(tpeaks))
    jsched = JaxScheduler(JaxServeEngine(jmodel, jparams, JaxServeConfig(**scfg)), **kw)
    jpeaks = []
    want = jsched.run(jax_requests_from_trace(jax_make_shared_prefix_trace(jmodel.cfg, **chip_smoke.PAGED_TRACE)),
                      on_tick=_peak(jpeaks))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    ts, js = tsched.stats.summary(), jsched.stats.summary()
    for key, value in gates.items():
        if key == "peak_pages":
            assert max(tpeaks) == max(jpeaks) == value
        else:
            assert ts[key] == js[key] == value, key
    assert tsched.pool.validate() == [] and jsched.pool.validate() == []
    assert tsched.pool.pages_in_use == jsched.pool.pages_in_use == len(tsched.pool.prefix.pids())


@pytest.mark.parametrize("n_pages,ticks,hits,preempted,tokens_out", [(557, 81, 14, 0, 512), (555, 95, 38, 24, 568),
                                                                      (540, 142, 117, 103, 760)])
def test_preemption_threshold_is_sharp(models, n_pages, ticks, hits, preempted, tokens_out):
    """Around the 556-page arm (held to the JAX scheduler above), the port's
    scheduler alone: one page more and it only reclaims cached prefix pages;
    one page less and it preempts 24 times; at 540 it thrashes."""
    _, _, tmodel, tparams = models
    sched = ContinuousScheduler(ServeEngine(tmodel, tparams, ServeConfig(max_len=chip_smoke.PAGED_MAX_LEN,
                                                                         batch=chip_smoke.PAGED_SLOTS), device="cpu"),
                                paged=True, page_size=chip_smoke.PAGE_SIZE, prefix_cache=True, n_pages=n_pages)
    reclaimed = []
    reclaim = sched.pool.reclaim_prefix_pages
    sched.pool.reclaim_prefix_pages = lambda n=1: reclaimed.append(reclaim(n)) or reclaimed[-1]
    sched.run(requests_from_trace(make_shared_prefix_trace(tmodel.cfg, device="cpu", **chip_smoke.PAGED_TRACE)))
    s = sched.stats.summary()
    assert (s["ticks"], s["prefix_hits"], s["preempted"], s["tokens_out"]) == (ticks, hits, preempted, tokens_out)
    assert sum(reclaimed) > 0 and sched.pool.validate() == []
