"""The port's collective matmul against the reference's, rank by rank.

The reference's ``all_gather_matmul`` / ``reduce_scatter_matmul`` run once,
in a subprocess with four forced host devices (as its own
``tests/_distributed_helper.py`` runs them; each ring step's block product
through the systolic kernel's plain reference, ``ref.matmul_ref``, for
time), on its cases: (128, 200) @
(200, 256) and (128, 512) @ (512, 200), fp32 and bf16, both ring
directions, overlap on and off, on "model" meshes of 2 and 4 devices; and
``core.ops.matmul`` under ``tensor_parallel`` (the ``tp_ops_dispatch``
case).  The port runs the same inputs (numpy, from a seed) in Gloo process
groups of 2 and 4 ranks (``launch.mesh.run_ranks``: one spawn per size, a
file rendezvous), each rank on its own shards; the ranks' shards are put
back together here and held to JAX's outputs at the reference's
tolerances.  Each rank also reports its sharded GEMMs' K1 calls (tp a call
with the ring, one without) and its ``collective.*`` counters, which are
held to the reference's own counts on the same calls.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPS = (2, 4)
DTYPES = {"float32": (2e-4, 2e-4), "bfloat16": (5e-2, 5e-1)}  # the reference's (rtol, atol)
AG = ((128, 200), (200, 256))
RS = ((128, 512), (512, 200))
CASES = [(fn, dt, d, ov) for fn in ("ag", "rs") for dt in DTYPES for d in ("plus", "minus") for ov in (True, False)]


def _inputs():
    """The cases' operands in fp32, from one numpy seed."""
    rng = np.random.default_rng(0)
    out = {"ag": [rng.standard_normal(s).astype(np.float32) for s in AG],
           "rs": [rng.standard_normal(s).astype(np.float32) for s in RS],
           "x": rng.standard_normal((2, 64, 256)).astype(np.float32),
           "w": rng.standard_normal((256, 512)).astype(np.float32),
           "w_odd": rng.standard_normal((256, 129)).astype(np.float32)}
    return out


_JAX = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
out_dir, tests_dir, tp, fns = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4].split(",")
sys.path.insert(0, tests_dir)
from test_torch_collective import CASES, _inputs
from repro.core import ops as core_ops
from repro.distributed import collective_matmul as cm
from repro.kernels.systolic import ops as systolic_ops
from repro.kernels.systolic.ref import matmul_ref
from repro.obs import metrics

# Each ring step's block product through the systolic kernel's plain reference
systolic_ops.matmul = lambda a, b, bias=None, *, out_dtype=None, **_: matmul_ref(a, b, bias, out_dtype=out_dtype)
inp = _inputs()
out, counts = {}, {}
mesh = Mesh(np.array(jax.devices()[:tp]), ("model",))
for fn, dt, d, ov in (c for c in CASES if c[0] in fns):
    a, b = (jnp.asarray(x).astype(dt) for x in inp[fn])
    call = cm.all_gather_matmul if fn == "ag" else cm.reduce_scatter_matmul
    metrics.reset()
    y = call(a, b, mesh=mesh, direction=d, overlap=ov)
    out[f"{tp}/{fn}/{dt}/{d}/{ov}"] = np.asarray(y.astype(jnp.float32))
    snap = metrics.get_registry().snapshot()["counters"]
    counts[f"{tp}/{fn}/{dt}/{d}/{ov}"] = {k: v for k, v in snap.items() if k.startswith("collective.")}
if "ag" in fns:
    x, w, w_odd = (jnp.asarray(inp[k]) for k in ("x", "w", "w_odd"))
    with core_ops.use_backend("pallas-systolic"), cm.tensor_parallel(mesh):
        out[f"{tp}/ops"] = np.asarray(core_ops.matmul(x, w))
        out[f"{tp}/ops_odd"] = np.asarray(core_ops.matmul(x, w_odd))
np.savez(f"{out_dir}/jax{tp}.npz", **out)
json.dump(counts, open(f"{out_dir}/counts{tp}.json", "w"))
"""


def reference_outputs(tmp_path_factory, fns: str):
    """Start the reference's runs, one subprocess per mesh size, at once;
    -> a function that waits for them and returns (outputs, counters)."""
    d = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(d), here, str(tp), fns], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for tp in TPS]
    done = {}

    def wait():
        if not done:
            for tp, p in zip(TPS, procs):
                log, _ = p.communicate(timeout=300)
                assert p.returncode == 0, log[-3000:]
            done["out"], done["counts"] = {}, {}
            for tp in TPS:
                done["out"].update(np.load(d / f"jax{tp}.npz"))
                with open(d / f"counts{tp}.json") as f:
                    done["counts"].update(json.load(f))
        return done["out"], done["counts"]

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    yield from reference_outputs(tmp_path_factory, "ag")


def _shards(rank, tp, fn, a, b):
    """This rank's operands: the all-gather form takes A's row block and B's
    column block, the reduce-scatter form A's column block and B's row block."""
    if fn == "ag":
        m, n = a.shape[0] // tp, b.shape[1] // tp
        return a[rank * m:(rank + 1) * m], b[:, rank * n:(rank + 1) * n].contiguous()
    k = a.shape[1] // tp
    return a[:, rank * k:(rank + 1) * k].contiguous(), b[rank * k:(rank + 1) * k]


def _rank(rank, world, fns=("ag",)):
    """One rank's side of the cases of ``fns`` -> {case: its output shard
    (fp32 numpy)}, the K1 calls of each sharded GEMM, its collective
    counters."""
    torch.set_num_threads(1)
    from repro_torch.core import ops as core_ops
    from repro_torch.distributed import collective_matmul as cm
    from repro_torch.kernels.systolic import ops as mm_ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.obs import metrics

    calls = [0]
    plain = mm_ops.matmul_ref

    def counting(*args, **kw):
        calls[0] += 1
        return plain(*args, **kw)

    mm_ops.matmul_ref = counting  # the CPU branch of each K1 launch
    mesh = Mesh((world,), ("model",))
    inp = _inputs()
    out, k1, counts = {}, {}, {}
    for fn, dt, d, ov in (c for c in CASES if c[0] in fns):
        a, b = (torch.from_numpy(x).to(getattr(torch, dt)) for x in inp[fn])
        call = cm.all_gather_matmul if fn == "ag" else cm.reduce_scatter_matmul
        metrics.reset()
        calls[0] = 0
        y = call(*_shards(rank, world, fn, a, b), mesh=mesh, direction=d, overlap=ov)
        key = f"{world}/{fn}/{dt}/{d}/{ov}"
        out[key], k1[key] = y.float().numpy(), calls[0]
        snap = metrics.get_registry().snapshot()["counters"]
        counts[key] = {k: v for k, v in snap.items() if k.startswith("collective.")}
    # one sampled call of each form, telemetry on: the collective series and the hop spans
    from repro_torch.obs import profile, trace

    metrics.reset()
    trace.get_tracer().clear()
    with profile.sampling(1.0):
        for fn in fns:
            a, b = (torch.from_numpy(x) for x in inp[fn])
            (cm.all_gather_matmul if fn == "ag" else cm.reduce_scatter_matmul)(*_shards(rank, world, fn, a, b),
                                                                             mesh=mesh)
    snap = metrics.get_registry().snapshot()
    hops = [e for e in trace.get_tracer().events() if e["name"] == "tp.ring_hop"]
    counts["obs"] = {"gauges": snap["gauges"], "histograms": snap["histograms"], "hop_spans": len(hops)}
    if "ag" in fns:
        x, w, w_odd = (torch.from_numpy(inp[k]) for k in ("x", "w", "w_odd"))
        with cm.tensor_parallel(mesh):
            out[f"{world}/ops"] = core_ops.matmul(x, w).numpy()
            out[f"{world}/ops_odd"] = core_ops.matmul(x, w_odd).numpy()
        out[f"{world}/ops_odd_alone"] = core_ops.matmul(x, w_odd).numpy()
    return out, k1, counts


def rank_outputs(tmp_path_factory, tp: int, fns: tuple):
    return tp, run_ranks(_rank, tp, str(tmp_path_factory.mktemp(f"tp{tp}")), args=(fns,), timeout_s=50)


@pytest.fixture(scope="module", params=TPS, ids=lambda tp: f"tp{tp}")
def ranks(request, tmp_path_factory):
    return rank_outputs(tmp_path_factory, request.param, ("ag",))


def check_outputs(reference, ranks, fn):
    got, _ = reference()
    tp, results = ranks
    for _, dt, d, ov in (c for c in CASES if c[0] == fn):
        key = f"{tp}/{fn}/{dt}/{d}/{ov}"
        whole = np.concatenate([r[0][key] for r in results], axis=1 if fn == "ag" else 0)
        rtol, atol = DTYPES[dt]
        np.testing.assert_allclose(whole, got[key], rtol=rtol, atol=atol, err_msg=key)


def check_launches_and_counters(reference, ranks, fn):
    """Each sharded GEMM is tp K1 launches with the ring and one without, and
    its ``collective.*`` counters are the reference's own on the same call."""
    _, ref_counts = reference()
    tp, results = ranks
    mode = "allgather" if fn == "ag" else "reducescatter"
    for _, k1, counts in results:
        for _, dt, d, ov in (c for c in CASES if c[0] == fn):
            key = f"{tp}/{fn}/{dt}/{d}/{ov}"
            assert k1[key] == (tp if ov else 1), key
            assert counts[key] == ref_counts[key], key
            # a hop moves an (M/tp, K) chunk of A, or an (M/tp, N) fp32 carry
            hop = AG[0][0] // tp * AG[0][1] * (4 if dt == "float32" else 2) if fn == "ag" else RS[0][0] // tp * RS[1][1] * 4
            assert counts[key][f'collective.hop_bytes{{mode="{mode}"}}'] == hop * (tp - 1 if ov else 0), key
            assert counts[key][f'collective.hops{{mode="{mode}"}}'] == (tp - 1 if ov else 0), key


def test_all_gather_matmul_matches_the_reference(reference, ranks):
    check_outputs(reference, ranks, "ag")


def test_all_gather_ring_steps_are_k1_launches_and_counters_follow_the_reference(reference, ranks):
    check_launches_and_counters(reference, ranks, "ag")


def test_ops_dispatch_matches_the_reference(reference, ranks):
    """``core.ops.matmul`` under ``tensor_parallel``: the divisible product
    on every rank within 2e-4 of the reference's, N = 129 falling through to
    the single-card path bit for bit."""
    got, _ = reference()
    tp, results = ranks
    for out, _, _ in results:
        np.testing.assert_allclose(out[f"{tp}/ops"], got[f"{tp}/ops"], rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(out[f"{tp}/ops_odd"], out[f"{tp}/ops_odd_alone"])
        np.testing.assert_allclose(out[f"{tp}/ops_odd"], got[f"{tp}/ops_odd"], rtol=2e-4, atol=2e-4)


def check_obs(ranks, fn):
    """A sampled sharded GEMM writes the modeled and measured overlap ratios
    and its wall, ``obs/doctor._collective_rows`` pairs them as the
    reference's doctor does, and each hop is a ``tp.ring_hop`` span."""
    from repro.obs import doctor as ref_doctor
    from repro_torch.obs import doctor

    tp, results = ranks
    mode = "allgather" if fn == "ag" else "reducescatter"
    for _, _, counts in results:
        obs = counts["obs"]
        rows = doctor._collective_rows({"gauges": obs["gauges"]})
        assert rows == ref_doctor._collective_rows({"gauges": obs["gauges"]})
        assert [r["mode"] for r in rows] == [mode] and rows[0]["modeled"] > 0 and rows[0]["measured"] is not None
        assert rows[0]["residual"] == rows[0]["measured"] - rows[0]["modeled"]
        assert obs["histograms"][f'collective.wall_us{{mode="{mode}",tp="{tp}"}}']["count"] == 1
        assert obs["hop_spans"] == tp - 1


def test_all_gather_obs_series_and_hop_spans(ranks):
    check_obs(ranks, "ag")
