"""Fault tolerance and the elastic restart, on the CPU, against the reference.

* ``distributed/fault.py`` against ``repro.distributed.fault``: a heartbeat
  written by either package is read as live or stale by the other (the same
  file name and JSON); ``elastic_meshes`` is the same ladder and
  ``pick_mesh_for(n)`` the same (shape, axes) for n in 1..600 (the
  reference's ``jax.make_mesh`` patched to hand back its arguments: it
  cannot build 512 devices here); ``restart_loop`` with ``time.sleep``
  patched makes the same attempts, sleeps the same backoffs and re-raises
  the same exception.
* The elastic restore: a data-parallel Trainer at dp 2 (Gloo ranks spawned
  by ``launch.mesh.run_ranks``) writes a checkpoint of whole leaves from
  rank 0 alone (each rank sends its moment blocks to rank 0, which alone
  holds the gathered state); a one-rank Trainer on ``pick_mesh_for(1)`` and four ranks
  on a dp 4 mesh resume from it with the gathered dp-2 state bit for bit
  (the dp-4 moment blocks cut out of the whole leaves), and their next step
  equals the dp-2 trainer's.
* ``launch/train.py --distributed --device cpu`` under ``torchrun`` at dp 2:
  rank 0 alone prints its metrics, equal to the one-process launcher's
  within 1e-5.

The ranks import this module to find their body, so the reference is
imported inside the tests that use it.
"""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core.tree import leaves, leaves_with_path, tree_map
from repro_torch.data.synthetic import make_batch
from repro_torch.distributed import fault
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models.registry import get_model
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-1.8b"
TCFG = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)


# ---------------------------------------------------------------------------
# distributed/fault.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_heartbeat_is_read_alike_by_both_packages(tmp_path, writer):
    from repro.distributed import fault as ref_fault

    make = fault.Heartbeat if writer == "port" else ref_fault.Heartbeat
    for host, step in ((3, 7), (12, 9)):
        make(str(tmp_path), host=host).beat(step)
    assert sorted(os.listdir(tmp_path)) == ["heartbeat_00003.json", "heartbeat_00012.json"]
    with open(tmp_path / "heartbeat_00003.json") as f:
        assert set(json.load(f)) == {"t", "step"}
    os.utime(tmp_path / "heartbeat_00012.json")
    (tmp_path / "heartbeat_00012.json.tmp").write_text("{}")  # a beat caught mid-write is skipped
    for read in (fault.Heartbeat.stale_hosts, ref_fault.Heartbeat.stale_hosts):
        assert read(str(tmp_path), timeout_s=300.0) == []  # live
        assert read(str(tmp_path), timeout_s=-1.0) == [3, 12]  # stale
        assert read(str(tmp_path / "absent")) == []


def test_elastic_ladder_and_pick_mesh_for_equal_the_reference(monkeypatch):
    import jax

    from repro.distributed import fault as ref_fault

    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    assert fault.elastic_meshes() == ref_fault.elastic_meshes()
    for n in range(1, 601):
        mesh = fault.pick_mesh_for(n)
        assert isinstance(mesh, Mesh)
        assert (tuple(mesh.shape.values()), mesh.axis_names) == ref_fault.pick_mesh_for(n), n
    assert (tuple(fault.pick_mesh_for(1).shape.values()), fault.pick_mesh_for(1).axis_names) == ((1, 1),
                                                                                                   ("data", "model"))


@pytest.mark.parametrize("failures", [0, 1, 3, 4, 9])
def test_restart_loop_equals_the_reference(monkeypatch, failures):
    from repro.distributed import fault as ref_fault

    def run(module):
        sleeps, attempts = [], []
        monkeypatch.setattr(time, "sleep", sleeps.append)

        def job(attempt):
            attempts.append(attempt)
            if attempt < failures:
                raise RuntimeError(f"worker lost at attempt {attempt}")

        try:
            got = module.restart_loop(job, max_restarts=3, backoff_s=0.5)
        except RuntimeError as e:
            got = str(e)
        return got, attempts, sleeps

    assert run(fault) == run(ref_fault)
    got, attempts, _ = run(fault)
    assert got == (failures if failures <= 3 else "worker lost at attempt 3") and len(attempts) == min(failures, 3) + 1


# ---------------------------------------------------------------------------
# The elastic restore
# ---------------------------------------------------------------------------


def _cfg():
    return dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")


def _batches(n):
    return [make_batch(_cfg(), batch=4, seq=16, kind="train", seed=s, device="cpu") for s in range(n)]


def _numpy(tree):
    if tree is None:  # a data-parallel state() off rank 0
        return None
    return tree_map(lambda t: t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else t, tree)


def _next_step(model, trainer, mesh, batch):
    """One more step from the trainer's state, written nowhere."""
    p, _, m = make_train_step(model, TrainConfig(**TCFG), mesh)(trainer.params, trainer.opt_state, batch,
                                                              trainer.step)
    return _numpy(p), {k: float(v) for k, v in m.items()}


def _save_rank(rank: int, world: int, root: str) -> dict:
    """Two dp-2 steps with a checkpoint, the gathered state, one more step."""
    torch.set_num_threads(1)
    mesh = Mesh((world, 1), ("data", "model"))
    model = get_model(_cfg())
    trainer = Trainer(model, TrainConfig(**TCFG, ckpt_dir=root, ckpt_every=2), model.init(0, "cpu", dtype=torch.float32),
                      mesh)
    b = _batches(3)
    trainer.run(iter(b[:2]), 2, log_every=0)
    return {"state": _numpy(trainer.state()), "next": _next_step(model, trainer, mesh, b[2]),
            "wrote": trainer.leader}


def _resume_rank(rank: int, world: int, root: str) -> dict:
    """A dp-4 Trainer from other weights resumes from the checkpoint."""
    torch.set_num_threads(1)
    mesh = Mesh((world, 1), ("data", "model"))
    model = get_model(_cfg())
    trainer = Trainer(model, TrainConfig(**TCFG, ckpt_dir=root), model.init(1, "cpu", dtype=torch.float32), mesh)
    resumed = trainer.try_resume()
    blocks = _numpy(trainer.opt_state.mu)
    return {"resumed": resumed, "step": trainer.step, "state": _numpy(trainer.state()), "blocks": blocks,
            "next": _next_step(model, trainer, mesh, _batches(3)[2])}


def _equal(a, b) -> bool:
    return all(pa == pb and np.array_equal(x, y) for (pa, x), (pb, y) in zip(leaves_with_path(a), leaves_with_path(b),
                                                                            strict=True))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    return root, run_ranks(_save_rank, 2, str(tmp_path_factory.mktemp("dp2")), args=(root,), timeout_s=120)


def test_dp2_checkpoint_is_whole_leaves_written_once(saved):
    root, results = saved
    assert latest_step(root) == 2
    d = os.path.join(root, "step_00000002")
    assert sorted(os.listdir(d)) == ["DONE", "host_00000.npz", "meta.json"]
    assert [r["wrote"] for r in results] == [True, False]
    assert results[1]["state"] is None  # the moments were gathered on rank 0 alone
    model = get_model(_cfg())
    template = Trainer(model, TrainConfig(**TCFG), model.init(1, "cpu", dtype=torch.float32)).state()
    on_disk, step = restore_checkpoint(root, template)
    assert step == 2 and _equal(_numpy(on_disk), results[0]["state"])
    assert int(on_disk["opt"].step) == 2


def test_dp2_checkpoint_resumes_at_dp1_bit_for_bit(saved):
    root, results = saved
    model = get_model(_cfg())
    mesh = fault.pick_mesh_for(1)
    trainer = Trainer(model, TrainConfig(**TCFG, ckpt_dir=root), model.init(1, "cpu", dtype=torch.float32), mesh)
    assert trainer.try_resume() and trainer.step == 2 and trainer.layout is None
    assert _equal(_numpy(trainer.state()), results[0]["state"])
    p, m = _next_step(model, trainer, mesh, _batches(3)[2])
    want_p, want_m = results[0]["next"]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m[k], want_m[k], rtol=1e-5, err_msg=k)
    for a, b in zip(leaves(p), leaves(want_p), strict=True):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_dp2_checkpoint_resumes_at_dp4_bit_for_bit(saved, tmp_path):
    root, results = saved
    ranks = run_ranks(_resume_rank, 4, str(tmp_path), args=(root,), timeout_s=120)
    want = results[0]["state"]
    want_mu = [torch.from_numpy(a) for a in leaves(want["opt"].mu)]
    model = get_model(_cfg())
    params = model.init(0, "cpu", dtype=torch.float32)
    from repro_torch.distributed.data_parallel import ZeroLayout

    for rank, r in enumerate(ranks):
        assert r["resumed"] and r["step"] == 2
        assert _equal(r["state"], want) if rank == 0 else r["state"] is None
        layout = ZeroLayout(params, Mesh((4, 1), ("data", "model")), rank=rank)
        cut = [layout.cut(i, w).numpy() for i, w in enumerate(want_mu)]
        assert all(np.array_equal(a, b) for a, b in zip(leaves(r["blocks"]), cut, strict=True))
        assert sum(a.size for a in leaves(r["blocks"])) * 4 == sum(a.size for a in leaves(want["opt"].mu))  # a quarter
        p, m = r["next"]
        want_p, want_m = results[0]["next"]
        np.testing.assert_allclose(m["loss"], want_m["loss"], rtol=1e-5)
        for a, b in zip(leaves(p), leaves(want_p), strict=True):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_distributed_dp2_matches_one_process(tmp_path, capsys):
    torchrun = shutil.which("torchrun")
    if torchrun is None:
        pytest.skip("no torchrun on this host")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16"]
    out = subprocess.run([torchrun, "--standalone", "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
                          *args, "--distributed"], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    metrics = [line for line in lines if line.startswith("{'ce'")]
    assert len(metrics) == 1  # rank 0 alone prints
    assert sum(line.startswith("arch=") for line in lines) == 1
    assert "data-parallel mesh: 2x1 ('data', 'model')" in out.stdout
    got = ast.literal_eval(metrics[0])
    want = launch_train.main(args)
    assert set(got) == set(want) == {"ce", "aux", "loss", "grad_norm", "lr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8, err_msg=k)
