"""The port's training loop, checkpoints, sharded data and launcher on the CPU.

* ``train/loop.py``: one ``make_train_step`` against the reference's on the
  same parameters and batch -- its metrics (ce, aux, loss, grad_norm, lr)
  within 1e-5 relative (the parameters after a step are not compared: AdamW's
  first step moves each weight by about +-lr, and a gradient near zero may
  flip its sign between packages); the reference's own loop tests
  (``tests/test_train_loop.py``) rebuilt on the port: microbatch and remat
  equivalence, checkpoint-resume, the loss falling on a fixed batch; the
  retry of a transient failure, counted.
* ``checkpoint/ckpt.py``: round trip into a template (dtype and device of
  each leaf, bf16 included), DONE atomicity (``latest_step`` ignores a
  directory without it and ``.tmp`` directories), missing and mismatched
  checkpoints, the async writer's garbage collection (the reference's
  ``tests/test_checkpoint.py``, its mesh test aside: the port has no
  shardings yet).
* ``data/sharded.py``: the copy against the reference, batch for batch.
* ``launch/train.py``: ``--smoke --device cpu`` a few steps, with a
  checkpoint and a resume; the MoE config (also at ``--layers 1``); the
  refused flags (``--distributed`` itself: ``tests/test_torch_fault.py``).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data import sharded as jax_sharded
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.registry import get_model as jax_get_model
from repro.optim import adamw_init as jax_adamw_init
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data import sharded
from repro_torch.data.synthetic import make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw, adamw_init
from repro_torch.train import loop
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

CPU = "cpu"


def _model():
    return get_model(dataclasses.replace(configs.get_smoke("internlm2-1.8b"), dtype="float32"))


def _batches(cfg, n, batch=4, seq=16):
    return [make_batch(cfg, batch=batch, seq=seq, kind="train", seed=s, device=CPU) for s in range(n)]


def _max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(leaves(a), leaves(b)))


def test_train_step_metrics_match_jax():
    jmodel = jax_get_model(dataclasses.replace(jax_get_smoke("internlm2-1.8b"), dtype="float32"))
    model = _model()
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg, device=CPU)
    jb = jax_make_batch(jmodel.cfg, batch=4, seq=16, kind="train", seed=3)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=0.5)
    _, _, jm = jax.jit(jax_make_train_step(jmodel, JaxTrainConfig(**kw)))(jparams, jax_adamw_init(jparams), jb, 3)
    _, opt, tm = make_train_step(model, TrainConfig(**kw))(params, adamw_init(params), tb, 3)
    assert set(tm) == set(jm) == {"ce", "aux", "loss", "grad_norm", "lr"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-8, err_msg=k)
    assert int(opt.step) == 1


def test_loss_decreases_on_fixed_batch():
    model = _model()
    step_fn = make_train_step(model, TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50))
    params = model.init(0, CPU, dtype=torch.float32)
    opt = adamw_init(params)
    batch = _batches(model.cfg, 1)[0]
    losses = []
    for step in range(25):
        params, opt, metrics = step_fn(params, opt, batch, step)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatch_equivalence():
    """grad accumulation over 4 microbatches == one big batch step."""
    model = _model()
    batch = make_batch(model.cfg, batch=8, seq=16, kind="train", seed=3, device=CPU)
    params = model.init(1, CPU, dtype=torch.float32)
    p1, p4 = (tree_map(torch.clone, params) for _ in range(2))  # a step writes into its parameters
    p1, _, m1 = make_train_step(model, TrainConfig(microbatches=1))(p1, adamw_init(p1), batch, 0)
    p4, _, m4 = make_train_step(model, TrainConfig(microbatches=4))(p4, adamw_init(p4), batch, 0)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    assert _max_diff(p1, p4) < 1e-5


def test_remat_equivalence():
    model = _model()
    batch = make_batch(model.cfg, batch=2, seq=16, kind="train", seed=4, device=CPU)
    params = model.init(1, CPU, dtype=torch.float32)
    p0, p1 = (tree_map(torch.clone, params) for _ in range(2))
    p0, _, _ = make_train_step(model, TrainConfig(remat=False))(p0, adamw_init(p0), batch, 0)
    p1, _, _ = make_train_step(model, TrainConfig(remat=True))(p1, adamw_init(p1), batch, 0)
    assert _max_diff(p0, p1) < 1e-5


def test_trainer_checkpoint_resume(tmp_path):
    model = _model()
    tcfg = TrainConfig(peak_lr=1e-3, total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=2)
    t1 = Trainer(model, tcfg, model.init(0, CPU, dtype=torch.float32))
    t1.run(iter(_batches(model.cfg, 4) * 3), n_steps=4, log_every=0)
    assert t1.step == 4 and t1.retries == 0

    t2 = Trainer(model, tcfg, model.init(9, CPU, dtype=torch.float32))
    assert t2.try_resume()
    assert t2.step == 4 and int(t2.opt_state.step) == 4
    for a, b in zip(leaves({"p": t2.params, "o": t2.opt_state}), leaves({"p": t1.params, "o": t1.opt_state})):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    # fresh trainer without checkpoints does not resume
    t3 = Trainer(model, dataclasses.replace(tcfg, ckpt_dir=str(tmp_path / "empty")),
                 model.init(1, CPU, dtype=torch.float32))
    assert not t3.try_resume()


def test_trainer_retries_a_transient_failure_and_counts_it(monkeypatch, capsys):
    model = _model()
    trainer = Trainer(model, TrainConfig(max_step_retries=2), model.init(0, CPU, dtype=torch.float32))
    real, calls = trainer._grads_of, []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("transient")
        return real(*args)

    trainer._grads_of = flaky
    trainer.run(iter(_batches(model.cfg, 2)), n_steps=2, log_every=0)
    assert trainer.retries == 1 and trainer.step == 2 and len(calls) == 3
    assert "retry 1 after OutOfMemoryError" in capsys.readouterr().out
    trainer._grads_of = lambda *a: (_ for _ in ()).throw(ValueError("not transient"))
    with pytest.raises(ValueError):
        trainer.run(iter(_batches(model.cfg, 1)), n_steps=1, log_every=0)
    assert trainer.retries == 1  # other errors are not retried
    assert loop.TRANSIENT_ERRORS == (torch.cuda.OutOfMemoryError,)


def test_trainer_does_not_retry_a_failure_inside_the_update(monkeypatch):
    """AdamW writes the parameters and moments in place, leaf by leaf: a
    transient error part way through is raised at once, uncounted, and no
    leaf is stepped twice -- those written equal a clean step's bit for bit,
    the rest are untouched."""
    model = _model()
    batch = _batches(model.cfg, 1)[0]
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=0, max_step_retries=2)
    clean = Trainer(model, tcfg, model.init(0, CPU, dtype=torch.float32))
    clean.run(iter([batch]), n_steps=1, log_every=0)
    trainer = Trainer(model, tcfg, model.init(0, CPU, dtype=torch.float32))
    start = [p.clone() for p in leaves(trainer.params)]
    real, calls = adamw._step_leaf, []

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise torch.cuda.OutOfMemoryError("inside the update")
        real(*args, **kw)

    monkeypatch.setattr(adamw, "_step_leaf", flaky)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        trainer.run(iter([batch] * 3), n_steps=1, log_every=0)
    assert trainer.retries == 0 and trainer.step == 0 and int(trainer.opt_state.step) == 0 and len(calls) == 3
    got, want = leaves(trainer.params), leaves(clean.params)
    for i in range(2):
        assert torch.equal(got[i], want[i]) and not torch.equal(got[i], start[i])
    assert all(torch.equal(g, s) for g, s in zip(got[2:], start[2:]))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g), "b": torch.zeros((8,)),
                       "h": torch.randn((4,), generator=g).bfloat16()},
            "layers": [{"x": torch.randn((3,), generator=g)}], "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_into_a_template(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 42, t)
    template = tree_map(torch.zeros_like, t)
    restored, step = restore_checkpoint(str(tmp_path), template)
    assert step == 42
    for a, b in zip(leaves(restored), leaves(t)):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    assert sorted(os.listdir(tmp_path / "step_00000042")) == ["DONE", "host_00000.npz", "meta.json"]


def test_latest_step_ignores_incomplete(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 10, t)
    save_checkpoint(str(tmp_path), 20, t)
    os.makedirs(tmp_path / "step_00000030")  # no DONE marker
    os.makedirs(tmp_path / "step_00000040.tmp")  # a write in progress
    (tmp_path / "step_00000040.tmp" / "DONE").write_text("ok")
    assert latest_step(str(tmp_path)) == 20
    assert latest_step(str(tmp_path / "none")) is None


def test_restore_missing_or_mismatched_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _tree())
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"w": torch.zeros((5,))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"v": torch.zeros((4,))})


def test_async_checkpointer_gc(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    ck.wait()
    assert latest_step(str(tmp_path)) == 4
    assert len([n for n in os.listdir(tmp_path) if n.startswith("step_")]) == 2
    restored, _ = restore_checkpoint(str(tmp_path), _tree(0))
    assert torch.equal(restored["params"]["w"], _tree(4)["params"]["w"])


def test_async_checkpointer_snapshots_before_it_returns(tmp_path):
    """The Trainer steps its tensors in place while the writer thread runs:
    ``save`` copies every leaf before it returns, CPU leaves too."""
    ck = AsyncCheckpointer(str(tmp_path))
    tree = _tree(1)
    want = tree_map(torch.clone, tree)
    ck.save(1, tree)
    for t in leaves(tree):
        t.add_(1)
    ck.wait()
    restored, _ = restore_checkpoint(str(tmp_path), _tree(0))
    assert all(torch.equal(a, b) for a, b in zip(leaves(restored), leaves(want)))


@pytest.mark.parametrize("codebooks", [0, 4])
def test_token_shard_dataset_is_the_reference_copy(tmp_path, codebooks):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    sharded.write_synthetic_shards(str(ours), n_shards=3, tokens_per_shard=1000, vocab=500, seed=7)
    jax_sharded.write_synthetic_shards(str(theirs), n_shards=3, tokens_per_shard=1000, vocab=500, seed=7)
    for name in sorted(os.listdir(theirs)):
        np.testing.assert_array_equal(np.load(ours / name), np.load(theirs / name))
    kw = dict(seq_len=33, global_batch=6, host_index=1, host_count=2, codebooks=codebooks)
    a, b = sharded.TokenShardDataset(str(ours), **kw), jax_sharded.TokenShardDataset(str(theirs), **kw)
    assert a.n_windows == b.n_windows
    for step in (0, 1, 5, 40):  # 40 wraps around the corpus
        got, want = a.batch_at(step), b.batch_at(step)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_launcher_trains_on_cpu_with_a_checkpoint_and_resumes(tmp_path, capsys):
    args = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "8",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = launch_train.main(args)
    assert set(out) == {"ce", "aux", "loss", "grad_norm", "lr"} and np.isfinite(out["loss"])
    assert latest_step(str(tmp_path)) == 3
    launch_train.main(args + ["--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert latest_step(str(tmp_path)) == 6


def test_launcher_reads_token_shards_on_cpu(tmp_path):
    sharded.write_synthetic_shards(str(tmp_path), n_shards=1, tokens_per_shard=4096, vocab=128, seed=0)
    out = launch_train.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                             "--seq", "8", "--data-dir", str(tmp_path), "--microbatches", "2", "--remat"])
    assert np.isfinite(out["loss"])


@pytest.mark.parametrize("flag", ["--production-mesh", "--multi-pod", "--distributed"])
def test_launcher_refuses_the_distributed_flags(flag, capsys, monkeypatch):
    """``--production-mesh`` / ``--multi-pod`` train over the reference's
    production mesh of 256 / 512 ranks, which a job of one process is not;
    ``--distributed`` outside torchrun's environment has no process group.
    Each exits naming the fix."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", flag])
    msg = f"{e.value} {capsys.readouterr().err}"
    want = {"--distributed": "under torchrun", "--production-mesh": "needs 256 ranks; this job runs 1",
            "--multi-pod": "needs 512 ranks; this job runs 1"}[flag]
    assert want in msg
    assert "torchrun --nproc-per-node N -m repro_torch.launch.train --distributed" in msg


@pytest.mark.parametrize("extra", [[], ["--layers", "1", "--remat"]])
def test_launcher_trains_moe_on_cpu(extra):
    """The MoE SMOKE config through the launcher (its expert GEMMs through
    K4's autograd Function), also cut to its first layer."""
    out = launch_train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "8", *extra])
    assert set(out) == {"ce", "aux", "loss", "grad_norm", "lr"}
    assert np.isfinite(out["loss"]) and out["aux"] > 0
