"""Tensor-parallel training on a ("data", "model") mesh, on the CPU, against the reference.

* The reference's ``train_equiv`` (``tests/_distributed_helper.py``): glm4-9b
  SMOKE in fp32, batch 8 x 16, one step on the meshes (1, 2), (1, 4) -- where
  two ranks share each KV head -- and (2, 2) -- ZeRO-1 blocks over "data" of
  the TP shards -- (Gloo ranks spawned by ``launch.mesh.run_ranks``, one
  spawn a world size) against JAX's single-device ``make_train_step`` on the
  same weights: loss within rtol 1e-5, every parameter leaf within rtol =
  atol = 2e-4, and each leaf's change from the initial weights within 1e-2
  relative L2 of JAX's change (``_moved_alike``: a step at lr 1e-4 moves a
  weight inside 2e-4, so only this sees a skipped update).  The ranks'
  parameters are gathered whole on rank 0 (``TPLayout.gather``); the ranks
  of a "model" coordinate hold bitwise equal shards, and a leaf replicated
  over "model" is bitwise equal on every rank.
* h2o-danube3-4b SMOKE (sliding window 32) at (1, 2), seq 48, so the window
  bites, under the same bounds.
* Two steps with two microbatches and remat at (1, 2) against the port's
  one-process steps; at (1, 4) a vocabulary of 254 (the head and the table
  do not divide: replicated, run on each rank's own rows) and a 3 x 15 batch
  (45 stream rows padded to 48) against the port's one-process step.
* The ring Functions (``all_gather_matmul`` / ``reduce_scatter_matmul``
  under autograd): dX and dW against autograd through the unsharded
  product, both ring directions, ``overlap`` on and off, at tp 2 and 4,
  within atol 1e-5 sqrt(K) of the gradient's contraction length K.
* A checkpoint written at (2, 2) (rank 0 writing whole leaves) restored at
  (1, 2) and at (1, 1), bit for bit.
* The witness: wk / wv cut to each rank's KV columns (the serving layout,
  ``TPLayout.shard``) give each rank a partial gradient at (1, 4); the two
  ranks sharing a KV head sum to the whole one, which the training layout's
  all-reduce over "model" recovers.

The ranks import this module to find their body, so JAX and the reference
are imported inside the fixture: a rank starts without them.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves, leaves_with_path, tree_map
from repro_torch.data.synthetic import make_batch
from repro_torch.distributed import collective_matmul as cm
from repro_torch.distributed import sharding
from repro_torch.distributed.tp_layout import TPLayout
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw_init
from repro_torch.train.loop import TrainConfig, Trainer, make_grad_fn, make_train_step

ARCH, SWA = "glm4-9b", "h2o-danube-3-4b"
TCFG = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)  # lr 1e-4 at step 1
STEP = 1
BATCH, SEQ, SWA_SEQ = 8, 16, 48
ODD_VOCAB, ODD_BATCH, ODD_SEQ = 254, 3, 15
MESHES = ((1, 2), (1, 4), (2, 2))
RING = (32, 24, 16)  # the ring checks' (M, K, N)
MOVED_RTOL = 1e-2


def _cfg(arch, **over):
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32", **over)


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _batch(cfg, seed=0, batch=BATCH, seq=SEQ):
    return make_batch(cfg, batch=batch, seq=seq, kind="train", seed=seed, device="cpu")


def _one_process(model, params, batches, tcfg):
    """The port's one-process steps from ``params`` -> (params, metrics)."""
    params = tree_map(lambda t: t.clone(), params)
    opt = adamw_init(params)
    fn = make_train_step(model, tcfg)
    for i, b in enumerate(batches):
        params, opt, m = fn(params, opt, b, STEP + i)
    return _numpy(params), {k: float(v) for k, v in m.items()}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _tp_steps(mesh, model, whole, batches, tcfg, ckpt_dir=None):
    """Steps of a Trainer on this rank's shards of ``whole`` -> (metrics,
    the whole state on rank 0 / None, this rank's shards, its moment bytes)."""
    layout = TPLayout(model.cfg, mesh)
    trainer = Trainer(model, tcfg, layout.shard_train(tree_map(torch.clone, whole)), mesh)  # stepped in place
    trainer.step = STEP
    m = trainer.run(iter(batches), len(batches), log_every=0)
    state = trainer.state()
    return ({k: float(v) for k, v in m.items()}, None if state is None else _numpy(state), _numpy(trainer.params),
            trainer.layout.moment_bytes(trainer.opt_state))


def _ring_errors(mesh, tp, idx):
    """Each ring Function's dX and dW against autograd through the whole
    product -> [(case, max |err| / sqrt(K) of dX, of dW)]."""
    m, k, n = RING
    gen = torch.Generator().manual_seed(3)
    a, b, dy = (torch.randn(shape, generator=gen) for shape in ((m, k), (k, n), (m, n)))
    aw, bw = a.clone().requires_grad_(), b.clone().requires_grad_()
    torch.mm(aw, bw).backward(dy)
    da, db = aw.grad, bw.grad  # contractions over N and over M
    rows, cols, kk = (slice(i * d // tp, (i + 1) * d // tp) for i, d in ((idx, m), (idx, n), (idx, k)))
    out = []
    for direction in cm.DIRECTIONS:
        for overlap in (True, False):
            x, w = a[rows].clone().requires_grad_(), b[:, cols].contiguous().requires_grad_()
            cm.all_gather_matmul(x, w, mesh=mesh, direction=direction, overlap=overlap).backward(dy[:, cols])
            out.append((f"allgather {direction} overlap={overlap}",
                        (x.grad - da[rows]).abs().max().item() / math.sqrt(n),
                        (w.grad - db[:, cols]).abs().max().item() / math.sqrt(m)))
            x, w = a[:, kk].contiguous().requires_grad_(), b[kk].clone().requires_grad_()
            cm.reduce_scatter_matmul(x, w, mesh=mesh, direction=direction, overlap=overlap).backward(dy[rows])
            out.append((f"reducescatter {direction} overlap={overlap}",
                        (x.grad - da[:, kk]).abs().max().item() / math.sqrt(n),
                        (w.grad - db[kk]).abs().max().item() / math.sqrt(m)))
    return out


def _witness(mesh, model, whole, batch):
    """This rank's gradient of wk with wk / wv cut to its KV columns."""
    layout = TPLayout(model.cfg, mesh)
    grads, _ = make_grad_fn(model, TrainConfig(**TCFG), layout.loss_fn)(layout.shard(whole), batch)
    return grads["layers"][0]["attn"]["wk"].numpy()


def _cases(mesh: Mesh, shape, data: dict, ckpt_dir: str) -> dict:
    """Every case of one mesh, on this rank."""
    model = get_model(_cfg(ARCH))
    whole = _torch(data["params"])
    batch = _torch(data["batch"])
    tcfg = TrainConfig(**TCFG)
    out = {"equiv": _tp_steps(mesh, model, whole, [batch], tcfg)}
    idx = mesh.axis_index("model")
    if shape == (2, 2):
        out["ckpt"] = _tp_steps(mesh, model, whole, [batch] * 2, TrainConfig(**TCFG, ckpt_dir=ckpt_dir,
                                                                               ckpt_every=2))[1]
    if shape == (1, 2):
        swa = get_model(_cfg(SWA))
        out["swa"] = _tp_steps(mesh, swa, _torch(data["swa_params"]), [_torch(data["swa_batch"])], tcfg)
        out["micro"] = _tp_steps(mesh, model, whole, _torch(data["two"]),
                                 TrainConfig(**TCFG, microbatches=2, remat=True))
        resumer = Trainer(model, TrainConfig(**TCFG, ckpt_dir=ckpt_dir),
                          TPLayout(model.cfg, mesh).init_shards(model, 1, "cpu"), mesh)
        resumed = resumer.try_resume()
        state = resumer.state()
        out["resumed"] = (resumed, resumer.step, None if state is None else _numpy(state))
        out["ring"] = _ring_errors(mesh, 2, idx)
    if shape == (1, 4):
        odd = get_model(_cfg(ARCH, vocab_size=ODD_VOCAB))
        out["odd"] = _tp_steps(mesh, odd, odd.init(0, "cpu", dtype=torch.float32),
                               [_batch(odd.cfg, batch=ODD_BATCH, seq=ODD_SEQ)], tcfg)
        out["witness"] = _witness(mesh, model, whole, batch)
        out["ring"] = _ring_errors(mesh, 4, idx)
    return out


def _rank(rank: int, world: int, shapes, data: dict, ckpt_dir: str) -> dict:
    """Every case of each mesh of ``shapes`` (meshes of this world size),
    one mesh after another, on this rank."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    return {shape: _cases(Mesh(shape, ("data", "model")), shape, data, ckpt_dir) for shape in shapes}


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """JAX's single-device steps (glm4-9b and the SWA model) and the port's
    one-process steps and gradients."""
    import jax

    from repro.configs import get_smoke as jax_get_smoke
    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.models.registry import get_model as jax_get_model
    from repro.optim import adamw_init as jax_adamw_init
    from repro.train.loop import TrainConfig as JaxTrainConfig
    from repro.train.loop import make_train_step as jax_make_train_step

    out = {}
    for arch, seq in ((ARCH, SEQ), (SWA, SWA_SEQ)):
        jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
        jmodel = jax_get_model(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jbatch = jax_make_batch(jcfg, batch=BATCH, seq=seq, kind="train", seed=0)
        jp, _, jm = jax.jit(jax_make_train_step(jmodel, JaxTrainConfig(**TCFG)))(
            jparams, jax_adamw_init(jparams), jbatch, STEP)
        cfg = _cfg(arch)
        out[arch] = {"params": params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu"),
                     "batch": {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()},
                     "jax": (_numpy(params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")),
                             {k: float(v) for k, v in jm.items()})}
    model = get_model(_cfg(ARCH))
    params, batch = out[ARCH]["params"], out[ARCH]["batch"]
    out["two"] = [_batch(model.cfg, seed=s) for s in range(2)]
    out["micro"] = _one_process(model, params, out["two"], TrainConfig(**TCFG, microbatches=2))
    odd = get_model(_cfg(ARCH, vocab_size=ODD_VOCAB))
    odd_params = odd.init(0, "cpu", dtype=torch.float32)
    out["odd"] = (_numpy(odd_params),
                  *_one_process(odd, odd_params, [_batch(odd.cfg, batch=ODD_BATCH, seq=ODD_SEQ)], TrainConfig(**TCFG)))
    out["grads"] = _numpy(make_grad_fn(model, TrainConfig(**TCFG))(params, batch)[0])
    return out


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """mesh shape -> the ranks' results; one spawn a world size running each
    of its meshes in turn, world 4 ((2, 2) and (1, 4)) first, as (1, 2)
    restores the checkpoint (2, 2) writes."""
    cache = {}
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    data = {"params": _numpy(reference[ARCH]["params"]), "batch": _numpy(reference[ARCH]["batch"]),
            "swa_params": _numpy(reference[SWA]["params"]), "swa_batch": _numpy(reference[SWA]["batch"]),
            "two": _numpy(reference["two"])}

    def get(shape):
        world = math.prod(shape)
        if world == 2:
            get((2, 2))  # the checkpoint (1, 2) restores
        if world not in cache:
            cache[world] = run_ranks(_rank, world, str(tmp_path_factory.mktemp("tp")), timeout_s=120,
                                     args=([s for s in MESHES if math.prod(s) == world], data, ckpt_dir))
        return [r[shape] for r in cache[world]]

    get.ckpt_dir = ckpt_dir
    return get


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _close(got, want, what, tol=2e-4):
    for (path, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{what} {path}")


def _moved_alike(got, want, start, what):
    """Each leaf's change from ``start`` within MOVED_RTOL (relative L2) of
    ``want``'s change from it, and the update moved the weights."""
    total = 0.0
    for (path, a), (_, b), (_, p0) in zip(leaves_with_path(got), leaves_with_path(want), leaves_with_path(start),
                                          strict=True):
        d_got, d_want = a - p0, b - p0
        moved = float(np.linalg.norm(d_want))
        total += moved
        assert np.linalg.norm(d_got - d_want) <= MOVED_RTOL * moved, (
            f"{what} {path}: change {np.linalg.norm(d_got - d_want) / max(moved, 1e-30):.3e} relative off")
    assert total > 0, f"{what}: the step moved no weight"


def _held(results, case, want_p, want_m, start, what):
    """Rank 0's gathered parameters and every rank's metrics against the
    wanted step; the shards alike across "data", the replicated leaves
    alike across every rank."""
    for r in results:
        np.testing.assert_allclose(r[case][0]["loss"], want_m["loss"], rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(r[case][0]["grad_norm"], want_m["grad_norm"], rtol=1e-5, err_msg=what)
    got = results[0][case][1]["params"]
    _close(got, want_p, what)
    _moved_alike(got, want_p, start, what)
    assert all(r[case][1] is None for r in results[1:])  # the whole state on rank 0 alone
    return got


def _shards_agree(results, shape, case, whole):
    """Ranks of one "model" coordinate hold bitwise equal shards; a leaf
    the specs replicate over "model" is bitwise equal on every rank."""
    mesh = Mesh(shape, ("data", "model"))
    specs = TPLayout(get_model(_cfg(ARCH)).cfg, mesh).leaf_specs(whole)
    for rank, r in enumerate(results):
        ref = results[mesh.coords(rank)["model"]][case][2]  # the data-0 rank of this model coordinate
        for (path, a), (_, b), (_, c), spec in zip(leaves_with_path(r[case][2]), leaves_with_path(ref),
                                                   leaves_with_path(results[0][case][2]), specs, strict=True):
            assert np.array_equal(a, b), (shape, rank, path, "differs from its data-0 rank")
            if all(ax is None for ax in spec):
                assert np.array_equal(a, c), (shape, rank, path, "replicated leaf differs from rank 0's")


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4", "2x2"])
def test_one_step_matches_jax_single_device_step(reference, spawned, shape):
    results = spawned(shape)
    want_p, want_m = reference[ARCH]["jax"]
    _held(results, "equiv", want_p, want_m, _numpy(reference[ARCH]["params"]), f"{shape} vs JAX")
    _shards_agree(results, shape, "equiv", reference[ARCH]["params"])


def test_sliding_window_model_matches_jax_at_tp2(reference, spawned):
    want_p, want_m = reference[SWA]["jax"]
    _held(spawned((1, 2)), "swa", want_p, want_m, _numpy(reference[SWA]["params"]), f"{SWA} (1, 2) vs JAX")


def test_microbatches_and_remat_at_tp2(reference, spawned):
    want_p, want_m = reference["micro"]
    _held(spawned((1, 2)), "micro", want_p, want_m, _numpy(reference[ARCH]["params"]),
          "(1, 2) microbatches 2 + remat vs one process")
    for k in ("ce", "lr"):
        assert spawned((1, 2))[0]["micro"][0][k] == pytest.approx(want_m[k], rel=1e-5)


def test_indivisible_vocab_and_padded_rows_at_tp4(reference, spawned):
    """Vocab 254 over 4 ranks: the table and the head replicated, each rank
    running the head on its own rows; 45 stream rows padded to 48, the pad
    carrying no loss and no gradient."""
    start, want_p, want_m = reference["odd"]
    assert ODD_VOCAB % 4 and (ODD_BATCH * ODD_SEQ) % 4
    _held(spawned((1, 4)), "odd", want_p, want_m, start, "(1, 4) vocab 254, 45 rows vs one process")


@pytest.mark.parametrize("tp", [2, 4])
def test_ring_functions_gradients_match_the_unsharded_product(spawned, tp):
    results = spawned((1, tp))
    for r in results:
        assert len(r["ring"]) == 8  # two rings x two directions x overlap on / off
        for case, ex, ew in r["ring"]:
            assert ex <= 1e-5 and ew <= 1e-5, (tp, case, ex, ew)


def test_checkpoint_written_at_2x2_restores_at_1x2_and_1x1(spawned):
    saved = spawned((2, 2))[0]["ckpt"]
    saved = dict(leaves_with_path(saved))
    ok, step, got = spawned((1, 2))[0]["resumed"]
    assert ok and step == STEP + 2
    model = get_model(_cfg(ARCH))
    one = Trainer(model, TrainConfig(**TCFG, ckpt_dir=spawned.ckpt_dir), model.init(2, "cpu", dtype=torch.float32))
    assert one.try_resume() and one.step == STEP + 2
    for where, state in (("(1, 2)", got), ("(1, 1)", _numpy(one.state()))):
        state = dict(leaves_with_path(state))
        assert state.keys() == saved.keys(), where
        for k, a in state.items():
            assert a.dtype == saved[k].dtype and np.array_equal(a, saved[k]), (where, k)


def test_moments_are_zero1_blocks_of_the_tp_shards(reference, spawned):
    """Each rank's moment bytes are ``zero1_specs``' assignment over both
    axes: a leaf cut over "data" and / or "model" a 1/dp, 1/tp share."""
    params = reference[ARCH]["params"]
    for shape in MESHES:
        mesh = Mesh(shape, ("data", "model"))
        want = 0
        for leaf, spec in zip(leaves(params), leaves(sharding.zero1_specs(params, mesh)), strict=True):
            div = 1
            for ax in spec:
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    div *= mesh.shape[a] if a is not None else 1
            want += 2 * 4 * leaf.numel() // div
        assert all(r["equiv"][3] == want for r in spawned(shape)), shape


def test_kv_columns_cut_to_the_rank_give_a_wrong_gradient_at_tp4(reference, spawned):
    """At (1, 4) ranks 0 / 1 share KV head 0 and ranks 2 / 3 KV head 1: a
    rank that keeps only its KV columns gets its own query head's part of
    their gradient, not the whole; the pair's sum is the whole."""
    wk = reference["grads"]["layers"][0]["attn"]["wk"]
    hd = wk.shape[1] // 2
    got = [r["witness"] for r in spawned((1, 4))]
    for head, pair in ((0, (0, 1)), (1, (2, 3))):
        want = wk[:, head * hd:(head + 1) * hd]
        for r in pair:
            assert np.linalg.norm(got[r] - want) > 0.1 * np.linalg.norm(want), (r, "a cut rank's gradient is whole")
        np.testing.assert_allclose(got[pair[0]] + got[pair[1]], want, rtol=1e-4, atol=1e-6)
