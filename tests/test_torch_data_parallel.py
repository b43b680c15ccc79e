"""Data-parallel training with ZeRO-1 moments, on the CPU, against the reference.

* The reference's ``train_equiv`` (``tests/_distributed_helper.py``): glm4-9b
  SMOKE in fp32, batch 8 x 16, one step at dp 2 and dp 4 (Gloo ranks spawned
  by ``launch.mesh.run_ranks``, one spawn per world size) against JAX's
  single-device ``make_train_step`` on the same weights
  (``convert.params_from_jax``) and against the port's one-process step:
  loss within rtol 1e-5, every parameter within 2e-4, every rank's
  parameters bitwise equal.  The step runs at lr 1e-4 (the reference's
  case runs at step 0, where the schedule's lr is 0 and no weight moves).
  An update moves a weight by about lr, inside 2e-4, so every parameter
  comparison also holds each leaf's change from the initial weights to the
  one-process step's change (``_moved_alike``): a step that skipped or
  misplaced the update reads 1 there.
* Each rank's moments equal its ``zero1_specs`` slice of the one-process
  moments (the per-layer blocks of a path concatenated over its layers are
  the slice of the reference's stacked leaf), and their bytes are what the
  specs assign it.
* Two steps with ``microbatches=2``; a ``loss_mask`` that gives the ranks
  unequal token counts (the global masked mean); both at once, where each
  rank's microbatch is weighted by its tokens over its global microbatch's
  (the one-process step's mean of per-microbatch masked means); d_model 63, where the
  norms' scales and the embedding do not divide over the ranks, so those
  leaves are all-reduced while the rest are reduce-scattered.
* minicpm3-4b, xlstm-125m, musicgen-medium and internvl2-1b at dp 2 against
  the port's one-process step.
* The refusals: at a "model" axis of 2 the MLA, recurrent and frontend
  configs and a tied head raise with the tensor-parallel layout's reason; a
  dense GQA config there builds a ``Trainer``, and so does a MoE config at
  dp 2 and at (2, 2) (``tests/test_torch_expert_parallel.py`` steps it); a
  batch that does not divide raises.
* ``distributed/annotate.py``: every spec the port chooses equals the
  reference's ``_resolve`` / ``PartitionSpec`` on stand-in meshes (4, 2),
  (2, 16, 16) and (1, 1) (the reference's ``with_sharding_constraint`` and
  ``NamedSharding`` patched to hand back the spec); ``constrain`` returns
  its tensor.

The ranks import this module to find their body, so JAX and the reference
are imported inside the fixtures and tests that use them: a rank starts
without them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves, leaves_with_path, tree_map
from repro_torch.data.synthetic import make_batch
from repro_torch.distributed import annotate, data_parallel, sharding
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw_init
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

ARCH = "glm4-9b"
FAMILIES = ("minicpm3-4b", "xlstm-125m", "musicgen-medium", "internvl2-1b")
TCFG = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)  # lr 1e-4 at step 1
STEP = 1
BATCH, SEQ = 8, 16


def _cfg(arch):
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32")


def _odd_cfg():
    """glm4-9b SMOKE at d_model 63 (heads kept at 16 wide)."""
    cfg = _cfg(ARCH)
    return dataclasses.replace(cfg, d_model=63, head_dim=cfg.resolved_head_dim)


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _masked(batch: dict) -> dict:
    """The batch with a loss mask keeping 2, 4, ... of each row's labels, so
    the ranks' token counts differ."""
    b, s = batch["labels"].shape[:2]
    keep = torch.arange(s)[None, :] < (2 * torch.arange(1, b + 1)[:, None]).clamp(max=s)
    return dict(batch, loss_mask=keep.to(torch.int32))


def _one_step(model, params, batch, mesh=None, tcfg=None, steps=((None, STEP),)):
    """Train steps from ``params`` -> (params, opt state, metrics) as numpy."""
    tcfg = tcfg or TrainConfig(**TCFG)
    params = tree_map(lambda t: t.clone(), params)
    opt = adamw_init(params) if mesh is None else data_parallel.ZeroLayout(params, mesh).zero_state(params)
    fn = make_train_step(model, tcfg, mesh)
    for b, step in steps:
        params, opt, m = fn(params, opt, batch if b is None else b, step)
    return _numpy(params), _numpy(opt.mu), {k: float(v) for k, v in m.items()}


def _batches(cfg, n):
    return [make_batch(cfg, batch=BATCH, seq=SEQ, kind="train", seed=s, device="cpu") for s in range(n)]


def _rank(rank: int, world: int, params_np, batch_np) -> dict:
    """Every case of this world size, on this rank."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    mesh = Mesh((world, 1), ("data", "model"))
    cfg = _cfg(ARCH)
    model = get_model(cfg)
    params, batch = _torch(params_np), _torch(batch_np)
    out = {}
    p, mu, m = _one_step(model, params, batch, mesh)
    layout = data_parallel.ZeroLayout(params, mesh)
    out["equiv"] = dict(params=p, mu=mu, metrics=m, moment_bytes=layout.moment_bytes(layout.zero_state(params)))
    odd = get_model(_odd_cfg())
    odd_params = odd.init(0, "cpu", dtype=torch.float32)
    out["odd"] = _one_step(odd, odd_params, _batches(odd.cfg, 1)[0], mesh)
    out["odd_replicated"] = len(data_parallel.ZeroLayout(odd_params, mesh).replicated)
    out["mask"] = _one_step(model, params, _masked(batch), mesh)
    b2 = _batches(cfg, 2)
    out["micro"] = _one_step(model, params, None, mesh, TrainConfig(**TCFG, microbatches=2),
                             steps=((b2[0], STEP), (b2[1], STEP + 1)))
    out["mask_micro"] = _one_step(model, params, None, mesh, TrainConfig(**TCFG, microbatches=2),
                                  steps=((_masked(b2[0]), STEP), (_masked(b2[1]), STEP + 1)))
    if world == 2:
        for arch in FAMILIES:
            fcfg = _cfg(arch)
            fmodel = get_model(fcfg)
            out[arch] = _one_step(fmodel, fmodel.init(0, "cpu", dtype=torch.float32), _batches(fcfg, 1)[0], mesh)
    return out


@pytest.fixture(scope="module")
def reference():
    """JAX's single-device step and the port's one-process steps."""
    import jax

    from repro.configs import get_smoke as jax_get_smoke
    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.models.registry import get_model as jax_get_model
    from repro.optim import adamw_init as jax_adamw_init
    from repro.train.loop import TrainConfig as JaxTrainConfig
    from repro.train.loop import make_train_step as jax_make_train_step

    jcfg = dataclasses.replace(jax_get_smoke(ARCH), dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = jax_make_batch(jcfg, batch=BATCH, seq=SEQ, kind="train", seed=0)
    jp, _, jm = jax.jit(jax_make_train_step(jmodel, JaxTrainConfig(**TCFG)))(
        jparams, jax_adamw_init(jparams), jbatch, STEP)
    cfg = _cfg(ARCH)
    model = get_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    out = {"params": params, "batch": batch,
           "jax": (_numpy(params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")),
                   {k: float(v) for k, v in jm.items()}),
           "one": _one_step(model, params, batch), "mask": _one_step(model, params, _masked(batch))}
    b2 = _batches(cfg, 2)
    out["micro"] = _one_step(model, params, None, None, TrainConfig(**TCFG, microbatches=2),
                             steps=((b2[0], STEP), (b2[1], STEP + 1)))
    out["mask_micro"] = _one_step(model, params, None, None, TrainConfig(**TCFG, microbatches=2),
                                  steps=((_masked(b2[0]), STEP), (_masked(b2[1]), STEP + 1)))
    for arch in FAMILIES:
        fcfg = _cfg(arch)
        fmodel = get_model(fcfg)
        out[arch] = _one_step(fmodel, fmodel.init(0, "cpu", dtype=torch.float32), _batches(fcfg, 1)[0])
    odd = get_model(_odd_cfg())
    out["odd"] = _one_step(odd, odd.init(0, "cpu", dtype=torch.float32), _batches(odd.cfg, 1)[0])
    return out


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """world -> the ranks' results, each world spawned once."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = run_ranks(_rank, world, str(tmp_path_factory.mktemp(f"dp{world}")),
                                     args=(_numpy(reference["params"]), _numpy(reference["batch"])), timeout_s=120)
        return cache[world]

    return get


def _same_on_every_rank(results, case, field=0):
    first = leaves(results[0][case] if field is None else results[0][case][field])
    for r in results[1:]:
        got = leaves(r[case] if field is None else r[case][field])
        assert all(np.array_equal(a, b) for a, b in zip(got, first, strict=True)), (case, "ranks differ")


def _close(got, want, rtol, atol, what):
    for (path, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what} {path}")


MOVED_RTOL = 1e-2  # relative L2 of a leaf's change; a skipped or misplaced update reads 1 (or more)


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
            f"{what} {path}: change {np.linalg.norm(d_got - d_want) / max(moved, 1e-30):.3e} relative off the "
            f"one-process step's")
    assert total > 0, f"{what}: the step moved no weight"


def _init(arch):
    return _numpy(get_model(_cfg(arch)).init(0, "cpu", dtype=torch.float32))


@pytest.mark.parametrize("world", [2, 4])
def test_one_step_matches_jax_single_device_step(reference, spawned, world):
    results = spawned(world)
    want_p, want_m = reference["jax"]
    for r in results:
        eq = r["equiv"]
        np.testing.assert_allclose(eq["metrics"]["loss"], want_m["loss"], rtol=1e-5)
        np.testing.assert_allclose(eq["metrics"]["grad_norm"], want_m["grad_norm"], rtol=1e-5)
        _close(eq["params"], want_p, 2e-4, 2e-4, f"dp{world} vs JAX")
        _close(eq["params"], reference["one"][0], 2e-4, 2e-4, f"dp{world} vs one process")
        _moved_alike(eq["params"], want_p, _numpy(reference["params"]), f"dp{world} vs JAX")
        _moved_alike(eq["params"], reference["one"][0], _numpy(reference["params"]), f"dp{world} vs one process")
        assert eq["metrics"]["loss"] == pytest.approx(reference["one"][2]["loss"], rel=1e-5)
    _same_on_every_rank([{"p": r["equiv"]["params"]} for r in results], "p", None)


def _stacked(tree) -> dict:
    """path without layer indices -> the leaves of that path, in layer order."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        out.setdefault("/".join(p for p in path.split("/") if not p.isdigit()), []).append((path, leaf))
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_each_ranks_moments_are_its_zero1_slice(reference, spawned, world):
    """The rank's first moments are the one-process ones at its
    ``zero1_specs`` slice (a path held in a list of layers stacked as the
    reference stacks it); its moment bytes are what the specs assign it."""
    results = spawned(world)
    params = reference["params"]
    mesh = Mesh((world, 1), ("data", "model"))
    specs = dict(leaves_with_path(sharding.zero1_specs(params, mesh)))
    one_mu = _stacked(reference["one"][1])
    n_params = {k: sum(v.numel() for _, v in ls) for k, ls in _stacked(params).items()}
    for rank, r in enumerate(results):
        mine = _stacked(r["equiv"]["mu"])
        want_bytes = 0
        for key, ls in one_mu.items():
            paths = [p for p, _ in ls]
            spec = specs[paths[0]]
            layered = paths[0] != key
            full = torch.from_numpy(np.stack([a for _, a in ls]) if layered else ls[0][1])
            want = sharding.shard_of(full, spec, mesh, rank).numpy()
            got = np.concatenate([a for _, a in mine[key]]) if layered else mine[key][0][1]
            scale = float(np.abs(full.numpy()).max())
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale, err_msg=f"rank {rank} {key}")
            sharded = any(e is not None and "data" in (e if isinstance(e, tuple) else (e,)) for e in spec)
            want_bytes += 2 * 4 * (n_params[key] // world if sharded else n_params[key])
        assert r["equiv"]["moment_bytes"] == want_bytes


@pytest.mark.parametrize("world", [2, 4])
def test_loss_mask_with_unequal_token_counts_is_the_global_masked_mean(reference, spawned, world):
    results = spawned(world)
    counts = _masked(reference["batch"])["loss_mask"].sum(1).reshape(world, -1).sum(1)
    assert len(set(counts.tolist())) == world  # every rank a different count
    want_p, want_mu, want_m = reference["mask"]
    for r in results:
        p, mu, m = r["mask"]
        for k in ("ce", "loss", "grad_norm"):
            np.testing.assert_allclose(m[k], want_m[k], rtol=1e-5, err_msg=k)
        _close(p, want_p, 2e-4, 2e-4, f"dp{world} masked")
        _moved_alike(p, want_p, _numpy(reference["params"]), f"dp{world} masked")
    assert reference["mask"][2]["loss"] != pytest.approx(reference["one"][2]["loss"], rel=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_two_steps_with_microbatches(reference, spawned, world):
    results = spawned(world)
    want_p, _, want_m = reference["micro"]
    for r in results:
        p, _, m = r["micro"]
        for k in ("ce", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], want_m[k], rtol=1e-5, err_msg=k)
        _close(p, want_p, 2e-4, 2e-4, f"dp{world} microbatches")
        _moved_alike(p, want_p, _numpy(reference["params"]), f"dp{world} microbatches")
    _same_on_every_rank(results, "micro")


@pytest.mark.parametrize("world", [2, 4])
def test_loss_mask_with_microbatches_weights_each_global_microbatch(reference, spawned, world):
    """A mask and two microbatches at once: each rank's microbatches lie in
    one global microbatch whose token count differs from theirs, so the
    step equals the one-process step only when each is weighted by its
    tokens over its global microbatch's."""
    results = spawned(world)
    want_p, _, want_m = reference["mask_micro"]
    for r in results:
        p, _, m = r["mask_micro"]
        for k in ("ce", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m[k], want_m[k], rtol=1e-5, err_msg=k)
        _close(p, want_p, 2e-4, 2e-4, f"dp{world} masked microbatches")
        _moved_alike(p, want_p, _numpy(reference["params"]), f"dp{world} masked microbatches")
    _same_on_every_rank(results, "mask_micro")


@pytest.mark.parametrize("arch", FAMILIES)
def test_other_families_at_dp2_match_one_process(reference, spawned, arch):
    results = spawned(2)
    want_p, want_mu, want_m = reference[arch]
    for r in results:
        p, _, m = r[arch]
        for k in ("ce", "loss", "grad_norm"):
            np.testing.assert_allclose(m[k], want_m[k], rtol=1e-5, err_msg=f"{arch} {k}")
        _close(p, want_p, 2e-4, 2e-4, f"{arch} dp2")
        _moved_alike(p, want_p, _init(arch), f"{arch} dp2")
    _same_on_every_rank(results, arch)


@pytest.mark.parametrize("world", [2, 4])
def test_indivisible_leaves_are_all_reduced(reference, spawned, world):
    """At d_model 63 the norms' scales and the embedding (V, 63) divide over
    no rank count: zero1_specs replicates them, the step all-reduces their
    gradients and reduce-scatters the rest; it equals the one-process step."""
    want_p, _, want_m = reference["odd"]
    specs = leaves(sharding.zero1_specs(get_model(_odd_cfg()).init(0, "cpu"), Mesh((world, 1), ("data", "model"))))
    replicated = sum("data" not in spec for spec in specs)
    assert 0 < replicated < len(specs)  # both exchanges run
    for r in spawned(world):
        p, _, m = r["odd"]
        assert r["odd_replicated"] == replicated
        for k in ("ce", "loss", "grad_norm"):
            np.testing.assert_allclose(m[k], want_m[k], rtol=1e-5, err_msg=k)
        _close(p, want_p, 2e-4, 2e-4, f"dp{world} d_model 63")
        _moved_alike(p, want_p, _numpy(get_model(_odd_cfg()).init(0, "cpu", dtype=torch.float32)),
                     f"dp{world} d_model 63")
    _same_on_every_rank(spawned(world), "odd")


def test_moe_at_dp2_and_a_model_axis_build_a_trainer():
    """On one process (no collective runs until a step): MoE at dp 2 trains
    through the layout at tp 1 (its routing pooled over the data ranks),
    and at a "model" axis of 2 each rank holds half the experts whole over
    "data" (the expert masters are not cut over "data"; their moments are,
    by ``zero1_specs``), the router whole."""
    from repro_torch.distributed.tp_layout import TPLayout

    cfg = _cfg("qwen3-moe-30b-a3b")
    model = get_model(cfg)
    params = model.init(0, "cpu", dtype=torch.float32)
    at_dp2 = Trainer(model, TrainConfig(), params, mesh=Mesh((2, 1), ("data", "model")))
    assert at_dp2.tp is not None and at_dp2.tp.tp == 1 and at_dp2.layout.dp == 2
    data_parallel.check_trainable(cfg, Mesh((2, 2), ("data", "model")))
    mesh = Mesh((2, 2), ("data", "model"))
    trainer = Trainer(model, TrainConfig(), TPLayout(cfg, mesh).shard_train(params), mesh=mesh)
    ffn, whole = trainer.params["layers"][0]["ffn"], params["layers"][0]["ffn"]
    assert ffn["w_gate"].shape == (cfg.moe.n_experts // 2, *whole["w_gate"].shape[1:])
    assert ffn["router"].shape == whole["router"].shape
    assert trainer.opt_state.mu["layers"][0]["ffn"]["w_gate"].shape == (1, cfg.moe.n_experts // 2, cfg.d_model // 2,
                                                                         cfg.moe.d_ff_expert)
    Trainer(model, TrainConfig(), params, mesh=Mesh((1, 1), ("data", "model")))  # one rank: trained as on one card


@pytest.mark.parametrize("arch,tied", [("minicpm3-4b", False), ("xlstm-125m", False), ("zamba2-7b", False),
                                       ("musicgen-medium", False), ("internvl2-1b", False), (ARCH, True)],
                         ids=["mla", "ssm", "hybrid", "audio", "vlm", "tied"])
def test_what_the_tp_layout_does_not_lay_out_is_refused_at_model2(arch, tied):
    cfg = _cfg(arch)
    if tied:
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    model = get_model(cfg)
    with pytest.raises(NotImplementedError, match="tensor-parallel layout lays out the dense GQA / SWA decoder"):
        Trainer(model, TrainConfig(), model.init(0, "cpu"), mesh=Mesh((1, 2), ("data", "model")))
    with pytest.raises(NotImplementedError, match="tensor-parallel layout lays out the dense GQA / SWA decoder"):
        data_parallel.check_trainable(cfg, Mesh((2, 2), ("data", "model")))


def test_dense_gqa_at_a_model_axis_of_2_builds_a_trainer():
    """On one process (no collective runs until a step): the rank's shards,
    its moment blocks at their shapes, the TP loss."""
    from repro_torch.distributed.tp_layout import TPLayout

    model = get_model(_cfg(ARCH))
    mesh = Mesh((1, 2), ("data", "model"))
    layout = TPLayout(model.cfg, mesh)
    whole = model.init(0, "cpu", dtype=torch.float32)
    trainer = Trainer(model, TrainConfig(), layout.shard_train(whole), mesh=mesh)
    assert trainer.tp is not None and trainer.layout is not None and trainer.leader
    wq = trainer.params["layers"][0]["attn"]["wq"]
    assert wq.shape[1] == whole["layers"][0]["attn"]["wq"].shape[1] // 2
    assert trainer.params["layers"][0]["attn"]["wk"].shape == whole["layers"][0]["attn"]["wk"].shape  # kept whole
    assert [tuple(t.shape) for t in leaves(trainer.whole)] == [tuple(t.shape) for t in leaves(whole)]
    assert trainer.opt_state.mu["layers"][0]["attn"]["wq"].shape == (1, *wq.shape)


def test_batch_that_does_not_divide_raises():
    batch = make_batch(_cfg(ARCH), batch=6, seq=8, kind="train", seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not divide over 4 data ranks"):
        data_parallel.local_batch(batch, Mesh((4, 1), ("data", "model")), rank=0)
    rows = [data_parallel.local_batch(batch, Mesh((3, 1), ("data", "model")), rank=r)["tokens"] for r in range(3)]
    assert torch.equal(torch.cat(rows), batch["tokens"]) and rows[0].shape[0] == 2


# ---------------------------------------------------------------------------
# distributed/annotate.py
# ---------------------------------------------------------------------------


class RefMesh:
    """A mesh's shape and axis names, all the reference's rules read."""

    def __init__(self, sizes, names):
        self.shape, self.axis_names = dict(zip(names, sizes)), tuple(names)


MESHES = [((4, 2), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")), ((1, 1), ("data", "model"))]
AXES = [None, "data", "model", "pod", ("pod", "data"), ("data", "model"), ("pod", "data", "model"), ("absent",)]
SHAPES = [(8, 32, 16), (6, 3, 5), (32, 64), (2,), (64, 1, 256)]


def _norm(entry):
    if isinstance(entry, tuple):
        return None if not entry else (entry[0] if len(entry) == 1 else entry)
    return entry


@pytest.fixture
def spec_of_ref(monkeypatch):
    """The reference's ``constrain`` / ``constrain_pref`` handing back the
    spec they build instead of a constrained array."""
    import jax

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)
    monkeypatch.setattr(jax.sharding, "NamedSharding", lambda mesh, spec: tuple(_norm(e) for e in spec))


@pytest.mark.parametrize("shape,names", MESHES, ids=["4x2", "2x16x16", "1x1"])
def test_annotate_specs_equal_the_reference(spec_of_ref, shape, names):
    from repro.distributed import annotate as ref_annotate

    mesh, ref = Mesh(shape, names), RefMesh(shape, names)
    for ax in AXES:
        assert annotate._resolve(ax, mesh) == ref_annotate._resolve(ax, ref), ax
    for x_shape in SHAPES:
        x = np.zeros(x_shape, np.float32)
        for axes in [(a, b, c) for a in AXES for b in AXES[:4] for c in AXES[:3]]:
            with ref_annotate.annotations(ref):
                want = ref_annotate.constrain(x, *axes)
            assert annotate.constrain_spec(x_shape, axes, mesh) == want, (x_shape, axes)
        for batch_dim in (None, 0, 1):
            if batch_dim is not None and batch_dim >= len(x_shape):
                continue
            for cands in [(), (1,), (2, 1), (0,), (1, 2), (5,)]:
                with ref_annotate.annotations(ref):
                    want = ref_annotate.constrain_pref(x, batch_dim, cands)
                assert annotate.constrain_pref_spec(x_shape, batch_dim, cands, mesh) == want, (x_shape, batch_dim,
                                                                                                cands)


def test_annotate_constrain_returns_its_tensor_and_the_context_holds_the_mesh():
    x = torch.zeros(4, 8)
    mesh = Mesh((2, 1), ("data", "model"))
    assert annotate.current_mesh() is None
    with annotate.annotations(mesh):
        assert annotate.current_mesh() is mesh
        assert annotate.constrain(x, "data", "model") is x
        assert annotate.constrain_pref(x, 0, (1,)) is x
    assert annotate.current_mesh() is None
    # the data-parallel batch rule is constrain_pref's on dim 0
    assert annotate.constrain_pref_spec((8, 16), 0, (), mesh) == ("data", None)
    assert annotate.constrain_pref_spec((7, 16), 0, (), mesh) == (None, None)
