"""Expert parallelism on a ("data", "model") mesh, on the CPU, against the reference.

* The reference's ``moe_ep`` (``tests/_distributed_helper.py``): fp32 SMOKE
  qwen3-moe-30b-a3b (8 experts, top-2), ``dispatch_groups`` 8 and
  ``capacity_factor`` 4.0, batch 8 x 16, every parameter placed by the
  sharding rules, equal to the single-device forward within 2e-4.  Here on
  Gloo ranks spawned by ``launch.mesh.run_ranks`` -- (1, 2), (2, 1) and (2, 2),
  one spawn a world size -- for three routings: that one, one dispatch
  group at 4.0, and one group at 0.5, where a third of the slots drop (16
  slots an expert against ~32 routed), so the drops are decided over the
  whole batch.  Each rank's ``TPLayout.forward`` (the logits of its data
  line's rows, the batch's aux loss) against JAX's ``model.forward``.
* Every layer's kept and dropped slots, as each rank's plan counts them from
  the pooled routing, equal the one-card dispatch's (``moe._dispatch_group``
  in the port's one-process forward).
* Served greedy tokens (``ServeEngine(mesh=...)``) equal to JAX's
  single-device engine, for the moe_ep routing and the dropping one.
* One training step (``Trainer(mesh=...)``) against JAX's single-device step:
  loss 1e-5, every parameter 2e-4, each leaf's change from the initial
  weights within 1e-2 relative L2 of JAX's (``_moved_alike``); rank 0 holds
  the whole state (``Trainer.state``), the ranks of a data line the same
  experts.  Two microbatches with remat at (2, 2) against the port's
  one-process step: the ranks step through the global microbatches together.
* The exchange's gradient against its plain transpose, bit for bit.
* ``expert_parallel.plan`` in one process, each rank of a line simulated:
  the packed buffers hold exactly the kept rows of the one-card dispatch.

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
from repro_torch.core.tree import leaves_with_path, tree_map
from repro_torch.distributed import expert_parallel as ep
from repro_torch.distributed.data_parallel import local_batch
from repro_torch.distributed.tp_layout import TPLayout
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import moe
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw_init
from repro_torch.serving import ServeConfig, ServeEngine
from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

ARCH = "qwen3-moe-30b-a3b"
ROUTINGS = {"moe_ep": (8, 4.0), "one_group": (1, 4.0), "drop": (1, 0.5)}  # (dispatch_groups, capacity_factor)
TRAINED = ("moe_ep", "drop")
SERVED = ("moe_ep", "drop")
MESHES = ((1, 2), (2, 1), (2, 2))
TCFG = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)  # lr 1e-4 at step 1
STEP = 1
BATCH, SEQ, GEN, MAX_LEN = 8, 16, 8, 24
TOL, MOVED_RTOL = 2e-4, 1e-2
EXCHANGE_D = 5


def _cfg(routing: str):
    cfg = dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")
    g, cf = ROUTINGS[routing]
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=g, capacity_factor=cf))


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _split(world: int, seed: int) -> list[list[int]]:
    """sizes[i][j]: the rows rank i sends rank j, some of them 0."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 4, (world, world), generator=gen).tolist()


def _exchange_check(mesh: Mesh) -> tuple[bool, bool]:
    """The exchange on this rank's "model" line and its gradient, against
    the plain gather of every rank's rows and its transpose, bit for bit."""
    tp, idx = mesh.shape["model"], mesh.axis_index("model")
    sizes = _split(tp, 7)
    gen = torch.Generator().manual_seed(11)
    xs = [torch.randn(sum(sizes[i]), EXCHANGE_D, generator=gen) for i in range(tp)]  # every rank's rows
    dys = [torch.randn(sum(sizes[i][j] for i in range(tp)), EXCHANGE_D, generator=gen) for j in range(tp)]

    def block(i, j):  # rank i's rows for rank j
        off = sum(sizes[i][:j])
        return slice(off, off + sizes[i][j])

    x = xs[idx].clone().requires_grad_()
    y = ep.exchange(x, mesh.group("model"), sizes[idx], [sizes[i][idx] for i in range(tp)])
    y.backward(dys[idx])
    want_y = torch.cat([xs[i][block(i, idx)] for i in range(tp)])
    recv = [[sizes[i][j] for i in range(tp)] for j in range(tp)]  # rank j receives from each i, in order
    want_dx = torch.cat([dys[j][sum(recv[j][:idx]):sum(recv[j][:idx + 1])] for j in range(tp)])
    return torch.equal(y.detach(), want_y), torch.equal(x.grad, want_dx)


def _cases(mesh: Mesh, shape, data: dict) -> dict:
    """Every case of one mesh, on this rank."""
    whole = _torch(data["params"])
    batch = _torch(data["batch"])
    out = {"fwd": {}, "kept": {}, "step": {}, "tokens": {}}
    for routing in ROUTINGS:
        model = get_model(_cfg(routing))
        layout = TPLayout(model.cfg, mesh)
        ep.LOG.on = True
        ep.LOG.clear()
        with torch.no_grad():
            logits, aux = layout.forward(layout.shard_train(whole), local_batch(batch, mesh))
        out["kept"][routing] = [(e["kept"], e["dropped"]) for e in ep.LOG.entries()]
        ep.LOG.on = False
        out["fwd"][routing] = (logits.numpy(), float(aux))
        if routing in TRAINED:
            trainer = Trainer(model, TrainConfig(**TCFG), layout.shard_train(tree_map(torch.clone, whole)), mesh)
            trainer.step = STEP
            m = trainer.run(iter([batch]), 1, log_every=0)
            state = trainer.state()
            out["step"][routing] = ({k: float(v) for k, v in m.items()},
                                    None if state is None else _numpy(state["params"]), _numpy(trainer.params))
        if routing in SERVED:
            engine = ServeEngine(model, whole, ServeConfig(max_len=MAX_LEN, batch=BATCH), device="cpu", mesh=mesh)
            out["tokens"][routing] = engine.generate({"tokens": _torch(data["prompt"])}, GEN).numpy()
    if shape == (2, 2):
        model = get_model(_cfg("drop"))
        trainer = Trainer(model, TrainConfig(**TCFG, microbatches=2, remat=True),
                          TPLayout(model.cfg, mesh).shard_train(tree_map(torch.clone, whole)), mesh)
        trainer.step = STEP
        m = trainer.run(iter([batch]), 1, log_every=0)
        state = trainer.state()
        out["micro"] = ({k: float(v) for k, v in m.items()}, None if state is None else _numpy(state["params"]))
    if shape[1] > 1:
        out["exchange"] = _exchange_check(mesh)
    return out


def _rank(rank: int, world: int, shapes, data: dict) -> dict:
    """Every case of each mesh of ``shapes`` (meshes of this world size),
    one mesh after another, on this rank."""
    torch.set_num_threads(1)  # the ranks share the host's cores
    return {shape: _cases(Mesh(shape, ("data", "model")), shape, data) for shape in shapes}


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """JAX's single-device forward (every routing), train step and served
    tokens (``TRAINED`` / ``SERVED``); the port's one-process step with two
    microbatches and each layer's kept slots on one card."""
    import jax

    from repro.configs import get_smoke as jax_get_smoke
    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.models.registry import get_model as jax_get_model
    from repro.optim import adamw_init as jax_adamw_init
    from repro.serving import ServeConfig as JaxServeConfig
    from repro.serving import ServeEngine as JaxServeEngine
    from repro.train.loop import TrainConfig as JaxTrainConfig
    from repro.train.loop import make_train_step as jax_make_train_step

    out = {"fwd": {}, "step": {}, "tokens": {}, "kept": {}}
    base = dataclasses.replace(jax_get_smoke(ARCH), dtype="float32")
    jparams = jax_get_model(base).init(jax.random.PRNGKey(0))
    jbatch = jax_make_batch(base, batch=BATCH, seq=SEQ, kind="train", seed=0)
    jprompt = jax_make_batch(base, batch=BATCH, seq=SEQ, kind="prefill", seed=0)
    for routing, (g, cf) in ROUTINGS.items():
        jmodel = jax_get_model(dataclasses.replace(base, moe=dataclasses.replace(base.moe, dispatch_groups=g,
                                                                                  capacity_factor=cf)))
        logits, aux = jax.jit(jmodel.forward)(jparams, jbatch)
        out["fwd"][routing] = (np.asarray(logits), float(aux))
        if routing in TRAINED:
            jp, _, jm = jax.jit(jax_make_train_step(jmodel, JaxTrainConfig(**TCFG)))(
                jparams, jax_adamw_init(jparams), jbatch, STEP)
            out["step"][routing] = (_numpy(params_from_jax(jax.tree.map(np.asarray, jp), _cfg(routing), device="cpu")),
                                    {k: float(v) for k, v in jm.items()})
        if routing in SERVED:
            out["tokens"][routing] = np.asarray(JaxServeEngine(jmodel, jparams, JaxServeConfig(
                max_len=MAX_LEN, batch=BATCH)).generate(jprompt, GEN))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), _cfg("drop"), device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    out.update(params=params, batch=batch, prompt=np.asarray(jprompt["tokens"]))
    model = get_model(_cfg("drop"))
    p, _, m = make_train_step(model, TrainConfig(**TCFG, microbatches=2))(
        tree_map(torch.clone, params), adamw_init(params), batch, STEP)
    out["micro"] = (_numpy(p), {k: float(v) for k, v in m.items()})
    dispatch = moe._dispatch_group
    for routing in ROUTINGS:
        seen = []

        def counting(xf, top_e, top_w, cap, cfg):
            got = dispatch(xf, top_e, top_w, cap, cfg)
            kept = int((got[2] < cap).sum())
            seen.append((kept, top_e.numel() - kept))
            return got

        moe._dispatch_group = counting
        try:
            with torch.no_grad():
                get_model(_cfg(routing)).forward(params, batch)
        finally:
            moe._dispatch_group = dispatch
        out["kept"][routing] = seen
    return out


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """mesh shape -> the ranks' results; one spawn a world size running each
    of its meshes in turn."""
    cache = {}
    data = {"params": _numpy(reference["params"]), "batch": _numpy(reference["batch"]), "prompt": reference["prompt"]}

    def get(shape):
        world = math.prod(shape)
        if world not in cache:
            cache[world] = run_ranks(_rank, world, str(tmp_path_factory.mktemp("ep")), timeout_s=120,
                                     args=([s for s in MESHES if math.prod(s) == world], data))
        return [r[shape] for r in cache[world]]

    return get


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _close(got, want, what, tol=TOL):
    for (path, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{what} {path}")


def _moved_alike(got, want, start, what):
    """Each leaf's change from ``start`` within MOVED_RTOL (relative L2) of
    ``want``'s change from it, and the update moved the weights."""
    total = 0.0
    for (path, a), (_, b), (_, p0) in zip(leaves_with_path(got), leaves_with_path(want), leaves_with_path(start),
                                          strict=True):
        moved = float(np.linalg.norm(b - p0))
        total += moved
        assert np.linalg.norm((a - p0) - (b - p0)) <= MOVED_RTOL * moved, f"{what} {path}"
    assert total > 0, f"{what}: the step moved no weight"


@pytest.mark.parametrize("routing", list(ROUTINGS))
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1", "2x2"])
def test_forward_logits_and_aux_match_jax_single_device(reference, spawned, shape, routing):
    want_logits, want_aux = reference["fwd"][routing]
    rows = BATCH // shape[0]
    mesh = Mesh(shape, ("data", "model"))
    for rank, r in enumerate(spawned(shape)):
        logits, aux = r["fwd"][routing]
        d = mesh.coords(rank)["data"]
        np.testing.assert_allclose(logits, want_logits[d * rows:(d + 1) * rows], rtol=TOL, atol=TOL,
                                   err_msg=f"{shape} {routing} rank {rank}")
        np.testing.assert_allclose(aux, want_aux, rtol=TOL, atol=TOL, err_msg=f"{shape} {routing} rank {rank} aux")


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1", "2x2"])
def test_kept_and_dropped_slots_equal_the_one_card_dispatch(reference, spawned, shape):
    """The capacity is decided over the whole batch: every layer's kept and
    dropped slots on every rank are the one-card dispatch's, and the
    dropping routing drops some."""
    for routing, want in reference["kept"].items():
        assert len(want) == _cfg(routing).n_layers
        for r in spawned(shape):
            assert r["kept"][routing] == want, (shape, routing)
    assert all(dropped > 0 for _, dropped in reference["kept"]["drop"])
    assert all(dropped == 0 for _, dropped in reference["kept"]["moe_ep"])


@pytest.mark.parametrize("routing", SERVED)
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1", "2x2"])
def test_served_tokens_equal_jax_single_device_engine(reference, spawned, shape, routing):
    for rank, r in enumerate(spawned(shape)):
        np.testing.assert_array_equal(r["tokens"][routing], reference["tokens"][routing],
                                      err_msg=f"{shape} {routing} rank {rank}")


@pytest.mark.parametrize("routing", TRAINED)
@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1", "2x2"])
def test_one_step_matches_jax_single_device_step(reference, spawned, shape, routing):
    want_p, want_m = reference["step"][routing]
    results = spawned(shape)
    what = f"{shape} {routing} vs JAX"
    for r in results:
        m = r["step"][routing][0]
        np.testing.assert_allclose(m["loss"], want_m["loss"], rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(m["aux"], want_m["aux"], rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(m["grad_norm"], want_m["grad_norm"], rtol=1e-5, err_msg=what)
    got = results[0]["step"][routing][1]
    _close(got, want_p, what)
    _moved_alike(got, want_p, _numpy(reference["params"]), what)
    assert all(r["step"][routing][1] is None for r in results[1:])  # the whole state on rank 0 alone
    mesh = Mesh(shape, ("data", "model"))
    for rank, r in enumerate(results):  # a data group holds the same shards
        ref = results[mesh.coords(rank)["model"]]["step"][routing][2]
        for (path, a), (_, b) in zip(leaves_with_path(r["step"][routing][2]), leaves_with_path(ref), strict=True):
            assert np.array_equal(a, b), (shape, rank, path)


def test_microbatches_and_remat_at_2x2_match_one_process(reference, spawned):
    want_p, want_m = reference["micro"]
    results = spawned((2, 2))
    for r in results:
        for k in ("ce", "aux", "loss", "grad_norm"):
            np.testing.assert_allclose(r["micro"][0][k], want_m[k], rtol=1e-5, err_msg=k)
    _close(results[0]["micro"][1], want_p, "(2, 2) microbatches 2 + remat vs one process")
    _moved_alike(results[0]["micro"][1], want_p, _numpy(reference["params"]), "(2, 2) microbatches")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_exchange_and_its_gradient_equal_the_plain_transpose(spawned, shape):
    for rank, r in enumerate(spawned(shape)):
        assert r["exchange"] == (True, True), (shape, rank)


# ---------------------------------------------------------------------------
# The plan, in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp,groups,cf,t", [(1, 2, 1, 0.5, 96), (1, 4, 1, 1.25, 96), (2, 2, 1, 0.5, 96),
                                               (2, 2, 8, 4.0, 96), (2, 1, 2, 0.5, 96), (4, 2, 2, 0.75, 96),
                                               (1, 4, 8, 0.25, 96), (1, 4, 2, 0.5, 90), (2, 4, 3, 0.5, 90)])
def test_plan_packs_the_one_card_dispatch(dp, tp, groups, cf, t):
    """Every rank of every line simulated: the rows the owners pack are the
    one-card dispatch's kept rows of their experts, expert by expert in
    (group, position) order, and the sends and receives agree; a line of
    90 tokens over 4 ranks pads its last rank's rows."""
    cfg = _cfg("drop")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=groups, capacity_factor=cf))
    e, k, d = cfg.moe.n_experts, cfg.moe.top_k, 3
    lines = dp
    m_line = t // lines
    r = -(-m_line // tp)
    gen = torch.Generator().manual_seed(dp * 100 + tp * 10 + groups)
    top_e = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(t)])
    x = torch.arange(t, dtype=torch.float32)[:, None].expand(t, d).clone()  # each token's row holds its index
    tg = t // groups
    cap = moe.capacity(tg, cfg)
    xdisp, _, pos, _, _, rows = moe._dispatch_group(x.reshape(groups, tg, d), top_e.reshape(groups, tg, k),
                                                    torch.ones(groups, tg, k), cap, cfg)
    total_kept = int((pos < cap).sum())
    for line in range(lines):
        plans = [ep.plan(top_e, cfg, line0=line * m_line, m_line=m_line, r=r, tp=tp, idx=i) for i in range(tp)]
        for i, pl in enumerate(plans):
            assert (pl.kept, pl.dropped) == (total_kept, t * k - total_kept)
            assert pl.send == [plans[j].recv[i] for j in range(tp)]
            assert int(pl.rows.sum()) == len(pl.recv_dest) and (pl.rows <= pl.cap).all()
        for i, pl in enumerate(plans):  # the owner's packed buffer from every source's rows
            recv = torch.cat([x[line * m_line + j * r:][plans[j].send_rows][sum(plans[j].send[:i]):
                                                                                sum(plans[j].send[:i + 1])]
                              for j in range(tp)])
            buf = torch.zeros(e // tp * pl.cap, d).index_copy(0, pl.recv_dest, recv).view(e // tp, pl.cap, d)
            g0, g1 = line * m_line // tg, ((line + 1) * m_line - 1) // tg
            for el in range(e // tp):
                ex = i * (e // tp) + el
                want = torch.cat([xdisp[g, ex, :rows[g, ex]] for g in range(g0, g1 + 1)])
                mine = (want[:, 0] >= line * m_line) & (want[:, 0] < (line + 1) * m_line)
                want = want[mine]
                assert int(pl.rows[el]) == want.shape[0]
                assert torch.equal(buf[el, :want.shape[0]], want), (line, i, ex)
