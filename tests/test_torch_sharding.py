"""The port's sharding rules, mesh and model flags against the reference's.

* ``param_specs``, ``zero1_specs``, ``cache_specs`` and ``batch_specs`` give
  every leaf of the SMOKE trees of every architecture the reference's spec
  on meshes (1, 2), (1, 4) and (2, 4): the reference runs on a stand-in
  mesh of that shape (it reads only the shape and the axis names), the port
  on its ``Mesh``.  The port keeps one dict per layer in a
  list where the reference stacks layers on a leading axis; a leaf of such
  a list has the stacked leaf's spec, layer entry first.
* ``shard_params`` cuts contiguous, row-major blocks; ``make_local_mesh``
  names the fix when oversubscribed; ``batch_axes``, ``axis_size``,
  ``mesh_balance_report`` and ``models/modelflags.py`` are the reference's.
* ``tune.cache.tuned_block`` clamps a tp-keyed hit to the ring step's problem.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.data.synthetic import make_batch as ref_make_batch
from repro.distributed import sharding as ref_sharding
from repro.launch import mesh as ref_mesh
from repro.models import modelflags as ref_flags
from repro.models.registry import get_model as ref_get_model
from repro_torch import configs
from repro_torch.data.synthetic import make_batch
from repro_torch.distributed import collective_matmul as cm
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import modelflags
from repro_torch.models.registry import get_model

MESHES = [(1, 2), (1, 4), (2, 4)]
ARCHS = configs.ALL_ARCHS


class RefMesh:
    """A mesh's shape and axis names, all the reference's spec rules read."""

    def __init__(self, sizes, names):
        self.shape, self.axis_names = dict(zip(names, sizes)), tuple(names)


def _norm(entry):
    """A spec entry as a ``PartitionSpec`` holds it: one axis by its name, none as None."""
    if isinstance(entry, tuple):
        return None if not entry else (entry[0] if len(entry) == 1 else entry)
    return entry


def _ref_specs(tree):
    """path -> spec tuple of a reference spec tree (stacked roots' paths
    without the layer index)."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in flat:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = tuple(_norm(e) for e in spec)
    return out


def _port_leaves(tree, prefix=""):
    """(path, leaf) of a port tree: an index segment is a layer of a list the
    reference stacks, dropped from the path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for v in tree:
            yield from _port_leaves(v, prefix)
    else:
        yield prefix, tree


def _compare(port_specs, ref_specs, what):
    seen = set()
    for path, spec in _port_leaves(port_specs):
        want = ref_specs[path]
        assert tuple(_norm(e) for e in spec) == want, (what, path, spec, want)
        seen.add(path)
    assert seen == set(ref_specs), (what, set(ref_specs) ^ seen)


@pytest.fixture(scope="module")
def trees():
    """Per arch: the SMOKE parameters, a cache and a batch of both packages
    (the reference's as shapes)."""
    out = {}
    for arch in ARCHS:
        cfg, rcfg = configs.get_smoke(arch), ref_get_smoke(arch)
        model, rmodel = get_model(cfg), ref_get_model(rcfg)
        out[arch] = dict(
            params=model.init(0, "cpu"),
            ref_params=jax.eval_shape(rmodel.init, jax.random.PRNGKey(0)),
            cache=model.init_cache(4, 16, torch.float32, "cpu"),
            ref_cache=jax.eval_shape(lambda rm=rmodel: rm.init_cache(4, 16, jnp.float32)),
            batch=make_batch(cfg, batch=4, seq=16, kind="train", seed=0, device="cpu"),
            ref_batch=ref_make_batch(rcfg, batch=4, seq=16, kind="train", seed=0),
        )
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(trees, arch, shape):
    t = trees[arch]
    mesh, ref = Mesh(shape, ("data", "model")), RefMesh(shape, ("data", "model"))
    _compare(sharding.param_specs(t["params"], mesh), _ref_specs(ref_sharding.param_specs(t["ref_params"], ref)),
             "param_specs")
    _compare(sharding.zero1_specs(t["params"], mesh), _ref_specs(ref_sharding.zero1_specs(t["ref_params"], ref)),
             "zero1_specs")
    _compare(sharding.cache_specs(t["cache"], mesh), _ref_specs(ref_sharding.cache_specs(t["ref_cache"], ref)),
             "cache_specs")
    _compare(sharding.batch_specs(t["batch"], mesh), _ref_specs(ref_sharding.batch_specs(t["ref_batch"], ref)),
             "batch_specs")


@pytest.mark.parametrize("opts", ["", "moe-tp-expert"])
def test_expert_spec_follows_the_option(trees, monkeypatch, opts):
    monkeypatch.setenv("REPRO_OPTS", opts)
    t = trees["qwen3-moe-30b-a3b"]
    mesh, ref = Mesh((2, 4), ("data", "model")), RefMesh((2, 4), ("data", "model"))
    _compare(sharding.param_specs(t["params"], mesh), _ref_specs(ref_sharding.param_specs(t["ref_params"], ref)),
             opts)
    w = sharding.param_specs(t["params"], mesh)["layers"][0]["ffn"]["w_gate"]
    assert w == ((None, "model", None, None) if opts else (None, "model", "data", None))


def test_production_mesh_specs_equal_the_reference(trees):
    t = trees["internlm2-1.8b"]
    for multi in (False, True):
        mesh = port_mesh.make_production_mesh(multi_pod=multi)
        ref = RefMesh(tuple(mesh.shape.values()), mesh.axis_names)
        _compare(sharding.param_specs(t["params"], mesh),
                 _ref_specs(ref_sharding.param_specs(t["ref_params"], ref)), "production")
        _compare(sharding.batch_specs(t["batch"], mesh), _ref_specs(ref_sharding.batch_specs(t["ref_batch"], ref)),
                 "production batch")
        assert port_mesh.batch_axes(mesh) == ref_mesh.batch_axes(ref)
        for name in ("pod", "data", "model", "expert"):
            assert port_mesh.axis_size(mesh, name) == ref_mesh.axis_size(ref, name)


def test_shard_params_cuts_contiguous_row_major_blocks():
    mesh = Mesh((2, 4), ("data", "model"))
    w = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for rank in range(8):
        c = mesh.coords(rank)
        col = sharding.shard_of(w, (None, "model"), mesh, rank)
        assert col.is_contiguous() and torch.equal(col, w[:, 3 * c["model"]:3 * c["model"] + 3])
        row = sharding.shard_of(w, ("model", None), mesh, rank)
        assert torch.equal(row, w[2 * c["model"]:2 * c["model"] + 2])
        both = sharding.shard_of(w, (("data", "model"), None), mesh, rank)
        assert torch.equal(both, w[rank:rank + 1])
    # a column block does not keep the whole tensor's storage alive
    assert sharding.shard_of(w, (None, "model"), mesh, 1).untyped_storage().nbytes() == 8 * 3 * 4
    cfg = configs.get_smoke("internlm2-1.8b")
    params = get_model(cfg).init(0, "cpu")
    specs = sharding.param_specs(params, Mesh((1, 2), ("data", "model")))
    local = sharding.shard_params(params, specs, Mesh((1, 2), ("data", "model")), 1)
    assert local["layers"][0]["attn"]["wk"] is params["layers"][0]["attn"]["wk"]  # replicated: not copied
    assert torch.equal(local["layers"][1]["ffn"]["w_down"], params["layers"][1]["ffn"]["w_down"][cfg.d_ff // 2:])
    assert torch.equal(local["lm_head"]["w"], params["lm_head"]["w"][:, cfg.vocab_size // 2:])


def test_mesh_coordinates_are_jax_device_order():
    """Global rank r sits where a JAX mesh of that shape puts device r."""
    for shape in MESHES + [(2, 2, 2)]:
        names = ("pod", "data", "model")[-len(shape):]
        mesh = Mesh(shape, names)
        grid = np.arange(mesh.size).reshape(shape)
        for r in range(mesh.size):
            c = mesh.coords(r)
            assert grid[tuple(c[n] for n in names)] == r and mesh.rank_of(c) == r
            line = mesh.axis_ranks("model", r)
            assert line == grid[tuple(c[n] for n in names[:-1])].tolist()


def test_make_local_mesh_oversubscribed_names_the_fix():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_local_mesh(2, 2, "cpu")
    with pytest.raises(ValueError, match="card"):
        make_local_mesh(1, 1 + torch.cuda.device_count())
    mesh = make_local_mesh(1, 1, "cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_index("model") == 0


def test_mesh_balance_report_is_the_reference_formula(monkeypatch):
    from repro.core import hw as ref_hw
    from repro_torch.core import hw

    class H100Like:  # the reference's two constants, at the port's H100
        peak_flops_bf16 = hw.H100.peak_flops()
        ici_bw_per_link = hw.H100.nvlink_bw_per_link

    monkeypatch.setattr(ref_hw, "TPU_V5E", H100Like)
    for shape in MESHES:
        got = sharding.mesh_balance_report(1_800_000_000, 64, 2048, Mesh(shape, ("data", "model")))
        want = ref_sharding.mesh_balance_report(1_800_000_000, 64, 2048, RefMesh(shape, ("data", "model")))
        assert got == pytest.approx(want)


def test_tensor_parallel_context_rejects_missing_axis():
    mesh = Mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="no axis"):
        with cm.tensor_parallel(mesh, axis="pod"):
            pass
    assert cm.current_tensor_parallel() is None
    with cm.tensor_parallel(mesh):
        assert cm.current_tensor_parallel() == (mesh, "model")
    assert cm.current_tensor_parallel() is None


def test_ring_perm_and_divisibility_are_the_reference():
    from repro.distributed import collective_matmul as ref_cm

    for tp in (1, 2, 4, 8):
        for d in cm.DIRECTIONS:
            assert cm._ring_perm(tp, d) == ref_cm._ring_perm(tp, d)
    with pytest.raises(ValueError, match="direction"):
        cm._ring_perm(4, "sideways")
    with pytest.raises(ValueError, match="does not divide"):
        cm._check_divisible("M", 10, 4)


def test_tp_tuned_block_clamps_to_shard_problem(tmp_path, monkeypatch):
    """A tp-keyed hit timed on the card is clamped to the ring step's
    problem: the all-gather step (M/tp, N/tp, K) cuts bn to N/tp, and a
    geometry no tile runs at the step's problem is not served."""
    from repro_torch.tune import cache as tune_cache

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "plans.json"))
    tune_cache.reset_default_cache()
    try:
        key = tune_cache.CacheKey("cuda-systolic", "h100", 2048, 1024, 4096, "bfloat16", tp=8)
        tune_cache.default_cache().store(key, tune_cache.TunedPlan(128, 256, 64, 1.0, 1.0, "cuda-events"))
        assert cm._tp_tuned_block(2048, 1024, 4096, torch.bfloat16, 8, (256, 128, 4096)) == (128, 128, 64)
        assert cm._tp_tuned_block(2048, 1024, 4096, torch.bfloat16, 8, (256, 1024, 512)) == (128, 256, 64)
        assert cm._tp_tuned_block(2048, 1024, 4096, torch.bfloat16, 8, (256, 100, 4096)) is None  # no tile
        assert cm._tp_tuned_block(2048, 1024, 4096, torch.bfloat16, 4, (512, 256, 4096)) is None  # another tp
        other = tune_cache.CacheKey("cuda-systolic", "h100", 4096, 4096, 4096, "bfloat16", tp=8)
        tune_cache.default_cache().store(other, tune_cache.TunedPlan(128, 256, 64, 1.0, 1.0, "cpu-proxy"))
        assert cm._tp_tuned_block(4096, 4096, 4096, torch.bfloat16, 8, (512, 512, 4096)) is None  # not card-timed
        assert tune_cache.tuned_path("cuda-systolic", 2048, 1024, 4096, "bfloat16") is None  # tp=1 dispatch unmoved
    finally:
        tune_cache.reset_default_cache()


def _source_of(module, name):
    return ast.dump(ast.parse(inspect.getsource(getattr(module, name))))


def test_modelflags_is_the_reference_copy(monkeypatch):
    for name in ("unroll_layers", "opt"):
        assert _source_of(modelflags, name) == _source_of(ref_flags, name)
    for value in ("", "attn-cp", "moe-tp-expert,attn-cp", "moe-tp-expertx"):
        monkeypatch.setenv("REPRO_OPTS", value)
        for flag in ("attn-cp", "moe-tp-expert"):
            assert modelflags.opt(flag) == ref_flags.opt(flag)
    assert not modelflags.LAYER_UNROLL.get()
    with modelflags.unroll_layers():
        assert modelflags.LAYER_UNROLL.get()
    assert not modelflags.LAYER_UNROLL.get()


def test_rule_sets_are_the_reference():
    for name in ("_COL", "_ROW", "_REPL"):
        assert getattr(sharding, name) == getattr(ref_sharding, name), name
    shapes = {"table": (256, 64), "tables": (4, 256, 64), "router": (64, 8), "conv_w": (4, 32), "r_h": (4, 16, 64),
              "wk": (64, 32), "wq": (64, 64), "w_gate": (8, 64, 128), "wo": (64, 64), "w_down": (8, 128, 64),
              "w": (64, 256), "scale": (64,)}
    for name, shape in shapes.items():
        assert sharding._param_rule(f"layers/0/x/{name}", shape) == tuple(ref_sharding._param_rule(
            f"layers/x/{name}", shape)), name
