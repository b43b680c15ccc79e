"""The port stands alone from JAX, and its entry points never fall back to the CPU.

* Importing every module of ``repro_torch``, and ``chip_smoke.py`` as a
  module, loads neither ``jax`` nor anything of ``repro``.
* Every entry point called without ``device="cpu"`` asks for the card and,
  on a host without one, raises instead of running on the CPU (the tuner's
  ``autotune``, ``measure_matmul`` and ``python -m repro_torch.tune`` too).
* The modules the port copies whole from the JAX package behave as the
  reference's do (``PrefixCache``, the paged pool's radix).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.check import audit as check_audit
from repro_torch.check.__main__ import main as check_main
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_adversarial_trace, make_batch, make_request_trace, make_shared_prefix_trace
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models.registry import get_model
from repro_torch.serving import KVPool, PagedKVPool, PrefixCache, ServeConfig, ServeEngine
from repro_torch.tune import autotune, measure_matmul
from repro_torch.tune.__main__ import main as tune_main

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print(json.dumps({"modules": names, "bad": bad}))
""" % (FORBIDDEN,)


def test_port_and_chip_smoke_import_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.serving.engine" in res["modules"]
    assert "repro_torch.kernels.systolic.kernel" in res["modules"]
    assert {"repro_torch.quant", "repro_torch.quant.qarray", "repro_torch.quant.params"} <= set(res["modules"])
    assert {"repro_torch.models.moe", "repro_torch.kernels.grouped.kernel", "repro_torch.kernels.grouped.ops",
            "repro_torch.kernels.grouped.ref"} <= set(res["modules"])
    assert {"repro_torch.obs.metrics", "repro_torch.obs.trace", "repro_torch.obs.slo", "repro_torch.obs.attribution",
            "repro_torch.obs.profile", "repro_torch.serving.scheduler",
            "repro_torch.serving.paged"} <= set(res["modules"])
    assert "repro_torch.models.ssm" in res["modules"]
    assert "repro_torch.models.frontends" in res["modules"]
    assert {"repro_torch.train.loop", "repro_torch.optim.adamw", "repro_torch.optim.clip", "repro_torch.optim.schedule",
            "repro_torch.optim.compress", "repro_torch.checkpoint.ckpt", "repro_torch.data.sharded",
            "repro_torch.launch.train", "repro_torch.core.tree"} <= set(res["modules"])
    assert {"repro_torch.core.analytical", "repro_torch.core.blocking", "repro_torch.core.dse",
            "repro_torch.core.systolic", "repro_torch.configs.paper", "repro_torch.tune", "repro_torch.tune.cache",
            "repro_torch.tune.candidates", "repro_torch.tune.measure", "repro_torch.tune.autotune",
            "repro_torch.tune.__main__"} <= set(res["modules"])
    assert {"repro_torch.obs.drift", "repro_torch.obs.doctor", "repro_torch.obs.ledger",
            "repro_torch.obs.__main__"} <= set(res["modules"])
    assert {"repro_torch.check", "repro_torch.check.audit", "repro_torch.check.lint", "repro_torch.check.baseline",
            "repro_torch.check.findings", "repro_torch.check.__main__"} <= set(res["modules"])
    assert {"repro_torch.distributed", "repro_torch.distributed.collective_matmul", "repro_torch.distributed.sharding",
            "repro_torch.distributed.tp_layout", "repro_torch.launch.mesh",
            "repro_torch.models.modelflags", "repro_torch.distributed.annotate", "repro_torch.distributed.fault",
            "repro_torch.distributed.data_parallel", "repro_torch.distributed.expert_parallel"} <= set(res["modules"])
    assert res["bad"] == []


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"], ids=lambda p: p.name
)
def test_no_import_statement_names_jax_or_repro(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def _cfg():
    return configs.get_smoke("internlm2-1.8b")


ENTRY_POINTS = {
    "model.init": lambda: get_model(_cfg()).init(0),
    "ServeEngine": lambda: ServeEngine(
        get_model(_cfg()), get_model(_cfg()).init(0, "cpu"), ServeConfig(max_len=8, batch=1)
    ),
    "params_from_jax": lambda: params_from_jax(
        {"layers": {"attn_norm": {"scale": np.ones((2, 64), np.float32)}}}, _cfg()
    ),
    "make_batch": lambda: make_batch(_cfg(), batch=1, seq=4),
    "launch.serve": lambda: serve.main(["--arch", "internlm2-1.8b", "--smoke", "--gen", "2"]),
    "launch.serve --quantize w8a8": lambda: serve.main(
        ["--arch", "internlm2-1.8b", "--smoke", "--gen", "2", "--quantize", "w8a8"]
    ),
    "launch.serve qwen3-moe-30b-a3b": lambda: serve.main(["--arch", "qwen3-moe-30b-a3b", "--gen", "2"]),
    "launch.serve qwen3-moe-30b-a3b --quantize w8a8": lambda: serve.main(
        ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--gen", "2", "--quantize", "w8a8"]
    ),
    "launch.serve minicpm3-4b": lambda: serve.main(["--arch", "minicpm3-4b", "--smoke", "--gen", "2"]),
    "minicpm3 model.init": lambda: get_model(configs.get_smoke("minicpm3-4b")).init(0),
    "moe model.init": lambda: get_model(configs.get_smoke("qwen3-moe-30b-a3b")).init(0),
    "ServeEngine.prefill_request": lambda: ServeEngine(
        get_model(_cfg()), {}, ServeConfig(max_len=8, batch=1)
    ).prefill_request({"tokens": torch.zeros((1, 4), dtype=torch.int32)}),
    "ServeEngine.decode_slots": lambda: ServeEngine(get_model(_cfg()), {}, ServeConfig(max_len=8, batch=2)).decode_slots(
        torch.zeros((2, 1), dtype=torch.int32), None, torch.full((2,), -1, dtype=torch.int32)
    ),
    "ServeEngine.prefill_chunk": lambda: ServeEngine(get_model(_cfg()), {}, ServeConfig(max_len=8, batch=1)).prefill_chunk(
        torch.zeros((1, 4), dtype=torch.int32), None, 0, last=True
    ),
    "KVPool": lambda: KVPool(get_model(_cfg()), 2, 8),
    "KVPool kv8": lambda: KVPool(get_model(_cfg()), 2, 8, quantize_kv_cache=True),
    "make_request_trace": lambda: make_request_trace(_cfg(), n_requests=2),
    "make_adversarial_trace": lambda: make_adversarial_trace(_cfg(), n_short=1),
    "launch.serve --continuous": lambda: serve.main(
        ["--arch", "internlm2-1.8b", "--smoke", "--continuous", "--requests", "2", "--gen", "2"]
    ),
    "launch.serve --continuous --chunked-prefill --quantize kv8": lambda: serve.main(
        ["--arch", "internlm2-1.8b", "--smoke", "--continuous", "--chunked-prefill", "--quantize", "kv8"]
    ),
    "PagedKVPool": lambda: PagedKVPool(get_model(_cfg()), 2, 8),
    "make_shared_prefix_trace": lambda: make_shared_prefix_trace(_cfg(), n_requests=2, prefix_len=4),
    "launch.serve --continuous --paged --prefix-cache": lambda: serve.main(
        ["--arch", "internlm2-1.8b", "--smoke", "--continuous", "--paged", "--prefix-cache"]
    ),
    "launch.train": lambda: launch_train.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1"]),
    "launch.train qwen3-moe-30b-a3b": lambda: launch_train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--steps", "1"]),
    "tune.autotune": lambda: autotune(64, 64, 64),
    "tune.autotune cuda-grouped": lambda: autotune(160, 768, 2048, backend="cuda-grouped"),
    "tune.measure_matmul": lambda: measure_matmul(64, 64, 64, 64, 64, 16),
    "python -m repro_torch.tune": lambda: tune_main(["--m", "64", "--n", "64", "--k", "64"]),
    "python -m repro_torch.check": lambda: check_main(["--no-lint", "--no-sweep"]),
    "check.audit.run_audit": lambda: check_audit.run_audit(),
    "check.audit.audit_launches": lambda: check_audit.audit_launches(systolic=[(4, 64, 64, "decode", 0, "rule")]),
    "ServeEngine(mesh=...)": lambda: ServeEngine(
        get_model(_cfg()), get_model(_cfg()).init(0, "cpu"), ServeConfig(max_len=8, batch=1),
        mesh=Mesh((1, 2), ("data", "model"))
    ),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_device_asks_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_launcher_distributed_without_a_card_a_rank_asks_for_them(monkeypatch):
    """``launch/train.py --distributed`` on the card needs one card a rank:
    a rank whose LOCAL_RANK has no card exits naming the fix, before any
    process group or CUDA work, never training on the CPU."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    monkeypatch.setenv("RANK", str(cards))
    monkeypatch.setenv("WORLD_SIZE", str(cards + 1))
    monkeypatch.setenv("LOCAL_RANK", str(cards))
    with pytest.raises(SystemExit, match="needs a card a rank.*torchrun --nproc-per-node N"):
        launch_train.main(["--arch", "internlm2-1.8b", "--smoke", "--distributed"])


def test_launcher_model_parallel_without_enough_cards_asks_for_them():
    """``--model-parallel N`` needs N cards, one a rank, and one process a
    rank: short of either it exits with a message naming the fix, never
    serving on fewer ranks or on the CPU."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present: the launcher would serve")
    with pytest.raises(SystemExit, match="needs 2 cards.*torchrun --nproc-per-node 2"):
        serve.main(["--arch", "internlm2-1.8b", "--smoke", "--model-parallel", "2"])
    with pytest.raises(SystemExit, match="one process a rank, 1 running"):
        serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--model-parallel", "2"])


def test_launcher_runs_on_cpu_when_asked(capsys):
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "prefill 2x8" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quantized_launcher_runs_on_cpu_when_asked(capsys, mode):
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--quantize", mode,
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    printed = capsys.readouterr().out
    assert f"quantize[{mode}]: 15 projection weights -> int8" in printed and "prefill 2x8" in printed


def test_moe_launcher_runs_on_cpu_when_asked(capsys):
    out = serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "prefill 2x8" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_moe_launcher_refuses_quantize(capsys, mode):
    """What the launcher once refused it now serves: ``--quantize`` on a MoE
    config quantizes attention and the head, and the expert block stays
    wide, as the reference skips it when it quantizes."""
    out = serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--quantize", mode,
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    printed = capsys.readouterr().out
    assert f"quantize[{mode}]: {4 * cfg.n_layers + 1} projection weights -> int8" in printed  # q k v o, the head


def test_launcher_refuses_kv8(capsys):
    """kv8 quantizes the continuous-batching KV pool: without --continuous
    the launcher warns and serves unquantized, as the reference does."""
    with pytest.warns(UserWarning, match="ignored in synchronized mode"):
        out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--quantize", "kv8",
                          "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    printed = capsys.readouterr().out
    assert "prefill 2x8" in printed and "quantize[" not in printed


@pytest.mark.parametrize("extra,mode", [(["--chunked-prefill", "--chunk-size", "4"], "continuous+chunked"),
                                        (["--quantize", "kv8"], "continuous"),
                                        (["--quantize", "kv8", "--chunked-prefill", "--chunk-size", "4",
                                          "--chunk-budget", "2", "--policy", "gang"], "gang+chunked")])
def test_continuous_launcher_chunked_and_kv8_on_cpu(capsys, extra, mode):
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--requests", "5",
                      "--slots", "2", "--mean-prompt", "6", "--mean-gen", "4", "--prompt-len", "12", "--gen", "6",
                      *extra])
    assert sorted(out) == list(range(5)) and all(1 <= len(t) <= 6 for t in out.values())
    printed = capsys.readouterr().out
    assert f"continuous[{mode}] 5 requests over " in printed and "mean slot occupancy" in printed
    chunks = int(printed.split(" prefill chunks)")[0].rsplit("idle, ", 1)[1])
    assert (chunks > 5) == ("--chunked-prefill" in extra)
    cfg = configs.get_smoke("internlm2-1.8b")  # bf16
    trace = make_request_trace(cfg, n_requests=5, mean_prompt=6, mean_gen=4, seed=0, max_prompt=12, max_gen=6,
                               device="cpu")
    rows = 2 * max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)  # slots x max_len
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    want = (cfg.n_layers * (rows * (2 * kv + 4) + 2 * 2 * cfg.n_kv_heads * 4) if "kv8" in extra  # int8, scales
            else cfg.n_layers * rows * (2 * kv * 2 + 4))
    assert f"kv bytes resident {want}" in printed


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_continuous_launcher_runs_on_cpu_when_asked(capsys, mode):
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--requests", "5",
                      "--slots", "2", "--mean-prompt", "6", "--mean-gen", "4", "--prompt-len", "12", "--gen", "6",
                      "--quantize", mode])
    assert sorted(out) == list(range(5)) and all(1 <= len(t) <= 6 for t in out.values())
    printed = capsys.readouterr().out
    assert "continuous[continuous] 5 requests over " in printed and "mean slot occupancy" in printed


@pytest.mark.parametrize("extra", [[], ["--chunked-prefill", "--chunk-size", "4"], ["--quantize", "kv8"]])
def test_paged_launcher_runs_on_cpu_when_asked(capsys, extra):
    """``--continuous --paged --prefix-cache`` serves and prints the paged
    summary; the adversarial trace with a shared prefix over an undersized
    arena reclaims and preempts, and every request still gets its tokens."""
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--paged",
                      "--page-size", "8", "--prefix-cache", "--requests", "5", "--slots", "2", "--mean-prompt", "6",
                      "--mean-gen", "4", "--prompt-len", "12", "--gen", "6", *extra])
    assert sorted(out) == list(range(5)) and all(1 <= len(t) <= 6 for t in out.values())
    printed = capsys.readouterr().out
    assert "continuous[" in printed and "paged kv: " in printed and "page size 8" in printed
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--paged",
                      "--page-size", "8", "--pages", "10", "--prefix-cache", "--adversarial", "--requests", "5",
                      "--long-requests", "2", "--prompt-len", "28", "--shared-prefix", "8", "--mean-prompt", "6",
                      "--mean-gen", "20", "--slots", "4", *extra])
    assert sorted(out) == list(range(5)) and [len(out[r]) for r in range(5)] == [20, 20, 20, 4, 4]
    paged_line = next(line for line in capsys.readouterr().out.splitlines() if line.startswith("paged kv: "))
    assert "/10 pages in use at drain" in paged_line
    preempted = int(paged_line.split("preempted ")[1].split()[0])
    assert preempted > 0


def test_prefix_cache_is_the_reference_copy():
    """The same seeded lookups, inserts and chain evictions on the port's
    ``PrefixCache`` and the reference's: the same answers and the same state
    (keys, pages, LRU stamps, hit and miss counts) after every operation."""
    from repro.serving.paged import PrefixCache as JaxPrefixCache

    rng = np.random.default_rng(5)
    page = 4
    ours, theirs = PrefixCache(page), JaxPrefixCache(page)
    stems = rng.integers(0, 3, (2, 40)).astype(np.int32)
    evicted = 0
    for step in range(400):
        toks = stems[int(rng.integers(2))][: int(rng.integers(1, 40))].copy()
        if rng.random() < 0.3:  # a tail that leaves the stem
            cut = int(rng.integers(len(toks)))
            toks[cut:] = rng.integers(0, 3, len(toks) - cut)
        op = int(rng.integers(3))
        if op == 0:
            assert ours.lookup(toks) == theirs.lookup(toks), step
        elif op == 1:
            j, pid = int(rng.integers(0, max(1, len(toks) // page))), int(rng.integers(100))
            assert ours.insert(toks, j, pid) == theirs.insert(toks, j, pid), step
        elif ours._stamp:
            key = sorted(ours._stamp)[int(rng.integers(len(ours._stamp)))]
            pids = ours.evict_chain(key)
            assert pids == theirs.evict_chain(key), step
            evicted += len(pids)
        assert ours._pages == theirs._pages and ours._stamp == theirs._stamp and ours._clock == theirs._clock, step
        assert (ours.hits, ours.misses, len(ours), ours.pids()) == (theirs.hits, theirs.misses, len(theirs),
                                                                    theirs.pids()), step
    assert ours.hits > 0 and ours.misses > 0 and evicted > 0


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
