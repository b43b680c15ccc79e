"""The port stands alone from JAX, and its entry points never fall back to the CPU.

* Importing every module of ``repro_torch``, and ``chip_smoke.py`` as a
  module, loads neither ``jax`` nor anything of ``repro``.
* Every entry point called without ``device="cpu"`` asks for the card and,
  on a host without one, raises instead of running on the CPU.
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
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch, make_request_trace
from repro_torch.launch import serve
from repro_torch.models.registry import get_model
from repro_torch.serving import KVPool, ServeConfig, ServeEngine

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
            "repro_torch.obs.profile", "repro_torch.serving.scheduler"} <= set(res["modules"])
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
    "moe model.init": lambda: get_model(configs.get_smoke("qwen3-moe-30b-a3b")).init(0),
    "ServeEngine.prefill_request": lambda: ServeEngine(
        get_model(_cfg()), {}, ServeConfig(max_len=8, batch=1)
    ).prefill_request({"tokens": torch.zeros((1, 4), dtype=torch.int32)}),
    "ServeEngine.decode_slots": lambda: ServeEngine(get_model(_cfg()), {}, ServeConfig(max_len=8, batch=2)).decode_slots(
        torch.zeros((2, 1), dtype=torch.int32), None, torch.full((2,), -1, dtype=torch.int32)
    ),
    "KVPool": lambda: KVPool(get_model(_cfg()), 2, 8),
    "make_request_trace": lambda: make_request_trace(_cfg(), n_requests=2),
    "launch.serve --continuous": lambda: serve.main(
        ["--arch", "internlm2-1.8b", "--smoke", "--continuous", "--requests", "2", "--gen", "2"]
    ),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_device_asks_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


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
def test_moe_launcher_refuses_quantize(mode):
    """The reference skips the expert block when it quantizes; quantized MoE
    serving is not ported."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 3"):
        serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--quantize", mode])


def test_launcher_refuses_kv8():
    """kv8 quantizes the continuous-batching KV pool, which is not ported yet."""
    with pytest.raises(ValueError, match="continuous serving"):
        serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--quantize", "kv8"])
    with pytest.raises(ValueError, match="item 2b"):
        serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--quantize", "kv8"])


@pytest.mark.parametrize("mode", ["none", "w8a8"])
def test_continuous_launcher_runs_on_cpu_when_asked(capsys, mode):
    out = serve.main(["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu", "--continuous", "--requests", "5",
                      "--slots", "2", "--mean-prompt", "6", "--mean-gen", "4", "--prompt-len", "12", "--gen", "6",
                      "--quantize", mode])
    assert sorted(out) == list(range(5)) and all(1 <= len(t) <= 6 for t in out.values())
    printed = capsys.readouterr().out
    assert "continuous[continuous] 5 requests over " in printed and "mean slot occupancy" in printed


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
