"""Tensor-parallel serving against the JAX package's single-device engine.

The reference's ``tp_serve_equiv`` case on the port: fp32 SMOKE
internlm2-1.8b, parameters from the JAX ``model.init(PRNGKey(0))`` through
``params_from_jax``, served by ``ServeEngine(mesh=...)`` in Gloo process
groups of 2 and 4 ranks on the CPU (``launch.mesh.run_ranks``).  Every
rank's greedy tokens equal the JAX single-device engine's, and its prefill
and decode-step logits (the layout's own, fed the reference's tokens) are
within 1e-4 of JAX's.  At tp 4 the SMOKE config's 4 / 2 heads leave each
rank one query head, two ranks sharing each KV head.  A degree above the
query heads warns as the reference's engine does, and is refused: it would
split a head.  The launcher serves ``--model-parallel`` under torchrun with
``--device cpu`` (Gloo), rank 0 alone printing, the tokens of one process.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.mesh import Mesh, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internlm2-1.8b"
BATCH, SEQ, GEN, MAX_LEN = 2, 16, 8, 24
TOL = 1e-4


def _cfg():
    return dataclasses.replace(configs.get_smoke(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def reference():
    """The JAX single-device engine's tokens, prefill logits and the
    decode-step logits fed those tokens; the parameters as numpy."""
    import jax

    from repro.configs import get_smoke
    from repro.data.synthetic import make_batch
    from repro.models.registry import get_model
    from repro.serving import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_smoke(ARCH), dtype="float32")
    model = get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = make_batch(cfg, batch=BATCH, seq=SEQ, kind="prefill", seed=0)
    tokens = np.asarray(ServeEngine(model, params, ServeConfig(max_len=MAX_LEN, batch=BATCH)).generate(batch, GEN))
    logits, cache = model.prefill(params, batch, max_len=MAX_LEN)
    out = [np.asarray(logits, np.float32)]
    for step in range(GEN - 1):
        logits, cache = model.decode_step(params, tokens[:, step:step + 1], cache=cache, pos=SEQ + step)
        out.append(np.asarray(logits, np.float32))
    return jax.tree.map(np.asarray, params), np.asarray(batch["tokens"]), tokens, out


def _rank(rank, world, np_params, prompt, feed):
    """-> (the engine's greedy tokens, the layout's prefill and decode-step
    logits fed ``feed``) on this rank."""
    torch.set_num_threads(1)
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed.tp_layout import TPLayout
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = _cfg()
    model = get_model(cfg)
    params = params_from_jax(np_params, cfg, device="cpu")
    mesh = Mesh((1, world), ("data", "model"))
    batch = {"tokens": torch.from_numpy(prompt)}
    engine = ServeEngine(model, params, ServeConfig(max_len=MAX_LEN, batch=BATCH), device="cpu", mesh=mesh)
    tokens = engine.generate(batch, GEN).numpy()
    layout = TPLayout(cfg, mesh)
    local = layout.shard(params)
    with torch.no_grad():
        logits, cache = layout.prefill(local, batch, MAX_LEN)
        out = [logits.numpy()]
        for step in range(GEN - 1):
            logits, cache = layout.decode_step(local, torch.from_numpy(feed[:, step:step + 1]), cache, SEQ + step)
            out.append(logits.numpy())
    return tokens, out


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_served_tokens_and_logits_equal_the_single_device_engine(reference, tmp_path, tp):
    np_params, prompt, want_tokens, want_logits = reference
    results = run_ranks(_rank, tp, str(tmp_path), args=(np_params, prompt, want_tokens), timeout_s=55)
    for rank, (tokens, logits) in enumerate(results):
        np.testing.assert_array_equal(tokens, want_tokens, err_msg=f"rank {rank}")
        assert len(logits) == len(want_logits)
        for step, (got, want) in enumerate(zip(logits, want_logits)):
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"rank {rank} step {step}")


def test_tp_above_the_query_heads_warns_and_is_refused():
    from repro_torch.models.registry import get_model
    from repro_torch.serving import ServeConfig, ServeEngine

    cfg = _cfg()
    model = get_model(cfg)
    params = model.init(0, "cpu")
    with pytest.warns(UserWarning, match="n_heads"), pytest.raises(ValueError, match="split a head"):
        ServeEngine(model, params, ServeConfig(max_len=MAX_LEN, batch=BATCH), device="cpu",
                    mesh=Mesh((1, 8), ("data", "model")))


def test_launcher_serves_model_parallel_under_torchrun_on_the_cpu(tmp_path):
    torchrun = shutil.which("torchrun")
    if torchrun is None:
        pytest.skip("no torchrun on this host")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    cmd = [torchrun, "--standalone", "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *args,
           "--model-parallel", "2"]
    out = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    alone = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=60)
    lines = out.stdout.splitlines()
    assert "tensor-parallel mesh: 1x2 ('data', 'model')" in lines
    assert sum(line.startswith("prefill 2x8") for line in lines) == 1  # rank 0 alone prints
    sample = [line for line in lines if line.startswith("sample tokens:")]
    assert sample and sample == [line for line in alone.stdout.splitlines() if line.startswith("sample tokens:")]
