"""The port's ``loss_fn`` and its gradients against the JAX package's on the
CPU, for every family the port trains.

Models: fp32 SMOKE configs of dense internlm2-1.8b, MoE qwen3-moe-30b-a3b
(its load-balance aux in the loss), MLA minicpm3-4b, the audio (musicgen-
medium) and vit (internvl2-1b) frontends, internlm2-1.8b with a tied head,
and the recurrent xlstm-125m (SSM) and zamba2-7b (hybrid).  Parameters come
from the JAX ``model.init(PRNGKey(0))`` through ``params_from_jax``; the
batch is the same numpy draw (``make_batch(kind="train")``) in both
packages.  The reference's gradient is ``jax.value_and_grad(model.loss_fn)``
(jitted) on its default attention (plain einsum); the port's runs its training path
(``flash_mha``, the systolic matmul's autograd Function, the head's).  The
JAX gradient tree is carried into the port's layout by the same
``params_from_jax`` (a gradient tree has the parameters' structure).

Gates: the loss and each metric (ce, aux, loss) within 1e-5 relative; every
gradient leaf within 1e-4 x its largest magnitude (fp32: the same math in
other summation orders; measured <= 1e-5).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.registry import get_model as jax_get_model
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves, leaves_with_path
from repro_torch.models.registry import get_model
from repro_torch.train.loop import TrainConfig, make_grad_fn

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MODELS = {
    "dense": ("internlm2-1.8b", {}),
    "moe": ("qwen3-moe-30b-a3b", {}),
    "mla": ("minicpm3-4b", {}),
    "audio": ("musicgen-medium", {}),
    "vlm": ("internvl2-1b", {}),
    "tied": ("internlm2-1.8b", dict(tie_embeddings=True)),
    "ssm": ("xlstm-125m", {}),
    "hybrid": ("zamba2-7b", {}),
}


def _pair(name):
    arch, over = MODELS[name]
    jmodel = jax_get_model(dataclasses.replace(jax_get_smoke(arch), dtype="float32", **over))
    tmodel = get_model(dataclasses.replace(configs.get_smoke(arch), dtype="float32", **over))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg, device="cpu")
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_grads_match_jax(name):
    jmodel, jparams, tmodel, tparams = _pair(name)
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=12, kind="train", seed=1)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jmodel.loss_fn, has_aux=True))(jparams, jb)
    grads, met = make_grad_fn(tmodel, TrainConfig())(tparams, tb)
    for k in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    if name == "moe":
        assert float(met["aux"]) > 0
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tmodel.cfg, device="cpu", dtype=torch.float32)
    got = dict(leaves_with_path(grads))
    assert list(got) == [k for k, _ in leaves_with_path(want)]
    for key, w in leaves_with_path(want):
        scale = w.abs().max().item()
        torch.testing.assert_close(got[key], w, rtol=0, atol=GRAD_TOL * max(scale, 1e-12), msg=key)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_remat_loss_and_grads_match_jax_remat(name):
    """remat (``torch.utils.checkpoint`` per layer) against the reference's
    ``loss_fn(remat=True)`` (``jax.checkpoint`` around the scan body)."""
    jmodel, jparams, tmodel, tparams = _pair(name)
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=8, kind="train", seed=2)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    loss_fn = jax.value_and_grad(lambda p, b: jmodel.loss_fn(p, b, remat=True), has_aux=True)
    (_, jmet), jgrads = jax.jit(loss_fn)(jparams, jb)
    grads, met = make_grad_fn(tmodel, TrainConfig(remat=True))(tparams, tb)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tmodel.cfg, device="cpu", dtype=torch.float32)
    for g, w in zip(leaves(grads), leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_TOL * max(w.abs().max().item(), 1e-12))
