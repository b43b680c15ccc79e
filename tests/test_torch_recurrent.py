"""The port's recurrent families served -- xlstm-125m (SSM: mLSTM + sLSTM)
and zamba2-7b (hybrid: Mamba2 + one shared attention block) -- against the
JAX package on the CPU.

Models: the fp32 SMOKE configs and a deeper variant of each (xlstm with
four layers: two groups; zamba2 with seven layers and ``attn_every`` 2: two
applications of the shared block, each with its own KV cache, and a tail of
one Mamba2 layer), plus xlstm with a chunk of 4, so that ``forward``'s
``mlstm_auto`` takes the chunked path.  Parameters come from the JAX
``model.init(PRNGKey(0))`` through ``params_from_jax``; prompts and request
traces from the same numpy seed in both packages.

Gates: ``forward`` and ``prefill`` logits within 1e-4 of JAX's, every cache
leaf of the prefill (states within 1e-4, positions equal), greedy
``ServeEngine.generate`` tokens identical, a decode step with a (B,)
position vector holding an empty slot (-1) equal to JAX's.  Serving through
the schedulers and quantized is in ``test_torch_recurrent_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine

CPU = "cpu"
FP32_TOL = 1e-4
# name -> (arch, ArchConfig overrides, SSMConfig overrides)
MODELS = {
    "xlstm": ("xlstm-125m", {}, {}),
    "xlstm-2groups": ("xlstm-125m", dict(n_layers=4), {}),
    "xlstm-chunked": ("xlstm-125m", {}, dict(chunk_size=4)),
    "zamba2": ("zamba2-7b", {}, {}),
    "zamba2-2apps": ("zamba2-7b", dict(n_layers=7, attn_every=2), {}),
}
WHOLE = ["xlstm", "xlstm-2groups", "zamba2", "zamba2-2apps"]


def _cfg(cfg, over, ssm_over, dtype="float32"):
    cfg = dataclasses.replace(cfg, dtype=dtype, **over)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm_over)) if ssm_over else cfg


@pytest.fixture(scope="module")
def pair():
    """pair(name) -> (JAX model, its parameters, the port's model, the
    carried parameters) of ``MODELS[name]``, built once per module."""
    built = {}

    def get(name):
        if name not in built:
            arch, over, ssm_over = MODELS[name]
            jmodel = jax_get_model(_cfg(jax_get_smoke(arch), over, ssm_over))
            tmodel = get_model(_cfg(configs.get_smoke(arch), over, ssm_over))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU)
            built[name] = (jmodel, jparams, tmodel, tparams)
        return built[name]

    return get


def _prompts(model, batch=2, seq=10, seed=1):
    jb = jax_make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed)
    tb = make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed, device=CPU)
    np.testing.assert_array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())
    return jb, tb


def _flat_cache(tcache, jcache):
    """[(path, port leaf, JAX leaf)]: the port's per-layer lists against the
    reference's stacked leaves."""
    out = []
    for key, stack in tcache.items():
        for i, per_layer in enumerate(stack):
            for name, leaf in per_layer.items():
                out.append((f"{key}/{i}/{name}", leaf, np.asarray(jcache[key][name][i])))
    return out


# -- the model --------------------------------------------------------------------------------


def test_layer_counts_and_cache_layout_equal_jax(pair):
    for name in WHOLE:
        jmodel, _, tmodel, tparams = pair(name)
        cfg = tmodel.cfg
        jcache = jmodel.init_cache(3, 12)
        tcache = tmodel.init_cache(3, 12, device=CPU)
        assert set(tcache) == set(jcache)
        for path, t, j in _flat_cache(tcache, jcache):
            assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype), path
            np.testing.assert_array_equal(t.numpy(), j)
        if cfg.family == "hybrid":
            n_mamba, n_apps, _ = transformer.hybrid_counts(cfg)
            assert (len(tparams["mamba"]), len(tcache["shared"])) == (n_mamba, n_apps)
        else:
            n_groups, n_m = transformer.xlstm_counts(cfg)
            assert (len(tparams["mlstm"]), len(tparams["slstm"])) == (n_groups * n_m, n_groups)


@pytest.mark.parametrize("name", [*WHOLE, "xlstm-chunked"])
def test_forward_and_prefill_equal_jax(pair, name):
    """Forward logits at every position and prefill's last logits within
    1e-4; every leaf of the primed cache (states within 1e-4, the shared
    block's positions equal)."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jb, tb = _prompts(jmodel, seq=12)
    want, _ = jmodel.forward(jparams, jb)
    np.testing.assert_allclose(tmodel.forward(tparams, tb).numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    want, jcache = jmodel.prefill(jparams, jb, max_len=16)
    got, tcache = tmodel.prefill(tparams, tb, max_len=16)
    assert tuple(got.shape) == (2, 1, tmodel.cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    for path, t, j in _flat_cache(tcache, jcache):
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=FP32_TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


@pytest.mark.parametrize("name", WHOLE)
def test_greedy_generate_equals_jax(pair, name):
    jmodel, jparams, tmodel, tparams = pair(name)
    jb, tb = _prompts(jmodel, seed=3)
    want = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=18, batch=2)).generate(jb, 8)
    got = ServeEngine(tmodel, tparams, ServeConfig(max_len=18, batch=2), device=CPU).generate(tb, 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["xlstm", "zamba2-2apps"])
def test_decode_step_with_an_empty_slot_equals_jax(pair, name):
    """A (B,) position vector with slot 1 empty (-1): the state of every
    slot advances (it ignores pos, as in the reference) and the shared
    attention masks the empty slot; logits and every cache leaf as JAX's."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jb, tb = _prompts(jmodel, seq=6, seed=4)
    _, jcache = jmodel.prefill(jparams, jb, max_len=12)
    _, tcache = tmodel.prefill(tparams, tb, max_len=12)
    tok = np.array([[5], [9]], np.int32)
    pos = np.array([6, -1], np.int32)
    want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), cache=jcache, pos=jnp.asarray(pos))
    got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    for path, t, j in _flat_cache(tcache, jcache):
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=FP32_TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


def test_check_supported_admits_ssm_and_hybrid_only():
    """The SSM and hybrid families are admitted with their own layers only:
    the SSM family with no attention, the hybrid with GQA; a tied head on
    either is admitted too (the frontends and tied embeddings are ported,
    ``test_torch_frontends.py``)."""
    for arch in ("xlstm-125m", "zamba2-7b"):
        transformer.check_supported(configs.get_config(arch))
        transformer.check_supported(dataclasses.replace(configs.get_config(arch), tie_embeddings=True))
    for arch, attention in (("xlstm-125m", "gqa"), ("zamba2-7b", "none")):
        with pytest.raises(NotImplementedError, match="decoders"):
            transformer.check_supported(dataclasses.replace(configs.get_smoke(arch), attention=attention))
