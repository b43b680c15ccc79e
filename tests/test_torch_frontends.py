"""The port's modality frontends and tied embeddings -- musicgen-medium
(audio: parallel codebook streams), internvl2-1b (vlm: a projected patch
prefix) and a tied head -- against the JAX package on the CPU.

Models: the fp32 SMOKE configs of musicgen-medium and internvl2-1b, and two
tied variants (``dataclasses.replace(..., tie_embeddings=True)``: no config
of the zoo ties its embeddings), internvl2-1b's and internlm2-1.8b's.
Parameters come from the JAX ``model.init(PRNGKey(0))`` through
``params_from_jax``; inputs from the same numpy seed in both packages.

Gates: each function of ``models/frontends.py`` and ``layers.unembed`` within
1e-5 of JAX's; ``forward``, ``prefill`` and ``decode_step`` logits within
1e-4 and the primed cache's positions equal; greedy ``generate`` tokens
identical (per codebook for audio); audio's chunked prefill composed over a
split equal to JAX's; the vit frontend's ``prefill_chunk`` refusing as
JAX's does.  Serving through the schedulers and quantized is in
``test_torch_frontends_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import frontends as jax_frontends
from repro.models import layers as jax_layers
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch
from repro_torch.models import frontends, layers, transformer
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine

CPU = "cpu"
MODULE_TOL = 1e-5
FP32_TOL = 1e-4
# name -> (arch, ArchConfig overrides)
MODELS = {
    "audio": ("musicgen-medium", {}),
    "vlm": ("internvl2-1b", {}),
    "tied-vlm": ("internvl2-1b", dict(tie_embeddings=True)),
    "tied-dense": ("internlm2-1.8b", dict(tie_embeddings=True)),
}


def _cfg(cfg, over):
    return dataclasses.replace(cfg, dtype="float32", **over)


@pytest.fixture(scope="module")
def pair():
    """pair(name) -> (JAX model, its parameters, the port's model, the
    carried parameters) of ``MODELS[name]``, built once per module."""
    built = {}

    def get(name):
        if name not in built:
            arch, over = MODELS[name]
            jmodel = jax_get_model(_cfg(jax_get_smoke(arch), over))
            tmodel = get_model(_cfg(configs.get_smoke(arch), over))
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tmodel.cfg, device=CPU)
            built[name] = (jmodel, jparams, tmodel, tparams)
        return built[name]

    return get


def _prompts(model, batch=2, seq=12, seed=1):
    """The same prefill batch in both packages: a vlm batch of ``seq``
    positions holds its patches and seq - n_patches text tokens."""
    jb = jax_make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed)
    tb = make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed, device=CPU)
    for key in jb:
        np.testing.assert_array_equal(np.asarray(jb[key]), tb[key].numpy())
    return jb, tb


def _rng(seed):
    return np.random.default_rng(seed)


def _flat_cache(tcache, jcache):
    """[(path, port leaf, JAX leaf)]: the port's per-layer list against the
    reference's stacked leaves."""
    return [(f"layers/{i}/{name}", leaf, np.asarray(jcache["layers"][name][i]))
            for i, per_layer in enumerate(tcache["layers"]) for name, leaf in per_layer.items()]


# -- the frontends' functions -------------------------------------------------------------------


def test_vit_project_equals_jax(pair):
    jmodel, jparams, tmodel, tparams = pair("vlm")
    cfg = tmodel.cfg
    pe = _rng(2).standard_normal((2, cfg.n_patches, cfg.vit_dim)).astype(np.float32)
    want = jax_frontends.vit_project(jparams["projector"], jnp.asarray(pe), jmodel.cfg)
    got = frontends.vit_project(tparams["projector"], torch.from_numpy(pe), cfg)
    assert tuple(got.shape) == (2, cfg.n_patches, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)


def test_audio_embed_equals_jax(pair):
    jmodel, jparams, tmodel, tparams = pair("audio")
    cfg = tmodel.cfg
    tok = _rng(3).integers(0, cfg.vocab_size, (2, 7, cfg.n_codebooks), dtype=np.int32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jax_frontends.audio_embed(jparams["embed"], jnp.asarray(tok), jdt)
        got = frontends.audio_embed(tparams["embed"], torch.from_numpy(tok), dt)
        assert tuple(got.shape) == (2, 7, cfg.d_model) and got.dtype == dt
        # bf16: the same gathers summed in the same order and dtype, so the same bits
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                                   atol=MODULE_TOL if dt == torch.float32 else 0)


def test_audio_logits_equal_jax(pair):
    jmodel, jparams, tmodel, tparams = pair("audio")
    cfg = tmodel.cfg
    x = _rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = jax_frontends.audio_logits(jparams["lm_head"], jnp.asarray(x))
    got = frontends.audio_logits(tparams["lm_head"], torch.from_numpy(x))
    assert tuple(got.shape) == (2, 5, cfg.n_codebooks, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)


@pytest.mark.parametrize("name", ["tied-vlm", "tied-dense"])
def test_unembed_equals_jax_and_reads_the_table_in_place(pair, name, monkeypatch):
    """Tied logits x @ table.T in fp32 within 1e-5; the table reaches the
    GEMM as its (d, V) transposed view (K-major), never copied."""
    jmodel, jparams, tmodel, tparams = pair(name)
    cfg = tmodel.cfg
    x = _rng(5).standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    want = jax_layers.unembed(jparams["embed"], jnp.asarray(x))
    seen = []
    real = layers.ops.matmul

    def spy(a, w, **kw):
        seen.append(w)
        return real(a, w, **kw)

    monkeypatch.setattr(layers.ops, "matmul", spy)
    got = layers.unembed(tparams["embed"], torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_TOL)
    (w,) = seen
    table = tparams["embed"]["table"]
    assert w.data_ptr() == table.data_ptr() and w.stride() == (1, cfg.d_model) and not w.is_contiguous()


@pytest.mark.parametrize("name", list(MODELS))
def test_param_tree_equals_jax(pair, name):
    """The port's random init builds the reference's tree: the codebook
    tables and heads, the projector, no lm_head when tied; every leaf of
    the same shape, and the carried tree the same."""
    jmodel, jparams, tmodel, tparams = pair(name)
    tinit = tmodel.init(0, CPU)

    def shapes(tree, prefix=""):
        out = {}
        for key, sub in tree.items():
            if key == "layers":
                continue
            if isinstance(sub, dict):
                out.update(shapes(sub, f"{prefix}{key}/"))
            else:
                out[prefix + key] = tuple(sub.shape)
        return out

    want = shapes(jparams)
    assert shapes(tinit) == shapes(tparams) == want
    assert ("lm_head" in tinit) == (not tmodel.cfg.tie_embeddings or tmodel.cfg.frontend == "audio_codec")
    assert ("projector" in tinit) == (tmodel.cfg.frontend == "vit")
    assert len(tinit["layers"]) == len(tparams["layers"]) == tmodel.cfg.n_layers


def test_check_supported_admits_the_frontends_and_tied():
    for arch in ("musicgen-medium", "internvl2-1b"):
        transformer.check_supported(configs.get_config(arch))
        transformer.check_supported(dataclasses.replace(configs.get_config(arch), tie_embeddings=True))


# -- the model ----------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_and_prefill_equal_jax(pair, name):
    """Forward logits at every position (the patch prefix's too) and
    prefill's last logits within 1e-4; the primed cache within 1e-4, its
    positions equal (the text after the patches)."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jb, tb = _prompts(jmodel, seq=14)
    want, _ = jmodel.forward(jparams, jb)
    got = tmodel.forward(tparams, tb)
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    want, jcache = jmodel.prefill(jparams, jb, max_len=20)
    got, tcache = tmodel.prefill(tparams, tb, max_len=20)
    assert tuple(got.shape) == np.asarray(want).shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    for path, t, j in _flat_cache(tcache, jcache):
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=FP32_TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)
    assert int(tcache["layers"][0]["pos"][0].max()) == 13  # 14 positions, patches included


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_step_with_an_empty_slot_equals_jax(pair, name):
    """A (B,) position vector with slot 1 empty (-1), after the prefill:
    logits and every cache leaf as JAX's."""
    jmodel, jparams, tmodel, tparams = pair(name)
    cfg = tmodel.cfg
    jb, tb = _prompts(jmodel, seq=12, seed=4)
    _, jcache = jmodel.prefill(jparams, jb, max_len=16)
    _, tcache = tmodel.prefill(tparams, tb, max_len=16)
    shape = (2, 1, cfg.n_codebooks) if cfg.frontend == "audio_codec" else (2, 1)
    tok = _rng(6).integers(0, cfg.vocab_size, shape, dtype=np.int32)
    pos = np.array([12, -1], np.int32)
    want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), cache=jcache, pos=jnp.asarray(pos))
    got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=torch.from_numpy(pos))
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], rtol=0, atol=FP32_TOL)
    for path, t, j in _flat_cache(tcache, jcache):
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=FP32_TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


@pytest.mark.parametrize("name", list(MODELS))
def test_greedy_generate_equals_jax(pair, name):
    """Eight greedy tokens of a synchronized batch, identical (each codebook's
    for audio), from an engine whose cache holds the patch prefix."""
    jmodel, jparams, tmodel, tparams = pair(name)
    jb, tb = _prompts(jmodel, seq=12, seed=3)
    max_len = 12 + 8 + (tmodel.cfg.n_patches if tmodel.cfg.frontend == "vit" else 0)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=max_len, batch=2))
    want = jeng.generate(jb, 8)
    teng = ServeEngine(tmodel, tparams, ServeConfig(max_len=max_len, batch=2), device=CPU)
    got = teng.generate(tb, 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert teng.pos == jeng.pos == 12 + 7


def test_audio_chunked_prefill_equals_jax_and_monolithic(pair):
    """Audio prompts chunk (the tokens carry their codebook axis): the
    chunks' last logits and the cache as JAX's, and as one prefill's."""
    jmodel, jparams, tmodel, tparams = pair("audio")
    jb, tb = _prompts(jmodel, batch=1, seq=11, seed=7)
    jcache = jmodel.init_cache(1, 16)
    tcache = tmodel.init_cache(1, 16, device=CPU)
    for off, length in ((0, 4), (4, 4), (8, 2), (10, 1)):
        want, jcache = jmodel.prefill_chunk(jparams, {"tokens": jb["tokens"][:, off:off + length]}, cache=jcache,
                                            offset=off)
        got, tcache = tmodel.prefill_chunk(tparams, {"tokens": tb["tokens"][:, off:off + length]}, cache=tcache,
                                           offset=off)
        assert tuple(got.shape) == (1, 1, tmodel.cfg.n_codebooks, tmodel.cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    whole, _ = tmodel.prefill(tparams, tb, max_len=16)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=FP32_TOL)
    for path, t, j in _flat_cache(tcache, jcache):
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=FP32_TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=path)


def test_vit_prefill_chunk_refuses_as_jax(pair):
    jmodel, jparams, tmodel, tparams = pair("vlm")
    jb, tb = _prompts(jmodel, batch=1, seq=12, seed=8)
    with pytest.raises(ValueError, match="vit"):
        jmodel.prefill_chunk(jparams, {"tokens": jb["tokens"]}, cache=jmodel.init_cache(1, 16), offset=0)
    with pytest.raises(ValueError, match="vit"):
        tmodel.prefill_chunk(tparams, {"tokens": tb["tokens"]}, cache=tmodel.init_cache(1, 16, device=CPU), offset=0)


@pytest.mark.parametrize("name", ["audio", "vlm"])
def test_bf16_model_runs_and_keeps_the_frontend_dtypes(name):
    """The bf16 SMOKE model from the port's own init: the codebook tables,
    heads and projector in bf16, the projector's norm fp32; prefill and a
    decode step give finite fp32 logits."""
    arch = MODELS[name][0]
    model = get_model(configs.get_smoke(arch))
    params = model.init(1, CPU)
    if name == "audio":
        assert params["embed"]["tables"].dtype == params["lm_head"]["w"].dtype == torch.bfloat16
    else:
        proj = params["projector"]
        assert proj["w1"].dtype == proj["w2"].dtype == torch.bfloat16 and proj["norm"]["scale"].dtype == torch.float32
    tb = make_batch(model.cfg, batch=2, seq=12, kind="prefill", seed=2, device=CPU)
    logits, cache = model.prefill(params, tb, max_len=16)
    tok = logits.argmax(-1).to(torch.int32)
    step, _ = model.decode_step(params, tok, cache=cache, pos=12)
    assert logits.dtype == step.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all())
