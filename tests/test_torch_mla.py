"""The port's MLA (multi-head latent attention; minicpm3-4b) against the JAX
package on the CPU.

Each function of the MLA part of ``repro_torch.models.attention`` against
its counterpart in ``repro.models.attention`` on one layer's parameters
(from the JAX ``model.init(PRNGKey(0))`` of the fp32 SMOKE minicpm3-4b,
through ``params_from_jax``) and inputs and caches from a numpy seed; then
the whole SMOKE model: prefill, forward and greedy decode through both
packages' ``ServeEngine``.

Tolerances: one layer's output and cache within atol 1e-5 * sqrt(K) (K =
d_model; fp32 sums in another order), the port's fp32 GEMM gate; fp32
logits within 1e-4 and greedy tokens identical; bf16 logits within 5e-2 of
the largest (each package rounds activations to bf16 at its own points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import attention as jattn
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch
from repro_torch.models import attention as tattn
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine

CPU = "cpu"
ARCH = "minicpm3-4b"
FP32_TOL = 1e-4
BF16_TOL = 5e-2


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jax_get_smoke(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(configs.get_smoke(ARCH), dtype=dtype)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _tol(cfg):
    return 1e-5 * cfg.d_model**0.5


def _layer(jparams, tparams, i=0):
    return jax.tree.map(lambda a: a[i], jparams["layers"])["attn"], tparams["layers"][i]["attn"]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _latent_cache(cfg, b, size, filled, seed):
    """A cache of ``size`` slots with random latents everywhere (masked slots
    hold garbage too) and ``filled[row]`` leading positions written."""
    m = cfg.mla
    c_kv = _x((b, size, m.kv_lora_rank), seed)
    k_rope = _x((b, size, m.qk_rope_head_dim), seed + 1)
    pos = np.full((b, size), -1, np.int32)
    for row, n in enumerate(filled):
        pos[row, :n] = np.arange(n)
    return {"c_kv": c_kv, "k_rope": k_rope, "pos": pos}


def _jax_cache(c):
    return {k: jnp.asarray(v) for k, v in c.items()}


def _torch_cache(c):
    return {k: torch.from_numpy(v.copy()) for k, v in c.items()}


def _assert_cache_equal(tc, jc, tol):
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=0, atol=tol)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_init_mla_has_the_references_leaves(pair):
    """The port's init draws the tree the reference's init builds (same
    keys, shapes; norms fp32 ones), and the carried tree has it too."""
    jmodel, jparams, tmodel, tparams = pair
    own = tmodel.init(0, CPU)
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    for tree in (own["layers"][0]["attn"], tparams["layers"][0]["attn"]):
        assert set(tree) == set(jlayer) == {"wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
        for key, leaf in jlayer.items():
            if isinstance(leaf, dict):
                assert tree[key]["scale"].dtype == torch.float32
                assert tuple(tree[key]["scale"].shape) == tuple(leaf["scale"].shape)
                assert (tree[key]["scale"] == 1).all()
            else:
                assert tuple(tree[key].shape) == tuple(leaf.shape)


def test_mla_fwd_equals_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    jp, tp = _layer(jparams, tparams, 1)
    x = _x((2, 11, cfg.d_model), 3)
    pos = np.arange(11, dtype=np.int32)
    jy, (jc, jr) = jattn.mla_fwd(jp, jnp.asarray(x), jmodel.cfg, jnp.asarray(pos))
    ty, (tc, tr) = tattn.mla_fwd(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    tol = _tol(cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=tol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=tol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=tol)


@pytest.mark.parametrize("max_len,s", [(16, 11), (11, 11)])
def test_mla_prime_cache_equals_jax(pair, max_len, s):
    jmodel, _, tmodel, _ = pair
    cfg = tmodel.cfg
    m = cfg.mla
    c_kv, k_rope = _x((2, s, m.kv_lora_rank), 4), _x((2, s, m.qk_rope_head_dim), 5)
    jc = jattn.mla_prime_cache(jattn.init_mla_cache(jmodel.cfg, 2, max_len, jnp.float32), jnp.asarray(c_kv),
                               jnp.asarray(k_rope), s)
    tc = tattn.init_mla_cache(cfg, 2, max_len, torch.float32, torch.device(CPU))
    out = tattn.mla_prime_cache(tc, torch.from_numpy(c_kv), torch.from_numpy(k_rope), s)
    assert out is tc  # in place
    _assert_cache_equal(tc, jc, 0.0)


@pytest.mark.parametrize("pos", [9, [9, 4], [-1, 6]], ids=["scalar", "vector", "empty-slot"])
def test_mla_decode_equals_jax(pair, pos):
    """The absorbed-matrix decode at a scalar position, at a (B,) position
    vector, and with an empty slot (pos -1): its row of the cache is left as
    it was and its output is what JAX gives for an all-masked row."""
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    jp, tp = _layer(jparams, tparams)
    filled = [9, 9] if isinstance(pos, int) else [max(p, 0) for p in pos]
    cache = _latent_cache(cfg, 2, 16, filled, seed=6)
    x = _x((2, 1, cfg.d_model), 7)
    jpos = jnp.int32(pos) if isinstance(pos, int) else jnp.asarray(np.array(pos, np.int32))
    tpos = pos if isinstance(pos, int) else torch.tensor(pos, dtype=torch.int32)
    jy, jc = jattn.mla_decode(jp, jnp.asarray(x), jmodel.cfg, _jax_cache(cache), jpos)
    tc = _torch_cache(cache)
    ty, tc2 = tattn.mla_decode(tp, torch.from_numpy(x), cfg, tc, tpos)
    assert tc2 is tc
    tol = _tol(cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=tol)
    _assert_cache_equal(tc, jc, tol)
    if pos == [-1, 6]:
        for name, leaf in tc.items():
            assert np.array_equal(leaf[0].numpy(), cache[name][0]), name


@pytest.mark.parametrize("offset,length,primed", [(0, 8, 0), (5, 4, 5), (8, 8, 8)])
def test_mla_prefill_chunk_equals_jax(pair, offset, length, primed):
    jmodel, jparams, tmodel, tparams = pair
    cfg = tmodel.cfg
    jp, tp = _layer(jparams, tparams, 1)
    cache = _latent_cache(cfg, 1, 20, [primed], seed=8)
    x = _x((1, length, cfg.d_model), 9)
    jy, jc = jattn.mla_prefill_chunk(jp, jnp.asarray(x), jmodel.cfg, _jax_cache(cache), jnp.int32(offset))
    tc = _torch_cache(cache)
    ty, tc2 = tattn.mla_prefill_chunk(tp, torch.from_numpy(x), cfg, tc, offset)
    assert tc2 is tc
    tol = _tol(cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=tol)
    _assert_cache_equal(tc, jc, tol)


def test_init_cache_is_latent_and_full_length(pair):
    _, _, tmodel, _ = pair
    cfg = tmodel.cfg
    cache = tmodel.init_cache(3, 40, torch.bfloat16, CPU)
    assert len(cache["layers"]) == cfg.n_layers
    for lc in cache["layers"]:
        assert tuple(lc["c_kv"].shape) == (3, 40, cfg.mla.kv_lora_rank) and lc["c_kv"].dtype == torch.bfloat16
        assert tuple(lc["k_rope"].shape) == (3, 40, cfg.mla.qk_rope_head_dim)
        assert lc["pos"].dtype == torch.int32 and (lc["pos"] == -1).all()


# -- the whole SMOKE model -------------------------------------------------------------


def _prompts(model, batch=2, seq=16, seed=1):
    jb = jax_make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed)
    tb = make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed, device=CPU)
    np.testing.assert_array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())
    return jb, tb


def test_prefill_and_forward_logits_match_jax_fp32(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _prompts(jmodel)
    want, jcache = jmodel.prefill(jparams, jb, max_len=24)
    got, tcache = tmodel.prefill(tparams, tb, max_len=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)
    for i, lc in enumerate(tcache["layers"]):
        np.testing.assert_array_equal(lc["pos"].numpy(), np.asarray(jcache["layers"]["pos"][i]))
        np.testing.assert_allclose(lc["c_kv"].numpy(), np.asarray(jcache["layers"]["c_kv"][i]), rtol=0,
                                   atol=_tol(tmodel.cfg))
    full, _ = jmodel.forward(jparams, jb)
    tfull = tmodel.forward(tparams, tb)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(full), rtol=0, atol=FP32_TOL)


def test_decode_logits_match_jax_fp32(pair):
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _prompts(jmodel, seed=2)
    _, jcache = jmodel.prefill(jparams, jb, max_len=24)
    _, tcache = tmodel.prefill(tparams, tb, max_len=24)
    tok = np.array([[3], [7]], np.int32)
    for pos in (16, 17):
        want, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), cache=jcache, pos=pos)
        got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FP32_TOL)


def test_greedy_tokens_identical_fp32(pair):
    """Prefill, then 8 greedy tokens through both ServeEngines."""
    jmodel, jparams, tmodel, tparams = pair
    jb, tb = _prompts(jmodel, seed=3)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=24, batch=2))
    teng = ServeEngine(tmodel, tparams, ServeConfig(max_len=24, batch=2), device=CPU)
    want = jeng.generate(jb, 8)
    got = teng.generate(tb, 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_logits_close_bf16():
    jmodel, jparams, tmodel, tparams = _pair("bfloat16")
    assert tparams["layers"][0]["attn"]["wkv_b"].dtype == torch.bfloat16
    assert tparams["layers"][0]["attn"]["kv_norm"]["scale"].dtype == torch.float32
    jb, tb = _prompts(jmodel)
    want, _ = jmodel.prefill(jparams, jb, max_len=24)
    got, _ = tmodel.prefill(tparams, tb, max_len=24)
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err


def test_check_supported_admits_mla_and_still_refuses_ssm():
    transformer.check_supported(configs.get_config(ARCH))
    with pytest.raises(NotImplementedError):
        transformer.check_supported(configs.get_config("xlstm-125m"))
