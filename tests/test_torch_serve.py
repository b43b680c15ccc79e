"""The port's served model against the JAX package on the CPU.

Parameters come from the JAX ``model.init(PRNGKey(0))`` and cross through
numpy with ``params_from_jax``; prompts come from the same numpy seed in
both packages.  The port runs on CPU tensors, i.e. through the plain
versions of its kernels; the JAX side runs its default XLA path and, where
stated, its Pallas kernels in interpret mode.

Tolerances:
  * fp32 logits 1e-4: the two packages sum in other orders (XLA vs torch
    CPU matmuls, online vs direct softmax); 1e-4 on O(1) logits is far above
    that noise and far below any real difference.
  * bf16 logits: max error at most 5e-2 of the largest logit.  Each package
    rounds activations to bf16 at its own points, and a one-ulp flip
    (2^-8 relative) in an early layer is carried through the stack.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.core.ops import use_backend
from repro.data.synthetic import make_batch as jax_make_batch
from repro.models import layers as jax_layers
from repro.models.attention import use_attn_impl
from repro.models.registry import get_model as jax_get_model
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import make_batch, make_request_trace
from repro_torch.launch import serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers
from repro_torch.models.registry import get_model
from repro_torch.serving import ServeConfig, ServeEngine

CPU = "cpu"
FP32_TOL = 1e-4
BF16_TOL = 5e-2


def _pair(arch: str, dtype: str, **overrides):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype=dtype, **overrides)
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype=dtype, **overrides)
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(tcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device=CPU)
    return jmodel, jparams, tmodel, tparams


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair("internlm2-1.8b", "float32")


def _prompts(model, batch=2, seq=16, seed=1):
    jb = jax_make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed)
    tb = make_batch(model.cfg, batch=batch, seq=seq, kind="prefill", seed=seed, device=CPU)
    np.testing.assert_array_equal(np.asarray(jb["tokens"]), tb["tokens"].numpy())
    return jb, tb


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("jax_path", ["default", "pallas-systolic+flash"])
def test_prefill_logits_match_jax_fp32(fp32_pair, jax_path):
    jmodel, jparams, tmodel, tparams = fp32_pair
    jb, tb = _prompts(jmodel)
    if jax_path == "default":
        want, _ = jmodel.prefill(jparams, jb, max_len=24)
    else:
        with use_backend("pallas-systolic"), use_attn_impl("flash"):
            want, _ = jmodel.prefill(jparams, jb, max_len=24)
    got, _ = tmodel.prefill(tparams, tb, max_len=24)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)


def test_forward_logits_match_jax_fp32(fp32_pair):
    """Full-sequence forward (every position through the head) against the
    reference's default path; its last row is the prefill's logits."""
    jmodel, jparams, tmodel, tparams = fp32_pair
    jb, tb = _prompts(jmodel, seed=4)
    want, _ = jmodel.forward(jparams, jb)
    got = tmodel.forward(tparams, tb)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)
    last, _ = tmodel.prefill(tparams, tb, max_len=24)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=0, atol=FP32_TOL)


def test_decode_logits_match_jax_fp32(fp32_pair):
    jmodel, jparams, tmodel, tparams = fp32_pair
    jb, tb = _prompts(jmodel, seed=2)
    _, jcache = jmodel.prefill(jparams, jb, max_len=24)
    _, tcache = tmodel.prefill(tparams, tb, max_len=24)
    tok = np.array([[3], [7]], np.int32)
    for pos in (16, 17):
        want, jcache = jmodel.decode_step(jparams, jax.numpy.asarray(tok), cache=jcache, pos=pos)
        got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)


def test_per_slot_decode_matches_jax_and_leaves_empty_slot_untouched(fp32_pair):
    """Vector positions: slot 0 decodes at 16, slot 1 is empty (pos -1)."""
    jmodel, jparams, tmodel, tparams = fp32_pair
    jb, tb = _prompts(jmodel, seed=5)
    _, jcache = jmodel.prefill(jparams, jb, max_len=24)
    _, tcache = tmodel.prefill(tparams, tb, max_len=24)
    before = {k: v[1].clone() for k, v in tcache["layers"][0].items()}
    tok = np.array([[3], [7]], np.int32)
    pos = np.array([16, -1], np.int32)
    want, _ = jmodel.decode_step(jparams, jax.numpy.asarray(tok), cache=jcache, pos=jax.numpy.asarray(pos))
    got, tcache = tmodel.decode_step(tparams, torch.from_numpy(tok), cache=tcache, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(got[0].numpy(), _np(want)[0], rtol=0, atol=FP32_TOL)
    for k, v in tcache["layers"][0].items():
        assert torch.equal(v[1], before[k]), k
    assert int(tcache["layers"][0]["pos"][0, 16]) == 16


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b", "glm4-9b"])
def test_greedy_tokens_identical_fp32(arch):
    """Prefill logits, then 8 greedy tokens through both ServeEngines.
    h2o-danube-3-4b's SMOKE window (32) is shorter than prompt + generation,
    so its ring cache wraps.  glm4-9b runs at the full model's head ratio
    (32 query heads on 2 KV heads, q_per_kv 16) with SMOKE's other widths."""
    overrides = {"n_heads": 32, "n_kv_heads": 2, "head_dim": 16} if arch == "glm4-9b" else {}
    jmodel, jparams, tmodel, tparams = _pair(arch, "float32", **overrides)
    seq = 30 if arch == "h2o-danube-3-4b" else 16
    jb, tb = _prompts(jmodel, seq=seq, seed=3)
    want_logits, _ = jmodel.prefill(jparams, jb, max_len=seq + 8)
    got_logits, _ = tmodel.prefill(tparams, tb, max_len=seq + 8)
    np.testing.assert_allclose(got_logits.numpy(), _np(want_logits), rtol=0, atol=FP32_TOL)
    jeng = JaxServeEngine(jmodel, jparams, JaxServeConfig(max_len=seq + 8, batch=2))
    teng = ServeEngine(tmodel, tparams, ServeConfig(max_len=seq + 8, batch=2), device=CPU)
    want = jeng.generate(jb, 8)
    got = teng.generate(tb, 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_logits_close_bf16():
    jmodel, jparams, tmodel, tparams = _pair("internlm2-1.8b", "bfloat16")
    assert tparams["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert tparams["layers"][0]["attn_norm"]["scale"].dtype == torch.float32
    jb, tb = _prompts(jmodel)
    want, _ = jmodel.prefill(jparams, jb, max_len=24)
    got, _ = tmodel.prefill(tparams, tb, max_len=24)
    want = _np(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= BF16_TOL * max(1.0, np.abs(want).max()), err


def test_reset_slots_marks_cleared_slot_empty(fp32_pair):
    _, _, tmodel, tparams = fp32_pair
    teng = ServeEngine(tmodel, tparams, ServeConfig(max_len=24, batch=2), device=CPU)
    _, tb = _prompts(tmodel)
    teng.generate(tb, 3)
    teng.reset_slots(torch.tensor([False, True]))
    for lc in teng.cache["layers"]:
        assert (lc["pos"][1] == -1).all()
        assert (lc["k"][1] == 0).all() and (lc["v"][1] == 0).all()
        assert (lc["pos"][0, :18] == torch.arange(18, dtype=torch.int32)).all()


# -- layers --------------------------------------------------------------------


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    x, scale = _x((3, 5, 64)), _x((64,), 1)
    want = jax_layers.rmsnorm({"scale": jax.numpy.asarray(scale)}, jax.numpy.asarray(x, dtype))
    got = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = FP32_TOL if dtype == "float32" else 1e-2  # bf16 output: one ulp of O(1) values
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [16, 17])
def test_apply_rope_matches_jax(hd):
    x = _x((2, 9, 4, hd))
    pos = np.arange(3, 12, dtype=np.int32)
    want = jax_layers.apply_rope(jax.numpy.asarray(x), jax.numpy.asarray(pos), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=FP32_TOL, atol=FP32_TOL)


def test_swiglu_matches_jax():
    x = _x((2, 7, 64))
    p = {"w_gate": _x((64, 128), 1), "w_up": _x((64, 128), 2), "w_down": _x((128, 64), 3)}
    want = jax_layers.swiglu({k: jax.numpy.asarray(v) for k, v in p.items()}, jax.numpy.asarray(x))
    got = layers.swiglu({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b"])
def test_flash_prefill_attention_matches_plain_gqa(arch):
    """The prefill route (the head-aware flash call, K/V at the model's KV
    heads) against the plain GQA attention with an explicit causal / window
    mask."""
    cfg = configs.get_smoke(arch)
    b, s, hd = 2, 40, cfg.resolved_head_dim
    q = torch.from_numpy(_x((b, s, cfg.n_heads, hd), 1))
    k = torch.from_numpy(_x((b, s, cfg.n_kv_heads, hd), 2))
    v = torch.from_numpy(_x((b, s, cfg.n_kv_heads, hd), 3))
    pos = torch.arange(s)
    want = t_attn._sdpa(q, k, v, t_attn._mask(pos, pos, t_attn._window(cfg)), cfg.q_per_kv)
    got = t_attn._sdpa_flash(q, k, v, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FP32_TOL, atol=FP32_TOL)


# -- the launcher on the MLA and quantized MoE families -------------------------------


@pytest.mark.parametrize("extra", [[], ["--quantize", "w8a16"], ["--quantize", "w8a8"]])
def test_mla_launcher_serves_on_cpu(capsys, extra):
    out = serve.main(["--arch", "minicpm3-4b", "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                      "--gen", "3", *extra])
    assert tuple(out.shape) == (2, 3)
    printed = capsys.readouterr().out
    assert "prefill 2x8" in printed
    if extra:  # wq_a, wq_b, wkv_a, wo and the SwiGLU's three per layer, and the head; never wkv_b
        n = 7 * configs.get_smoke("minicpm3-4b").n_layers + 1
        assert f"quantize[{extra[1]}]: {n} projection weights -> int8" in printed


@pytest.mark.parametrize("extra,mode", [([], "continuous"), (["--chunked-prefill", "--chunk-size", "4"],
                                                            "continuous+chunked"),
                                        (["--quantize", "kv8"], "continuous"), (["--quantize", "w8a8"], "continuous")])
def test_mla_continuous_launcher_on_cpu(capsys, extra, mode):
    """The continuous launcher on the latent cache: its resident bytes are the
    latents (c_kv, k_rope) and the int32 positions, and under kv8 the int8
    latents with one fp32 scale per slot for each."""
    out = serve.main(["--arch", "minicpm3-4b", "--smoke", "--device", "cpu", "--continuous", "--requests", "5",
                      "--slots", "2", "--mean-prompt", "6", "--mean-gen", "4", "--prompt-len", "12", "--gen", "6",
                      *extra])
    assert sorted(out) == list(range(5)) and all(1 <= len(t) <= 6 for t in out.values())
    printed = capsys.readouterr().out
    assert f"continuous[{mode}] 5 requests over " in printed
    cfg = configs.get_smoke("minicpm3-4b")  # bf16
    trace = make_request_trace(cfg, n_requests=5, mean_prompt=6, mean_gen=4, seed=0, max_prompt=12, max_gen=6,
                               device="cpu")
    rows = 2 * max(t["prompt"]["tokens"].shape[1] + t["max_new_tokens"] for t in trace)  # slots x max_len
    lat = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    want = (cfg.n_layers * (rows * (lat + 4) + 2 * 2 * 4) if "kv8" in extra
            else cfg.n_layers * rows * (lat * 2 + 4))
    assert f"kv bytes resident {want}" in printed


def test_quantized_moe_launcher_continuous_on_cpu(capsys):
    out = serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device", "cpu", "--continuous", "--requests", "4",
                      "--slots", "2", "--mean-prompt", "6", "--mean-gen", "4", "--prompt-len", "12", "--gen", "6",
                      "--quantize", "w8a8"])
    assert sorted(out) == list(range(4))
    assert "continuous[continuous] 4 requests over " in capsys.readouterr().out
