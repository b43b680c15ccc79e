"""The port's quantization (QArray, quantize_params, the block-scaled GEMM's
plain version, the quantized matmul dispatch, w8a16 / w8a8 serving) against
the JAX package on the CPU.

Inputs come from numpy seeds and go to both packages; the JAX side runs its
default path and, where stated, its Pallas kernels in interpret mode.

Tolerances:
  * quantized values and scales: equal (int8 with ``array_equal``, fp8 as
    ``uint8`` bit patterns); dequantized values atol 0.
  * the plain GEMM: ``1e-5 * (max|ref| + 1)``, the reference's own
    (``tests/test_quant.py``): the same quantized values, another fp32
    summation order.
  * the SMOKE model's logits: ``1e-4`` of the largest logit, the fp path's
    tolerance (same weights, other summation order), and identical greedy
    tokens.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.quant import qarray as jqarray
from repro.configs import get_smoke as jax_get_smoke
from repro.core import ops as jax_core_ops
from repro.data.synthetic import make_batch as jax_make_batch
from repro.kernels.systolic import ops as jax_sops
from repro.models.registry import get_model as jax_get_model
from repro_torch import configs, quant
from repro_torch.convert import params_from_jax
from repro_torch.core import ops as core_ops
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels.systolic import kernel as t_kernel
from repro_torch.kernels.systolic import ops as sops
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.quant import qarray
from repro_torch.quant.qarray import QArray

CPU = "cpu"
QDTYPES = ["int8", "fp8"]
LOGITS_TOL = 1e-4


def _rand(shape, seed, wide_range=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if wide_range:  # down to 1e-6 of a block's max: e4m3 subnormals and int8 zeros
        x *= (10.0 ** rng.uniform(-6, 0, shape)).astype(np.float32)
    return x


def _values(q):
    """Quantized values as comparable numpy (fp8 as its bit pattern)."""
    v = q.values
    if isinstance(v, torch.Tensor):
        return (v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn else v).numpy()
    v = np.asarray(v)
    return v.view(np.uint8) if v.dtype.itemsize == 1 and v.dtype != np.int8 else v


def _assert_same_qarray(tq, jq):
    assert tq.block == tuple(jq.block) and tq.qdtype == jq.qdtype
    np.testing.assert_array_equal(_values(tq), _values(jq))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_allclose(tq.dequantize().numpy(), np.asarray(jq.dequantize()), rtol=0, atol=0)


# -- QArray --------------------------------------------------------------------

QUANT_CASES = {
    "nondivisible-16x32": ((70, 130), "quantize", (16, 32)),
    "per-column": ((70, 130), "quantize", (0, 1)),
    "per-row": ((70, 130), "quantize", (1, 0)),
    "whole": ((70, 130), "quantize", (0, 0)),
    "act-64": ((48, 200), "quantize_act", 64),
    "act-default": ((33, 300), "quantize_act", None),
    "weight-default": ((300, 33), "quantize_weight", None),
    "stacked-weight-k8": ((3, 32, 16), "quantize_weight", 8),
}


@pytest.mark.parametrize("wide_range", [False, True], ids=["normal", "wide-range"])
@pytest.mark.parametrize("case", list(QUANT_CASES))
@pytest.mark.parametrize("qd", QDTYPES)
def test_quantize_matches_jax_bit_for_bit(qd, case, wide_range):
    shape, fn, block = QUANT_CASES[case]
    x = _rand(shape, 7, wide_range)
    if fn == "quantize":
        jq = jquant.quantize(jnp.asarray(x), qd, block=block)
        tq = quant.quantize(torch.from_numpy(x), qd, block=block)
    else:
        kw = {} if block is None else {"block_k": block}
        jq = getattr(jquant, fn)(jnp.asarray(x), qd, **kw)
        tq = getattr(quant, fn)(torch.from_numpy(x), qd, **kw)
    assert tq.values.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[qd]
    assert tq.scales.dtype == torch.float32 and tq.shape == tuple(x.shape)
    _assert_same_qarray(tq, jq)


def test_int8_rounds_half_to_even_like_jax():
    """A block whose max is 127 has scale 1, so x * (1 / scale) = x: the
    ties 0.5, 1.5, 2.5, -0.5, -2.5 round to even, as jnp.round does."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -1.5]], np.float32)
    tq = quant.quantize(torch.from_numpy(x), "int8", block=(1, 0))
    jq = jquant.quantize(jnp.asarray(x), "int8", block=(1, 0))
    np.testing.assert_array_equal(_values(tq), [[127, 0, 2, 2, 0, -2, 126, -2]])
    _assert_same_qarray(tq, jq)


@pytest.mark.parametrize("qd", QDTYPES)
def test_zero_block_gets_scale_one(qd):
    x = np.zeros((8, 8), np.float32)
    x[:, 4:] = _rand((8, 4), 1)
    tq = quant.quantize(torch.from_numpy(x), qd, block=(8, 4))
    assert tq.scales[0, 0].item() == 1.0
    assert tq.dequantize()[:, :4].abs().max().item() == 0.0
    _assert_same_qarray(tq, jquant.quantize(jnp.asarray(x), qd, block=(8, 4)))


@pytest.mark.parametrize("spelling", ["int8", "i8", "fp8", "float8_e4m3fn"])
def test_dtype_names_match_jax(spelling):
    assert quant.canonical_qdtype(spelling) == jquant.canonical_qdtype(spelling)
    storage, qmax = qarray.qdtype_info(quant.canonical_qdtype(spelling))
    assert str(storage).removeprefix("torch.") == jqarray.storage_dtype_name(spelling)
    assert qmax == jqarray.qdtype_info(jquant.canonical_qdtype(spelling))[1]


def test_qarray_passthroughs_and_errors():
    q = quant.quantize_weight(torch.from_numpy(_rand((64, 16), 2)))
    assert q.ndim == 2 and q.shape == (64, 16) and q.block == (64, 1)
    assert quant.canonical_qdtype(torch.float8_e4m3fn) == "fp8"
    assert quant.canonical_qdtype("int8") == "int8"
    with pytest.raises(ValueError, match="unknown quant dtype"):
        quant.quantize(torch.ones(4, 4), "int4")
    with pytest.raises(ValueError, match="ndim"):
        quant.quantize(torch.ones(4), "int8")


# -- quantize_params / count_quantized ------------------------------------------


def _jax_fp32_pair(arch="internlm2-1.8b"):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    jmodel = jax_get_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams, get_model(tcfg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_quantize_params_matches_jax_on_smoke_model():
    """Quantizing the same fp32 masters in both packages quantizes the same
    leaves to the same values.  The reference stacks layers, so one of its
    leaves is n_layers of the port's; the bytes are equal."""
    jmodel, jparams, tmodel = _jax_fp32_pair()
    cfg = tmodel.cfg
    masters = params_from_jax(_np_tree(jparams), cfg, device=CPU, dtype=torch.float32)
    tq = quant.quantize_params(masters)
    jq = jquant.quantize_params(jparams)
    for i, layer in enumerate(tq["layers"]):
        for group, key in [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                           ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]:
            jleaf = jq["layers"][group][key]
            got = layer[group][key]
            assert isinstance(got, QArray) and got.block == tuple(jleaf.block)
            np.testing.assert_array_equal(_values(got), _values(jleaf)[i])
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(jleaf.scales)[i])
        assert not isinstance(layer["attn_norm"]["scale"], QArray)
    _assert_same_qarray(tq["lm_head"]["w"], jq["lm_head"]["w"])
    assert not isinstance(tq["embed"]["table"], QArray)
    n_t, bytes_t = quant.count_quantized(tq)
    n_j, bytes_j = jquant.count_quantized(jq)
    stacked = sum(isinstance(v, jquant.QArray) and v.ndim == 3
                  for g in jq["layers"].values() if isinstance(g, dict) for v in g.values())
    assert n_t == n_j + stacked * (cfg.n_layers - 1)
    assert bytes_t == bytes_j


def test_quantize_params_skips_what_the_reference_skips():
    """The reference's skips on a hand-made tree (norms, the embedding table,
    MLA's wkv_b, MoE experts under a router, a 3-D ``w``)."""
    rng = np.random.default_rng(3)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {
        "embed": {"table": arr(16, 8)},
        "attn": {"wq_a": arr(8, 16), "wkv_b": arr(16, 8), "q_norm": {"scale": arr(8)}},
        "ffn": {"router": arr(8, 4), "w_up": arr(4, 8, 16)},
        "audio_head": {"w": arr(2, 8, 16)},
        "lm_head": {"w": arr(8, 16)},
        "mlp": {"w_down": arr(3, 16, 8)},
    }
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, tree))
    tq = quant.quantize_params(jax.tree.map(torch.from_numpy, tree))

    def quantized_paths(node, prefix, cls):
        if isinstance(node, cls):
            return {prefix}
        if isinstance(node, dict):
            return set().union(*(quantized_paths(v, f"{prefix}/{k}", cls) for k, v in node.items()))
        return set()

    want = quantized_paths(jq, "", jquant.QArray)
    assert want == {"/attn/wq_a", "/lm_head/w", "/mlp/w_down"}
    assert quantized_paths(tq, "", QArray) == want
    _assert_same_qarray(tq["mlp"]["w_down"], jq["mlp"]["w_down"])
    assert quant.count_quantized(tq) == jquant.count_quantized(jq)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "qwen3-moe-30b-a3b"])
def test_quantize_params_skips_wkv_b_and_moe_subtrees_as_jax_on_smoke_models(arch):
    """On the SMOKE MLA and MoE models' own trees: the port quantizes the
    leaves the reference quantizes (its stacked leaf standing for every
    layer's), MLA's wkv_b and every MoE ``ffn`` leaf stay wide, and the
    values are the reference's bit for bit."""
    jmodel, jparams, tmodel = _jax_fp32_pair(arch)
    masters = params_from_jax(_np_tree(jparams), tmodel.cfg, device=CPU, dtype=torch.float32)
    tq = quant.quantize_params(masters)
    jq = jquant.quantize_params(jparams)

    def paths(node, prefix, cls):
        if isinstance(node, cls):
            return {prefix}
        if isinstance(node, dict):
            return set().union(*(paths(v, f"{prefix}/{k}", cls) for k, v in node.items()))
        if isinstance(node, list):  # the port's layers: one dict each, the reference's one stacked dict
            return set().union(*(paths(v, prefix, cls) for v in node))
        return set()

    want = paths(jq, "", jquant.QArray)
    assert paths(tq, "", QArray) == want
    assert "/layers/attn/wkv_b" not in want
    if arch == "qwen3-moe-30b-a3b":
        assert not any(p.startswith("/layers/ffn") for p in want)
    else:
        assert {"/layers/attn/wq_a", "/layers/ffn/w_up"} <= want
    for i, layer in enumerate(tq["layers"]):
        for key, leaf in layer["attn"].items():
            if isinstance(leaf, QArray):
                np.testing.assert_array_equal(_values(leaf), _values(jq["layers"]["attn"][key])[i])
                np.testing.assert_array_equal(leaf.scales.numpy(), np.asarray(jq["layers"]["attn"][key].scales)[i])
    if arch == "minicpm3-4b":
        assert not isinstance(tq["layers"][0]["attn"]["wkv_b"], QArray)
        assert isinstance(tq["layers"][0]["attn"]["wq_a"], QArray)
    else:
        assert tq["layers"][0]["ffn"] is masters["layers"][0]["ffn"]  # the subtree returned as it was


# -- the block-scaled GEMM's plain version ---------------------------------------


def _quant_pair(qd, m, n, k, seed=0):
    a, b = _rand((m, k), seed), _rand((k, n), seed + 1)
    jqa, jqb = jquant.quantize_act(jnp.asarray(a), qd), jquant.quantize_weight(jnp.asarray(b), qd)
    tqa, tqb = quant.quantize_act(torch.from_numpy(a), qd), quant.quantize_weight(torch.from_numpy(b), qd)
    return (jqa, jqb), (tqa, tqb)


def _gemm_tol(want):
    return 1e-5 * (float(np.abs(want).max()) + 1.0)


@pytest.mark.parametrize("mnk", [(8, 128, 128), (72, 130, 100), (300, 257, 515)])
@pytest.mark.parametrize("qd", QDTYPES)
def test_quant_matmul_matches_pallas(qd, mnk):
    m, n, k = mnk
    (jqa, jqb), (tqa, tqb) = _quant_pair(qd, m, n, k)
    want = np.asarray(jax_sops.quant_matmul(jqa, jqb, out_dtype=jnp.float32, interpret=True))
    got = sops.quant_matmul(tqa, tqb, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_gemm_tol(want))


@pytest.mark.parametrize("qd", QDTYPES)
def test_quant_matmul_per_channel_relu_matches_pallas(qd):
    a, b = _rand((40, 96), 1), _rand((96, 64), 2)
    jqa = jquant.quantize(jnp.asarray(a), qd, block=(1, 0))
    jqb = jquant.quantize(jnp.asarray(b), qd, block=(0, 1))
    want = np.asarray(jax_sops.quant_matmul(jqa, jqb, out_dtype=jnp.float32, activation="relu",
                                            interpret=True))
    tqa = quant.quantize(torch.from_numpy(a), qd, block=(1, 0))
    tqb = quant.quantize(torch.from_numpy(b), qd, block=(0, 1))
    got = sops.quant_matmul(tqa, tqb, out_dtype=torch.float32, activation="relu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_gemm_tol(want))
    assert got.min().item() >= 0.0


@pytest.mark.parametrize("activation", ["none", "gelu", "silu", "tanh"])
@pytest.mark.parametrize("qd", QDTYPES)
def test_quant_matmul_activations_match_pallas(qd, activation):
    """The serving layout (per-token x 128-k, 128-k x per-column) with each
    epilogue activation but relu (above), K over two scale blocks."""
    (jqa, jqb), (tqa, tqb) = _quant_pair(qd, 24, 40, 200, seed=4)
    want = np.asarray(jax_sops.quant_matmul(jqa, jqb, out_dtype=jnp.float32, activation=activation,
                                            interpret=True))
    got = sops.quant_matmul(tqa, tqb, out_dtype=torch.float32, activation=activation)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_gemm_tol(want))


def test_quant_matmul_coarse_blocks_expand_to_rows_and_columns():
    """A-side scales over 16-row blocks and B-side over 8-column blocks are
    expanded to per-row / per-column before the kernel's plain version."""
    a, b = _rand((50, 96), 6), _rand((96, 40), 7)
    jqa, jqb = jquant.quantize(jnp.asarray(a), "int8", block=(16, 32)), jquant.quantize(jnp.asarray(b), "int8", block=(64, 8))
    want = np.asarray(jax_sops.quant_matmul(jqa, jqb, out_dtype=jnp.float32, interpret=True))
    tqa = quant.quantize(torch.from_numpy(a), "int8", block=(16, 32))
    tqb = quant.quantize(torch.from_numpy(b), "int8", block=(64, 8))
    got = sops.quant_matmul(tqa, tqb, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_gemm_tol(want))


def test_quant_matmul_mismatched_qdtypes_raise():
    qa = quant.quantize_act(torch.from_numpy(_rand((8, 64), 1)), "int8")
    qb = quant.quantize_weight(torch.from_numpy(_rand((64, 8), 2)), "fp8")
    with pytest.raises(ValueError, match="qdtypes differ"):
        jax_sops.quant_matmul(jquant.quantize_act(jnp.ones((8, 64)), "int8"),
                              jquant.quantize_weight(jnp.ones((64, 8)), "fp8"), interpret=True)
    with pytest.raises(ValueError, match="qdtypes differ"):
        sops.quant_matmul(qa, qb)


# -- core.ops.matmul -------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas-systolic"])
@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
@pytest.mark.parametrize("qd", QDTYPES)
def test_core_matmul_qarray_weight_matches_jax(qd, mode, backend):
    """A QArray weight with leading batch dims on x: w8a16 dequantizes it,
    w8a8 (under ``use_act_quant`` of the weight's qdtype) quantizes x too."""
    x, w = _rand((3, 4, 96), 10), _rand((96, 40), 11)
    jw = jquant.quantize_weight(jnp.asarray(w), qd)
    tw = quant.quantize_weight(torch.from_numpy(w), qd)
    jctx = jquant.use_act_quant(qd) if mode == "w8a8" else contextlib.nullcontext()
    tctx = quant.use_act_quant(qd) if mode == "w8a8" else contextlib.nullcontext()
    with jax_core_ops.use_backend(backend), jctx:
        want = np.asarray(jax_core_ops.matmul(jnp.asarray(x), jw))
    with tctx:
        got = core_ops.matmul(torch.from_numpy(x), tw)
    assert tuple(got.shape) == (3, 4, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_gemm_tol(want))
    assert quant.act_qdtype() is None  # the policy is scoped


def test_core_matmul_qarray_shape_mismatch_raises():
    tw = quant.quantize_weight(torch.from_numpy(_rand((64, 8), 12)))
    with pytest.raises(ValueError, match="shape mismatch"):
        core_ops.matmul(torch.ones(2, 32), tw)


# -- the slice: w8a16 / w8a8 SMOKE model against the JAX package -----------------


@pytest.fixture(scope="module")
def quant_models():
    jmodel, jparams, tmodel = _jax_fp32_pair()
    jq = jquant.quantize_params(jparams)
    from_jax = params_from_jax(_np_tree(jq), tmodel.cfg, device=CPU)
    masters = params_from_jax(_np_tree(jparams), tmodel.cfg, device=CPU, dtype=torch.float32)
    in_port = quant.quantize_params(masters)
    return jmodel, jq, tmodel, {"quantized-in-jax": from_jax, "quantized-in-port": in_port}


def test_carried_qarrays_keep_storage_dtype(quant_models):
    _, jq, _, tp = quant_models
    w = tp["quantized-in-jax"]["layers"][1]["attn"]["wq"]
    assert isinstance(w, QArray) and w.values.dtype == torch.int8 and w.block == (64, 1)
    np.testing.assert_array_equal(w.values.numpy(), np.asarray(jq["layers"]["attn"]["wq"].values)[1])


def test_fp8_qarrays_cross_as_bit_patterns():
    _, jparams, tmodel = _jax_fp32_pair()
    jq = jquant.quantize_params(jparams, "fp8")
    tp = params_from_jax(_np_tree(jq), tmodel.cfg, device=CPU)
    w = tp["layers"][0]["ffn"]["w_down"]
    assert w.values.dtype == torch.float8_e4m3fn
    _assert_same_qarray(w, jax.tree.map(lambda a: a[0], jq["layers"]["ffn"]["w_down"]))


@pytest.mark.parametrize("source", ["quantized-in-jax", "quantized-in-port"])
@pytest.mark.parametrize("jax_path", ["default", "pallas-systolic"])
@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_quantized_serving_matches_jax(quant_models, mode, jax_path, source):
    """Prefill, then two decode steps from the same cache, through both
    packages: logits within 1e-4 of the largest, greedy tokens identical."""
    jmodel, jq, tmodel, tparams = quant_models
    tparams = tparams[source]
    jb = jax_make_batch(jmodel.cfg, batch=2, seq=16, kind="prefill", seed=11)
    tb = make_batch(tmodel.cfg, batch=2, seq=16, kind="prefill", seed=11, device=CPU)
    jctx = jquant.use_act_quant("int8") if mode == "w8a8" else contextlib.nullcontext()
    tctx = quant.use_act_quant("int8") if mode == "w8a8" else contextlib.nullcontext()
    backend = "pallas-systolic" if jax_path == "pallas-systolic" else "xla"
    with jax_core_ops.use_backend(backend), jctx:
        jl, jcache = jmodel.prefill(jq, jb, max_len=24)
        jlogits, jtoks = [np.asarray(jl)], [np.asarray(jnp.argmax(jl, -1))]
        for step in range(2):
            jl, jcache = jmodel.decode_step(jq, jnp.asarray(jtoks[-1], jnp.int32), cache=jcache, pos=16 + step)
            jlogits.append(np.asarray(jl))
            jtoks.append(np.asarray(jnp.argmax(jl, -1)))
    with tctx:
        tl, tcache = tmodel.prefill(tparams, tb, max_len=24)
        tlogits, ttoks = [tl.numpy()], [tl.argmax(-1).numpy()]
        for step in range(2):
            tl, tcache = tmodel.decode_step(tparams, torch.from_numpy(ttoks[-1]).to(torch.int32),
                                            cache=tcache, pos=16 + step)
            tlogits.append(tl.numpy())
            ttoks.append(tl.argmax(-1).numpy())
    for got, want in zip(tlogits, jlogits):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL * max(1.0, np.abs(want).max()))
    for got, want in zip(ttoks, jtoks):
        np.testing.assert_array_equal(got, want)


def test_cast_params_keeps_norms_and_qarrays(quant_models):
    _, _, _, tp = quant_models
    cast = transformer.cast_params(tp["quantized-in-port"], torch.bfloat16)
    assert cast["embed"]["table"].dtype == torch.bfloat16
    assert cast["layers"][0]["attn_norm"]["scale"].dtype == torch.float32
    assert cast["layers"][0]["ffn"]["w_up"] is tp["quantized-in-port"]["layers"][0]["ffn"]["w_up"]


# -- the kernel binding's guards (no card needed) ---------------------------------


def _kernel_args(m=4, k=64, n=32, qk_a=16, qk_b=32, dtype=torch.int8):
    """Operands of the binding's layouts: A (M, K) row-major, B (K, N) K-major."""
    a = torch.zeros((m, k), dtype=torch.int8).view(dtype)
    b = torch.zeros((n, k), dtype=torch.int8).view(dtype).t()
    a_s = torch.ones((m, -(-k // qk_a) if qk_a else 1))
    b_s = torch.ones((-(-k // qk_b) if qk_b else 1, n))
    return a, a_s, b, b_s, dict(qk_a=qk_a, qk_b=qk_b, out_dtype=torch.bfloat16)


def test_quant_kernel_call_refuses_cpu_tensors():
    a, a_s, b, b_s, kw = _kernel_args()
    with pytest.raises(ValueError, match="CUDA"):
        t_kernel.quant_systolic_matmul_call(a, a_s, b, b_s, **kw)


def test_quant_kernel_call_refuses_mismatched_dtypes():
    a, a_s, b, b_s, kw = _kernel_args()
    with pytest.raises(TypeError, match="one dtype"):
        t_kernel.quant_systolic_matmul_call(a, a_s, b.view(torch.float8_e4m3fn), b_s, **kw)
    with pytest.raises(TypeError, match="fp32 scales"):
        t_kernel.quant_systolic_matmul_call(a, a_s.bfloat16(), b, b_s, **kw)
    with pytest.raises(TypeError, match="int8 or float8"):
        t_kernel.quant_systolic_matmul_call(a.float(), a_s, b.float(), b_s, **kw)


def test_quant_kernel_call_refuses_bad_scale_shape():
    a, a_s, b, b_s, kw = _kernel_args()
    with pytest.raises(ValueError, match="scale shapes"):
        t_kernel.quant_systolic_matmul_call(a, a_s[:, :2], b, b_s, **kw)
    with pytest.raises(ValueError, match="scale shapes"):
        t_kernel.quant_systolic_matmul_call(a, a_s, b, b_s.t().contiguous(), **kw)


@pytest.mark.parametrize("qk_a,qk_b", [(24, 0), (48, 40), (8, 16)])
def test_quant_kernel_call_refuses_a_step_off_the_16_grid(qk_a, qk_b):
    """Scale steps of 24, 8 and 8: neither whole-K nor a multiple of 16."""
    a, a_s, b, b_s, kw = _kernel_args(k=96, qk_a=qk_a, qk_b=qk_b)
    with pytest.raises(ValueError, match="multiple of 16"):
        t_kernel.quant_systolic_matmul_call(a, a_s, b, b_s, **kw)


@pytest.mark.parametrize("qk_a,qk_b,step", [(0, 0, 100), (128, 64, 64), (96, 0, 96), (48, 32, 16)])
def test_scale_step_is_the_references_gcd_clamp(qk_a, qk_b, step):
    assert t_kernel.scale_step(qk_a, qk_b, 100) == step


def test_plain_kernel_version_on_whole_k_scales():
    """The kernel-interface plain version with qk = 0 (one scale block over
    K) equals the QArray oracle."""
    qa = quant.quantize(torch.from_numpy(_rand((6, 40), 12)), "int8", block=(1, 0))
    qb = quant.quantize(torch.from_numpy(_rand((40, 9), 13)), "int8", block=(0, 1))
    from repro_torch.kernels.systolic.ref import quant_matmul_ref, quant_systolic_matmul_ref

    got = quant_systolic_matmul_ref(qa.values, qa.scales, qb.values, qb.scales, qk_a=0, qk_b=0,
                                    out_dtype=torch.float32)
    torch.testing.assert_close(got, quant_matmul_ref(qa, qb), rtol=0, atol=0)


# -- K-major w8a8 weights ------------------------------------------------------------


def test_k_major_weights_keep_values_and_scales_bit_equal_to_jax():
    """quant.k_major lays the projection weights out K-major (strides (1, K)
    over (N, K) storage) and changes no value: values and scales stay bit-equal
    to the reference's quantization of the same fp32 masters; the head stays
    row-major."""
    jmodel, jparams, tmodel = _jax_fp32_pair()
    masters = params_from_jax(_np_tree(jparams), tmodel.cfg, device=CPU, dtype=torch.float32)
    tq = quant.k_major(quant.quantize_params(masters))
    jq = jquant.quantize_params(jparams)
    for i, layer in enumerate(tq["layers"]):
        for group, key in [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                           ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]:
            got, jleaf = layer[group][key], jq["layers"][group][key]
            k = got.shape[0]
            assert got.values.stride() == (1, k) and t_kernel.is_k_major(got.values)
            np.testing.assert_array_equal(_values(got), _values(jleaf)[i])
            np.testing.assert_array_equal(got.scales.numpy(), np.asarray(jleaf.scales)[i])
    assert tq["lm_head"]["w"].values.is_contiguous()
    _assert_same_qarray(tq["lm_head"]["w"], jq["lm_head"]["w"])


@pytest.mark.parametrize("qd", QDTYPES)
@pytest.mark.parametrize("qk", [128, 64, 0])
def test_plain_quant_matmul_identical_on_k_major_weights(qd, qk):
    """The plain versions give the same bits on K-major weights as on the
    row-major ones (the same values), through QArrays and through the
    kernel-interface plain version that ops.quant_matmul calls."""
    from repro_torch.kernels.systolic.ref import quant_matmul_ref

    qa = quant.quantize_act(torch.from_numpy(_rand((9, 200), 21)), qd)
    qb = quant.quantize(torch.from_numpy(_rand((200, 72), 22)), qd, block=(qk, 1))
    qbk = quant.k_major({"w": qb})["w"]
    assert t_kernel.is_k_major(qbk.values) and not t_kernel.is_k_major(qb.values)
    assert torch.equal(quant_matmul_ref(qa, qbk), quant_matmul_ref(qa, qb))
    assert torch.equal(sops.quant_matmul(qa, qbk, out_dtype=torch.float32),
                       sops.quant_matmul(qa, qb, out_dtype=torch.float32))


def test_quant_kernel_call_takes_k_major_b_and_refuses_other_strides():
    """The binding takes B only as a K-major view (strides (1, K)): it passes
    every check and reaches the device check; a row-major B and any other
    strides are refused before it.  B of one column or one k row is both."""
    a, a_s, b, b_s, kw = _kernel_args(k=64, n=32)
    assert b.stride() == (1, 64) and t_kernel.is_k_major(b)
    with pytest.raises(ValueError, match="CUDA device"):
        t_kernel.quant_systolic_matmul_call(a, a_s, b, b_s, **kw)
    wide = torch.zeros((64, 64), dtype=torch.int8)
    pitched = torch.zeros((32, 128), dtype=torch.int8).t()[:64]  # K-major rows 128 bytes apart, not K
    for bad in (b.contiguous(), wide[:, ::2], wide[:, :32], pitched):
        assert not t_kernel.is_k_major(bad)
        with pytest.raises(ValueError, match="K-major"):
            t_kernel.quant_systolic_matmul_call(a, a_s, bad, b_s, **kw)
    for k, n in ((64, 1), (1, 32)):
        assert t_kernel.is_k_major(torch.zeros((k, n), dtype=torch.int8))


@pytest.mark.parametrize(
    "m,n,k,step,dtype,aligned,want",
    [
        (2048, 2048, 2048, 128, torch.int8, True, "wgmma"),  # the served prefill shapes
        (2048, 2048, 8192, 128, torch.int8, True, "wgmma"),
        (2048, 288, 2560, 128, torch.int8, True, "wgmma"),  # minicpm3's wkv_a: N 288, a ragged column tile
        (2048, 3840, 768, 128, torch.int8, True, "wgmma"),  # its wq_b: K 768
        (4, 288, 2560, 128, torch.int8, True, "decode"),
        (4, 2048, 2048, 128, torch.int8, True, "decode"),  # the served decode shapes
        (16, 2048, 2048, 128, torch.int8, True, "decode"),
        (17, 2048, 2048, 128, torch.int8, True, "wgmma"),
        (300, 264, 528, 0, torch.int8, True, "wgmma"),  # whole-K scales
        (300, 264, 528, 256, torch.int8, True, "wgmma"),
        (300, 264, 528, 32, torch.int8, True, "wmma"),  # steps inside the tile's 128-deep k stage
        (300, 264, 528, 64, torch.int8, True, "wmma"),
        (100, 130, 520, 16, torch.int8, True, "wmma"),
        (100, 136, 520, 128, torch.int8, True, "wmma"),  # K not a multiple of 16: no TMA rows
        (100, 130, 512, 128, torch.int8, True, "wmma"),  # N not a multiple of 8
        (17, 8, 16, 0, torch.int8, True, "wgmma"),  # the smallest shape TMA takes
        (2048, 2048, 2048, 128, torch.int8, False, "wmma"),  # unaligned bases: no TMA
        (2048, 2048, 2048, 128, torch.float8_e4m3fn, True, "wmma"),  # fp8: the WMMA tiles
        (4, 2048, 2048, 128, torch.float8_e4m3fn, True, "decode"),
    ],
)
def test_qgemm_path_by_shape_and_layout(m, n, k, step, dtype, aligned, want):
    assert t_kernel.qgemm_path(m, n, k, step, dtype, aligned) == want
    assert want in t_kernel.QPATHS
