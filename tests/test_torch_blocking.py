"""The port's blocking, chip registry, Definition-4 oracle and DSE against the
JAX package's on the CPU.

* ``core/hw.py``: ``get_chip`` (the H100, or a record passed in; the
  reference's ``REPRO_CHIP`` leaves it), the card's rates and balances.
* ``core/blocking.py``: ``BlockPlan``'s chip-neutral members (flops, HBM
  traffic, intensity, reuse, the tp members) equal the reference's over a
  grid of plans, exactly; the roofline terms equal the reference's on a card
  record built from ``repro.core.hw.TPU_V5E``'s fields; ``smem_bytes`` is the
  shared memory each wgmma tile allocates (``WgTile::SMEM`` in
  ``csrc/wgmma_gemm.cuh``, ``QTile::SMEM`` in ``csrc/systolic_qmm.cu``, their
  constants read from the sources); ``derive_block_plan`` lands on the
  kernel's widest tile at large shapes.
* ``core/systolic.py``: ``systolic_mmm`` / ``classical_mmm`` /
  ``blocked_matmul`` against JAX's on numpy-seeded fp32 inputs within
  1e-5 * sqrt(K).
* ``core/dse.py``: the kernel's tiles as the default axes, the fitter
  failures, and ``best``'s ranking against the reference's on the same
  records.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as jax_blocking
from repro.core import dse as jax_dse
from repro.core import hw as jax_hw
from repro.core import systolic as jax_systolic
from repro_torch.core import blocking, dse, hw, systolic
from repro_torch.kernels.grouped import kernel as gk
from repro_torch.kernels.systolic import kernel as mk

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def _tpu_like() -> hw.GPU:
    """A card record holding the reference's TPU v5e constants, so the
    roofline terms can be compared number for number."""
    t = jax_hw.TPU_V5E
    return hw.GPU(name="tpu_v5e_like", hbm_bw=t.hbm_bw, smem_per_block=t.vmem_budget_bytes, n_sm=1,
                  nvlink_bw_per_link=t.ici_bw_per_link,
                  peak_flops_by_dtype={d: t.peak_flops(d) for d in ("bfloat16", "float32", "int8", "float8_e4m3fn")})


# -- chip registry -----------------------------------------------------------


def test_registry_defaults_to_the_h100():
    assert hw.get_chip(None) is hw.H100 and hw.get_chip("h100") is hw.H100 and hw.get_chip(hw.H100) is hw.H100
    tpu = _tpu_like()
    assert hw.get_chip(tpu) is tpu
    assert hw.H100.peak_flops() == hw.H100.peak_flops("bfloat16") == 989e12
    assert hw.H100.peak_flops("fp8") == hw.H100.peak_flops(torch.float8_e4m3fn) == 1979e12
    assert hw.H100.machine_balance_hbm == pytest.approx(295.2, abs=0.1)
    assert hw.H100.machine_balance("int8") == pytest.approx(1979e12 / 3.35e12)
    assert hw.H100.machine_balance_nvlink(2) == 989e12 / 50e9
    with pytest.raises(KeyError):
        hw.get_chip("tpu_v5e")


def test_the_references_variable_leaves_the_port_on_the_h100():
    probe = "from repro_torch.core import hw; print(hw.get_chip(None).name)"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_CHIP="tpu_v4")
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "h100"


# -- BlockPlan -------------------------------------------------------------------

GRID = [(m, n, k, bm, bn, bk) for m, n, k in [(2048, 8192, 2048), (4, 2048, 2048), (1000, 300, 777)]
        for bm, bn, bk in [(128, 256, 64), (64, 128, 64), (16, 64, 512), (128, 128, 32)]]


@pytest.mark.parametrize("m,n,k,bm,bn,bk", GRID)
@pytest.mark.parametrize("kw", [{}, {"in_dtype": "float32"}, {"in_dtype": "int8", "quant_block_k": 128,
                                                             "out_dtype_bytes": 2}, {"tp": 4}])
def test_chip_neutral_members_equal_the_references(m, n, k, bm, bn, bk, kw):
    got = blocking.BlockPlan(m, n, k, bm, bn, bk, **kw)
    want = jax_blocking.BlockPlan(m, n, k, bm, bn, bk, **kw)
    for name in ("flops", "hbm_traffic_bytes", "arithmetic_intensity", "reuse_ratios", "shard_shape", "hop_bytes"):
        assert getattr(got, name)() == getattr(want, name)(), name
    assert got.in_dtype_bytes == want.in_dtype_bytes
    tpu = _tpu_like()
    for name in ("compute_seconds", "memory_seconds", "bound_by", "compute_bound", "shard_step_seconds",
                 "hop_seconds", "mesh_balanced"):
        assert getattr(got, name)(tpu) == getattr(want, name)(jax_hw.TPU_V5E), name


def test_tensor_parallel_balance_equals_the_references():
    for m, n, k, tp in [(8192, 8192, 8192, 8), (64, 4096, 4096, 4), (2048, 2048, 512, 2)]:
        assert blocking.tensor_parallel_balance(m, n, k, tp, chip=_tpu_like()) == \
            jax_blocking.tensor_parallel_balance(m, n, k, tp, chip=jax_hw.TPU_V5E)
    assert blocking.round_up(130, 64) == jax_blocking.round_up(130, 64) == 192


def _constants(path: Path, *names) -> dict:
    src = path.read_text()
    return {nm: int(re.search(rf"\b{nm} = (\d+)", src).group(1)) for nm in names}


@pytest.mark.parametrize("rows,bn", [(64, 128), (128, 128), (128, 256), (192, 128)])
def test_smem_bytes_is_what_the_wgmma_tile_allocates(rows, bn):
    """WgTile::SMEM = W_STAGES * (BM * W_BK * 2 + BN / 64 * W_BK * 64 * 2)
    + 2 * W_STAGES * 8 + 1024, with the source's constants."""
    c = _constants(CSRC / "wgmma_gemm.cuh", "W_BK", "W_STAGES")
    want = c["W_STAGES"] * (rows * c["W_BK"] * 2 + bn // 64 * c["W_BK"] * 64 * 2) + 2 * c["W_STAGES"] * 8 + 1024
    plan = blocking.BlockPlan(2048, 2048, 2048, rows, bn, c["W_BK"], stages=c["W_STAGES"])
    assert plan.smem_bytes() == want and plan.fits_smem()
    assert plan.acc_regs_per_thread() == bn // 2 and plan.fits_registers() and plan.mma_aligned()


def test_smem_bytes_of_the_int8_wgmma_tile():
    c = _constants(CSRC / "systolic_qmm.cu", "Q_BM", "Q_BN", "Q_BK", "Q_STAGES")
    stage = c["Q_BM"] * c["Q_BK"] + c["Q_BN"] * c["Q_BK"] + c["Q_BM"] * 4 + c["Q_BN"] * 4
    plan = blocking.BlockPlan(2048, 2048, 2048, c["Q_BM"], c["Q_BN"], c["Q_BK"], in_dtype="int8", quant_block_k=128,
                              stages=c["Q_STAGES"])
    assert plan.smem_bytes() == c["Q_STAGES"] * stage + 2 * c["Q_STAGES"] * 8 + 1024


def test_the_fitter_rejects_oversized_tiles():
    assert not blocking.BlockPlan(4096, 4096, 4096, 256, 256, 64).fits_smem()
    assert not blocking.BlockPlan(4096, 4096, 4096, 128, 512, 64).fits_registers()
    assert not blocking.BlockPlan(4096, 4096, 4096, 96, 128, 64).mma_aligned()
    assert not blocking.BlockPlan(4096, 4096, 4096, 128, 264, 64).mma_aligned()


@pytest.mark.parametrize("shape", [(4096, 4096, 4096), (2048, 8192, 2048), (8192, 2048, 8192), (2048, 2560, 2560)])
def test_derive_block_plan_lands_on_the_widest_wgmma_tile(shape):
    """The balance equation against ~295 FLOP/B with the smem fitter gives
    128 x 256 x 64 over 4 stages at large shapes: the kernel's widest tile."""
    p = blocking.derive_block_plan(*shape)
    assert (p.bm, p.bn, p.bk, p.stages) == (*mk.TILES["wgmma_128x256"], 4)
    assert p.fits_smem() and p.fits_registers() and p.mma_aligned()
    # every tile one notch larger fails the fitter
    assert not blocking.BlockPlan(*shape, 256, 256, 64).fits_smem()
    assert not blocking.BlockPlan(*shape, 128, 512, 64).fits_registers()


def test_derive_block_plan_small_and_narrow_problems():
    p = blocking.derive_block_plan(4, 2048, 2048)
    assert (p.bm, p.bk) == (64, 64) and p.fits_smem()
    p8 = blocking.derive_block_plan(2048, 2048, 2048, in_dtype="int8")
    assert (p8.bm, p8.bn, p8.bk) == (128, 256, 128)  # one 128-byte panel of int8 k


# -- the Definition-4 oracle ----------------------------------------------------------


def _pair(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x, torch.from_numpy(x)


@pytest.mark.parametrize("d_k0,d_p", [(96, 96), (48, 48), (48, 16), (24, 8), (96, 32)])
def test_systolic_mmm_matches_jax(d_k0, d_p):
    a, ta = _pair((16, 96), 0)
    b, tb = _pair((96, 24), 1)
    want = np.asarray(jax_systolic.systolic_mmm(jnp.asarray(a), jnp.asarray(b), d_k0=d_k0, d_p=d_p))
    got = systolic.systolic_mmm(ta, tb, d_k0=d_k0, d_p=d_p)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * 96**0.5)
    with pytest.raises(ValueError):
        systolic.systolic_mmm(ta, tb, d_k0=40)


def test_classical_mmm_matches_jax():
    a, ta = _pair((8, 40), 2)
    b, tb = _pair((40, 12), 3)
    want = np.asarray(jax_systolic.classical_mmm(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(systolic.classical_mmm(ta, tb).numpy(), want, rtol=0, atol=1e-5 * 40**0.5)


@pytest.mark.parametrize("blocks", [(32, 32, 64), (64, 64, 192), (128, 16, 32)])
def test_blocked_matmul_matches_jax(blocks):
    a, ta = _pair((128, 192), 4)
    b, tb = _pair((192, 64), 5)
    plan = blocking.BlockPlan(128, 64, 192, *blocks)
    want = np.asarray(jax_systolic.blocked_matmul(jnp.asarray(a), jnp.asarray(b),
                                                  jax_blocking.BlockPlan(128, 64, 192, *blocks)))
    got = systolic.blocked_matmul(ta, tb, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * 192**0.5)
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=0, atol=1e-5 * 192**0.5)
    with pytest.raises(ValueError):
        systolic.blocked_matmul(ta, tb, blocking.BlockPlan(128, 64, 192, 48, 32, 64))


# -- DSE -------------------------------------------------------------------------------


def test_explore_defaults_to_the_kernels_tiles():
    prefill = dse.explore(2048, 2048, 2048)
    assert {r.path for r in prefill} == {"wmma", "wgmma_128x128", "wgmma_64x128", "wgmma_128x256"}
    assert all(r.fits and (r.bm, r.bn, r.bk) == mk.TILES[r.path] for r in prefill)
    decode = dse.explore(4, 2048, 2048)
    assert {r.path for r in decode} == {"decode"} and all(r.fits for r in decode)
    assert sorted(r.bk for r in decode) == dse.decode_chunks(2048, hw.H100.n_sm, 2048) == [64, 128, 256, 512, 1024, 2048]
    ragged = dse.explore(2048, 2050, 2048)  # N off TMA's 16-byte rows: WMMA only
    assert [r.path for r in ragged] == ["wmma"]
    assert [r.path for r in dse.explore(2048, 2048, 2048, in_dtype="float32")] == ["fma"]
    q8 = dse.explore(2048, 2048, 2048, in_dtype="int8")
    assert {r.path: (r.bm, r.bn, r.bk) for r in q8} == {"wmma": (128, 128, 64), "wgmma": (128, 128, 128)}
    assert all(r.quant_block_k == 128 for r in q8)
    grouped = dse.explore(160, 768, 2048, backend="cuda-grouped")
    assert {r.path for r in grouped} == set(gk.TILES) - {"fma", "decode"}


def test_explore_marks_geometries_no_tile_runs_as_fitter_failures():
    recs = dse.explore(4096, 4096, 4096, bms=(64, 128, 256), bns=(128, 256), bks=(32, 64))
    fits = {r.ident for r in recs if r.fits}
    assert fits == {"64x128x64", "128x128x32", "128x128x64", "128x256x64"}
    assert all(r.path is None for r in recs if not r.fits)
    big = next(r for r in recs if r.ident == "256x256x64")
    assert big.smem_kib * 1024 > hw.H100.smem_per_block
    assert dse.attach_measurements(recs, lambda r: 1.0)[0].measured_us is None  # 64x128x32: not measured


def test_explore_on_the_reference_backend():
    ref = dse.explore(256, 384, 512, backend="reference")
    assert {r.ident for r in ref} == {"128x128x32", "64x128x64", "128x128x64"}  # 128x256 does not divide N=384


def _both(fields: list[dict]):
    """The same records in both packages (the port's smem_kib for vmem_kib)."""
    port = [dse.DSERecord(**{"smem_kib": 1.0, **f}) for f in fields]
    ref = [jax_dse.DSERecord(**{"vmem_kib": 1.0, **f}) for f in fields]
    return port, ref


def test_best_ranks_as_the_reference_does():
    base = dict(fits=True, arithmetic_intensity=50.0, compute_bound=False, compute_us=1.0, memory_us=5.0,
                bound_by="memory")
    fields = [dict(base, bm=128, bn=128, bk=64, memory_us=4.0),
              dict(base, bm=128, bn=256, bk=64, arithmetic_intensity=80.0, memory_us=4.0),
              dict(base, bm=64, bn=128, bk=64, fits=False, memory_us=1.0),
              dict(base, bm=256, bn=128, bk=64, arithmetic_intensity=60.0, memory_us=4.0)]
    port, ref = _both(fields)
    assert dse.best(port).ident == jax_dse.best(ref).ident == "128x256x64"
    port = [r.with_measurement(t) for r, t in zip(port, (3.0, 5.0, 1.0, 4.0))]
    ref = [r.with_measurement(t) for r, t in zip(ref, (3.0, 5.0, 1.0, 4.0))]
    assert dse.best(port).ident == jax_dse.best(ref).ident == "128x128x64"
    with pytest.raises(ValueError):
        dse.best([dataclasses.replace(r, fits=False) for r in port])
