"""The port's copy of the paper's analytical model and design points against
the JAX package's on the CPU.

``repro_torch.core.analytical`` and ``repro_torch.configs.paper`` equal
``repro.core.analytical`` / ``repro.configs.paper`` on every Table I design
and every equation (1)-(19): the Stratix-10 constants, the fitter failures,
the level-1 blocks, eq. 19's predicted efficiencies beside the paper's
measured ones (exact: the same Python arithmetic), and the reference's own
regression tests (``tests/test_analytical.py``) rebuilt on the port.
``block_plan_for`` maps each design onto the systolic kernel's tiles.
"""

import dataclasses
import math

import pytest

from repro.configs import paper as jax_paper
from repro.core import analytical as JA
from repro.core import hw as jax_hw
from repro_torch.configs import paper
from repro_torch.core import analytical as A
from repro_torch.core import hw
from repro_torch.kernels.systolic.kernel import TILES, WGMMA_TILES

F_MAX = [160e6, 200e6, 300e6, 368e6, 410e6, 600e6]


def test_stratix10_constants_are_the_references():
    assert dataclasses.asdict(hw.STRATIX10) == dataclasses.asdict(jax_hw.STRATIX10)
    for f in F_MAX:
        assert hw.STRATIX10.b_ddr_floats_per_cycle(f) == jax_hw.STRATIX10.b_ddr_floats_per_cycle(f)
    for f in (100e6, 700e6):
        with pytest.raises(ValueError):
            hw.STRATIX10.b_ddr_floats_per_cycle(f)


@pytest.mark.parametrize("ident", sorted(JA.paper_designs()))
def test_every_design_and_equation_matches_the_reference(ident):
    got, want = A.paper_designs()[ident], JA.paper_designs()[ident]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.fitter_ok == want.fitter_ok and got.t_peak() == want.t_peak()
    arr, jarr = got.array, want.array
    for name in ("n_layers", "n_pe", "n_dsp", "flop_throughput", "data_throughput"):
        assert getattr(arr, name) == getattr(jarr, name), name
    assert arr.loop_body_latency() == jarr.loop_body_latency()
    for k in (512, 4096, 21504):
        assert arr.total_latency(k) == jarr.total_latency(k)
    for f in F_MAX:
        assert arr.peak_flops(f) == jarr.peak_flops(f)
    # eqs. 14 / 18 at each LSU band, and eq. 19 at each of the paper's sizes
    for f in (200e6, 400e6):
        bw = hw.STRATIX10.b_ddr_floats_per_cycle(f)
        assert A.level1_blocks(arr, bw, bw) == JA.level1_blocks(jarr, bw, bw)
        for d2 in paper.PAPER_MATRIX_SIZES.get(ident, [512, 4096]):
            assert A.compute_fraction(d2, arr, bw) == JA.compute_fraction(d2, jarr, bw)


def test_fitter_failures_are_table1s():
    """Rows A, B, D failed the fitter in Table I, in both packages."""
    assert {k for k, d in A.paper_designs().items() if not d.fitter_ok} == {"A", "B", "D"}
    assert {k for k, d in JA.paper_designs().items() if not d.fitter_ok} == {"A", "B", "D"}


def test_eq19_efficiencies_equal_the_reference_and_track_the_paper():
    """Each cell's eq.-19 prediction is the reference's, and they track the
    paper's measured e_D within the reference's bounds (mean error < 4
    points, max < 9, over the cells with d2 >= 2 d1)."""
    assert A.PAPER_MEASURED_ED == JA.PAPER_MEASURED_ED
    designs = A.paper_designs()
    errs = []
    for (ident, d2), measured in A.PAPER_MEASURED_ED.items():
        d = designs[ident]
        bw = hw.STRATIX10.b_ddr_floats_per_cycle(d.f_max_hz)
        got = A.compute_fraction(d2, d.array, bw)
        assert got == JA.compute_fraction(d2, JA.paper_designs()[ident].array, bw)
        if d2 >= 2 * d.d_i1:
            errs.append(abs(got - measured))
    assert len(errs) >= 30 and sum(errs) / len(errs) < 0.04 and max(errs) < 0.09


def test_scalar_equations_match_the_reference():
    for args in [(10, 1, 100), (3.5, 2, 17)]:
        assert A.pipeline_total_latency(*args) == JA.pipeline_total_latency(*args)
    for stall in (0.0, 0.25):
        assert A.op_throughput(4, 400e6, stall) == JA.op_throughput(4, 400e6, stall)
    with pytest.raises(ValueError):
        A.op_throughput(4, 400e6, 1.0)
    for br in (32, 64, 256):
        for e in (1.0, 0.8):
            assert A.stall_rate(br, 400e6, 19200e6 * 4, e) == JA.stall_rate(br, 400e6, 19200e6 * 4, e)
    assert A.dsp_peak_flops(4096, 398e6) == JA.dsp_peak_flops(4096, 398e6)
    for d_p in (1, 2, 8):
        assert A.dot_unit_flop_throughput(d_p) == JA.dot_unit_flop_throughput(d_p)
        assert A.dot_unit_input_demand(d_p) == JA.dot_unit_input_demand(d_p)
    assert A.reuse_ratios(64, 32, 8, 8) == JA.reuse_ratios(64, 32, 8, 8)
    with pytest.raises(ValueError):
        A.reuse_ratios(64, 32, 0, 8)
    for d2 in (512, 4096):
        assert A.matmul_flops(d2, d2, d2) == JA.matmul_flops(d2, d2, d2)
        assert A.measured_throughput(d2, d2, d2, 0.01) == JA.measured_throughput(d2, d2, d2, 0.01)
    assert A.dsp_efficiency(2.5e12, 3.2e12) == JA.dsp_efficiency(2.5e12, 3.2e12)
    c2 = A.Classical2DArray(28, 28)
    jc2 = JA.Classical2DArray(28, 28)
    assert (c2.total_latency(100), c2.flop_throughput, c2.data_throughput) == (
        jc2.total_latency(100), jc2.flop_throughput, jc2.data_throughput)
    with pytest.raises(ValueError):
        A.Systolic3DArray(8, 8, 6, 4)


def test_eq5_table1_t_peak():
    """T_peak = 2 * #DSP * f_max reproduces Table I's GFLOPS column (the
    reference's own test on the port)."""
    expected = {"C": 3462, "E": 3391, "F": 3673, "G": 3260, "H": 3342, "I": 3244, "L": 3203, "M": 2973, "N": 3121}
    for ident, t_peak in expected.items():
        assert A.paper_designs()[ident].t_peak() == pytest.approx(t_peak * 1e9, rel=0.001), ident


def test_paper_config_copies_sizes_and_designs():
    assert paper.PAPER_MATRIX_SIZES == jax_paper.PAPER_MATRIX_SIZES
    assert {k: dataclasses.asdict(v) for k, v in paper.designs().items()} == {
        k: dataclasses.asdict(v) for k, v in jax_paper.designs().items()}


@pytest.mark.parametrize("ident", sorted(JA.paper_designs()))
def test_block_plan_for_maps_each_design_onto_a_wgmma_tile(ident):
    """The design's (d_i0, d_j0) aspect picks the nearest wgmma tile (the
    larger on a tie); the problem is the design's d2^3; the reference maps the
    same design onto its TPU blocks (``tpu_block_plan_for``)."""
    design = paper.designs()[ident]
    d2 = paper.PAPER_MATRIX_SIZES.get(ident, [512])[0]
    plan = paper.block_plan_for(design, d2)
    assert (plan.m, plan.n, plan.k) == (d2, d2, d2)
    tiles = {TILES[p] for p, _, _ in WGMMA_TILES}
    assert (plan.bm, plan.bn, plan.bk) in tiles
    want = math.log2(design.array.d_i0 / design.array.d_j0)
    gap = abs(math.log2(plan.bm / plan.bn) - want)
    assert all(gap <= abs(math.log2(bm / bn) - want) for bm, bn, _ in tiles)
    ref = jax_paper.tpu_block_plan_for(JA.paper_designs()[ident], d2)
    assert (ref.m, ref.n, ref.k) == (plan.m, plan.n, plan.k)
