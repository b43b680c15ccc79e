"""The port's reduce-scatter matmul against the reference's, rank by rank:
``test_torch_collective.py``'s harness on the (128, 512) @ (512, 200) cases
(fp32 and bf16, both ring directions, overlap on and off) at tp 2 and 4."""

import pytest
from test_torch_collective import (TPS, check_launches_and_counters, check_obs, check_outputs, rank_outputs,
                                   reference_outputs)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    yield from reference_outputs(tmp_path_factory, "rs")


@pytest.fixture(scope="module", params=TPS, ids=lambda tp: f"tp{tp}")
def ranks(request, tmp_path_factory):
    return rank_outputs(tmp_path_factory, request.param, ("rs",))


def test_reduce_scatter_matmul_matches_the_reference(reference, ranks):
    check_outputs(reference, ranks, "rs")


def test_reduce_scatter_ring_steps_are_k1_launches_and_counters_follow_the_reference(reference, ranks):
    check_launches_and_counters(reference, ranks, "rs")


def test_reduce_scatter_obs_series_and_hop_spans(ranks):
    check_obs(ranks, "rs")
