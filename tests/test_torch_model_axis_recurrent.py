"""The port's tensor parallelism over the "model" axis on the recurrent
stacks: reduced hybrid-grs (g, r, s in one unit: the RG-LRU's gate
all-gather, the SSD's head split with its gated norm all-reduced, and at
M = 4 query heads split over kv heads that are not) and reduced
recurrentgemma-2b (r, r, l plus a tail: one kv head under 4 query heads,
the ring cache), through the same worlds and checks as
tests/test_torch_model_axis.py, against the reference's unsharded engine
and partitioned model.
"""
import pytest

import _model_axis as ma
from test_torch_model_axis import (MESHES, check_engine, check_plm,
                                   reference_stacks, spawn_worlds)

NAMES = ("hybrid-grs", "recurrentgemma")


@pytest.fixture(scope="module")
def stacks():
    return reference_stacks(NAMES)


@pytest.fixture(scope="module")
def worlds(stacks):
    return spawn_worlds(stacks)


@pytest.mark.parametrize("case", sorted(ma.ENGINE_CASES))
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ranks,m", MESHES)
def test_engine_tokens_equal_the_unsharded_reference(worlds, stacks, ranks,
                                                     m, name, case):
    check_engine(worlds, stacks, ranks, m, name, case)


@pytest.mark.parametrize("cut", ma.PLM_CUTS)
@pytest.mark.parametrize("ranks,m", MESHES)
def test_partitioned_lm_equals_the_unsharded_reference(worlds, stacks, ranks,
                                                       m, cut):
    check_plm(worlds, stacks, ranks, m, "hybrid-grs", cut)
