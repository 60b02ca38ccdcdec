"""ZeRO-3 training of reduced moonshot-v1-16b-a3b under moe-only (experts
and vocabulary over "model", every other layer whole, ZeRO-3 storage) on
a (data 2, model 2) gloo world, against the reference's jitted
one-device step (the body is tests/test_torch_zero_train.py's).  The MoE
runs at the no-drop capacity factor, with a dispatch group of one row
(``ffn.MOE_GROUP`` 64 on both sides, 1,024 at full size), so each data
rank's rows and each microbatch's are whole groups of the reference's
batch and a rank routes its tokens as the reference does: 3 steps at 1
and at 2 microbatches, each step's loss at rtol 1e-5, the gathered
parameters within 1e-4 and Adam's moments within 1e-4 / 2e-4 of each
leaf's largest entry.
"""
import pytest
import torch.distributed as dist

from test_torch_zero_train import STEPS, hold_case, run_worlds

CASES = [("m", "moe", 1, STEPS), ("m", "moe", 2, STEPS)]


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_worlds(tmp_path_factory, CASES, [], False)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-mb{c[2]}")
def test_moe_only_zero_training_equals_the_reference_step(world, case):
    hold_case(world, case)
