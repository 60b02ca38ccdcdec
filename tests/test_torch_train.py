"""Port parity: the LM train step (``models.steps``) on reduced qwen3-0.6b
against the reference's, jitted on the CPU through its non-Pallas arm:
losses of 3 steps within 1e-5 relative, step-1 gradients within 1e-4 of
each leaf's max |g|, parameters after 3 steps within
``_train_parity.PARAM_TOL`` (measured; see there), at 1 and 2
microbatches; a batch of 3 at 2 microbatches refused by both (the port
with ValueError, nothing moved); per-unit remat against none.  ``test_torch_train_gemma3.py``
and ``test_torch_train_moe.py`` hold the same for gemma3-1b and moonshot.
"""
import pytest

import _train_parity as tp


@pytest.fixture(scope="module", params=['qwen3-0.6b'])
def arch(request):
    return tp.make_arch(request.param)


def test_gradients_match_reference(arch):
    tp.check_gradients(arch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(arch, microbatches):
    tp.check_train_step(arch, microbatches)


def test_indivisible_batch_raises_as_the_reference_does(arch):
    tp.check_indivisible_batch(arch)


def test_accumulation_dtype_and_split(arch):
    tp.check_accumulation(arch)


def test_remat_gives_the_same_gradients(arch):
    tp.check_remat(arch)
