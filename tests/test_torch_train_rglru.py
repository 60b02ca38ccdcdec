"""Port parity: the LM train step (``models.steps``) on reduced
recurrentgemma-2b ("r" and "l" layers, the RG-LRU scan) against the
reference's, jitted on the CPU
through its non-Pallas arm, under ``_train_parity``'s bars: losses of 3
steps within 1e-5 relative, step-1 gradients within 1e-4 of each leaf's
max |g|, parameters after 3 steps within ``PARAM_TOL``, at 1 and 2
microbatches; a batch of 3 at 2 microbatches refused by both; per-unit
remat against none.  ``test_torch_train_scans.py`` holds the same for
reduced mamba2-1.3b (each file under 40 s).  On the CPU the scans'
gradients are autograd through the plain versions; on CUDA the same step
runs the scans' backward kernels (``tests/test_torch_gpu.py``,
``chip_smoke.py`` phase 20).
"""
import pytest

import _train_parity as tp


@pytest.fixture(scope="module", params=["recurrentgemma-2b"])
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
