"""Port parity: the LM train step on reduced gemma3-1b (the "l" kind:
sliding-window attention at S above the window, MQA, a tail layer; its
unit cut to (l, g) + (l,)), held as ``test_torch_train.py`` holds qwen3
(``_train_parity``).
"""
import pytest

import _train_parity as tp


@pytest.fixture(scope="module", params=['gemma3-1b'])
def arch(request):
    return tp.make_arch(request.param)


def test_gradients_match_reference(arch):
    tp.check_gradients(arch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(arch, microbatches):
    tp.check_train_step(arch, microbatches)


def test_accumulation_dtype_and_split(arch):
    tp.check_accumulation(arch)


def test_remat_gives_the_same_gradients(arch):
    tp.check_remat(arch)
