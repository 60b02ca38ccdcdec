"""Tensor-parallel training over "model": every rank's gradient of its
shard against its shard of the one-rank gradient, for every layer kind.

A 2-rank world (model 2) and a 4-rank world (model 4) are spawned once each
(``launch.mesh.run_world``, rank bodies in ``tests/_model_axis_train.py``).
Each rank draws the same float32 parameters and batch, takes the one-rank
gradient itself, then its shard's gradient under
``shardctx.activation_sharding`` (with ``sharding.reduce_partial_grads``):
every leaf must equal its shard of the one-rank gradient to 1e-5 of the
leaf's largest entry, so a backward rule that scales by M, or drops a
rank's part, fails at one M or the other.  The stacks: g, gemma3's (l, g)
with an l tail and one kv head, recurrentgemma's (r, r, l) with an (r, r)
tail, the SSD, the MoE at the no-drop capacity, 6 query heads over 3 kv
heads, vision's x and seamless' e/d; qwen3 also under remat.  Also: a clip
that binds (a rank's own norm would scale its moments wrongly), and
``gather_params`` of ``place_params`` is the identity; the
vocabulary-parallel loss is the one-rank loss to 1e-6.  The one-rank
gradient is held to the reference by tests/test_torch_train*.py and
tests/test_torch_grads.py.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch.distributed as dist

import _model_axis_train as mt
from repro_torch.launch import mesh as pmesh

WORLD_S = 300.0
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-6
CLIP_TOL = 1e-4
CASES = [(name, False) for name in mt.STACKS] + [("g", True)]


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def worlds():
    """Both worlds at once (each rank one thread)."""
    with ThreadPoolExecutor(2) as pool:
        runs = {m: pool.submit(pmesh.run_world, mt.grad_world, m,
                               args=(CASES, m), deadline_s=WORLD_S)
                for m in (2, 4)}
        return {m: run.result() for m, run in runs.items()}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_close_to_leaf_max(got, want, tol: float, where: str):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert pairs and len(list(_leaves(got))) == len(list(_leaves(want)))
    for (path, g), (_, w) in pairs:
        assert g.shape == w.shape, f"{where} {path}"
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{where} {path}: off by {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("name,remat", CASES)
@pytest.mark.parametrize("m", [2, 4])
def test_shard_gradients_equal_the_one_rank_gradient(worlds, m, name, remat):
    for out in worlds[m]:
        case = out[("grad", name, remat)]
        # the vocabulary-parallel loss against the whole logits' loss
        assert np.isfinite(case["loss"])
        assert abs(case["loss"] - case["loss_one"]) <= LOSS_RTOL * abs(
            case["loss_one"])
        assert_close_to_leaf_max(case["grad"], case["want"], GRAD_TOL,
                                 f"{name} remat={remat} rank "
                                 f"{out['rank']} of {m}")


@pytest.mark.parametrize("name", list(mt.STACKS))
@pytest.mark.parametrize("m", [2, 4])
def test_gather_of_place_is_the_identity(worlds, m, name):
    for out in worlds[m]:
        case = out[("grad", name, False)]
        for (path, g), (_, w) in zip(_leaves(case["round_trip"]),
                                     _leaves(case["params"])):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {path}")


@pytest.mark.parametrize("m", [2, 4])
def test_binding_clip_takes_the_whole_models_norm(worlds, m):
    for out in worlds[m]:
        assert_close_to_leaf_max(out["clip"]["mu"], out["clip"]["want"],
                                 CLIP_TOL, f"clip rank {out['rank']}")


def test_clip_binds():
    """The clip of the clip case is below the gradient's norm."""
    from repro_torch.models import steps
    from repro_torch.optim.adam import global_norm
    cfg, p = mt.params(mt.STACKS["g"]())
    _, g = steps.value_and_grad(p, cfg, mt.batch(cfg))
    assert float(global_norm(g)) > 10 * mt.CLIP
