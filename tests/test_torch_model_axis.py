"""The port's tensor parallelism over the "model" axis: ``ServingEngine(
mesh=)`` and ``PartitionedLM(mesh=)`` on spawned gloo worlds, held to the
reference's UNSHARDED engine and partitioned model on the same weights.

The reference's own sharded tests fail on this tree (ROADMAP queue 3), so
its one-device path is the oracle, as tests/test_model_axis.py's contract
states it: greedy tokens identical, logits and the boundary hidden within
rtol/atol 1e-5 (a split contraction sums in another order), argmax equal.
A 2-rank world runs ``make_cells_mesh(model=1)`` (two replicas, nothing
split) and ``model=2``; a 4-rank world ``model=4`` and ``model=2`` (two
cells rows, each a replica of its own 2-way model axis).  Every rank must
agree with the reference.  This file holds reduced qwen3-0.6b and moonshot
(the no-drop capacity factor); tests/test_torch_model_axis_recurrent.py
the recurrent stacks.  The 2-rank world also restores a checkpoint with
``params_shardings`` (equal to ``place_params``), serves weights each
rank drew alone (``init_rank_params``) and builds elastic meshes.
"""
import jax
import numpy as np
import pytest
import torch

import _model_axis as ma
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.serving import engine as r_engine
from repro.serving.partitioned import PartitionedLM as RPartitionedLM
from repro_torch.launch import mesh as pmesh
from repro_torch.models import transformer as p_tf
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.serving import engine as p_engine

NAMES = ("qwen3", "moonshot")
WORLDS = {2: (1, 2), 4: (4, 2)}          # ranks -> the model degrees run
TOL = dict(rtol=1e-5, atol=1e-5)
WORLD_S = 300.0
ELASTIC = (16, 3, 1)
INIT_SEED = 3


def reference_stacks(names) -> dict:
    """name -> (reference cfg, reference params, the params as numpy)."""
    out = {}
    for name in names:
        cfg = ma.STACKS[name](r_get_config, r_reduced)
        params = r_tf.init_params(jax.random.PRNGKey(0), cfg)
        out[name] = (cfg, params, jax.tree.map(np.asarray, params))
    return out


def spawn_worlds(stacks: dict, extra: dict | None = None) -> dict:
    """ranks -> each rank's ``model_axis_world`` results; ``extra`` adds
    cases to the 2-rank world (``ma.PLM_ONLY`` stacks run there only)."""
    trees = {name: s[2] for name, s in stacks.items()}
    out = {}
    for ranks, meshes in WORLDS.items():
        cases = {"meshes": meshes, "engine": tuple(ma.ENGINE_CASES),
                 "stacks": {name: tree for name, tree in trees.items()
                            if ranks == 2 or name not in ma.PLM_ONLY}}
        if ranks == 2 and extra:
            cases.update(extra)
        out[ranks] = pmesh.run_world(ma.model_axis_world, ranks,
                                     args=(cases,), deadline_s=WORLD_S)
    return out


_ref: dict = {}


def reference_engine(stacks, name: str, case: str) -> dict:
    if (name, case) not in _ref:
        cfg, params, _ = stacks[name]
        _ref[(name, case)] = ma.run_engine(r_engine, cfg, params, case)
    return _ref[(name, case)]


def reference_plm(stacks, name: str, cut: int):
    cfg, params, _ = stacks[name]
    toks = jax.numpy.asarray(ma.plm_tokens(cfg))
    logits, boundary = RPartitionedLM(cfg, params, cut).infer(toks)
    return np.asarray(logits, np.float32), np.asarray(boundary, np.float32)


def check_engine(worlds, stacks, ranks, m, name, case):
    want = reference_engine(stacks, name, case)
    for r in worlds[ranks]:
        got = r[(m, name, case)]
        assert got["out"] == want["out"], f"rank {r['rank']}"
        for k in ma.COUNTERS:
            assert got[k] == want[k], (f"rank {r['rank']}", k)
    if case == "preempt":
        assert want["preemptions"] > 0


def check_plm(worlds, stacks, ranks, m, name, cut):
    want_lg, want_b = reference_plm(stacks, name, cut)
    for r in worlds[ranks]:
        lg, boundary = r[(m, name, "plm", cut)]
        np.testing.assert_allclose(lg, want_lg, **TOL)
        np.testing.assert_array_equal(lg.argmax(-1), want_lg.argmax(-1))
        if cut == 0:
            np.testing.assert_array_equal(boundary, want_b)
        else:
            np.testing.assert_allclose(boundary, want_b, **TOL)


MESHES = [(ranks, m) for ranks, ms in WORLDS.items() for m in ms]


@pytest.fixture(scope="module")
def stacks():
    return reference_stacks(NAMES + ma.PLM_ONLY)


@pytest.fixture(scope="module")
def worlds(stacks, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    cfg = ma.port_cfg("qwen3")
    params = p_tf.params_from_reference(stacks["qwen3"][2], cfg, "cpu")
    CheckpointManager(str(ckpt), async_save=False).save(1, params)
    return spawn_worlds(stacks, {"restore": str(ckpt), "elastic": ELASTIC,
                                 "init_rank": INIT_SEED})


@pytest.mark.parametrize("case", sorted(ma.ENGINE_CASES))
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ranks,m", MESHES)
def test_engine_tokens_equal_the_unsharded_reference(worlds, stacks, ranks,
                                                     m, name, case):
    check_engine(worlds, stacks, ranks, m, name, case)


@pytest.mark.parametrize("cut", ma.PLM_CUTS)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("ranks,m", MESHES)
def test_partitioned_lm_equals_the_unsharded_reference(worlds, stacks, ranks,
                                                       m, name, cut):
    check_plm(worlds, stacks, ranks, m, name, cut)


@pytest.mark.parametrize("cut", ma.PLM_CUTS)
def test_uneven_query_groups_equal_the_unsharded_reference(worlds, stacks,
                                                           cut):
    """6 query heads over 3 kv heads on a 2-way model axis: each rank
    reads, per local query head, the kv head of its global group."""
    check_plm(worlds, stacks, 2, 2, "uneven-gqa", cut)


def test_restore_with_shardings_equals_place_params(worlds):
    """Each rank of a 2-way model axis restores the whole checkpoint with
    ``params_shardings`` and keeps exactly ``place_params``' shard of
    every leaf."""
    for r in worlds[2]:
        got = r["restore"]
        assert got["equal"] == got["leaves"] > 0
        assert got["split"] == ("attn", "ffn", "vocab")
        cfg = ma.port_cfg("qwen3")
        assert (cfg.vocab // 2, cfg.d_model) in got["shapes"]   # the embed


def test_rank_drawn_weights_serve_the_unsharded_tokens(worlds):
    """Each rank of a 2-way model axis draws only its shard
    (``init_rank_params``) and serves the tokens of the port's unsharded
    engine on the whole init of the same seed."""
    cfg = ma.port_cfg("qwen3")
    want = ma.run_engine(p_engine, cfg, p_tf.init_params(INIT_SEED, cfg,
                                                         "cpu"), "chunked")
    for r in worlds[2]:
        assert r["init_rank"] == want


def test_elastic_mesh_takes_the_largest_model_axis(worlds):
    """On 2 ranks: target 16 -> (1, 2), 3 -> (1, 2), 1 -> (2, 1)."""
    for r in worlds[2]:
        assert r["elastic"] == [(1, 2), (1, 2), (2, 1)]
