"""Port parity: the checkpoint manager and the two training entry points.

The four single-device cases of ``tests/test_runtime.py`` (round trip,
keep-last-k, async, atomicity) run against the port's
``CheckpointManager``.  Both packages flatten their trees to the same key
strings (``a:`` NamedTuple fields, ``k:`` dict keys, ``i:`` list indices),
so a checkpoint the reference writes of its PPO ``TrainState`` restores
into the port's equal to ``ppo.train_state_from_reference``, the port
writes the reference's ``manifest["keys"]`` and dtypes, and bf16 leaves
cross both ways as raw bits.  ``train_lymdo`` killed after its first chunk
and resumed ends with the parameters of an uninterrupted run, bit for bit,
and ``train_compare.main`` at 1 episode x 4 slots writes every key of
``scripts/train_compare.py``'s artifact.
"""
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as r_env
from repro.core import policies as r_pol
from repro.core import ppo as r_ppo
from repro.runtime.checkpoint import CheckpointManager as RManager
from repro_torch import _tree, train_compare, train_lymdo
from repro_torch.core import env as p_env
from repro_torch.core import policies as p_pol
from repro_torch.core import ppo as p_ppo
from repro_torch.runtime.checkpoint import CheckpointManager, _flatten

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
            "lst": [torch.zeros(2, dtype=torch.int32)]}


def _ref_tree():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "nested": {"b": jnp.ones((4,), jnp.bfloat16) * 1.5},
            "lst": [jnp.zeros((2,), jnp.int32)]}


def test_checkpoint_roundtrip(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, tree, extra={"data_step": 7})
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 7 and manifest["extra"]["data_step"] == 7
    for a, b in zip(_tree.leaves(tree), _tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_k_and_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.list_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, tree)
    mgr.wait()
    assert mgr.latest_step() == 1


class _Half:
    """A sharding that keeps the first half of a leaf's leading dim."""

    def local(self, t):
        return t[:t.shape[0] // 2]


def test_checkpoint_atomicity(tmp_path, tree):
    """A leftover .tmp dir from a crashed writer is invisible to restore;
    ``restore(shardings=)`` keeps each sharded leaf's ``local`` part and
    every other leaf whole."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree)
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert mgr.latest_step() == 1
    assert mgr.restore_or_none(tree)[1]["step"] == 1
    assert CheckpointManager(str(tmp_path / "empty")).restore_or_none(
        tree) == (None, None)
    got, _ = mgr.restore(tree, shardings={"a": _Half(), "nested": None})
    assert torch.equal(got["a"], tree["a"][:tree["a"].shape[0] // 2])
    assert torch.equal(got["nested"]["b"], tree["nested"]["b"])


def test_bf16_crosses_both_ways_as_raw_bits(tmp_path, tree):
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(1, tree)
    RManager(str(tmp_path / "r"), async_save=False).save(1, _ref_tree())
    for d in ("p", "r"):
        got, man = CheckpointManager(str(tmp_path / d)).restore(tree)
        assert got["nested"]["b"].dtype == torch.bfloat16
        assert torch.equal(got["nested"]["b"], tree["nested"]["b"])
        assert man["dtypes"] == {"k:a": "float32", "k:nested/k:b": "bfloat16",
                                 "k:lst/i:0": "int32"}
        back, _ = RManager(str(tmp_path / d)).restore(_ref_tree())
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_ref_tree())):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))


@pytest.fixture(scope="module")
def states():
    """A reference TrainState after one update's worth of Adam moments, and
    the port's agent for the same head."""
    env = r_env.paper_env()
    agent = r_ppo.PPO(r_pol.GaussianTanhPolicy(env.obs_dim, env.L),
                      env.obs_dim, r_ppo.PPOConfig())
    st = agent.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    noisy = lambda t: jnp.asarray(rng.standard_normal(np.shape(t)),
                                  jnp.float32)
    st = st._replace(opt_state=st.opt_state._replace(
        step=jnp.int32(8), mu=jax.tree.map(noisy, st.opt_state.mu),
        nu=jax.tree.map(lambda t: noisy(t) ** 2, st.opt_state.nu)))
    p_env_ = p_env.paper_env(device="cpu")
    p_agent = p_ppo.PPO(p_pol.GaussianTanhPolicy(p_env_.obs_dim, p_env_.L),
                        p_env_.obs_dim, p_ppo.PPOConfig())
    return st, p_agent, p_env_


def test_reference_checkpoint_restores_into_the_port(tmp_path, states):
    r_state, p_agent, p_env_ = states
    RManager(str(tmp_path), async_save=False).save(8, r_state,
                                                   extra={"episodes": 8})
    like = p_agent.init(p_env_.generator(0))
    got, manifest = CheckpointManager(str(tmp_path)).restore(like)
    assert isinstance(got, p_ppo.TrainState)
    assert manifest["extra"] == {"episodes": 8}
    want = p_ppo.train_state_from_reference(
        jax.tree.map(np.asarray, r_state), p_agent.policy, "cpu")
    got_leaves, want_leaves = _flatten(got), _flatten(want)
    assert sorted(got_leaves) == sorted(want_leaves)
    assert len(got_leaves) == len(jax.tree.leaves(r_state))
    for key, a in got_leaves.items():
        b = want_leaves[key]
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert int(got.opt_state.step) == 8


def test_port_writes_the_references_manifest_keys(tmp_path, states):
    r_state, p_agent, p_env_ = states
    RManager(str(tmp_path / "r"), async_save=False).save(1, r_state)
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        1, p_agent.init(p_env_.generator(0)))
    mans = [json.loads((tmp_path / d / "step_0000000001" /
                        "manifest.json").read_text()) for d in ("r", "p")]
    assert mans[1]["keys"] == mans[0]["keys"]
    assert mans[1]["dtypes"] == mans[0]["dtypes"]
    assert "a:opt_state/a:mu/k:pi/k:mlp/i:0/k:w" in mans[1]["keys"]
    # and the reference restores what the port wrote
    back, _ = RManager(str(tmp_path / "p")).restore(r_state)
    assert type(back).__name__ == "TrainState"


def _train(ckpt, episodes):
    return train_lymdo.main(["--device", "cpu", "--episodes", str(episodes),
                             "--chunk", "1", "--steps", "6",
                             "--eval-episodes", "1", "--ckpt-dir", str(ckpt)])


def test_train_lymdo_killed_and_resumed_equals_an_uninterrupted_run(tmp_path):
    first = _train(tmp_path / "a", 1)
    assert first["resumed_from"] == 0 and len(first["chunks"]) == 1
    resumed = _train(tmp_path / "a", 2)
    assert resumed["resumed_from"] == 1 and len(resumed["chunks"]) == 1
    whole = _train(tmp_path / "b", 2)
    assert whole["resumed_from"] == 0 and len(whole["chunks"]) == 2
    assert resumed["chunks"] == whole["chunks"][1:]
    for a, b in zip(_tree.leaves(resumed["train_state"]),
                    _tree.leaves(whole["train_state"])):
        assert torch.equal(a, b)
    assert resumed["eval"] == whole["eval"]
    assert int(whole["train_state"].opt_state.step) == 2 * 8
    assert CheckpointManager(str(tmp_path / "b")).list_steps() == [1, 2]
    assert train_lymdo.chunk_seed(0, 1) != train_lymdo.chunk_seed(0, 0)


# the artifact keys of scripts/train_compare.py
ARTIFACT_KEYS = {"episodes", "rates", "fig3", "fig4", "fig5",
                 "headline_delay_reduction_vs_ppo",
                 "headline_delay_reduction_best",
                 "fig5_alexnet_queue_reduction",
                 "fig5_resnet_queue_reduction"}
ALGORITHMS = {"lymdo", "lymdo_categorical", "ppo_joint", "local", "edge",
              "random", "oracle"}


def test_train_compare_writes_every_key_of_the_reference_artifact(tmp_path):
    script = (ROOT / "scripts" / "train_compare.py").read_text()
    for key in ARTIFACT_KEYS | ALGORITHMS:
        key = key.replace("alexnet", "{task}").replace("resnet", "{task}")
        assert f'"{key}"' in script, key
    out = tmp_path / "paper_artifacts.json"
    rep = train_compare.main(["--device", "cpu", "--episodes", "1",
                              "--steps", "4", "--eval-episodes", "1",
                              "--out", str(out)])
    art = json.loads(out.read_text())
    assert set(art) == ARTIFACT_KEYS
    assert set(rep) == ARTIFACT_KEYS | {"agents"}
    assert art["rates"] == train_compare.RATES
    assert set(art["fig3"]) == {"lymdo", "lymdo_categorical", "ppo_joint"}
    assert all(len(v["reward_curve"]) == 1 for v in art["fig3"].values())
    assert set(art["fig4"]) == {str(r) for r in train_compare.RATES}
    for row in art["fig4"].values():
        assert set(row) == ALGORITHMS
        assert all(np.isfinite(m["delay"]) for m in row.values())
        assert row["oracle"]["reward"] >= max(row["local"]["reward"],
                                              row["edge"]["reward"]) - 1e-3
    for name in ("lymdo", "ppo_joint"):
        for q in ("alexnet_queue", "resnet_queue"):
            assert len(art["fig5"][name][q]) == 4
