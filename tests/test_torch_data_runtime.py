"""Port parity: the synthetic stream (``data.pipeline``), the resilience
policies (``runtime.resilience``), the launcher's microbatch rule and the
two training entry points (``launch.train``, ``train_lm``) on the CPU.

The stream is the port's own (torch's generator, not JAX's threefry), so
its numbers differ from the reference's; its semantics, shapes and dtypes
must not.  The resilience scenarios are ``tests/test_runtime.py``'s, run
on both packages with the same fake clock.  A run killed at a checkpoint
and resumed must end with the parameters of one that is not, bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import load_all as r_load_all
from repro.configs.base import reduced as r_reduced
from repro.data import pipeline as r_pipe
from repro.launch.sharding import recommended_options
from repro.runtime import resilience as r_res
from repro_torch import _tree, train_lm
from repro_torch.configs import base as p_base
from repro_torch.data import pipeline as p_pipe
from repro_torch.launch import sharding as p_sh
from repro_torch.launch import train as p_train
from repro_torch.runtime import resilience as p_res

ARCH_NAMES = sorted(r_load_all())


def _shapes(batch):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in batch.items()}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_for_arch_shapes_and_dtypes_match_reference(name):
    """Tokens, targets and the vision / audio stubs: the reference's keys,
    shapes and dtypes for every config, enc-dec at seq // 4."""
    r_batch = r_pipe.for_arch(r_get_config(name), batch=2, seq=32,
                              seed=1).get_batch(3)
    p_batch = p_pipe.for_arch(p_base.get_config(name), batch=2, seq=32,
                              seed=1).get_batch(3)
    assert _shapes(p_batch) == _shapes(r_batch)


def test_stream_is_deterministic_shifted_and_in_range():
    cfg = p_pipe.DataConfig(batch=3, seq=40, vocab=97, seed=5,
                            image_tokens=4, d_model=8, src_frames=6)
    a, b = p_pipe.SyntheticStream(cfg), p_pipe.SyntheticStream(cfg)
    for step in (0, 1, 17):
        x, y = a.get_batch(step), b.get_batch(step)
        assert all(torch.equal(x[k], y[k]) for k in x)
    x, z = a.get_batch(0), a.get_batch(1)
    assert not torch.equal(x["tokens"], z["tokens"])
    other = p_pipe.SyntheticStream(dataclasses.replace(cfg, seed=6))
    assert not torch.equal(other.get_batch(0)["tokens"], x["tokens"])
    assert torch.equal(x["targets"][:, :-1], x["tokens"][:, 1:])
    toks = torch.cat([x["tokens"], x["targets"][:, -1:]], dim=1)
    assert int(toks.min()) >= 0 and int(toks.max()) < 97
    # the stubs: normal at 0.02 scale
    emb = torch.cat([p_pipe.SyntheticStream(dataclasses.replace(
        cfg, image_tokens=512, d_model=64)).get_batch(s)["image_embeds"]
        for s in range(4)])
    assert abs(float(emb.std()) - 0.02) < 1e-3
    assert abs(float(emb.mean())) < 1e-3


def test_stream_steps_follow_the_drift():
    """(base + cumsum(drift)) % vocab: with the base redrawn, consecutive
    tokens are uniform over the vocabulary, as in the reference."""
    cfg = p_pipe.DataConfig(batch=64, seq=256, vocab=16, seed=0)
    toks = p_pipe.SyntheticStream(cfg).get_batch(0)["tokens"]
    counts = torch.bincount(toks.flatten().long(), minlength=16).float()
    assert float(counts.max() / counts.min()) < 1.25


# ---------------------------------------------------------------------------
# resilience: tests/test_runtime.py's scenarios on both packages
# ---------------------------------------------------------------------------

def _straggler_run(mod):
    t = {"now": 0.0}
    mon = mod.StragglerMonitor(threshold=2.0, patience=2,
                               clock=lambda: t["now"])
    flags = []
    for step, dt in enumerate([1.0] * 10 + [5.0, 5.0]):
        mon.start_step(step)
        t["now"] += dt
        flags.append((mon.end_step(), mon.should_redispatch))
    return flags, mon.deadline(), [dataclasses.astuple(e) for e in mon.events]


def test_straggler_monitor_matches_reference():
    flags, deadline, events = _straggler_run(p_res)
    assert (flags, deadline, events) == _straggler_run(r_res)
    assert flags[:10] == [(False, False)] * 10
    assert flags[10:] == [(True, False), (True, True)]
    assert deadline == pytest.approx(2.0, rel=0.3)


@pytest.mark.parametrize("live,current", [(256, None), (248, (16, 16)),
                                          (256, (16, 16)), (7, None),
                                          (12, (4, 4))])
def test_elastic_policy_matches_reference(live, current):
    got = p_res.ElasticPolicy(target_model=16).plan(live, current)
    assert got == r_res.ElasticPolicy(target_model=16).plan(live, current)
    assert got["shape"][0] * got["shape"][1] == live


def _restart_run(mod, fail_at, max_restarts=3):
    saves = {}
    crashed = {"done": False}

    def step_fn(state, step):
        if step == fail_at and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")
        return state + 1

    loop = mod.RestartLoop(lambda s, i: saves.__setitem__("latest", (s, i)),
                           lambda: saves.get("latest"), checkpoint_every=5,
                           max_restarts=max_restarts)
    state, step = loop.run(step_fn, 0, n_steps=10)
    return state, step, loop.restarts


def test_restart_loop_matches_reference():
    assert _restart_run(p_res, 7) == _restart_run(r_res, 7) == (10, 10, 1)
    loop = p_res.RestartLoop(lambda s, i: None, lambda: None, max_restarts=1)

    def bad(state, step):
        raise RuntimeError("permanent failure")

    with pytest.raises(RuntimeError):
        loop.run(bad, 0, n_steps=3)


# ---------------------------------------------------------------------------
# the launcher and the train_lm twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_microbatch_rule_matches_reference(name):
    """The launcher's microbatch count is the recommended options' (full
    size and reduced), as the reference's launcher takes it."""
    cfg = p_base.get_config(name)
    assert p_sh.recommended_options(cfg, "train").microbatches == \
        recommended_options(r_get_config(name), "train").microbatches
    small = p_base.reduced(cfg)
    assert p_sh.recommended_options(small, "train").microbatches == \
        recommended_options(r_reduced(r_get_config(name)), "train").microbatches


def test_train_lm_config_is_the_examples():
    want = r_reduced(r_get_config("qwen3-0.6b"), n_layers=4, d_model=128,
                     d_ff=256, n_heads=4, n_kv=2, head_dim=32, vocab=512)
    assert dataclasses.asdict(train_lm.model_config()) == \
        dataclasses.asdict(want)


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tree.leaves(a),
                                                  _tree.leaves(b)))


def test_launch_train_resumes_to_the_uninterrupted_run(tmp_path):
    common = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
              "--batch", "4", "--seq", "16", "--ckpt-every", "3"]
    whole = p_train.main(common + ["--steps", "6", "--ckpt-dir",
                                   str(tmp_path / "a")])
    first = p_train.main(common + ["--steps", "3", "--ckpt-dir",
                                   str(tmp_path / "b")])
    resumed = p_train.main(common + ["--steps", "6", "--ckpt-dir",
                                     str(tmp_path / "b")])
    assert whole["microbatches"] == 2 and resumed["start"] == 3
    assert sorted(first["losses"]) == [0, 1, 2]
    assert sorted(resumed["losses"]) == [3, 4, 5]
    for s in range(3):
        assert first["losses"][s] == whole["losses"][s]
    for s in range(3, 6):
        assert resumed["losses"][s] == whole["losses"][s]
    assert np.isfinite(list(whole["losses"].values())).all()
    assert _equal_trees(resumed["params"], whole["params"])
    assert _equal_trees(resumed["opt"], whole["opt"])
    assert len(whole["step_s"]) == 6 and min(whole["step_s"]) > 0
    with pytest.raises(ValueError, match="needs 512 ranks"):
        p_train.main(["--arch", "qwen3-0.6b", "--multi-pod"])


def test_train_lm_resumes_to_the_uninterrupted_run(tmp_path):
    common = ["--device", "cpu", "--ckpt-every", "4"]
    whole = train_lm.main(common + ["--steps", "8", "--ckpt-dir",
                                    str(tmp_path / "a")])
    train_lm.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    resumed = train_lm.main(common + ["--steps", "8", "--ckpt-dir",
                                      str(tmp_path / "b")])
    assert resumed["start"] == 4
    assert _equal_trees(resumed["params"], whole["params"])
    assert _equal_trees(resumed["opt"], whole["opt"])
