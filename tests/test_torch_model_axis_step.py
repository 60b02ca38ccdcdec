"""LM training on a (data 2, model 2) mesh against the reference's
one-device step, and ``launch.train`` on that mesh, stopped and resumed.

One 4-rank gloo world (``launch.mesh.run_world``, rank bodies in
``tests/_model_axis_train.py``):

* ``launch.train.make_mesh_train_step`` at 2 microbatches, 2 steps from the
  reference's parameters (``params_from_reference``), each rank its rows
  of the logical batch and its shard of the weights: each step's loss at
  rtol 1e-5, the gathered parameters within 1e-4 and Adam's moments within
  1e-4 / 2e-4 of each leaf's largest entry (tests/_train_parity.py's
  bars), against the reference's jitted one-device step on the whole
  batch;
* ``launch.train.main(mesh=)`` on reduced qwen3: 2 steps with a
  checkpoint, resumed to 4, equals 4 uninterrupted steps bit for bit on
  every rank; the checkpoint is the whole tree, which restores on one
  device, and its shards are the ranks' own;
* ``launch.train.save_checkpoint`` on that mesh: the second data replica
  issues no collective, the first gathers one leaf at a time, and the
  checkpoint is the whole initial tree.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _model_axis_train as mt
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import steps as r_steps
from repro.models import transformer as r_tf
from repro_torch import _tree
from repro_torch.configs import base as p_base
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding
from repro_torch.models import transformer as p_tf
from repro_torch.runtime.checkpoint import CheckpointManager

ARCH, STEPS, MICRO = "qwen3-0.6b", 2, 2
TRAIN_ARGV = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
              "--seq", "16"]
STOP, TOTAL = 2, 4
PROBE_STEP = 7


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


def _reference_run():
    cfg = r_reduced(r_get_config(ARCH))
    params = r_tf.init_params(jax.random.PRNGKey(0), cfg)
    init, step = r_steps.make_train_step(cfg, lr=1e-3, microbatches=MICRO)
    step = jax.jit(step)
    opt, losses, start = init(params), [], params
    for i in range(STEPS):
        batch = {k: v.numpy().astype(np.int32) for k, v in
                 mt.batch(p_base.reduced(p_base.get_config(ARCH)), i).items()}
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return as_np(start), as_np(params), as_np(opt.mu), as_np(opt.nu), losses


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    start, params, mu, nu, losses = _reference_run()
    ckpt = str(tmp_path_factory.mktemp("mesh_ckpt"))
    probe = str(tmp_path_factory.mktemp("mesh_save"))
    out = pmesh.run_world(_both, 4, args=(start, ckpt, probe),
                          deadline_s=300)
    return {"ref": (params, mu, nu, losses), "ranks": out, "ckpt": ckpt,
            "probe": probe}


def _both(start, ckpt, probe):
    return {"step": mt.reference_step_world(start, ARCH, STEPS, MICRO),
            "train": mt.train_world(ckpt, TRAIN_ARGV, STOP, TOTAL),
            "save": mt.save_world(probe, PROBE_STEP)}


def _port(tree):
    cfg = p_base.reduced(p_base.get_config(ARCH))
    return [t.numpy() for t in _tree.leaves(
        p_tf.params_from_reference(tree, cfg, "cpu"))]


def _flat(tree) -> list:
    """The leaves of a tree of numpy arrays, in the port's tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


class ModelRank:
    """Rank ``r``'s view of a 2-way "model" axis, at index ``data`` of a
    2-way "data" axis: what ``place_params`` reads of a mesh."""

    mesh_dim_names = ("data", "model")
    mesh = torch.zeros(2, 2)

    def __init__(self, r: int, data: int = 0):
        self.r, self.data = r, data

    def get_local_rank(self, axis) -> int:
        return self.data if axis == "data" else self.r


def test_mesh_step_equals_the_reference_one_device_step(world):
    params, mu, nu, losses = world["ref"]
    want = {"params": _port(params), "mu": _port(mu), "nu": _port(nu)}
    for r, out in enumerate(world["ranks"]):
        got = out["step"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
        for part, tol, rel in (("params", 1e-4, False), ("mu", 1e-4, True),
                               ("nu", 2e-4, True)):
            g_leaves = _flat(got[part])
            assert len(g_leaves) == len(want[part])
            for i, (g, w) in enumerate(zip(g_leaves, want[part])):
                bound = tol * (max(float(np.abs(w).max()), 1e-30)
                               if rel else 1.0)
                err = float(np.abs(g - w).max())
                assert err <= bound, f"rank {r} {part} leaf {i}: {err:.3e}"


def test_launch_train_on_a_mesh_resumes_bit_for_bit(world):
    for r, out in enumerate(world["ranks"]):
        run = out["train"]
        assert run["resumed"]["start"] == STOP
        assert run["first"]["start"] == 0
        assert run["resumed"]["losses"] == {
            k: v for k, v in run["straight"]["losses"].items() if k >= STOP}
        for part in ("params", "mu"):
            for g, w in zip(_flat(run["resumed"][part]),
                            _flat(run["straight"][part])):
                np.testing.assert_array_equal(g, w, err_msg=f"{r} {part}")


def test_mesh_checkpoint_restores_on_one_device(world):
    """The checkpoint is the whole tree: it restores into one device's
    (params, opt) and its shards are each rank's parameters after the
    first run (the launcher's layout: the recommended options, ZeRO-3
    slices over ("data", "model"))."""
    from repro_torch.models.steps import make_train_step
    cfg = p_base.reduced(p_base.get_config(ARCH))
    params = p_tf.init_params(0, cfg, "cpu")
    opt = make_train_step(cfg)[0](params)
    (whole, opt), manifest = CheckpointManager(world["ckpt"]).restore(
        (params, opt))
    assert manifest["step"] == STOP and int(opt.step) == STOP
    for r, out in enumerate(world["ranks"]):
        mine = sharding.place_params(
            ModelRank(r % 2, r // 2), cfg, whole,
            sharding.recommended_options(cfg, "train"))[0]
        got = _flat(out["train"]["first"]["params"])
        assert len(got) == len(_tree.leaves(mine))
        for g, w in zip(got, _tree.leaves(mine)):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=str(r))


def test_mesh_checkpoint_gathers_on_the_first_replica_one_leaf_at_a_time(
        world):
    """Only the first data replica gathers, each leaf dropped once written
    (at most the written leaf and the next are alive), and the checkpoint
    is seed 0's whole initial parameters with zero moments."""
    from repro_torch.models.steps import make_train_step
    cfg = p_base.reduced(p_base.get_config(ARCH))
    params = p_tf.init_params(0, cfg, "cpu")
    opt = make_train_step(cfg)[0](params)
    for r, out in enumerate(world["ranks"]):
        save = out["save"]
        if save["data"]:
            assert save["calls"] == [] and save["made"] == 0, r
            continue
        assert len(save["calls"]) == save["made"] > 2, r
        assert max(save["alive"]) <= 2, (r, save["alive"])
    (got, got_opt), manifest = CheckpointManager(world["probe"]).restore(
        (params, opt))
    assert manifest["step"] == PROBE_STEP
    got, want = _tree.leaves([got, got_opt]), _tree.leaves([params, opt])
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
