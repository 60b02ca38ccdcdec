"""ZeRO-3 training in the rank-local layout against the reference's
unsharded step.

Two gloo worlds (``launch.mesh.run_world``, rank bodies in
``tests/_zero_train.py``): a (data 2, model 2) world trains reduced qwen3
(float32) for 3 steps under its recommended options (vocab-only, ZeRO-3
over ("data", "model")) and under full TP with ZeRO-3 over "data"
(``fsdp_override``), each at 1 and 2 microbatches; a (data 2, model 1)
world trains qwen3 as pure ZeRO-3 (moonshot under moe-only:
tests/test_torch_zero_train_moe.py).  Each is held to the reference's
jitted one-device ``make_train_step`` on the whole batches: each step's
loss at rtol 1e-5, the gathered parameters within 1e-4, and
Adam's moments within 1e-4 / 2e-4 of each leaf's largest entry
(tests/_train_parity.py's bars).  The 4-rank world also takes one remat
step with ``remat_offload`` and without (equal bit for bit; the host
holds one carry a unit and microbatch and nothing else), and writes a
checkpoint from ZeRO-3 slices, which must be the whole initial tree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _model_axis_train as mt
import _zero_train as zt
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import ffn as r_ffn
from repro.models import steps as r_steps
from repro.models import transformer as r_tf
from repro_torch import _tree
from repro_torch.launch import mesh as pmesh
from repro_torch.models import transformer as p_tf
from repro_torch.runtime.checkpoint import CheckpointManager

STEPS = 3
ARCHS = {"g": "qwen3-0.6b", "m": "moonshot-v1-16b-a3b"}
WIDE = [("g", "rec", 1, STEPS), ("g", "rec", 2, STEPS),
        ("g", "zero_full", 1, STEPS), ("g", "zero_full", 2, STEPS)]
PURE = [("g", "rec", 2, STEPS)]


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


def _ref_cfg(name):
    cfg = r_reduced(r_get_config(ARCHS[name]))
    if name == "m":
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(-(-cfg.n_experts // cfg.top_k)))
    return cfg


def _start(name):
    params = r_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(name))
    return params, jax.tree.map(np.asarray, params)


def _reference(name, microbatches):
    cfg = _ref_cfg(name)
    params = _start(name)[0]
    init, step = r_steps.make_train_step(cfg, lr=1e-3,
                                         microbatches=microbatches)
    step = jax.jit(step)
    opt, losses, start = init(params), [], params
    with zt.moe_group(r_ffn, name):
        for i in range(STEPS):
            batch = {k: v.numpy().astype(np.int32)
                     for k, v in zt.batch(name, i).items()}
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return as_np(start), {"params": as_np(params), "mu": as_np(opt.mu),
                          "nu": as_np(opt.nu), "losses": losses}


def run_worlds(tmp_path_factory, wide_cases, pure_cases, extras):
    """The (data 2, model 2) world on ``wide_cases`` (with the offload,
    checkpoint and ledger cases where ``extras``) and the (data 2, model
    1) world on ``pure_cases``, run while this process runs the
    reference."""
    from concurrent.futures import ThreadPoolExecutor
    names = {c[0] for c in wide_cases + pure_cases}
    refs = {name: _start(name)[1] for name in names}
    ckpt = str(tmp_path_factory.mktemp("zero_ckpt")) if extras else None
    with ThreadPoolExecutor(2) as pool:
        wide = pool.submit(pmesh.run_world, zt.zero_world, 4,
                           args=(wide_cases, refs, ckpt), deadline_s=300)
        pure = pool.submit(pmesh.run_world, zt.zero_world, 2,
                           args=(pure_cases, refs, None),
                           deadline_s=300) if pure_cases else None
        want = {}
        for name, _, mb, _ in wide_cases + pure_cases:
            if (name, mb) not in want:
                want[(name, mb)] = _reference(name, mb)[1]
        return {"want": want, "wide": wide.result(),
                "pure": pure and pure.result(), "ckpt": ckpt}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_worlds(tmp_path_factory, WIDE, PURE, True)


def _port(name, tree):
    cfg = zt.STACKS[name]()
    return [t.numpy() for t in _tree.leaves(
        p_tf.params_from_reference(tree, cfg, "cpu"))]


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _hold(got, want, name, label):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               err_msg=label)
    for part, tol, rel in (("params", 1e-4, False), ("mu", 1e-4, True),
                           ("nu", 2e-4, True)):
        g_leaves, w_leaves = _flat(got[part]), _port(name, want[part])
        assert len(g_leaves) == len(w_leaves)
        for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
            bound = tol * (max(float(np.abs(w).max()), 1e-30) if rel
                           else 1.0)
            err = float(np.abs(g - w).max())
            assert err <= bound, f"{label} {part} leaf {i}: {err:.3e}"


def hold_case(world, case):
    """Every rank of the 4-rank world against the reference, on ``case``."""
    name, layout, mb, _ = case
    split = {"rec": ("vocab",), "zero_full": ("attn", "ffn", "vocab"),
             "moe": ("moe", "vocab")}[layout]
    for r, out in enumerate(world["wide"]):
        got = out[(name, layout, mb)]
        assert got["split"] == split, (r, got["split"])
        assert got["zero"] > 0, r
        _hold(got, world["want"][(name, mb)], name, f"rank {r} {case}")


@pytest.mark.parametrize("case", WIDE, ids=lambda c: f"{c[0]}-{c[1]}-mb{c[2]}")
def test_zero_training_equals_the_reference_step(world, case):
    hold_case(world, case)


def test_pure_zero_world_equals_the_reference_step(world):
    for r, out in enumerate(world["pure"]):
        got = out[("g", "rec", 2)]
        assert got["split"] == () and got["zero"] > 0, r
        _hold(got, world["want"][("g", 2)], "g", f"rank {r} (data 2, model 1)")


def test_remat_offload_equals_no_offload_bit_for_bit(world):
    for r, out in enumerate(world["wide"]):
        off = out["offload"]
        for part in ("params", "mu", "nu"):
            for a, b in zip(_flat(off[False][part]), _flat(off[True][part])):
                np.testing.assert_array_equal(a, b, err_msg=f"{r} {part}")
        # one carry a unit and microbatch: (rows, S, d_model), nothing else
        cfg = zt.STACKS["g"]()
        assert off["moved"] == [(mt.B // 2 // 2, mt.S, cfg.d_model)] * (
            2 * off["units"]), (r, off["moved"])


def test_checkpoint_from_zero_slices_is_the_whole_tree(world):
    from repro_torch.models.steps import make_train_step
    cfg = zt.STACKS["g"]()
    params = p_tf.init_params(mt.SEED, cfg, "cpu")
    opt = make_train_step(cfg)[0](params)
    assert all(out["checkpoint"]["zero"] > 0 for out in world["wide"])
    (got, got_opt), manifest = CheckpointManager(world["ckpt"]).restore(
        (params, opt))
    assert manifest["step"] == 3
    got, want = _tree.leaves([got, got_opt]), _tree.leaves([params, opt])
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
