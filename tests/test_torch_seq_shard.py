"""Sequence parallelism over "model" (``ShardingOptions(seq_shard=True)``)
against the reference's unsharded train step.

Three gloo worlds (``launch.mesh.run_world``, rank bodies in
``tests/_seq_shard.py``) start from the reference's parameters:

* a 2-rank (model 2) and a 4-rank (data 2, model 2) world take the
  gradient of the loss over the logical batch under ``seq_shard`` for
  reduced qwen3 (g), gemma3 ((l, g) and an "l" tail), the g/r/s hybrid
  and moonshot (m, at the no-drop capacity), at a length the model axis
  divides (the residual stream is then each rank's block of the
  sequence) and at one it does not (the plain tensor-parallel path, the
  reference's rule); and reduced qwen3 under "vocab-only" with ZeRO-3
  (every layer whole on each model rank, so every leaf's gradient is the
  rank's rows' and is summed over "model").  Each is held to
  ``jax.value_and_grad`` of the reference's ``loss_fn`` on the whole
  batch: the loss at rtol 1e-5, every gradient leaf within 1e-5 of the
  leaf's largest entry, the norm scales (which run on the rank's block)
  named one by one;
* a 4-rank (data 2, model 2) world takes one ``make_mesh_train_step``
  step under each layout, held to the reference's jitted
  ``make_train_step`` (tests/test_torch_model_axis_step.py's bars), and
  two steps of ``launch.train.main(mesh=)`` on qwen3's recommended
  options with and without ``seq_shard``, whose losses agree.
"""
import jax
import numpy as np
import pytest
import torch.distributed as dist

import _seq_shard as sq
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import steps as r_steps
from repro.models import transformer as r_tf
from repro_torch import _tree
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding
from repro_torch.models import transformer as p_tf

import _model_axis as ma

GRAD_TOL, LOSS_RTOL = 1e-5, 1e-5
NORMS = ("norm1", "norm2", "final_norm", "ssm/norm")
LAUNCH_ARGV = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
               "--batch", "4", "--seq", "16", "--steps", "2"]
R_STACKS = {
    "g": lambda: r_reduced(r_get_config("qwen3-0.6b")),
    "lg": lambda: r_reduced(r_get_config("gemma3-1b"),
                            block_pattern=("l", "g"), tail_pattern=("l",),
                            n_layers=5),
    "grs": lambda: ma.hybrid_grs(r_get_config, r_reduced),
    "m": lambda: ma.moonshot_no_drop(r_get_config, r_reduced),
}


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


def _reference_grad(name, params, s):
    cfg = R_STACKS[name]()
    data = {k: v.numpy().astype(np.int32)
            for k, v in sq.batch(sq.STACKS[name](), s).items()}
    (loss, (ce, aux)), grads = jax.jit(
        jax.value_and_grad(r_steps.loss_fn, has_aux=True),
        static_argnums=1)(params, cfg, data)
    port = p_tf.params_from_reference(jax.tree.map(np.asarray, grads),
                                      sq.STACKS[name](), "cpu")
    return {"loss": [float(loss), float(ce), float(aux)],
            "grads": sq.named(port)}


def _reference_step(params):
    cfg = R_STACKS["g"]()
    init, step = r_steps.make_train_step(cfg, lr=1e-3)
    data = {k: v.numpy().astype(np.int32)
            for k, v in sq.batch(sq.STACKS["g"]()).items()}
    new, opt, metrics = jax.jit(step)(params, init(params), data)
    as_port = lambda t: [x.numpy() for x in _tree.leaves(
        p_tf.params_from_reference(jax.tree.map(np.asarray, t),
                                   sq.STACKS["g"](), "cpu"))]
    return {"params": as_port(new), "mu": as_port(opt.mu),
            "nu": as_port(opt.nu), "loss": float(metrics["loss"])}


@pytest.fixture(scope="module")
def worlds():
    """The three worlds, run while this process runs the reference."""
    from concurrent.futures import ThreadPoolExecutor
    params = {name: r_tf.init_params(jax.random.PRNGKey(0), make())
              for name, make in R_STACKS.items()}
    start = {name: jax.tree.map(np.asarray, p) for name, p in params.items()}
    with ThreadPoolExecutor(3) as pool:
        two = pool.submit(pmesh.run_world, sq.grad_world, 2,
                          args=(sq.GRAD_CASES, 2, start), deadline_s=300)
        four = pool.submit(pmesh.run_world, sq.grad_world, 4,
                           args=(sq.GRAD_CASES, 2, start), deadline_s=300)
        step = pool.submit(pmesh.run_world, sq.step_world, 4,
                           args=(start["g"], LAUNCH_ARGV), deadline_s=300)
        want = {(name, s): _reference_grad(name, params[name], s)
                for name, s, _ in sq.GRAD_CASES}
        want["step"] = _reference_step(params["g"])
        return {"want": want, 2: two.result(), 4: four.result(),
                "step": step.result()}


def _case_id(case) -> str:
    return "-".join(map(str, case))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case", sq.GRAD_CASES, ids=_case_id)
def test_seq_shard_gradient_equals_the_reference(worlds, case, ranks):
    name, s, layout = case
    want = worlds["want"][(name, s)]
    for r, out in enumerate(worlds[ranks]):
        got = out[case]
        label = f"{ranks} ranks, rank {r}, {case}"
        # the length 2 divides runs on the rank's block, the odd one not
        assert got["seq"] == (s % 2 == 0), label
        assert ("reduce-scatter" in got["kinds"]) == got["seq"], label
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=label)
        assert set(got["grads"]) == set(want["grads"]), label
        for path, w in want["grads"].items():
            g = got["grads"][path]
            bound = GRAD_TOL * max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(g - w).max())
            assert err <= bound, f"{label} {path}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("name", sorted(sq.STACKS))
def test_norm_scales_summed_over_the_blocks(worlds, name, ranks):
    """The norm scales run on the rank's block of the sequence, so each
    rank's gradient is its rows' part: summed over "model" they are the
    reference's, leaf by leaf (held by name)."""
    want = worlds["want"][(name, sq.S)]["grads"]
    norms = [p for p in want if p.endswith(NORMS)]
    assert norms and any(p.endswith("norm1") for p in norms)
    for out in worlds[ranks]:
        got = out[(name, sq.S, "full")]["grads"]
        for path in norms:
            w = want[path]
            err = float(np.abs(got[path] - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (path, err)


def test_vocab_only_keeps_every_layer_whole(worlds):
    for ranks in (2, 4):
        for out in worlds[ranks]:
            assert out[("g", sq.S, "vocab-only")]["split"] == ("vocab",)
            assert "attn" in out[("g", sq.S, "full")]["split"]


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("layout", sorted(sq.LAYOUTS))
def test_mesh_step_equals_the_reference_step(worlds, layout):
    want = worlds["want"]["step"]
    for r, out in enumerate(worlds["step"]):
        got = out[layout]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
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


def test_launch_train_takes_seq_shard_on_a_mesh(worlds):
    """``launch.train.main(mesh=)`` on the recommended options ("vocab-
    only", ZeRO-3, 2 microbatches) with ``seq_shard``: the same losses
    as without it."""
    for out in worlds["step"]:
        plain, seq = out[("launch", "plain")], out[("launch", "seq")]
        assert len(seq) == 2
        np.testing.assert_allclose(seq, plain, rtol=1e-5)
