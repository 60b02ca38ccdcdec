"""The MoE over the data axes against the reference's unsharded step.

Reduced moonshot-v1-16b-a3b (1 layer, 16 experts, top-6, a shared
expert) at its capacity factor 1.25 and at the no-drop one, with the
natural dispatch group (``ffn.MOE_GROUP`` = 1,024): a microbatch of
1,280 tokens puts 640 on each data rank, so group 0 straddles the ranks
and group 1 holds 256 tokens and 768 zero pads, on the last rank.

Two gloo worlds (``launch.mesh.run_world``, rank bodies in
``tests/_moe_data_axis.py``) take one step of
``launch.train.make_mesh_train_step`` from the reference's parameters: a
(data 2) world under the baseline layout at 1 and 2 microbatches (F2),
and a (data 2, model 2) world under the baseline layout,
``moe_dp_groups=False`` alone, ``expert_shard_dff`` (full TP at the
no-drop factor, and llama4's "moe-only") and ``expert_mesh="data"``.
Each is held to the reference's jitted one-device ``make_train_step`` on
the same batch: every MoE call's kept
(token, expert) set exactly (the reference's dispatch tensor read through
an ordered debug callback in its one dispatch einsum, the port's through
``ffn.route``), then loss, ce and aux at rtol 1e-5, the gathered
parameters after the Adam step within 1e-4, and Adam's moments (its
first the clipped gradient times 0.1) within 1e-4 / 2e-4 of each leaf's
largest entry (tests/test_torch_zero_train.py's bars).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _moe_data_axis as md
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import steps as r_steps
from repro.models import transformer as r_tf
from repro_torch import _tree
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding
from repro_torch.models import ffn
from repro_torch.models import transformer as p_tf

CF = md.CAPACITY
DATA = [("base", CF, 1), ("base", CF, 2)]
WIDE = [("base", CF, 1), ("gather", CF, 1), ("dff", md.NO_DROP, 1),
        ("moe-dff", CF, 1), ("edata", CF, 1)]


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


def _ref_cfg(capacity):
    cfg = r_reduced(r_get_config("moonshot-v1-16b-a3b"), n_experts=md.EXPERTS,
                    n_layers=1)
    return dataclasses.replace(cfg, capacity_factor=capacity)


def _reference(params, capacity, microbatches):
    """The reference's jitted one-device step: its metrics, parameters,
    moments, and each MoE call's kept (token, expert) mask in order
    (microbatch by microbatch, layer by layer)."""
    cfg = _ref_cfg(capacity)
    kept = []
    einsum = jnp.einsum

    def spy(spec, *operands, **kw):
        if spec == "gsec,gsd->egcd":
            jax.debug.callback(
                lambda d: kept.append((np.asarray(d).sum(-1) > 0)
                                      .reshape(-1, d.shape[2])),
                operands[0], ordered=True)
        return einsum(spec, *operands, **kw)

    init, step = r_steps.make_train_step(cfg, lr=1e-3,
                                         microbatches=microbatches)
    data = {k: v.numpy().astype(np.int32)
            for k, v in md.batch(microbatches).items()}
    jnp.einsum = spy
    try:
        new, opt, metrics = jax.jit(step)(params, init(params), data)
        jax.block_until_ready(new)
    finally:
        jnp.einsum = einsum
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return {"params": as_np(new), "mu": as_np(opt.mu), "nu": as_np(opt.nu),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "kept": kept}


@pytest.fixture(scope="module")
def worlds():
    """Both worlds, run while this process runs the reference."""
    from concurrent.futures import ThreadPoolExecutor
    params = r_tf.init_params(jax.random.PRNGKey(0), _ref_cfg(CF))
    start = jax.tree.map(np.asarray, params)
    with ThreadPoolExecutor(2) as pool:
        data = pool.submit(pmesh.run_world, md.world, 2,
                           args=(DATA, start), deadline_s=300)
        wide = pool.submit(pmesh.run_world, md.world, 4,
                           args=(WIDE, start), deadline_s=300)
        want = {(cf, mb): _reference(params, cf, mb)
                for cf, mb in sorted({c[1:] for c in DATA + WIDE})}
        return {"want": want, "data": data.result(), "wide": wide.result()}


def _port(tree):
    cfg = md.config(CF)
    return [t.numpy() for t in _tree.leaves(
        p_tf.params_from_reference(tree, cfg, "cpu"))]


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def _kept(ranks, case) -> list:
    """Each MoE call's kept mask over the whole stream, joined from the
    data ranks' shares (every model rank routes the same tokens)."""
    calls = None
    for out in ranks:
        got = out[case]["kept"]
        calls = calls or [dict() for _ in got]
        assert len(got) == len(calls)
        for call, (start, mask) in zip(calls, got):
            if start in call:
                np.testing.assert_array_equal(call[start], mask)
            call[start] = mask
    return [np.concatenate([c[k] for k in sorted(c)]) for c in calls]


def _hold(ranks, want, case):
    for got, ref in zip(_kept(ranks, case), want["kept"]):
        assert got.shape == ref.shape, case
        np.testing.assert_array_equal(got, ref, err_msg=str(case))
    for r, out in enumerate(ranks):
        got = out[case]
        label = f"rank {r} {case}"
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-5, err_msg=f"{label} {k}")
        for part, tol, rel in (("params", 1e-4, False), ("mu", 1e-4, True),
                               ("nu", 2e-4, True)):
            g_leaves, w_leaves = _flat(got[part]), _port(want[part])
            assert len(g_leaves) == len(w_leaves)
            for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
                bound = tol * (max(float(np.abs(w).max()), 1e-30) if rel
                               else 1.0)
                err = float(np.abs(g - w).max())
                assert err <= bound, f"{label} {part} leaf {i}: {err:.3e}"


def test_the_cases_exercise_straddling_padded_and_dropping_groups():
    """A data rank's 640 tokens of a microbatch: group 0 straddles, the
    last rank holds group 1's pad; at 1.25 the reference drops tokens
    (fewer kept pairs than 6 a routed position)."""
    st0, st1 = (ffn.stream(md.ROWS * md.S // 2, r, 2) for r in (0, 1))
    assert (st0.gsize, st0.groups, st0.pad) == (1024, 2, 768)
    assert (st0.first, st0.lead, st0.local) == (0, 0, 2)
    assert (st1.first, st1.lead, st1.held) == (0, 640, 640 + 768)
    assert ffn.moe_capacity(md.config(CF), 1024) == 480
    assert ffn.moe_capacity(md.config(md.NO_DROP), 1024) == 1024


def _case_id(c) -> str:
    return f"{c[0]}-cf{c[1]}-mb{c[2]}"


@pytest.mark.parametrize("case", DATA, ids=_case_id)
def test_data_axis_step_equals_the_reference_step(worlds, case):
    """F2: the baseline layout on (data 2), the reference's groups."""
    want = worlds["want"][case[1:]]
    if case[1] == CF:
        assert sum(int(m.sum()) for m in want["kept"]) < sum(
            6 * m.shape[0] for m in want["kept"])
    _hold(worlds["data"], want, case)


@pytest.mark.parametrize("case", WIDE, ids=_case_id)
def test_moe_knobs_step_equals_the_reference_step(worlds, case):
    _hold(worlds["wide"], worlds["want"][case[1:]], case)


VIEWS = {"base": ("model", ""), "gather": ("model", ""),
         "dff": ("model", "dff"), "moe-dff": ("model", "dff"),
         "edata": ("data", "experts")}


@pytest.mark.parametrize("layout", sorted(VIEWS))
def test_rank_views_hold_their_slices(worlds, layout):
    """Each rank's view names its experts and F columns: 8 of 16 experts
    (over "model", or over "data" under expert_mesh="data"), and F (32)
    whole, halved over "data" (dff) or over "model" (edata)."""
    case = next(c for c in WIDE if c[0] == layout)
    axis, how = VIEWS[layout]
    f = md.config(case[1]).resolved_moe_dff
    for out in worlds["wide"]:
        d, m = out["coords"]
        view = out[case]["view"]
        assert (view["expert_mesh"], view["moe_data"]) == (axis, how)
        assert "moe" in view["split"]
        assert view["local_experts"] == md.EXPERTS // 2
        at = d if axis == "data" else m
        assert view["expert_offset"] == at * md.EXPERTS // 2
        cols = {"dff": (f // 2, d * f // 2), "experts": (f // 2, m * f // 2),
                "": (f, 0)}[how]
        assert (view["local_dff"], view["dff_offset"]) == cols


def test_microbatch_order_gives_each_rank_its_part_of_each():
    """Rank i's block of the reordered batch holds rows [m b + i b/n,
    m b + (i+1) b/n) for each microbatch m in turn."""
    from repro_torch.launch.train import reference_microbatches
    rows = torch.arange(16)
    got = reference_microbatches({"t": rows}, 2, 4)["t"]
    assert got.tolist() == [0, 1, 4, 5, 8, 9, 12, 13,
                            2, 3, 6, 7, 10, 11, 14, 15]
    assert reference_microbatches({"t": rows}, 2, 1)["t"] is rows
    odd = {"t": torch.arange(12)}
    assert reference_microbatches(odd, 2, 4) is odd   # the checks refuse it


def test_gathered_expert_slices_keep_no_zero_storage():
    """expert_shard_dff and expert_mesh="data" on a ZeRO-3 config
    (llama4, ``cfg.fsdp``): the expert leaves are compute splits over
    "data", not storage slices, and the rank holds the policy's
    per-device share of each."""
    from repro_torch.configs import base as p_base
    from repro_torch.launch import dryrun, specs
    cfg = p_base.get_config("llama4-maverick-400b-a17b")
    mesh = dryrun._RankMesh(("data", "model"), (16, 16), {})
    for opts, how in ((sharding.recommended_options(cfg, "train"), "dff"),
                      (sharding.ShardingOptions(expert_mesh="data"),
                       "experts")):
        placed, view = sharding.place_params(mesh, cfg,
                                             specs.params_specs(cfg), opts)
        assert view.moe_data == how
        assert not [p for p, _, _ in view.zero if "/moe/w" in p]
        # E over one axis, F over the other: 128 / 16 experts, 8,192 / 16
        wi = placed["units"]["slot1"]["moe"]["wi"]
        assert tuple(wi.shape) == (24, 8, cfg.d_model, 512), how
