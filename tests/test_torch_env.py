"""Port parity: environment setup and one slot, device rules and imports.

``make_params`` / ``stack_params`` are held against the reference for every
registered scenario (the tables come from the same numpy profiles, so they
must agree exactly); a single-cell ``step_p`` from the reference's state
with the reference's next draws must give the reference's slot.
Tolerance for the slot: rtol 1e-4, except for the quantities that follow
the P3 and P5 minimizers (f_ue, alpha and the delays and energy built on
them), which are only defined to ALLOC_RTOL -- see tests/test_torch_convex.py
and tests/test_torch_grid.py.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as r_env
from repro.core import scenarios as r_sc
from repro.core.lyapunov import VirtualQueues as RQueues
from repro_torch import _tree, quickstart
from repro_torch.core import env as p_env
from repro_torch.core import networks as p_net
from repro_torch.core import policies as p_pol
from repro_torch.core import ppo as p_ppo
from repro_torch.core import scenarios as p_sc
from repro_torch.core import sweep as p_sweep
from repro_torch.kernels import ref as p_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-4
ALLOC_RTOL = 1e-2
# slot fields held at RTOL; the rest follow the P3/P5 minimizers
EXACT_FIELDS = ("reward", "t_es", "mem_cost", "cut", "f_es", "q_energy",
                "q_memory")
ALLOC_FIELDS = ("f_ue", "alpha", "t_ue", "t_tx", "delay", "energy")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def ref_param_leaves(p):
    """The reference MecParams as the port's ``params_from_numpy`` inputs."""
    leaves = {f.name: np.asarray(getattr(p, f.name))
              for f in dataclasses.fields(p_env.MecParams)
              if f.name not in ("arrival", "edge_queueing")}
    arr = p.arrival
    arr_leaves = {f.name: np.asarray(getattr(arr, f.name))
                  for f in dataclasses.fields(arr)}
    return leaves, type(arr).kind, arr_leaves


def assert_params_equal(port, ref):
    leaves, kind, arr_leaves = ref_param_leaves(ref)
    for name, want in leaves.items():
        got = _np(getattr(port, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=name)
    assert port.arrival.kind == kind
    for name, want in arr_leaves.items():
        np.testing.assert_array_equal(
            _np(getattr(port.arrival, name)).astype(want.dtype), want,
            err_msg=f"arrival.{name}")
    assert port.edge_queueing == ref.edge_queueing
    assert port.L.dtype == torch.int64 and port.macs.dtype == torch.float32


@pytest.mark.parametrize("name", r_sc.names())
def test_make_params_matches_reference_for_every_scenario(name):
    assert p_sc.names() == r_sc.names()
    port = p_sc.make(name)
    ref = r_sc.make(name)
    assert port.name == ref.name and port.n_ue == ref.n_ue
    # the sweep kernel's row of constants is the reference's, in float32
    np.testing.assert_array_equal(
        _np(p_sweep.scalar_rows_p(port.params(device="cpu"))),
        np.asarray([ref.sweep_scalars()[k] for k in p_ref.SCALAR_NAMES],
                   np.float32))
    assert_params_equal(port.params(device="cpu"), ref.params())
    # the carry-across function rebuilds the same params from numpy
    leaves, kind, arr_leaves = ref_param_leaves(ref.params())
    again = p_env.params_from_numpy(leaves, kind, arr_leaves,
                                    ref.params().edge_queueing, device="cpu")
    assert_params_equal(again, ref.params())


def test_stack_params_pads_cuts_like_reference():
    """AlexNet-only (C = 9) and ResNet-only (C = 11) cells stack to C = 11:
    per-cut tables edge-padded, raw per-layer tables zero-padded."""
    specs = [("fixed_rate", dict(rate=1.0, n_alexnet=4, n_resnet=0)),
             ("fixed_rate", dict(rate=2.0, n_alexnet=0, n_resnet=4)),
             ("fixed_rate", dict(rate=1.5, n_alexnet=2, n_resnet=2))]
    ref = r_sc.stack_params([r_sc.make(n, **k).params() for n, k in specs])
    port = p_sc.stack_params([p_sc.make(n, **k).params(device="cpu")
                              for n, k in specs])
    assert_params_equal(port, ref)
    assert port.macs.shape == (3, 4, 11)
    assert (port.macs[0, :, 9:] == 0).all()
    assert (port.prefix_macs[0, :, 9:] == port.prefix_macs[0, :, 8:9]).all()
    with pytest.raises(ValueError, match="UE count"):
        p_sc.stack_params([p_sc.make("fixed_rate").params(device="cpu"),
                           p_sc.make("hetero_fleet").params(device="cpu")])
    with pytest.raises(ValueError, match="arrival-process type"):
        p_sc.stack_params([p_sc.make("fixed_rate").params(device="cpu"),
                           p_sc.make("diurnal").params(device="cpu")])


def test_multicell_grid_params_match_reference():
    ref = r_sc.ScenarioGrid(r_sc.multicell_grid(4, 6, seed=3))
    port = p_sc.ScenarioGrid(p_sc.multicell_grid(4, 6, seed=3), device="cpu")
    assert_params_equal(port.params, ref.params)
    # one row of sweep constants per cell: here the reference's shared ones
    want = np.asarray([ref.sweep_scalars[k] for k in p_ref.SCALAR_NAMES],
                      np.float32)
    np.testing.assert_array_equal(_np(port.sweep_scalars),
                                  np.broadcast_to(want, (4, 11)))
    # cells with their own V share the grid's one sweep; each cell's table
    # equals the reference's per-cell (vmapped lax) table
    r_mixed = r_sc.ScenarioGrid(r_sc.multicell_grid(3, 4, uniform_scalars=False))
    mixed = p_sc.ScenarioGrid(
        p_sc.multicell_grid(3, 4, uniform_scalars=False), device="cpu")
    assert r_mixed.sweep_scalars is None
    v = _np(mixed.sweep_scalars)[:, p_ref.SCALAR_NAMES.index("v")]
    assert len(set(v.tolist())) == 3
    rst = r_mixed.reset(jax.random.PRNGKey(0))
    rst = rst._replace(queues=RQueues(rst.queues.energy + 30.0,
                                      rst.queues.memory + 2.0))
    want = np.asarray(r_mixed.objective_tables(rst, backend="lax"))
    got = _np(mixed.objective_tables(_port_state(rst)))
    feasible = want < 1e29
    np.testing.assert_allclose(got[feasible], want[feasible], rtol=1e-4,
                               atol=1e-3)
    assert ((got > 1e29) == ~feasible).all()
    srt = np.sort(want, -1)
    clear = srt[..., 1] - srt[..., 0] > 1e-3 + 1e-4 * np.abs(srt[..., 0])
    cuts = _np(mixed.oracle_cuts(_port_state(rst)))
    np.testing.assert_array_equal(cuts[clear], np.argmin(want, -1)[clear])


def _ref_state_with_queues(env, seed=3):
    st = env.reset(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    n = env.n_ue
    q = RQueues(jnp.asarray(rng.uniform(0, 20, n), jnp.float32),
                jnp.asarray(rng.uniform(0, 5, n), jnp.float32))
    return st._replace(queues=q)


def _port_state(st):
    return p_env.state_from_numpy(st.t, st.gain, st.lam, st.queues.energy,
                                  st.queues.memory, device="cpu")


def assert_slot_close(got, want, fields=EXACT_FIELDS + ALLOC_FIELDS):
    for name in fields:
        g, w = _np(getattr(got, name)), np.asarray(getattr(want, name))
        rtol = ALLOC_RTOL if name in ALLOC_FIELDS else RTOL
        atol = 1e-6 * float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("cut", [[0, 0, 0, 0, 0], [8, 8, 10, 10, 10],
                                 [3, 7, 2, 5, 9], [99, -3, 4, 1, 6]])
def test_single_cell_step_matches_reference(cut):
    ref_env = r_env.paper_env()
    port_env = p_env.paper_env(device="cpu")
    st = _ref_state_with_queues(ref_env)
    ref_next, ref_res = ref_env.step(st, jnp.asarray(cut, jnp.int32))
    port_next, port_res = port_env.step(
        _port_state(st), torch.tensor(cut),
        draws=(np.asarray(ref_next.gain), np.asarray(ref_next.lam)))
    assert_slot_close(port_res, ref_res)
    np.testing.assert_allclose(_np(port_next.queues.memory),
                               np.asarray(ref_next.queues.memory), rtol=RTOL)
    np.testing.assert_allclose(
        _np(port_next.queues.energy), np.asarray(ref_next.queues.energy),
        rtol=ALLOC_RTOL,
        atol=100.0 * ALLOC_RTOL * float(np.max(np.asarray(ref_res.energy))))
    assert int(port_next.t) == int(ref_next.t) == 1
    np.testing.assert_array_equal(_np(port_next.gain), np.asarray(ref_next.gain))
    np.testing.assert_allclose(
        _np(p_env.observe_p(port_env.params, _port_state(ref_next))),
        np.asarray(ref_env.observe(ref_next)), rtol=1e-6)


def test_single_cell_step_with_edge_queueing_matches_reference():
    """The G/D/1-corrected edge sojourn (``edge_queueing=True``)."""
    ref_env = r_env.paper_env(r_env.MecConfig(edge_queueing=True))
    port_env = p_env.paper_env(p_env.MecConfig(edge_queueing=True),
                               device="cpu")
    st = _ref_state_with_queues(ref_env, seed=4)
    cut = [3, 7, 2, 5, 9]
    ref_next, ref_res = ref_env.step(st, jnp.asarray(cut, jnp.int32))
    _, port_res = port_env.step(
        _port_state(st), torch.tensor(cut),
        draws=(np.asarray(ref_next.gain), np.asarray(ref_next.lam)))
    assert_slot_close(port_res, ref_res)
    assert (_np(port_res.t_es) > 0).any()


def test_projection_and_joint_step_match_reference():
    ref_env = r_env.paper_env()
    port_env = p_env.paper_env(device="cpu")
    st = _ref_state_with_queues(ref_env, seed=5)
    # push rates up so C7 binds for the deep cuts
    st = st._replace(lam=st.lam * 6.0)
    pst = _port_state(st)
    np.testing.assert_array_equal(_np(port_env.max_feasible_cut(pst.lam)),
                                  np.asarray(ref_env.max_feasible_cut(st.lam)))
    cut = [10, 10, 10, 10, 10]
    np.testing.assert_array_equal(
        _np(port_env.project_cut(torch.tensor(cut), pst.lam)),
        np.asarray(ref_env.project_cut(jnp.asarray(cut), st.lam)))
    alpha, f_ue, f_es = [0.1, 0.3, 0.2, 0.2, 0.2], [1e9] * 5, [3e9] * 5
    ref_next, ref_res = ref_env.step_joint(st, jnp.asarray(cut), *(
        jnp.asarray(x, jnp.float32) for x in (alpha, f_ue, f_es)))
    _, port_res = port_env.step_joint(
        pst, torch.tensor(cut), *(torch.tensor(x) for x in (alpha, f_ue, f_es)),
        draws=(np.asarray(ref_next.gain), np.asarray(ref_next.lam)))
    for name in EXACT_FIELDS + ALLOC_FIELDS:
        np.testing.assert_allclose(_np(getattr(port_res, name)),
                                   np.asarray(getattr(ref_res, name)),
                                   rtol=RTOL, atol=1e-9, err_msg=name)


def test_oracle_table_single_cell_matches_reference():
    from repro.core import sweep as r_sweep
    ref_env = r_env.paper_env()
    port_env = p_env.paper_env(device="cpu")
    st = _ref_state_with_queues(ref_env, seed=9)
    want = np.asarray(r_sweep.env_objective_table(ref_env, st))
    got = _np(p_sweep.env_objective_table(port_env, _port_state(st)))
    feasible = want < 1e29
    np.testing.assert_allclose(got[feasible], want[feasible], rtol=1e-4, atol=1e-3)
    assert ((got > 1e29) == ~feasible).all()
    np.testing.assert_array_equal(_np(p_sweep.oracle_cut(port_env, _port_state(st))),
                                  np.asarray(r_sweep.oracle_cut(ref_env, st)))


def test_env_object_api_and_generators():
    env = p_env.paper_env(device="cpu")
    st = env.reset(env.generator(0))
    assert st.gain.shape == (5,) and (st.gain > 0).all()
    assert env.obs_dim == 20 and env.observe(st).shape == (20,)
    again = env.reset(env.generator(0))
    assert torch.equal(st.gain, again.gain) and torch.equal(st.lam, again.lam)
    st2, res = env.step(st, env.L)
    assert int(st2.t) == 1 and torch.isfinite(res.delay).all()
    fixed = p_env.paper_env(p_env.MecConfig(lam_mode=p_env.LAM_FIXED),
                            device="cpu")
    assert torch.equal(fixed.lam_fixed, torch.full((5,), 2.5))
    fixed.lam_fixed = [1.0] * 5
    assert torch.equal(fixed.reset(fixed.generator(1)).lam, torch.ones(5))
    with pytest.raises(AttributeError):
        env.lam_fixed
    with pytest.raises(ValueError, match="Generator"):
        env.reset()
    with pytest.raises(ValueError, match="LAM_TRACE"):
        p_env.paper_env(p_env.MecConfig(lam_mode=p_env.LAM_TRACE), device="cpu")


def test_tree_helpers_stack_and_index():
    cells = [p_sc.make("diurnal").params(device="cpu") for _ in range(2)]
    stacked = _tree.stack(cells)
    assert stacked.macs.shape == (2, 5, 11) and stacked.arrival.period.shape == (2,)
    one = _tree.index(stacked, 1)
    assert torch.equal(one.psi, cells[1].psi) and one.edge_queueing is False


# ---------------------------------------------------------------------------
# Device rules and imports
# ---------------------------------------------------------------------------

def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA; with no CUDA it raises instead of quietly
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = p_sc.make("paper_table1")
    calls = [
        lambda: p_env.paper_env(),
        lambda: sc.params(),
        lambda: sc.build(),
        lambda: p_env.make_params(list(sc.profiles), sc.cfg,
                                  list(sc.e_budget), list(sc.c_budget)),
        lambda: p_env.MecEnv(list(sc.profiles), sc.cfg, list(sc.e_budget),
                             list(sc.c_budget)),
        lambda: p_sc.ScenarioGrid(p_sc.multicell_grid(2, 3)),
        lambda: p_sc.grid_from_names(["paper_table1"]),
        lambda: p_env.state_from_numpy(0, [1.0], [1.0], [0.0], [0.0]),
        lambda: quickstart.main([]),
        lambda: p_net.mlp_init(torch.Generator(), (4, 2)),
        lambda: p_ppo.train_state_from_reference(None, None),
        lambda: p_pol.CategoricalPolicy(8, [8] * 5),
        lambda: p_pol.GaussianTanhPolicy(8, np.full(5, 8)),
        lambda: p_pol.JointGaussianPolicy(8, [8] * 5, 1.5e9, 15e9),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert p_env.paper_env(device="cpu").device.type == "cpu"
    # a head takes the device it is given, else its layer-count tensor's
    assert p_pol.CategoricalPolicy(8, [8] * 5, device="cpu").device.type == "cpu"
    assert p_pol.GaussianTanhPolicy(8, torch.full((5,), 8)).device.type == "cpu"


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files, "no port sources found"
    return files + [ROOT / "chip_smoke.py"]


def test_import_guard_covers_the_serving_slice():
    """The guard below globs the whole package: the modules of the served
    LM path, the kernel sources' wrappers, the learning loop and LM
    training are among its files."""
    names = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
             for p in _port_sources()[:-1]}
    for mod in ("configs/base.py", "kernels/_build.py",
                "kernels/flash_attention.py", "kernels/decode_attention.py",
                "models/transformer.py", "models/attention.py",
                "serving/engine.py", "serving/kvpool.py",
                "serving/partitioned.py", "profiling/lmprofiles.py",
                "serve_partitioned.py", "kernels/ssd_scan.py",
                "kernels/rglru_scan.py", "models/ssm.py", "models/rglru.py",
                "launch/serve.py", "core/networks.py", "core/policies.py",
                "core/ppo.py", "optim/adam.py", "quickstart.py",
                "profiling/roofline.py", "data/pipeline.py",
                "models/steps.py", "runtime/resilience.py",
                "launch/train.py", "train_lm.py"):
        assert mod in names, mod


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {mod}")
    assert not bad, bad
