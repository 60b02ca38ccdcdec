"""The grid's per-cell model axis: ``ScenarioGrid.use_mesh(model=M)`` on a
``("cells", "model")`` mesh against the unsharded port, and the sweep's
split count against the whole cell's table.

A 2-rank world (model 2) and a 4-rank world ((cells 2, model 2), then
model 4 under the Oracle) are spawned once each (``launch.mesh.run_world``,
rank bodies in ``tests/_grid_model_axis.py``) and run every case; each test then holds
one case, on every rank, against the unsharded grid run here, bit for bit:
every registered scenario (at 4 UEs where it takes a fleet size, so the
axis splits it; paper_table1 and peak_window at 5, which replicate) under
the Oracle, Local and Edge on the reference's draws and under Random on
its own (each rank drawing the logical tensor and keeping its block), and
``eval_policy_batched``.

Against the reference's unsharded paths (its own sharded tests are not the
oracle here): every registered grid under the Oracle, Local and Edge runs
on the reference's channel and arrival draws, on every rank and both
meshes, and is held slot by slot to the reference's rollout on those
draws (cuts identical; tests/test_torch_grid.py's bars for the rest); a
rank's sweep rows with the split count N are held to the reference's
kernel (interpret mode) on the same rows with ``n_total=N`` and to its
columns of the reference's plain whole-cell table.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _grid_model_axis as gm
from repro.core import scenarios as r_sc
from repro.kernels import partition_sweep as r_ps
from repro.kernels import ref as r_ref
from repro_torch.core import scenarios as sc
from repro_torch.core import sweep
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as pmesh

WORLD_S = 300.0
# ranks: the ("model" size, policies) they run
WORLDS = {2: [(2, gm.POLICIES)], 4: [(2, gm.POLICIES), (4, ("oracle",))]}
CASES = [(r, m) for r, ms in WORLDS.items() for m, _ in ms]
POLICIES = {(r, m): pols for r, ms in WORLDS.items() for m, pols in ms}


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


# tests/test_torch_grid.py's bars, port against reference: rtol 1e-4 with
# an atol of 1e-6 x the field's max, and the P3/P5 minimizers' fields at
# the band their flat minima leave
RTOL = 1e-4
ALLOC_RTOL = {"f_ue": 1e-3, "t_ue": 1e-3, "energy": 2e-3, "delay": 2e-3,
              "t_tx": 1e-2, "alpha": 1e-2}
SLOT_FIELDS = ("reward", "t_es", "mem_cost", "f_es", "q_energy", "q_memory",
               *ALLOC_RTOL)
# the energy queue Q + nu_e (E - e) integrates energy's band, times nu_e
NU_E = 100.0
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-3


_plain: dict = {}        # the unsharded port's runs, made by ``both``


class Reference:
    """The reference's unsharded ``ScenarioGrid`` of ``gm.REGISTRY[key]``:
    ``run(policy)`` steps it ``gm.STEPS`` slots from its ``make_rollout``'s
    reset (``PRNGKey(0)``), keeping each slot's results and the channel
    and arrival draws it made (``draws``, (gains, lams), which depend on
    the keys alone)."""

    def __init__(self, key: str):
        self.grid = r_sc.ScenarioGrid([r_sc.make(key, **gm.REGISTRY[key])
                                       for _ in range(gm.B)])
        self._step = jax.jit(self.grid.step)
        self._tables = jax.jit(
            lambda st: self.grid.objective_tables(st, backend="lax"))
        self._k0 = jax.random.split(jax.random.PRNGKey(0))[1]
        self.results: dict = {}
        self.draws = None

    def run(self, policy: str) -> None:
        st = self.grid.reset(self._k0)
        gains, lams, slots = [st.gain], [st.lam], []
        for _ in range(gm.STEPS):
            if policy == "oracle":
                cuts = jnp.argmin(self._tables(st), -1).astype(jnp.int32)
            else:
                cuts = jax.vmap(r_sc.POLICIES[policy])(
                    self.grid.params, st, jax.random.split(self._k0, gm.B))
            st, res = self._step(st, cuts)
            slots.append(res)
            gains.append(st.gain)
            lams.append(st.lam)
        draws = (np.stack(gains), np.stack(lams))
        if self.draws is None:
            self.draws = draws
        for got, want in zip(draws, self.draws):
            np.testing.assert_array_equal(got, want)
        self.results[policy] = {
            f: np.stack([np.asarray(getattr(r, f)) for r in slots])
            for f in ("cut", *SLOT_FIELDS)}


@pytest.fixture(scope="module")
def both():
    """Both worlds at once (each rank one thread), on the reference's
    draws; the reference's rollouts under its other policies and the
    unsharded port's runs (``_plain``) run here meanwhile."""
    reference = {key: Reference(key) for key in gm.REGISTRY}
    first, *rest = gm.REFERENCE_POLICIES
    for r in reference.values():
        r.run(first)
    draws = {key: r.draws for key, r in reference.items()}
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {r: pool.submit(pmesh.run_world, gm.model_world, r,
                               args=(ms, draws), deadline_s=WORLD_S)
                for r, ms in WORLDS.items()}
        for r in reference.values():
            for policy in rest:
                r.run(policy)
        for key in gm.REGISTRY:
            for policy in gm.POLICIES:
                _plain[key, policy] = gm.rollout(
                    gm.registry_grid(key), policy,
                    draws=gm.on_draws(draws, key, policy))
        _plain["eval"] = gm.eval_ppo(gm.rate_grid())
        return {r: run.result() for r, run in runs.items()}, reference


@pytest.fixture(scope="module")
def worlds(both):
    return both[0]


def assert_equal_trees(got, want, where: str):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_equal_trees(got[k], want[k], f"{where}.{k}")
        return
    assert got.shape == want.shape, where
    np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("key", list(gm.REGISTRY))
@pytest.mark.parametrize("ranks,m", CASES)
def test_registry_rollouts_equal_unsharded_bit_for_bit(worlds, ranks, m,
                                                       key):
    n_ue = gm.registry_grid(key).n_ue
    for out in worlds[ranks]:
        assert out[("split", m, key)] == (n_ue % m == 0)
        for policy in POLICIES[ranks, m]:
            want = _plain[key, policy]
            assert_equal_trees(out[("rollout", m, key, policy)], want,
                               f"{key} {policy} M{m} ranks {ranks} at "
                               f"{out[('coords', m)]}")


@pytest.mark.parametrize("key", list(gm.REGISTRY))
@pytest.mark.parametrize("ranks,m", CASES)
def test_registry_rollouts_track_the_reference_on_its_draws(both, ranks, m,
                                                           key):
    worlds, reference = both
    ref = reference[key]
    for out in worlds[ranks]:
        for policy in set(POLICIES[ranks, m]) & set(gm.REFERENCE_POLICIES):
            got = out[("rollout", m, key, policy)]
            want = ref.results[policy]
            where = (f"{key} {policy} M{m} ranks {ranks} at "
                     f"{out[('coords', m)]}")
            np.testing.assert_array_equal(got["states"]["gain"],
                                          ref.draws[0][-1], err_msg=where)
            np.testing.assert_array_equal(got["results"]["cut"], want["cut"],
                                          err_msg=where)
            e_band = ALLOC_RTOL["energy"]
            for name in SLOT_FIELDS:
                g = got["results"][name].astype(np.float64)
                w = want[name].astype(np.float64)
                rtol = ALLOC_RTOL.get(name, RTOL)
                atol = 1e-6 * float(np.max(np.abs(w)))
                if name == "q_energy":
                    rtol = e_band
                    atol = NU_E * e_band * float(np.max(want["energy"]))
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                           err_msg=f"{name} {where}")


@pytest.mark.parametrize("ranks,m", CASES)
def test_eval_policy_batched_equals_unsharded(worlds, ranks, m):
    want = _plain["eval"]
    for out in worlds[ranks]:
        assert_equal_trees(out[("eval", m)], want, f"eval M{m}")


@pytest.mark.parametrize("ranks,m", CASES)
def test_collectives_a_slot_are_a_constant(worlds, ranks, m):
    """Two "model" collectives a slot (P4/P5's inputs, the reward's
    terms), at P5's own iteration counts and at others."""
    for out in worlds[ranks]:
        assert out[("collectives", m)] == [2, 4, 4]


def _grid_and_states(ues: int = 8, cells: int = 3, slots: int = 2):
    grid = sc.ScenarioGrid(sc.multicell_grid(cells=cells, ues=ues, seed=1),
                           device="cpu")
    gen = grid.generator(4)
    st = grid.reset(gen)
    for _ in range(slots):
        st, _ = grid.step(st, grid.oracle_cuts(st))
    return grid, st


def _cols(tree, cols):
    return [x[:, cols] for x in tree]


@pytest.mark.parametrize("m", [2, 4])
def test_local_sweep_equals_its_columns_of_the_whole_table(m):
    """A rank's (b, N / M) rows swept with the split count N equal its
    columns of the unsharded table, plain and through ``ops``; swept with
    the local row count (the even split over N / M) they do not, so a
    split that reads the rows fails this test."""
    grid, st = _grid_and_states()
    p = grid.params
    whole = sweep.objective_table_p(p, st)
    args = (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, st.lam, st.gain,
            st.queues.energy, st.queues.memory)
    n = grid.n_ue
    for r in range(m):
        cols = slice(r * n // m, (r + 1) * n // m)
        mine = _cols(args, cols)
        want = whole[:, cols]
        plain = ref.partition_sweep_batched_ref(*mine, grid.sweep_scalars,
                                                n_total=n)
        through = ops.partition_sweep_batched(*mine, grid.sweep_scalars,
                                              n_total=n)
        assert torch.equal(plain, want) and torch.equal(through, want)
        local_rows = ops.partition_sweep_batched(*mine, grid.sweep_scalars)
        assert not torch.equal(local_rows, want)
    cell = [a[0] for a in args]
    one = ops.partition_sweep(*[a[:2] for a in cell], grid.sweep_scalars[0],
                              n_total=n)
    assert torch.equal(one, whole[0, :2])


@pytest.mark.parametrize("m", [2, 4])
def test_local_sweep_tracks_the_reference_with_the_split_count(m):
    """A rank's rows swept with the split count N, plain and through
    ``ops``, against the reference on the same numpy inputs: its kernel
    (interpret mode) over those rows with ``n_total=N``, and its columns of
    the reference's plain whole-cell table; swept with the local row count
    they part from both."""
    grid, st = _grid_and_states()
    rgrid = r_sc.ScenarioGrid(r_sc.multicell_grid(cells=3, ues=8, seed=1))
    p = grid.params
    args = (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, st.lam, st.gain,
            st.queues.energy, st.queues.memory)
    for name in ("macs", "param_bytes", "act_bytes", "psi", "L"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(rgrid.params, name)))
    host = [a.numpy() for a in args]
    whole = np.asarray(r_ref.partition_sweep_batched_ref(
        *host, rgrid.sweep_scalars))
    n, b = grid.n_ue, grid.b
    sweep_n = jax.jit(lambda *rows: r_ps.partition_sweep_pallas(
        *rows, rgrid.sweep_scalars, interpret=True, n_total=n))
    for r in range(m):
        cols = slice(r * n // m, (r + 1) * n // m)
        mine = _cols(args, cols)
        flat = [a.numpy()[:, cols].reshape((b * (n // m),) + a.shape[2:])
                for a in args]
        kernel = np.asarray(sweep_n(*flat)).reshape(b, n // m, -1)
        local_rows = ops.partition_sweep_batched(*mine, grid.sweep_scalars)
        for got in (ref.partition_sweep_batched_ref(
                        *mine, grid.sweep_scalars, n_total=n),
                    ops.partition_sweep_batched(*mine, grid.sweep_scalars,
                                                n_total=n)):
            got = got.numpy()
            for want in (kernel, whole[:, cols]):
                feasible = want < 1e29
                assert ((got > 1e29) == ~feasible).all()
                np.testing.assert_allclose(got[feasible], want[feasible],
                                           rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                assert not np.allclose(local_rows.numpy()[feasible],
                                       want[feasible], rtol=SWEEP_RTOL,
                                       atol=SWEEP_ATOL)


def test_default_split_count_is_the_rows_of_a_cell():
    grid, st = _grid_and_states(ues=5)
    p = grid.params
    args = (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, st.lam, st.gain,
            st.queues.energy, st.queues.memory, grid.sweep_scalars)
    assert torch.equal(ops.partition_sweep_batched(*args),
                       ops.partition_sweep_batched(*args, n_total=5))
    assert torch.equal(sweep.kernel_table_p(p, st, grid.sweep_scalars),
                       sweep.objective_table_p(p, st))


def test_mesh_model_size_must_agree(tmp_path):
    pmesh.init_group("gloo", "cpu", rank=0, world_size=1,
                     init_method=f"file://{tmp_path}/store")
    try:
        mesh = pmesh.make_cells_mesh()
        grid, _ = _grid_and_states(ues=4, slots=0)
        with pytest.raises(ValueError, match="1-way 'model' axis"):
            grid.use_mesh(mesh, model=2)
        with pytest.raises(ValueError, match="does not divide"):
            grid.use_mesh(model=2)
        with pytest.raises(ValueError, match="model axis size"):
            grid.use_mesh(mesh, model=0)
    finally:
        dist.destroy_process_group()
