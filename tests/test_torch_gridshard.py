"""The port's rank-sharded ScenarioGrid (repro_torch.core.gridshard and
ScenarioGrid.use_mesh): layout, the draw rule, the mesh's refusals, and
sharded-vs-unsharded parity on spawned gloo worlds.

Layout and draws run in this process: ``FakeMesh`` is one rank's view of an
n-rank cells mesh (names, size, rank), enough for everything but the
gather.  The parity suite spawns a 2-rank and a 4-rank world once each
(module fixtures, ``launch.mesh.run_world``) and runs every case inside;
each test then holds one case, on every rank, against the unsharded grid
run here: identical cuts, rtol 1e-5 / atol 1e-7 on every summary, result
and state leaf.  B = 4 over 2 is even, 5 over 2 and 6 over 4 pad.

Against the reference: one rank's objective tables on its shard of the
reference's states equal those rows of the reference's unsharded
``objective_tables(backend="lax")`` at the sweep tolerance; a sharded
rollout on the reference's draws equals the unsharded port rollout that
tests/test_torch_grid.py holds to the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _mesh_workers as mw
from _hypothesis_compat import given, settings, st
from repro.core import scenarios as r_sc
from repro_torch.core import gridshard
from repro_torch.core import scenarios as sc
from repro_torch.core.env import state_from_numpy
from repro_torch.launch import mesh as pmesh

RTOL, ATOL = 1e-5, 1e-7
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-3
WORLD_S = 300.0
REF_B, REF_N, REF_STEPS = 3, 5, 20      # tests/test_torch_grid.py's grid
PARITY = [(2, 4), (2, 5), (4, 6)]       # (ranks, B)
LAYOUT = [(1, 0, 1), (3, 1, 2), (5, 0, 4), (6, 2, 3)]   # (b, extra, k)


class FakeMesh:
    """One rank's view of an n-rank mesh: what ``plan`` reads."""

    def __init__(self, n: int, rank: int = 0, names=("cells",), sizes=None):
        self.mesh_dim_names = tuple(names)
        self._sizes = tuple(sizes) if sizes else (n,)
        self._rank = rank

    def size(self, dim: int = 0) -> int:
        return self._sizes[dim]

    def get_local_rank(self, name) -> int:
        return self._rank


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture
def one_rank(tmp_path):
    pmesh.init_group("gloo", "cpu", rank=0, world_size=1,
                     init_method=f"file://{tmp_path}/store")
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Plan / pad / local / mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_plan_rounds_up_to_rank_multiple(n):
    gs = gridshard.plan(3 * n, FakeMesh(n))
    assert gs.b_padded == 3 * n and gs.pad == 0 and gs.b_local == 3
    gs = gridshard.plan(3 * n + 1, FakeMesh(n, rank=n - 1))
    assert gs.b_padded == 4 * n and gs.pad == n - 1
    assert gs.b_local == 4 and gs.rows == slice(4 * (n - 1), 4 * n)


def test_plan_validates():
    with pytest.raises(ValueError, match="no 'nope' axis"):
        gridshard.plan(2, FakeMesh(2), axis="nope")
    with pytest.raises(ValueError, match="at least one cell"):
        gridshard.plan(0, FakeMesh(2))
    with pytest.raises(ValueError, match="pad_to"):     # below the natural
        gridshard.plan(3, FakeMesh(2), pad_to=2)
    with pytest.raises(ValueError, match="pad_to"):     # not a multiple
        gridshard.plan(3, FakeMesh(2), pad_to=5)
    with pytest.raises(ValueError, match="b_padded"):
        gridshard.GridSharding(b=4, b_padded=2)
    with pytest.raises(ValueError, match="rank"):
        gridshard.GridSharding(b=4, b_padded=4, n_shards=2, rank=2)


def test_cell_index_clamps_padded_slots_to_the_last_cell():
    gs = [gridshard.plan(7, FakeMesh(3, r)) for r in range(3)]
    got = [gridshard.cell_index(g).tolist() for g in gs]
    assert got == [[0, 1, 2], [3, 4, 5], [6, 6, 6]]


def _joined(tree, b, n, extra, lead=0):
    """Every rank's ``local`` rows joined in rank order, as the gather
    joins them."""
    pads = -(-b // n) * n + extra * n
    parts = [gridshard.local(tree, gridshard.plan(b, FakeMesh(n, r),
                                                  pad_to=pads), lead=lead)
             for r in range(n)]
    gs = gridshard.plan(b, FakeMesh(n), pad_to=pads)
    return gs, {key: (torch.cat([p[key] for p in parts], dim=lead)
                      if x.dim() > lead else parts[0][key])
                for key, x in tree.items()}


class TestLayoutRoundTrip:
    """pad_cells -> local on every rank -> join -> unpad is the identity,
    and the validity mask is padding-invariant, for any b, pad, rank count
    and leaf rank (the gather's own join is held on real worlds below)."""

    @given(b=st.integers(1, 9), extra=st.integers(0, 2), k=st.integers(1, 6),
           n=st.integers(1, 4))
    @settings(max_examples=12, deadline=None)
    def test_pad_local_join_unpad_identity(self, b, extra, k, n):
        tree, seq = mw.layout_tree(b, k)
        gs, joined = _joined(tree, b, n, extra)
        padded = gridshard.pad_cells(tree, gs)
        for key in tree:
            torch.testing.assert_close(joined[key], padded[key], rtol=0,
                                       atol=0)
            if tree[key].dim():
                assert padded[key].shape[0] == gs.b_padded
        back = gridshard.unpad(joined, gs)
        for key in tree:
            assert torch.equal(back[key], tree[key]), key
        _, joined = _joined({"seq": seq}, b, n, extra, lead=1)
        assert torch.equal(gridshard.unpad(joined, gs, lead=1)["seq"], seq)
        mask = gs.mask()
        assert int(mask.sum()) == b and bool(mask[:b].all())

    @given(b=st.integers(1, 6), extra=st.integers(1, 3), n=st.integers(1, 4))
    @settings(max_examples=8, deadline=None)
    def test_mask_is_padding_invariant(self, b, extra, n):
        natural = -(-b // n) * n
        narrow = gridshard.plan(b, FakeMesh(n))
        wide = gridshard.plan(b, FakeMesh(n), pad_to=natural + extra * n)
        m_n, m_w = narrow.mask(), wide.mask()
        assert torch.equal(m_w[:len(m_n)][:b], m_n[:b])
        assert int(m_n.sum()) == int(m_w.sum()) == b
        assert not bool(m_w[b:].any())


@pytest.mark.parametrize("n,extra", [(1, 0), (1, 1), (2, 0), (2, 1), (3, 0),
                                     (4, 1)])
def test_draws_equal_at_any_padding_and_rank_count(n, extra):
    """Every rank's reset and per-slot draws are the rows ``cell_index``
    names of the unsharded grid's, bit for bit, and they consume the
    generator as the unsharded grid does."""
    b, slots = 5, 3
    plain = mw.multicell(b)
    gen = plain.generator(7)
    st_p = plain.reset(gen)
    want = [(st_p.gain, st_p.lam)]
    for _ in range(slots):
        st_p, _ = plain.step(st_p, plain.params.L)
        want.append((st_p.gain, st_p.lam))
    after = torch.rand(4, generator=gen)
    pad_to = -(-b // n) * n + extra * n
    for r in range(n):
        g = mw.multicell(b, mesh=FakeMesh(n, r), pad_to=pad_to)
        idx = gridshard.cell_index(g.gridshard)
        gen = g.generator(7)
        st_s = g.reset(gen)
        got = [(st_s.gain, st_s.lam)]
        for _ in range(slots):
            st_s, _ = g.step(st_s, g._run_params.L)
            got.append((st_s.gain, st_s.lam))
        for (gain, lam), (w_gain, w_lam) in zip(got, want):
            assert gain.shape[0] == g.b_local
            assert torch.equal(gain, w_gain[idx])
            assert torch.equal(lam, w_lam[idx])
        assert torch.equal(torch.rand(4, generator=gen), after)


# ---------------------------------------------------------------------------
# The mesh's and the grid's refusals
# ---------------------------------------------------------------------------

def test_make_cells_mesh_refuses_without_a_group():
    with pytest.raises(RuntimeError, match="init_group"):
        pmesh.make_cells_mesh()


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_devices=0), "at least one device"),
    (dict(n_devices=2), "torchrun --nproc-per-node 2"),
    (dict(model=0), "model axis size"),
    (dict(model=3), "does not divide"),
])
def test_make_cells_mesh_refusals(one_rank, kwargs, match):
    with pytest.raises(ValueError, match=match):
        pmesh.make_cells_mesh(**kwargs)


def test_one_rank_mesh_and_group(one_rank):
    mesh = pmesh.make_cells_mesh()
    assert mesh.mesh_dim_names == ("cells",) and mesh.device_type == "cpu"
    assert mesh.size() == 1 and pmesh.data_axes(mesh) == ()
    assert pmesh.world_size() == 1 and pmesh.is_rank0()
    with pytest.raises(RuntimeError, match="already exists"):
        pmesh.init_group("gloo", "cpu")
    grid = mw.multicell(3).use_mesh(pad_to=4)    # the group's own mesh
    assert (grid.b, grid.b_run, grid.b_local) == (3, 4, 4)
    _, res, summary = grid.rollout("oracle", steps=2, seed=3)
    assert res.delay.shape == (2, 3, mw.UES)
    assert summary["delay"].shape == (3,)


def test_init_group_reads_torchruns_rank(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    device = pmesh.init_group(device="cpu",
                              init_method=f"file://{tmp_path}/store")
    try:
        assert device == torch.device("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


def test_use_mesh_model_axis_is_not_implemented():
    """The model axis was refused until it was ported; now ``model=2``
    needs only a group, a mesh that disagrees with ``model`` raises as the
    reference's does, and a (cells, model) mesh splits each cell's UEs
    where the axis divides them and holds whole cells where it does not
    (the sharded rollouts: tests/test_torch_grid_model_axis.py)."""
    with pytest.raises(RuntimeError, match="init_group"):
        mw.multicell(3).use_mesh(model=2)
    two_d = FakeMesh(2, names=("cells", "model"), sizes=(1, 2))
    with pytest.raises(ValueError, match="2-way 'model' axis"):
        mw.multicell(3).use_mesh(two_d, model=4)
    whole = mw.multicell(3).use_mesh(two_d)           # 3 UEs: replicated
    assert whole.ue_sharding is None
    assert whole._run_params.L.shape == (3, mw.UES)
    four = sc.ScenarioGrid(sc.multicell_grid(cells=3, ues=4), device="cpu")
    four.use_mesh(two_d)
    assert four.ue_sharding.ue_cols == slice(0, 2)
    assert four._run_params.L.shape == (3, 2)
    assert four._run_params.prefix_macs.shape == (3, 2, four.num_cuts)


def test_params_for_refuses_a_third_width():
    g = mw.multicell(3, mesh=FakeMesh(2, 1))          # b 3, shard 2
    states = g.reset(g.generator(0))
    assert states.t.shape[0] == g.b_local == 2
    assert g.objective_tables(states).shape == (2, mw.UES, g.num_cuts)
    logical = g.reset(draws=(np.ones((3, mw.UES), np.float32) * 1e-11,
                             np.ones((3, mw.UES), np.float32)))
    assert logical.t.shape[0] == 2                    # draws take the shard
    full = mw.multicell(3).reset(g.generator(0))
    assert g.objective_tables(full).shape[0] == 3     # the logical stack
    bad = state_from_numpy(np.zeros(5, np.int64),
                           *(np.ones((5, mw.UES), np.float32),) * 4,
                           device="cpu")
    with pytest.raises(ValueError, match="neither b=3"):
        g.step(bad, torch.zeros((5, mw.UES), dtype=torch.long))


# ---------------------------------------------------------------------------
# One rank's sweep tables against the reference's unsharded tables
# ---------------------------------------------------------------------------

def _ref_states(ref, slots: int):
    """The reference's Oracle trajectory: its state at each slot."""
    step = jax.jit(ref.step)
    tables = jax.jit(lambda s: ref.objective_tables(s, backend="lax"))
    st = ref.reset(jax.random.PRNGKey(2))
    out = []
    for _ in range(slots):
        table = tables(st)
        out.append((st, np.asarray(table)))
        st, _ = step(st, jnp.argmin(table, -1).astype(jnp.int32))
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_shard_tables_equal_the_reference_rows(n):
    b = 5
    ref = r_sc.ScenarioGrid(r_sc.multicell_grid(b, mw.UES, seed=mw.SEED))
    for st, want in _ref_states(ref, 4):
        logical = [np.asarray(x) for x in (st.t, st.gain, st.lam,
                                           st.queues.energy,
                                           st.queues.memory)]
        for r in range(n):
            g = mw.multicell(b, mesh=FakeMesh(n, r))
            idx = gridshard.cell_index(g.gridshard).numpy()
            mine = state_from_numpy(*(x[idx] for x in logical), device="cpu")
            got = g.objective_tables(mine).numpy()
            rows = want[idx]
            feasible = rows < 1e29
            assert ((got > 1e29) == ~feasible).all()
            np.testing.assert_allclose(got[feasible], rows[feasible],
                                       rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
            srt = np.sort(rows, -1)
            clear = srt[..., 1] - srt[..., 0] > SWEEP_ATOL + SWEEP_RTOL * \
                np.abs(srt[..., 0])
            assert (got.argmin(-1)[clear] == rows.argmin(-1)[clear]).all()


# ---------------------------------------------------------------------------
# Sharded == unsharded on spawned gloo worlds
# ---------------------------------------------------------------------------

def _ref_draws():
    """The reference rollout's per-slot (gain, lam) on test_torch_grid's
    grid: they depend on its keys only, so any cuts reproduce them."""
    ref = r_sc.ScenarioGrid(r_sc.multicell_grid(REF_B, REF_N))
    step = jax.jit(ref.step)
    key, k0 = jax.random.split(jax.random.PRNGKey(0))
    st = ref.reset(k0)
    gains, lams = [st.gain], [st.lam]
    for _ in range(REF_STEPS):
        st, _ = step(st, ref.params.L)
        gains.append(st.gain)
        lams.append(st.lam)
    return np.stack(gains), np.stack(lams)


@pytest.fixture(scope="module")
def worlds():
    gains, lams = _ref_draws()
    two = pmesh.run_world(mw.parity_world, 2, args=({
        "policies": [(4, None), (5, None)],
        "registry": sc.names(),
        "runners": (3, 4),
        "ref_draws": (REF_B, REF_N, REF_STEPS, gains, lams),
        "layout": LAYOUT,
    },), deadline_s=WORLD_S)
    four = pmesh.run_world(mw.parity_world, 4, args=({
        "policies": [(6, None)], "layout": LAYOUT},), deadline_s=WORLD_S)
    return {2: two, 4: four, "draws": (gains, lams)}


_plain: dict = {}


def _unsharded(key, run):
    if key not in _plain:
        _plain[key] = run()
    return _plain[key]


def assert_same(got: dict, want: dict, where: str):
    """Identical cuts; every other leaf at rtol 1e-5 / atol 1e-7, with the
    logical shape."""
    for part in ("states", "results", "summary"):
        assert set(got[part]) == set(want[part])
        for name, w in want[part].items():
            g = got[part][name]
            assert g.shape == w.shape, f"{where} {part}.{name}"
            if name == "cut":
                np.testing.assert_array_equal(g, w, err_msg=where)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{where} {part}.{name}")


@pytest.mark.parametrize("policy", mw.POLICIES)
@pytest.mark.parametrize("ranks,b", PARITY)
def test_sharded_parity(worlds, ranks, b, policy):
    want = _unsharded(("policy", b, policy),
                      lambda: mw.rollout(mw.multicell(b), policy))
    for out in worlds[ranks]:
        assert_same(out[("policy", b, policy)], want,
                    f"{policy} B{b} rank {out['rank']} of {ranks}")


@pytest.mark.parametrize("ranks,b", PARITY)
def test_shard_widths(worlds, ranks, b):
    b_padded = -(-b // ranks) * ranks
    for out in worlds[ranks]:
        assert out[("layout", b)] == (b_padded // ranks, b_padded - b,
                                      b_padded // ranks)
    assert sorted(out["rank"] for out in worlds[ranks]) == list(range(ranks))


@pytest.mark.parametrize("name", sc.names())
def test_registry_sharded_parity(worlds, name):
    """Every registered scenario at B = 3 over 2 ranks (one padded cell)."""
    want = mw.rollout(mw.registry_grid(name), "oracle", mw.REG_STEPS)
    for out in worlds[2]:
        assert_same(out[("registry", name)], want, name)


def test_run_fixed_batched_transparent(worlds):
    want = _unsharded("runners", lambda: mw.runners(mw.multicell(3)))
    for out in worlds[2]:
        got = out["runners"]
        for part in ("fixed", "eval"):
            for name, w in want[part].items():
                assert got[part][name].shape == (w.shape[0],)
                np.testing.assert_allclose(got[part][name], w, rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got["fixed_delay"], want["fixed_delay"],
                                   rtol=RTOL, atol=ATOL)


def test_eval_policy_batched_transparent(worlds):
    want = _unsharded("runners", lambda: mw.runners(mw.multicell(3)))
    for out in worlds[2]:
        assert out["runners"]["eval_delay"].shape == (4, 3, 5)
        np.testing.assert_allclose(out["runners"]["eval_delay"],
                                   want["eval_delay"], rtol=RTOL, atol=ATOL)


def test_sharded_rollout_on_reference_draws(worlds):
    """B = 3 over 2 ranks on the reference's draws equals the unsharded
    port rollout that test_torch_grid holds to the reference."""
    gains, lams = worlds["draws"]
    grid = sc.ScenarioGrid(sc.multicell_grid(REF_B, REF_N), device="cpu")
    want = mw.rollout(grid, "oracle", REF_STEPS, seed=0, draws=(gains, lams))
    for out in worlds[2]:
        got = out["ref_draws"]
        assert_same(got, want, f"rank {out['rank']}")
        np.testing.assert_array_equal(got["states"]["gain"], gains[-1])


@pytest.mark.parametrize("ranks", [2, 4])
def test_gather_round_trip(worlds, ranks):
    """pad -> local -> gather -> unpad over the real group is the
    identity, lead 0 and lead 1, float and integer leaves, a scalar rider."""
    for out in worlds[ranks]:
        for (b, _, k), back in zip(LAYOUT, out["layout"]):
            tree, seq = mw.layout_tree(b, k)
            for key, x in {**tree, "seq": seq}.items():
                np.testing.assert_array_equal(back[key], x.numpy(),
                                              err_msg=f"{key} b={b}")
