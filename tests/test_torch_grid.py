"""Port parity for the slice as a whole: the batched scenario grid.

A 3-cell x 5-UE ``multicell_grid`` runs 20 teacher-forced slots per policy:
every slot starts both packages from the reference's state (gains, rates,
both virtual queues) and feeds both the reference's next draws, then
compares the decision and the whole slot.  Cuts: the Oracle may pick
another cut only where the reference's table has a near tie (best and
second best within the sweep tolerance), and then its pick must score
within that tolerance of the best; the step always takes the reference's
cut so both packages stay on one trajectory.

Slot fields: rtol 1e-4 (reward, memory, edge terms and both queues agree to
within the 1e-6 x max atol), except those that follow the P3 and P5
minimizers.  Both objectives are flat at their minimum to within float32
rounding, so the searches land anywhere in a narrow band while the reward
-- the objective value -- agrees.  Each such field is held just above the
largest gap measured over these 80 slots (all four policies, CPU):

    field   measured   bound     what moves it
    f_ue    4.5e-4     1e-3      P3's Fibonacci minimizer
    t_ue    5.2e-4     1e-3      f_ue through the M/D/1 queue
    energy  9.0e-4     2e-3      f_ue squared, plus t_tx
    delay   1.2e-3     2e-3      t_ue + t_tx
    t_tx    5.3e-3     1e-2      alpha
    alpha   5.8e-3     1e-2      P5's bisection, for a UE whose term weighs
                                 little in P5

The energy queue Q + nu_e (E - e) carries energy's band times nu_e = 100:
measured 7.7e-2 x max(energy) absolute, bound 100 x 2e-3 x max(energy).
See tests/test_torch_convex.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as r_sc
from repro_torch import _tree
from repro_torch.core import env as p_env
from repro_torch.core import lymdo as p_lymdo
from repro_torch.core import scenarios as p_sc
from repro_torch.core import sweep as p_sweep

B, N, STEPS = 3, 5, 20
RTOL = 1e-4
ALLOC_RTOL = {"f_ue": 1e-3, "t_ue": 1e-3, "energy": 2e-3, "delay": 2e-3,
              "t_tx": 1e-2, "alpha": 1e-2}
NU_E = 100.0
EXACT_FIELDS = ("reward", "t_es", "mem_cost", "cut", "f_es", "q_energy",
                "q_memory")
ALLOC_FIELDS = tuple(ALLOC_RTOL)
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def grids():
    ref = r_sc.ScenarioGrid(r_sc.multicell_grid(B, N))
    port = p_sc.ScenarioGrid(p_sc.multicell_grid(B, N), device="cpu")
    return ref, port, jax.jit(ref.step), jax.jit(
        lambda s: ref.objective_tables(s, backend="lax"))


def _port_state(st, gen=None):
    return p_env.state_from_numpy(st.t, st.gain, st.lam, st.queues.energy,
                                  st.queues.memory, gen=gen, device="cpu")


def assert_slot_close(got, want, where=""):
    for name in EXACT_FIELDS + ALLOC_FIELDS:
        g, w = _np(getattr(got, name)), np.asarray(getattr(want, name))
        rtol = ALLOC_RTOL.get(name, RTOL)
        atol = 1e-6 * float(np.max(np.abs(w)))
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{name} {where}")


def assert_oracle_cut(port_cut, ref_cut, ref_table):
    tab = np.asarray(ref_table)
    srt = np.sort(tab, -1)
    tol = SWEEP_ATOL + SWEEP_RTOL * np.abs(srt[..., 0])
    clear = srt[..., 1] - srt[..., 0] > tol
    np.testing.assert_array_equal(port_cut[clear], np.asarray(ref_cut)[clear])
    picked = np.take_along_axis(tab, port_cut[..., None], -1)[..., 0]
    assert (picked <= srt[..., 0] + tol).all()


@pytest.mark.parametrize("policy", ["oracle", "local", "edge", "random"])
def test_teacher_forced_grid_rollout(grids, policy):
    ref, port, ref_step, ref_tables = grids
    key = jax.random.PRNGKey(0)
    key, k0 = jax.random.split(key)
    rst = ref.reset(k0)
    gen = port.generator(0)
    for t in range(STEPS):
        pst = _port_state(rst, gen)
        if policy == "oracle":
            table = ref_tables(rst)
            ref_cut = jnp.argmin(table, -1).astype(jnp.int32)
            port_cut = _np(port.oracle_cuts(pst))
            assert_oracle_cut(port_cut, ref_cut, table)
            # the kernel entry point (its plain version on the CPU) and the
            # ported plain sweep
            for got in (port.objective_tables(pst),
                        p_sweep.objective_table_p(port.params, pst)):
                got, want = _np(got), np.asarray(table)
                feasible = want < 1e29
                np.testing.assert_allclose(got[feasible], want[feasible],
                                           rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
                assert ((got > 1e29) == ~feasible).all()
        elif policy == "random":
            key, k = jax.random.split(key)
            ref_cut = jax.vmap(r_sc.random_policy)(ref.params, rst,
                                                   jax.random.split(k, B))
            port_cut = _np(p_sc.random_policy(port.params, pst, gen))
            assert ((port_cut >= 0) & (port_cut <= _np(port.params.L))).all()
        else:
            ref_cut = jax.vmap(r_sc.POLICIES[policy])(ref.params, rst,
                                                      jax.random.split(k0, B))
            port_cut = _np(p_sc.POLICIES[policy](port.params, pst, gen))
            np.testing.assert_array_equal(port_cut, np.asarray(ref_cut))
        rst2, rres = ref_step(rst, ref_cut)
        pst2, pres = port.step(pst, torch.as_tensor(np.asarray(ref_cut)),
                               draws=(np.asarray(rst2.gain), np.asarray(rst2.lam)))
        assert_slot_close(pres, rres, where=f"slot {t}")
        np.testing.assert_allclose(_np(pst2.queues.memory),
                                   np.asarray(rst2.queues.memory), rtol=RTOL)
        # Q(t+1) = Q + nu_e (E - e): the energy's allocation band, times nu_e
        e_band = ALLOC_RTOL["energy"]
        np.testing.assert_allclose(
            _np(pst2.queues.energy), np.asarray(rst2.queues.energy),
            rtol=e_band,
            atol=NU_E * e_band * float(np.max(np.asarray(rres.energy))))
        assert (_np(pst2.t) == t + 1).all()
        rst = rst2
    # the run built up queues, so the allocators saw Q > 0
    assert float(jnp.max(rst.queues.energy) + jnp.max(rst.queues.memory)) > 0


def _ref_draws(ref, ref_step, steps):
    """The reference rollout's per-slot (gain, lam): they depend on its keys
    only, not on the cuts, so any cuts reproduce them."""
    key, k0 = jax.random.split(jax.random.PRNGKey(0))
    st = ref.reset(k0)
    gains, lams = [st.gain], [st.lam]
    for _ in range(steps):
        st, _ = ref_step(st, ref.params.L)
        gains.append(st.gain)
        lams.append(st.lam)
    return np.stack(gains), np.stack(lams)


@pytest.mark.parametrize("policy", ["edge", "local", "oracle"])
def test_rollout_with_injected_draws_tracks_reference(grids, policy):
    """``make_rollout`` end to end on the reference's draws, each package on
    its own trajectory.  The allocations differ within ALLOC_RTOL per slot,
    the energy queue integrates that (nu_e = 100) and feeds it back, so over
    20 slots the per-cell summaries are held to 1e-2."""
    ref, port, ref_step, _ = grids
    gains, lams = _ref_draws(ref, ref_step, STEPS)
    _, ref_res, ref_sum = ref.make_rollout(policy, STEPS)(jax.random.PRNGKey(0))
    states, res, summary = port.make_rollout(policy, STEPS,
                                             draws=(gains, lams))(0)
    assert res.delay.shape == (STEPS, B, N) and res.reward.shape == (STEPS, B)
    np.testing.assert_array_equal(_np(states.gain), gains[-1])
    assert (_np(res.cut) == np.asarray(ref_res.cut)).mean() > 0.95
    for name in ("reward", "delay", "energy", "mem", "cut_mean",
                 "q_memory_final"):
        np.testing.assert_allclose(_np(summary[name]), np.asarray(ref_sum[name]),
                                   rtol=1e-2, err_msg=name)


def test_run_fixed_batched_and_single_cell_runners():
    port = p_sc.ScenarioGrid(p_sc.multicell_grid(2, 4), device="cpu")
    metrics, last = p_lymdo.run_fixed_batched(port, "random", episodes=2,
                                              steps=3, seed=1)
    assert set(metrics) == {"reward", "delay", "energy", "mem",
                            "q_energy_final", "q_memory_final", "cut_mean"}
    assert all(v.shape == (2,) and np.isfinite(v).all() for v in metrics.values())
    assert last.cut.shape == (3, 2, 4)
    env = p_env.paper_env(p_env.MecConfig(lam_mode=p_env.LAM_FIXED), device="cpu")
    out = {}
    for name, fn in [("local", p_lymdo.local_cut_fn(env)),
                     ("edge", p_lymdo.edge_cut_fn(env)),
                     ("random", p_lymdo.random_cut_fn(env)),
                     ("oracle", p_lymdo.oracle_cut_fn(env))]:
        m, res = p_lymdo.run_fixed(env, fn, episodes=1, steps=4)
        assert res.delay.shape == (4, 5) and np.isfinite(list(m.values())).all()
        out[name] = m
    assert out["edge"]["cut_mean"] == 0.0
    # the oracle scores no worse than always-local or always-edge
    assert out["oracle"]["reward"] >= max(out["local"]["reward"],
                                          out["edge"]["reward"]) - 1e-3


def test_trace_grid_batched_equals_per_cell_loop():
    """Trace cells (a (B, T, N) rate table indexed by slot) stepped as one
    batch equal each cell stepped alone."""
    cells = [p_sc.trace_replay(offset=7 * b) for b in range(3)]
    grid = p_sc.ScenarioGrid(cells, device="cpu")
    rng = np.random.default_rng(0)
    st = grid.reset(draws=(rng.exponential(1.0, (3, 4)) * 1e-11,
                           np.asarray(grid.params.arrival(None, 0))))
    for t in range(4):
        cuts = torch.as_tensor(rng.integers(0, 11, (3, 4)))
        gain = rng.exponential(1.0, (3, 4)).astype(np.float32) * 1e-11
        lam = grid.params.arrival(None, t + 1)
        nxt, res = grid.step(st, cuts, draws=(gain, lam))
        for b in range(3):
            p_b = _tree.index(grid.params, b)
            st_b = _tree.index(st, b)
            nxt_b, res_b = p_env.step_p(p_b, st_b, cuts[b],
                                        draws=(gain[b], p_b.arrival(None, t + 1)))
            for name in EXACT_FIELDS + ALLOC_FIELDS:
                np.testing.assert_allclose(_np(getattr(res, name))[b],
                                           _np(getattr(res_b, name)),
                                           rtol=1e-6, err_msg=name)
            np.testing.assert_allclose(_np(nxt.lam)[b], _np(nxt_b.lam), rtol=0)
        st = nxt
