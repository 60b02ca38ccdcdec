"""Port parity: the LyMDO Runner (episodes, training chunks, evaluation),
``eval_policy_batched`` and the quickstart twin.

Every episode runs on the reference's own inputs: its channel and arrival
draws (they depend only on its keys, not on the cuts) through
``episode(draws=...)``, and its action draws through ``noise`` (see
tests/test_torch_ppo.py).  Parameters come from the reference's
``agent.init`` through ``ppo.train_state_from_reference``.

Tolerances, each beside the largest gap measured here (CPU; "beyond
atol" is the smallest rtol that passes with the stated atol):

    joint mode, every slot field and the trajectory
                                     rtol 1e-4, atol 1e-6    1.0e-7 beyond atol
                                     (slot fields: 1e-6 x max)
    joint mode, 2 training episodes: metrics
                                     rtol 1e-4, atol 1e-6    3.3e-6 beyond atol
                                     params, first moments
                                     atol 1e-5 (rtol 1e-4)   6.9e-7 absolute
    lymdo mode (episodes, training, the grid):
        cuts equal                   >= 95 % of places       cut_mean equal
        per-episode and per-cell     rtol 1e-2               3.7e-5
        summaries, rewards
        params, first moments after  atol 2e-5 (rtol 1e-4)   6.8e-6 absolute
        2 training episodes

Joint mode runs no minimizer, so it is held tightly.  In lymdo mode P3 and
P5 return minimizers of objectives flat to float32 rounding (f_ue within
1e-3, alpha within 1e-2 of the reference; tests/test_torch_grid.py); the
energy queue integrates that drift and feeds it back into the
observation, so each package runs its own trajectory and the summaries
are held as the grid's are.  The rewards of those trajectories enter the
advantages, so the parameters after training carry their drift: atol
2e-5, 3x the measured gap.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as r_env
from repro.core import lymdo as r_lymdo
from repro.core import policies as r_pol
from repro.core import ppo as r_ppo
from repro.core import scenarios as r_sc
from repro_torch import _tree
from repro_torch import quickstart
from repro_torch.core import env as p_env
from repro_torch.core import lymdo as p_lymdo
from repro_torch.core import policies as p_pol
from repro_torch.core import ppo as p_ppo
from repro_torch.core import scenarios as p_sc

K = 8
RTOL_JOINT = 1e-4
ATOL_PARAMS_JOINT, ATOL_PARAMS_LYMDO = 1e-5, 2e-5
SUMMARY_RTOL, SAME_CUTS = 1e-2, 0.95
SUMMARY = ("reward", "delay", "energy", "mem", "q_energy_final",
           "q_memory_final", "cut_mean")
UPDATE = ("loss", "actor_loss", "critic_loss", "ratio_max")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def leaves_np(tree):
    if isinstance(tree, dict):
        return {k: leaves_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [leaves_np(v) for v in tree]
    return _np(tree)


def assert_params_close(got, want, atol):
    for a, b in zip(jax.tree.leaves(leaves_np(got)), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL_JOINT, atol=atol)


@pytest.fixture(scope="module")
def envs():
    return r_env.paper_env(), p_env.paper_env(device="cpu")


_JIT = {}


def jitted(fn):
    """One compiled program per reference function for the whole module."""
    return _JIT.setdefault(fn, jax.jit(fn))


def make_agents(ref_env, head):
    L = np.array(ref_env.L)
    cfg = ref_env.cfg
    if head == "gaussian":
        pols = (r_pol.GaussianTanhPolicy(ref_env.obs_dim, L),
                p_pol.GaussianTanhPolicy(ref_env.obs_dim, torch.as_tensor(L)))
    elif head == "categorical":
        pols = (r_pol.CategoricalPolicy(ref_env.obs_dim, L),
                p_pol.CategoricalPolicy(ref_env.obs_dim, torch.as_tensor(L)))
    else:
        pols = (r_pol.JointGaussianPolicy(ref_env.obs_dim, L, cfg.f_max_ue,
                                          cfg.f_max_es),
                p_pol.JointGaussianPolicy(ref_env.obs_dim, torch.as_tensor(L),
                                          cfg.f_max_ue, cfg.f_max_es))
    ref = r_ppo.PPO(pols[0], ref_env.obs_dim, r_ppo.PPOConfig())
    port = p_ppo.PPO(pols[1], ref_env.obs_dim, p_ppo.PPOConfig())
    state = ref.init(jax.random.PRNGKey(11))
    ps = p_ppo.train_state_from_reference(jax.tree.map(np.asarray, state),
                                          pols[1], "cpu")
    return ref, port, state, ps


def ref_episode_inputs(ref_env, policy, key, steps):
    """The draws and action noise of the reference's ``episode(params,
    key)``: ``key, k0 = split(key)``, reset from k0, then per slot
    ``key, k_act = split(key)``."""
    key, k0 = jax.random.split(key)
    st = ref_env.reset(k0)
    step = jitted(ref_env.step)
    gains, lams = [st.gain], [st.lam]
    for _ in range(steps):
        st, _ = step(st, ref_env.L)
        gains.append(st.gain)
        lams.append(st.lam)
    noise = []
    for _ in range(steps):
        key, k_act = jax.random.split(key)
        if isinstance(policy, r_pol.CategoricalPolicy):
            noise.append(jax.random.gumbel(k_act, (policy.n_ue, policy.num_cuts)))
        else:
            noise.append(jax.random.normal(k_act, (policy.act_dim,)))
    return (np.stack(gains), np.stack(lams)), np.stack(noise)


def mode_of(head):
    return "joint" if head == "joint" else "lymdo"


def assert_summaries(got, want, rtol):
    for name in SUMMARY:
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]),
                                   rtol=rtol, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# Episodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head,deterministic", [
    ("gaussian", False), ("categorical", False), ("joint", False),
    ("joint", True)])
def test_episode_on_reference_draws_and_noise(envs, head, deterministic):
    ref_env, port_env = envs
    ref, port, state, ps = make_agents(ref_env, head)
    runner = r_lymdo.Runner(ref_env, ref, steps=K, mode=mode_of(head))
    key = jax.random.PRNGKey(21)
    fn = runner._eval_episode if deterministic else jax.jit(runner._make_episode())
    traj, summary, res = fn(state.params, key)
    draws, noise = ref_episode_inputs(ref_env, ref.policy, key, K)
    got_traj, got_sum, got_res = p_lymdo.Runner(
        port_env, port, steps=K, mode=mode_of(head)).episode(
            ps.params, None, deterministic=deterministic, draws=draws,
            noise=noise)
    assert got_res.delay.shape == (K, 5) and got_traj.obs.shape == (K, 20)
    assert not got_traj.obs.requires_grad
    if head == "joint":
        for name, g, w in zip(traj._fields, got_traj, traj):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL_JOINT,
                                       atol=1e-6, err_msg=name)
        for name in res._fields:
            w = np.asarray(getattr(res, name), np.float64)
            np.testing.assert_allclose(
                _np(getattr(got_res, name)).astype(np.float64), w,
                rtol=RTOL_JOINT, atol=1e-6 * float(np.max(np.abs(w))),
                err_msg=name)
        assert_summaries(got_sum, summary, RTOL_JOINT)
    else:
        assert (_np(got_res.cut) == np.asarray(res.cut)).mean() >= SAME_CUTS
        assert_summaries(got_sum, summary, SUMMARY_RTOL)
        np.testing.assert_allclose(_np(got_traj.reward), np.asarray(traj.reward),
                                   rtol=SUMMARY_RTOL)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", ["joint", "categorical"])
def test_train_chunk_from_reference_state(envs, head):
    """Two episodes of K = 8, each followed by an 8-epoch update, from the
    reference's initial state on its draws and noise: the (2,) history of
    every metric and the final parameters and Adam state."""
    ref_env, port_env = envs
    ref, port, state, ps = make_agents(ref_env, head)
    runner = r_lymdo.Runner(ref_env, ref, steps=K, mode=mode_of(head))
    k_chunk = jax.random.PRNGKey(31)
    want_state, want = runner._train_chunk(state, k_chunk, n=2)
    inputs = [ref_episode_inputs(ref_env, ref.policy, k, K)
              for k in jax.random.split(k_chunk, 2)]
    draws = (np.stack([d[0] for d, _ in inputs]),
             np.stack([d[1] for d, _ in inputs]))
    noise = np.stack([n for _, n in inputs])
    got_state, got = p_lymdo.Runner(port_env, port, steps=K,
                                    mode=mode_of(head))._train_chunk(
        ps, None, 2, draws=draws, noise=noise)
    assert set(got) == set(want) == set(SUMMARY + UPDATE)
    assert all(v.shape == (2,) for v in got.values())
    assert int(got_state.opt_state.step) == 16
    if head == "joint":
        for name in SUMMARY + UPDATE:
            np.testing.assert_allclose(_np(got[name]), np.asarray(want[name]),
                                       rtol=RTOL_JOINT, atol=1e-6, err_msg=name)
        atol = ATOL_PARAMS_JOINT
    else:
        assert_summaries(got, want, SUMMARY_RTOL)
        atol = ATOL_PARAMS_LYMDO
    assert_params_close(got_state.params, want_state.params, atol)
    assert_params_close(got_state.opt_state.mu, want_state.opt_state.mu, atol)


def test_train_logs_per_chunk_and_returns_history(envs, capsys):
    _, port_env = envs
    _, port, _, _ = make_agents(envs[0], "gaussian")
    state, hist = p_lymdo.Runner(port_env, port, steps=2).train(
        p_lymdo.RunConfig(episodes=3, steps=2, chunk=2, seed=4))
    lines = [l for l in capsys.readouterr().out.splitlines() if "ep " in l]
    assert len(lines) == 2 and "ep     2/3" in lines[0] and "ep     3/3" in lines[1]
    assert set(hist) == set(SUMMARY + UPDATE)
    assert all(isinstance(v, np.ndarray) and v.shape == (3,) and
               np.isfinite(v).all() for v in hist.values())
    assert int(state.opt_state.step) == 3 * p_ppo.PPOConfig().epochs
    # the same seed trains to the same state
    again, _ = p_lymdo.Runner(port_env, port, steps=2).train(
        p_lymdo.RunConfig(episodes=3, steps=2, chunk=2, seed=4, log=False))
    assert all(torch.equal(a, b) for a, b in
               zip(_tree.leaves(state.params), _tree.leaves(again.params)))


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def test_evaluate_is_the_mean_of_deterministic_episodes(envs):
    _, port_env = envs
    _, port, _, ps = make_agents(envs[0], "categorical")
    fixed = p_env.paper_env(p_env.MecConfig(lam_mode=p_env.LAM_FIXED),
                            device="cpu")
    runner = p_lymdo.Runner(fixed, port, steps=3)
    metrics, last = runner.evaluate(ps, episodes=2, seed=5)
    gen = fixed.generator(5)
    rows = [runner.episode(ps.params, gen, deterministic=True)[1]
            for _ in range(2)]
    for name in SUMMARY:
        assert metrics[name] == pytest.approx(
            float(np.mean([float(r[name]) for r in rows])), rel=1e-6)
    assert last.delay.shape == (3, 5)
    # the deterministic cut is the logits' argmax
    st = fixed.reset(fixed.generator(6))
    obs = fixed.observe(st)
    cut = port.policy.mean_action(ps.params["pi"], obs)
    assert torch.equal(cut, torch.argmax(port.policy._logits(ps.params["pi"], obs), -1))


def ref_grid_draws(ref_grid, key, steps):
    key, k0 = jax.random.split(key)
    st = ref_grid.reset(k0)
    step = jitted(ref_grid.step)
    gains, lams = [st.gain], [st.lam]
    for _ in range(steps):
        st, _ = step(st, ref_grid.params.L)
        gains.append(st.gain)
        lams.append(st.lam)
    return np.stack(gains), np.stack(lams)


def test_eval_policy_batched_on_a_fixed_rate_grid(envs, monkeypatch):
    ref_env, _ = envs
    ref, port, state, ps = make_agents(ref_env, "categorical")
    specs = [("fixed_rate", {"rate": r}) for r in (0.5, 1.5, 2.5)]
    ref_grid = r_sc.grid_from_names(specs)
    port_grid = p_sc.grid_from_names(specs, device="cpu")
    seed = 1234
    want, want_res = r_lymdo.eval_policy_batched(ref_grid, ref, state,
                                                 episodes=1, steps=K, seed=seed)
    # run_fixed_batched's one episode rolls out from split(PRNGKey(seed))[1]
    draws = ref_grid_draws(ref_grid, jax.random.split(jax.random.PRNGKey(seed))[1], K)
    make = port_grid.make_rollout
    monkeypatch.setattr(port_grid, "make_rollout",
                        lambda policy, steps: make(policy, steps, draws=draws))
    got, got_res = p_lymdo.eval_policy_batched(port_grid, port, ps, episodes=1,
                                               steps=K, seed=seed)
    assert got_res.cut.shape == (K, 3, 5)
    assert (_np(got_res.cut) == np.asarray(want_res.cut)).mean() >= SAME_CUTS
    for name in SUMMARY:
        assert got[name].shape == (3,)
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=SUMMARY_RTOL, atol=1e-7, err_msg=name)


def test_eval_policy_batched_refuses_other_layer_counts(envs):
    _, port, _, ps = make_agents(envs[0], "categorical")
    for cells, ues in ((2, 5), (2, 4)):
        grid = p_sc.ScenarioGrid(p_sc.multicell_grid(cells, ues, seed=3),
                                 device="cpu")
        with pytest.raises(ValueError, match="layer counts"):
            p_lymdo.eval_policy_batched(grid, port, ps, steps=1)


def test_runner_modes(envs):
    _, port_env = envs
    for head in ("gaussian", "categorical"):
        _, port, _, _ = make_agents(envs[0], head)
        with pytest.raises(ValueError, match="JointGaussianPolicy"):
            p_lymdo.Runner(port_env, port, mode="joint")
    with pytest.raises(ValueError, match="mode"):
        p_lymdo.Runner(port_env, port, mode="sync")


# ---------------------------------------------------------------------------
# The quickstart twin
# ---------------------------------------------------------------------------

def test_quickstart_main_on_cpu(capsys, tmp_path):
    out = tmp_path / "qs.json"
    rep = quickstart.main(["--device", "cpu", "--episodes", "1", "--steps",
                           "8", "--eval-episodes", "1", "--json", str(out)])
    lines = capsys.readouterr().out.splitlines()
    for name in ("LyMDO", "Local", "Edge", "Random", "Oracle"):
        assert any(l.startswith(f"{name:7s} @2.5req/s: delay") for l in lines), name
    assert (rep["device"], rep["episodes"], rep["steps"]) == ("cpu", 1, 8)
    assert set(rep["history"]) == set(SUMMARY + UPDATE)
    assert all(len(v) == 1 for v in rep["history"].values())
    assert int(rep["train_state"].opt_state.step) == 8
    assert rep["shapes"] == {n: [8, 5] for n in ("LyMDO", "Local", "Edge",
                                                 "Random", "Oracle")}
    assert isinstance(rep["agent"].policy, p_pol.CategoricalPolicy)
    b = rep["baselines"]
    assert b["Edge"]["cut_mean"] == 0.0
    assert b["Oracle"]["reward"] >= max(b["Local"]["reward"],
                                        b["Edge"]["reward"]) - 1e-3
    for m in [rep["lymdo"], *b.values()]:
        assert all(np.isfinite(v) for v in m.values())
    saved = json.loads(out.read_text())
    assert "agent" not in saved and saved["baselines"]["Oracle"] == b["Oracle"]
