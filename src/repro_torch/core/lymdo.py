"""LyMDO training and evaluation (Algorithm 1) and the baseline runners.

Port of ``repro/core/lymdo.py``.  An episode is K time slots (paper:
K = 200); virtual queues reset at episode start (Algorithm 1 line 5).  The
replay memory holds exactly one episode and is consumed by a PPO update
when filled (lines 16-27).  Where the reference jits the rollout and the
update into one ``lax.scan`` program, the port runs them eagerly: rollouts
under ``torch.no_grad()``, with no host synchronisation inside an episode.

The baselines (Local / Edge / Random + Oracle, paper Sec. V-B) are
``run_fixed`` over one ``MecEnv`` and ``run_fixed_batched`` over a
``ScenarioGrid``; ``eval_policy_batched`` runs a trained agent over a
grid.  All reuse the exact convex allocators through ``step_p``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from .. import _tree
from . import sweep
from .env import MecEnv, MecState, SlotResult, observe_p
from .policies import JointGaussianPolicy
from .ppo import PPO, Trajectory, TrainState
from .scenarios import random_policy


@dataclasses.dataclass(frozen=True)
class RunConfig:
    episodes: int = 500
    steps: int = 200           # K, slots per episode
    seed: int = 0
    chunk: int = 25            # episodes per chunk (logging cadence)
    log: bool = True


def _summarize(results: SlotResult) -> dict:
    """Per-episode means/finals used by the paper's figures."""
    return {
        "reward": torch.mean(results.reward),
        "delay": torch.mean(torch.mean(results.delay, dim=-1)),
        "energy": torch.mean(torch.mean(results.energy, dim=-1)),
        "mem": torch.mean(torch.mean(results.mem_cost, dim=-1)),
        "q_energy_final": torch.mean(results.q_energy[-1]),
        "q_memory_final": torch.mean(results.q_memory[-1]),
        "cut_mean": torch.mean(results.cut.to(torch.float32)),
    }


class Runner:
    """Binds (env, agent) into episode, training and evaluation loops.

    ``mode``:
      * "lymdo": the agent picks the cut; convex optimization allocates
        resources (the paper's algorithm).
      * "joint": the agent picks cut + alpha + f_ue + f_es (the paper's
        "PPO" baseline); needs a ``JointGaussianPolicy``.
    """

    def __init__(self, env: MecEnv, agent: PPO, steps: int = 200,
                 mode: str = "lymdo"):
        if mode not in ("lymdo", "joint"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "joint" and not isinstance(agent.policy, JointGaussianPolicy):
            raise ValueError("joint mode needs JointGaussianPolicy")
        self.env, self.agent, self.steps, self.mode = env, agent, steps, mode

    def _apply(self, state: MecState, action, draws=None):
        if self.mode == "joint":
            cut, alpha, f_ue, f_es = self.agent.policy.split(action)
            return self.env.step_joint(state, cut, alpha, f_ue, f_es, draws)
        return self.env.step(state, self.agent.policy.to_cut(action), draws)

    @torch.no_grad()
    def episode(self, params, gen, deterministic: bool = False, draws=None,
                noise=None):
        """One K-slot episode: reset, then per slot observe, act (the mean
        action when ``deterministic``: Fig. 4 evaluates policies without
        exploration noise) and step; then the critic at the final state.

        ``draws=(gains, lams)``, each (K + 1, N), replaces the channel and
        arrival draws (entry 0 at reset, entry t + 1 after slot t);
        ``noise`` (K, ...) replaces each slot's action draw (see
        ``policies``).  Returns ``(Trajectory, summary, results)``.
        """
        env, agent = self.env, self.agent
        at = (lambda t: None) if draws is None else (
            lambda t: (draws[0][t], draws[1][t]))
        st = env.reset(gen, at(0))
        cols = {"obs": [], "action": [], "logp": [], "value": []}
        slots = []
        for t in range(self.steps):
            obs = env.observe(st)
            action, logp, value = agent.act(
                params, obs, gen, None if noise is None else noise[t])
            if deterministic:
                action = agent.policy.mean_action(params["pi"], obs)
            st, res = self._apply(st, action, at(t + 1))
            for name, x in zip(cols, (obs, action, logp, value)):
                cols[name].append(x)
            slots.append(res)
        results = _tree.stack(slots)
        traj = Trajectory(**{k: torch.stack(v) for k, v in cols.items()},
                          reward=results.reward,
                          last_value=agent.value(params, env.observe(st)))
        return traj, _summarize(results), results

    def _train_chunk(self, state: TrainState, gen, n: int, draws=None,
                     noise=None):
        """``n`` episodes, each followed by a PPO update.  ``draws`` and
        ``noise`` hold one ``episode`` argument per episode on a leading
        (n,) axis.  Returns the state and each metric stacked (n,)."""
        rows = []
        for i in range(n):
            traj, metrics, _ = self.episode(
                state.params, gen,
                draws=None if draws is None else (draws[0][i], draws[1][i]),
                noise=None if noise is None else noise[i])
            state, upd = self.agent.update(state, traj)
            rows.append({**metrics, **upd})
        return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def train(self, cfg: RunConfig = RunConfig()):
        """Init from ``cfg.seed``, then ``cfg.episodes`` episodes in chunks
        of ``cfg.chunk``.  Returns ``(state, history)``: each history entry
        an (episodes,) numpy array."""
        gen = self.env.generator(cfg.seed)
        state = self.agent.init(gen)
        history: dict[str, list] = {}
        done = 0
        t0 = time.time()
        while done < cfg.episodes:
            n = min(cfg.chunk, cfg.episodes - done)
            state, metrics = self._train_chunk(state, gen, n)
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            for k, val in metrics.items():
                history.setdefault(k, []).append(val)
            done += n
            if cfg.log:
                print(f"  ep {done:5d}/{cfg.episodes} "
                      f"reward {metrics['reward'][-1]:9.3f} "
                      f"delay {metrics['delay'][-1]:7.4f}s "
                      f"({time.time() - t0:5.1f}s)")
        return state, {k: np.concatenate(v) for k, v in history.items()}

    def evaluate(self, state: TrainState, episodes: int = 10, seed: int = 1234):
        """Deterministic-policy evaluation: per-episode metric means and the
        last episode's full result stack (for Fig. 5-style traces)."""
        gen = self.env.generator(seed)
        all_metrics: dict[str, list] = {}
        results = None
        for _ in range(episodes):
            _, metrics, results = self.episode(state.params, gen,
                                               deterministic=True)
            values = torch.stack(list(metrics.values())).tolist()  # one sync
            for name, val in zip(metrics, values):
                all_metrics.setdefault(name, []).append(val)
        return {k: float(np.mean(v)) for k, v in all_metrics.items()}, results


def run_fixed(env: MecEnv, cut_fn: Callable, episodes: int, steps: int,
              seed: int = 0):
    """cut_fn(state, generator) -> (N,) int cuts.

    Returns (metrics, last_results): metric means over episodes as floats,
    and the last episode's (steps, N) result stack.
    """
    gen = env.generator(seed)
    agg: dict[str, list] = {}
    results = None
    for _ in range(episodes):
        st = env.reset(gen)
        slots = []
        for _ in range(steps):
            st, res = env.step(st, cut_fn(st, gen))
            slots.append(res)
        results = _tree.stack(slots)
        for name, val in _summarize(results).items():
            agg.setdefault(name, []).append(float(val))
    return {k: float(np.mean(v)) for k, v in agg.items()}, results


def local_cut_fn(env: MecEnv):
    return lambda st, gen: env.L


def edge_cut_fn(env: MecEnv):
    return lambda st, gen: torch.zeros_like(env.L)


def random_cut_fn(env: MecEnv):
    return lambda st, gen: random_policy(env.params, st, gen)


def oracle_cut_fn(env: MecEnv):
    """The decoupled Oracle through the partition-sweep kernel on CUDA."""
    scalars = sweep.scalar_rows_p(env.params)
    return lambda st, gen: sweep.kernel_oracle_cut_p(env.params, st, scalars)


def run_fixed_batched(grid, policy="oracle", episodes: int = 1,
                      steps: int = 200, seed: int = 0):
    """Batched analogue of :func:`run_fixed` over a ``ScenarioGrid``.

    ``policy`` is a ``scenarios.POLICIES`` name or a callable
    ``(params, states, generator) -> (B, N) cuts``.  Returns (metrics,
    last_results): metrics maps each summary name to a (B,) numpy array of
    per-cell means over episodes; last_results is the final episode's
    (steps, B, N) result stack.

    A grid sharded over a cells mesh (``grid.use_mesh(...)``; see
    ``repro_torch.core.gridshard``) is taken transparently: each rank runs
    its shard, and every rank returns the logical-B outputs, equal to the
    unsharded run's to 1e-5.
    """
    rollout = grid.make_rollout(policy, steps)
    gen = grid.generator(seed)
    agg: dict[str, list] = {}
    results = None
    for _ in range(episodes):
        _, results, summary = rollout(gen)
        for name, val in summary.items():
            agg.setdefault(name, []).append(val.cpu().numpy())
    return {k: np.mean(np.stack(v), axis=0) for k, v in agg.items()}, results


def eval_policy_batched(grid, agent: PPO, train_state: TrainState,
                        episodes: int = 1, steps: int = 200, seed: int = 1234):
    """Deterministic-policy LyMDO evaluation across every cell of a grid.

    The one trained agent acts per cell on that cell's observation, and all
    cells advance together (on a sharded grid each rank's shard, as in
    :func:`run_fixed_batched`).  Cells must have the per-UE layer counts the
    policy head was built with: ``to_cut`` maps actions onto the policy's
    own L, so a deeper cell would never receive its deep cuts.
    """
    pol_L = agent.policy.num_layers.cpu().numpy()
    grid_L = grid.params.L.cpu().numpy()
    if (pol_L.shape != grid_L.shape[-1:]
            or not np.array_equal(np.broadcast_to(pol_L, grid_L.shape), grid_L)):
        raise ValueError(
            f"policy layer counts {pol_L} do not match every grid cell's L "
            f"{grid_L}; eval_policy_batched needs cells with the profiles "
            "the policy was trained for")
    pi_params = train_state.params["pi"]
    ues = grid.ue_sharding

    def act(params, states, gen):
        del gen
        if ues is not None:
            # the head reads the whole cell: one all-gather of the UE
            # columns; every "model" rank takes the mean action, each
            # keeps its cuts
            gain, lam, qe, qm = ues.ue_whole(
                [states.gain, states.lam, states.queues.energy,
                 states.queues.memory])
            states = dataclasses.replace(
                states, gain=gain, lam=lam,
                queues=type(states.queues)(qe, qm))
        y = agent.policy.mean_action(pi_params, observe_p(params, states))
        cuts = agent.policy.to_cut(y)
        return cuts if ues is None else ues.ue_own(cuts)

    with torch.no_grad():
        return run_fixed_batched(grid, act, episodes=episodes, steps=steps,
                                 seed=seed)
