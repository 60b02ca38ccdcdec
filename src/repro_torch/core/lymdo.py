"""LyMDO baseline runners (paper Sec. V-B: Local / Edge / Random + Oracle).

Port of the non-learning part of ``repro/core/lymdo.py``: ``run_fixed``
over one ``MecEnv`` and ``run_fixed_batched`` over a ``ScenarioGrid``.  All
reuse the exact convex allocators through ``step_p``.  An episode is K
slots; virtual queues reset at episode start.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _tree
from . import sweep
from .env import MecEnv, SlotResult
from .scenarios import random_policy


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
