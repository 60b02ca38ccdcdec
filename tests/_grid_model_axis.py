"""Rank bodies for the grid's per-cell model axis
(tests/test_torch_grid_model_axis.py): each runs inside a world that
``repro_torch.launch.mesh.run_world`` spawns (gloo, CPU) and returns numpy
outputs for the test process to hold against its unsharded runs.  Imports
no JAX.

Shared here too: the grids and cases both sides run, so the test process
runs the same definitions unsharded.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import convex, gridshard
from repro_torch.core import scenarios as sc
from repro_torch.core.lymdo import eval_policy_batched
from repro_torch.core.policies import GaussianTanhPolicy
from repro_torch.core.ppo import PPO, PPOConfig

POLICIES = ("oracle", "local", "edge", "random")
# the policies whose cuts the reference computes as the port does (its
# Random draws its own stream)
REFERENCE_POLICIES = ("local", "edge", "oracle")
B, STEPS, SEED = 3, 2, 3
EVAL_RATES = (1.0, 1.5, 2.0)

# Every registered scenario, with knobs that give 4 UEs a cell where the
# scenario takes a fleet size (so "model" = 2 and 4 split it), and two at 5
# UEs, which neither divides: paper_table1 and peak_window replicate.
REGISTRY = {
    "paper_table1": {},
    "fixed_rate": dict(n_alexnet=2, n_resnet=2),
    "peak_window": {},
    "hetero_fleet": dict(n_ue=8),
    "mmpp_burst": dict(n_alexnet=2, n_resnet=2),
    "diurnal": dict(n_alexnet=2, n_resnet=2),
    "flash_crowd": dict(n_alexnet=2, n_resnet=2),
    "trace_replay": {},
}


def _np(tree):
    return _tree.map_tensors(lambda x: x.detach().cpu().numpy(), tree)


def registry_grid(key: str) -> sc.ScenarioGrid:
    name = key.split("@")[0]
    return sc.ScenarioGrid([sc.make(name, **REGISTRY[key])
                            for _ in range(B)], device="cpu")


def rate_grid() -> sc.ScenarioGrid:
    return sc.grid_from_names([("fixed_rate", {"rate": r, "n_alexnet": 2,
                                               "n_resnet": 2})
                               for r in EVAL_RATES], device="cpu")


def rollout(grid, policy: str, steps: int = STEPS, seed: int = SEED,
            draws=None):
    """(final states, results, summary) as numpy, the generator dropped;
    ``draws=(gains, lams)`` replaces the channel and arrival draws."""
    states, res, summary = grid.make_rollout(policy, steps, draws)(seed)
    states = dict(t=states.t, gain=states.gain, lam=states.lam,
                  q_energy=states.queues.energy,
                  q_memory=states.queues.memory)
    return _np({"states": states, "results": res._asdict(),
                "summary": summary})


def eval_ppo(grid) -> dict:
    """``eval_policy_batched`` of a seeded Gaussian head on ``grid``."""
    env = grid.scenarios[0].build("cpu")
    agent = PPO(GaussianTanhPolicy(env.obs_dim, env.L, device="cpu"),
                env.obs_dim, PPOConfig())
    state = agent.init(torch.Generator().manual_seed(0))
    metrics, res = eval_policy_batched(grid, agent, state, episodes=1,
                                       steps=STEPS)
    return {"metrics": metrics, "delay": res.delay.numpy(),
            "cut": res.cut.numpy()}


def on_draws(draws: dict, key: str, policy: str):
    """The draws a rollout of ``key`` under ``policy`` takes: the
    reference's (``draws[key]``, (gains, lams)) under REFERENCE_POLICIES,
    the grid's own (each rank drawing the logical tensor and keeping its
    block) under the others."""
    return draws[key] if policy in REFERENCE_POLICIES else None


def slot_collectives(grid, steps: int) -> int:
    """The "model" collectives of ``steps`` Oracle slots, the end's
    gathers left out."""
    before = gridshard.calls["ue_whole"]
    rollout(grid, "oracle", steps)
    return gridshard.calls["ue_whole"] - before


def model_world(models: list, draws: dict) -> dict:
    """For each ("model" size M, policies) of ``models``: every
    ``REGISTRY`` grid under those policies (``on_draws``' draws);
    ``eval_policy_batched``; and the collectives a slot at P5's own
    iteration counts and at others."""
    from repro_torch.launch.mesh import make_cells_mesh
    out: dict = {}
    for m, policies in models:
        mesh = make_cells_mesh(model=m)
        out[("coords", m)] = (mesh.get_local_rank("cells"),
                              mesh.get_local_rank("model"))
        for key in REGISTRY:
            grid = registry_grid(key).use_mesh(mesh)
            out[("split", m, key)] = grid.ue_sharding is not None
            for policy in policies:
                out[("rollout", m, key, policy)] = rollout(
                    grid, policy, draws=on_draws(draws, key, policy))
        out[("eval", m)] = eval_ppo(rate_grid().use_mesh(model=m))
        grid = registry_grid("hetero_fleet").use_mesh(mesh)
        counts = [slot_collectives(grid, 1), slot_collectives(grid, 2)]
        outer, inner = convex._OUTER_ITERS, convex._INNER_ITERS
        convex._OUTER_ITERS, convex._INNER_ITERS = 7, 5
        try:
            counts.append(slot_collectives(grid, 2))
        finally:
            convex._OUTER_ITERS, convex._INNER_ITERS = outer, inner
        out[("collectives", m)] = counts
    return out
