"""Rank bodies for the port's sharded-grid tests: each runs inside a world
that ``repro_torch.launch.mesh.run_world`` spawns (gloo, CPU) and returns
numpy outputs for the test process to hold against its unsharded runs.
Imports no JAX: the reference's inputs arrive as numpy arguments.

Shared here too: how the test process builds the same grids and runs the
same cases unsharded, so both sides run one definition.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import gridshard
from repro_torch.core import scenarios as sc
from repro_torch.core.lymdo import eval_policy_batched, run_fixed_batched
from repro_torch.core.policies import GaussianTanhPolicy
from repro_torch.core.ppo import PPO, PPOConfig

POLICIES = ("oracle", "local", "edge", "random")
STEPS = 6               # slots a parity rollout
REG_B, REG_STEPS = 3, 4  # the registry-wide cases
UES, SEED = 3, 5
EVAL_RATES = (1.0, 1.5, 2.0)


def _np(tree):
    return _tree.map_tensors(lambda x: x.detach().cpu().numpy(), tree)


def multicell(b: int, device="cpu", mesh=None, pad_to=None):
    grid = sc.ScenarioGrid(sc.multicell_grid(cells=b, ues=UES, seed=SEED),
                           device=device)
    return grid if mesh is None else grid.use_mesh(mesh, pad_to=pad_to)


def registry_grid(name: str, mesh=None):
    grid = sc.ScenarioGrid([sc.make(name) for _ in range(REG_B)],
                           device="cpu")
    return grid if mesh is None else grid.use_mesh(mesh)


def rollout(grid, policy: str, steps: int = STEPS, seed: int = 3,
            draws=None):
    """(final states, results, summary) as numpy, the generator dropped."""
    states, res, summary = grid.make_rollout(policy, steps, draws=draws)(seed)
    states = dict(t=states.t, gain=states.gain, lam=states.lam,
                  q_energy=states.queues.energy,
                  q_memory=states.queues.memory)
    return _np({"states": states, "results": res._asdict(),
                "summary": summary})


def runners(grid) -> dict:
    """``run_fixed_batched`` (Local, 2 episodes) and
    ``eval_policy_batched`` (a seeded Gaussian head) on ``grid``'s twin
    of three Fig. 4 cells; ``grid`` is the multicell one."""
    m_fixed, r_fixed = run_fixed_batched(grid, "local", episodes=2, steps=4,
                                         seed=11)
    rates = sc.grid_from_names([("fixed_rate", {"rate": r})
                                for r in EVAL_RATES], device="cpu")
    if grid.gridshard is not None:
        rates.use_mesh(grid.gridshard.mesh)
    env = rates.scenarios[0].build("cpu")
    agent = PPO(GaussianTanhPolicy(env.obs_dim, env.L, device="cpu"),
                env.obs_dim, PPOConfig())
    state = agent.init(torch.Generator().manual_seed(0))
    m_eval, r_eval = eval_policy_batched(rates, agent, state, episodes=1,
                                         steps=4)
    return {"fixed": m_fixed, "fixed_delay": r_fixed.delay.numpy(),
            "eval": m_eval, "eval_delay": r_eval.delay.numpy()}


def layout_round_trip(mesh, shapes) -> list:
    """pad -> local -> gather -> unpad on the real group, for each
    (b, extra, k), lead 0 and lead 1: returns the joined trees (the test
    checks each against its input, which it rebuilds from the same seed)."""
    out = []
    n = mesh.size(0)
    for b, extra, k in shapes:
        gs = gridshard.plan(b, mesh, pad_to=-(-b // n) * n + extra * n)
        tree, seq = layout_tree(b, k)
        mine = gridshard.local(gridshard.pad_cells(tree, gs), gs)
        back = gridshard.unpad(gridshard.gather(mine, gs), gs)
        back["seq"] = gridshard.unpad(gridshard.gather(
            gridshard.local(seq, gs, lead=1), gs, lead=1), gs, lead=1)
        out.append(_np(back))
    return out


def layout_tree(b: int, k: int) -> tuple[dict, torch.Tensor]:
    """A tree of b-cell leaves of every rank with a scalar rider, and a
    (4, b, k) leaf whose cell axis is its second."""
    rng = np.random.default_rng(b * 100 + k)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    return ({"vec": f(b), "mat": f(b, k), "cube": f(b, k, 3),
             "ints": torch.as_tensor(rng.integers(0, 9, (b, k))),
             "scalar": torch.tensor(1.5)}, f(4, b, k))


def parity_world(cases: dict) -> dict:
    """Every case a rank can run on the default group's cells mesh:

    * ``"policies"``: (b, pad_to) pairs, each rolled out under every policy;
    * ``"registry"``: each registered scenario at ``REG_B`` cells, Oracle;
    * ``"runners"``: ``runners`` on a (b, pad_to) grid;
    * ``"ref_draws"``: (b, ues, steps, gains, lams) -- the reference
      rollout's draws -- rolled out under the Oracle on ``multicell_grid(b,
      ues)``;
    * ``"layout"``: ``layout_round_trip`` shapes.
    """
    from repro_torch.launch.mesh import make_cells_mesh
    mesh = make_cells_mesh()
    out: dict = {"rank": mesh.get_local_rank("cells")}
    for b, pad_to in cases.get("policies", ()):
        grid = multicell(b, mesh=mesh, pad_to=pad_to)
        out[("layout", b)] = (grid.b_local, grid.gridshard.pad,
                              grid._run_params.L.shape[0])
        for policy in POLICIES:
            out[("policy", b, policy)] = rollout(grid, policy)
    for name in cases.get("registry", ()):
        out[("registry", name)] = rollout(registry_grid(name, mesh),
                                          "oracle", REG_STEPS)
    if "runners" in cases:
        b, pad_to = cases["runners"]
        out["runners"] = runners(multicell(b, mesh=mesh, pad_to=pad_to))
    if "ref_draws" in cases:
        b, ues, steps, gains, lams = cases["ref_draws"]
        grid = sc.ScenarioGrid(sc.multicell_grid(b, ues), device="cpu",
                               mesh=mesh)
        out["ref_draws"] = rollout(grid, "oracle", steps, seed=0,
                                   draws=(gains, lams))
    if "layout" in cases:
        out["layout"] = layout_round_trip(mesh, cases["layout"])
    return out


def twins_world(out_dir: str, tc_argv: list, sweep_argv: list) -> dict:
    """``train_compare.main`` (``--out`` per rank) and
    ``scenario_sweep.main`` on the default group."""
    import torch.distributed as dist

    from repro_torch import scenario_sweep, train_compare
    rank = dist.get_rank()
    art = train_compare.main(tc_argv + ["--out", f"{out_dir}/r{rank}.json"])
    swept = scenario_sweep.main(sweep_argv)
    return {"fig4": art["fig4"], "sweep": swept}
