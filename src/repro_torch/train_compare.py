"""The paper's experiment: train the three agents, then build the Fig. 3,
Fig. 4 and Fig. 5 artifacts and the headline ratios.

    PYTHONPATH=src python -m repro_torch.train_compare [--device cpu]
        [--episodes 1500] [--steps 200] [--eval-episodes 5]
        [--out build/paper_artifacts.json]

Writes ``--out`` with the keys of ``scripts/train_compare.py``'s artifact:
  * fig3: reward curves (LyMDO, LyMDO-categorical, PPO-joint);
  * fig4: {delay, energy, mem, ...} x arrival rate x algorithm;
  * fig5: per-slot energy-queue traces under the peak_window pattern;
  * the headline delay reductions against joint PPO at 2.5 req/s and
    fig5's peak energy-queue reductions.

Fig. 4's rate sweep is ONE ``ScenarioGrid`` of ``fixed_rate`` cells (the
trained heads through ``eval_policy_batched``, the baselines through
``run_fixed_batched``; the Oracle decides through the partition-sweep
kernel on CUDA), and Fig. 5 is the ``peak_window`` scenario.  Joint PPO
allocates resources itself (``env.step_joint``), so it evaluates per env.
As the reference does when more than one device is live, the grid is
sharded over a ``("cells",)`` mesh (``grid.use_mesh()``) when the default
process group has more than one rank:

    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.train_compare

Every rank trains the agents; rank 0's train states are broadcast before
the Fig. 4 grid, so every shard is evaluated with one policy, and only
rank 0 prints and writes ``--out``.  Runs on CUDA unless ``--device cpu``
(gloo then joins the ranks; NCCL on CUDA).  Port of
``scripts/train_compare.py``; the defaults are its settings.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch.distributed as dist

from .core.lymdo import (Runner, RunConfig, eval_policy_batched,
                         run_fixed_batched)
from .core.policies import (CategoricalPolicy, GaussianTanhPolicy,
                            JointGaussianPolicy)
from .core.ppo import PPO, PPOConfig
from .core.scenarios import grid_from_names, make
from .device import resolve_device
from .launch.mesh import broadcast_tree, init_group, is_rank0, world_size

RATES = [0.5, 1.0, 1.5, 2.0, 2.5]
AGENTS = (("lymdo", GaussianTanhPolicy, "lymdo"),
          ("lymdo_categorical", CategoricalPolicy, "lymdo"),
          ("ppo_joint", JointGaussianPolicy, "joint"))
BASELINES = ("local", "edge", "random", "oracle")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--episodes", type=int, default=1500)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eval-episodes", type=int, default=5)
    ap.add_argument("--out", default="build/paper_artifacts.json")
    return ap.parse_args(argv)


def say(*args, **kwargs) -> None:
    if is_rank0():
        print(*args, **kwargs)


def train_agents(args, device) -> tuple[dict, dict]:
    """The three agents trained on Table I's iid-uniform rates: name ->
    (agent, state, mode), and fig3's reward curves."""
    train_env = make("paper_table1").build(device)
    agents, fig3 = {}, {}
    for name, policy_cls, mode in AGENTS:
        t0 = time.time()
        if policy_cls is JointGaussianPolicy:
            pol = policy_cls(train_env.obs_dim, train_env.L,
                             train_env.cfg.f_max_ue, train_env.cfg.f_max_es)
        else:
            pol = policy_cls(train_env.obs_dim, train_env.L)
        agent = PPO(pol, train_env.obs_dim, PPOConfig())
        runner = Runner(train_env, agent, steps=args.steps, mode=mode)
        state, hist = runner.train(RunConfig(episodes=args.episodes,
                                             steps=args.steps, chunk=50,
                                             log=is_rank0()))
        agents[name] = (agent, state, mode)
        fig3[name] = {"reward_curve": [float(x) for x in hist["reward"]],
                      "train_s": time.time() - t0}
        say(f"[trained] {name} in {time.time() - t0:.0f}s", flush=True)
    return agents, fig3


def fig4_sweep(args, agents, device) -> dict:
    """rate -> algorithm -> metric means, every rate in one grid."""
    grid = grid_from_names([("fixed_rate", {"rate": r}) for r in RATES],
                           device=device)
    if world_size() > 1:
        grid.use_mesh()                        # ("cells",) over the ranks
    fig4 = {str(r): {} for r in RATES}

    def record(name, metrics):
        for b, rate in enumerate(RATES):
            fig4[str(rate)][name] = {k: float(v[b])
                                     for k, v in metrics.items()}

    for name in ("lymdo", "lymdo_categorical"):
        agent, state, _ = agents[name]
        metrics, _ = eval_policy_batched(grid, agent, state,
                                         episodes=args.eval_episodes,
                                         steps=args.steps)
        record(name, metrics)
    for name in BASELINES:
        metrics, _ = run_fixed_batched(grid, name,
                                       episodes=args.eval_episodes,
                                       steps=args.steps)
        record(name, metrics)
    agent_j, state_j, mode_j = agents["ppo_joint"]
    for rate in RATES:
        env_r = make("fixed_rate", rate=rate).build(device)
        m, _ = Runner(env_r, agent_j, steps=args.steps, mode=mode_j).evaluate(
            state_j, episodes=args.eval_episodes)
        fig4[str(rate)]["ppo_joint"] = {k: float(v) for k, v in m.items()}
    for rate in RATES:
        row = fig4[str(rate)]
        say(f"[fig4] rate {rate}: lymdo delay {row['lymdo']['delay']:.4f} "
            f"ppo {row['ppo_joint']['delay']:.4f} "
            f"local {row['local']['delay']:.4f} "
            f"oracle {row['oracle']['delay']:.4f}", flush=True)
    return fig4


def fig5_queues(args, agents, device) -> dict:
    """Per-slot energy queues of LyMDO and joint PPO under peak_window,
    averaged over the AlexNet UEs (0-1) and the ResNet18 UEs (2-4)."""
    peak_grid = grid_from_names([("peak_window", {"boost": 1.0})],
                                device=device)
    agent_l, state_l, _ = agents["lymdo"]
    _, results = eval_policy_batched(peak_grid, agent_l, state_l,
                                     episodes=1, steps=args.steps)
    qe_traces = {"lymdo": results.q_energy[:, 0, :].cpu().numpy()}
    agent_j, state_j, mode_j = agents["ppo_joint"]
    env_p = make("peak_window", boost=1.0).build(device)
    _, results_j = Runner(env_p, agent_j, steps=args.steps,
                          mode=mode_j).evaluate(state_j, episodes=1)
    qe_traces["ppo_joint"] = results_j.q_energy.cpu().numpy()
    return {name: {"alexnet_queue": qe[:, :2].mean(1).tolist(),
                   "resnet_queue": qe[:, 2:].mean(1).tolist()}
            for name, qe in qe_traces.items()}


def main(argv=None) -> dict:
    """Returns the artifact (the JSON written to ``--out``) with the
    trained ``agents`` beside it."""
    args = parse_args(argv)
    own = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    device = init_group(device=args.device) if own else resolve_device(
        args.device)
    try:
        return _run(args, device)
    finally:
        if own:
            dist.destroy_process_group()


def _run(args, device) -> dict:
    artifacts = {"episodes": args.episodes, "rates": RATES}
    agents, artifacts["fig3"] = train_agents(args, device)
    if world_size() > 1:
        # ranks that trained apart need not hold the same weights
        agents = {name: (agent, broadcast_tree(state), mode)
                  for name, (agent, state, mode) in agents.items()}
    fig4 = artifacts["fig4"] = fig4_sweep(args, agents, device)

    d_l = fig4["2.5"]["lymdo"]["delay"]
    d_j = fig4["2.5"]["ppo_joint"]["delay"]
    artifacts["headline_delay_reduction_vs_ppo"] = 1.0 - d_l / d_j
    best = min(d_l, fig4["2.5"]["lymdo_categorical"]["delay"])
    artifacts["headline_delay_reduction_best"] = 1.0 - best / d_j

    fig5 = artifacts["fig5"] = fig5_queues(args, agents, device)
    for task, idx in [("alexnet", "alexnet_queue"),
                      ("resnet", "resnet_queue")]:
        peak_l = max(fig5["lymdo"][idx])
        peak_j = max(fig5["ppo_joint"][idx])
        artifacts[f"fig5_{task}_queue_reduction"] = \
            1.0 - peak_l / max(peak_j, 1e-9)

    if is_rank0():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifacts, f)
    say("headline: %.1f%% delay reduction vs joint PPO (best %.1f%%)"
        % (100 * artifacts["headline_delay_reduction_vs_ppo"],
           100 * artifacts["headline_delay_reduction_best"]), flush=True)
    say(f"saved {args.out}")
    return {**artifacts, "agents": agents}


if __name__ == "__main__":
    main()
