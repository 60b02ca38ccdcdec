"""Quickstart: train the LyMDO controller and compare it with the baselines.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
        [--episodes 60] [--steps 200] [--eval-episodes 3] [--chunk 20]
        [--seed 0] [--json PATH]

Builds the Sec. V-A scenario (5 UEs: 2x AlexNet + 3x ResNet18), trains
PPO with the categorical cut head for ``--episodes`` episodes of
``--steps`` slots, then evaluates it at a fixed 2.5 req/s beside the
paper's Local, Edge and Random baselines and the decoupled Oracle (which
decides through the partition-sweep kernel on CUDA).  Runs on CUDA unless
``--device cpu``.  Port of ``examples/quickstart.py``; the defaults are
its settings.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from .core.env import LAM_FIXED, MecConfig, paper_env
from .core.lymdo import (Runner, RunConfig, edge_cut_fn, local_cut_fn,
                         oracle_cut_fn, random_cut_fn, run_fixed)
from .core.policies import CategoricalPolicy
from .core.ppo import PPO, PPOConfig
from .device import resolve_device

# entries of main's report that are objects, not numbers: left out of --json
OBJECTS = ("agent", "train_state")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eval-episodes", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, help="write the report here")
    return ap.parse_args(argv)


def _line(name: str, m: dict) -> str:
    return (f"{name:7s} @2.5req/s: delay {m['delay'] * 1e3:7.1f} ms  "
            f"energy {m['energy'] * 1e3:5.1f} mJ  reward {m['reward']:8.2f}")


def main(argv=None) -> dict:
    """Returns the report: settings, the training history, LyMDO's and each
    baseline's metrics, the shape of each one's last-episode results and
    the seconds each part took, plus the trained ``agent`` and its
    ``train_state``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    env = paper_env(device=device)
    print(f"MEC scenario: {env.n_ue} UEs, profiles "
          f"{[p.name for p in env.batch.profiles]}")

    agent = PPO(CategoricalPolicy(env.obs_dim, env.L), env.obs_dim, PPOConfig())
    runner = Runner(env, agent, steps=args.steps)
    print(f"\ntraining LyMDO ({args.episodes} episodes)...")
    t0 = time.perf_counter()
    state, hist = runner.train(RunConfig(episodes=args.episodes,
                                         steps=args.steps, seed=args.seed,
                                         chunk=args.chunk))
    sync()
    train_s = time.perf_counter() - t0

    eval_env = paper_env(MecConfig(lam_mode=LAM_FIXED), device=device)
    t0 = time.perf_counter()
    metrics, results = Runner(eval_env, agent, steps=args.steps).evaluate(
        state, episodes=args.eval_episodes)
    eval_s = time.perf_counter() - t0
    print("\n" + _line("LyMDO", metrics))
    # the (steps, N) shape of each method's last episode
    shapes = {"LyMDO": list(results.delay.shape)}

    baselines, baseline_s = {}, {}
    for name, fn in [("Local", local_cut_fn(eval_env)),
                     ("Edge", edge_cut_fn(eval_env)),
                     ("Random", random_cut_fn(eval_env)),
                     ("Oracle", oracle_cut_fn(eval_env))]:
        t0 = time.perf_counter()
        baselines[name], results = run_fixed(eval_env, fn,
                                             episodes=args.eval_episodes,
                                             steps=args.steps)
        baseline_s[name] = time.perf_counter() - t0
        shapes[name] = list(results.delay.shape)
        print(_line(name, baselines[name]))

    report = {
        "device": device.type, "episodes": args.episodes,
        "steps": args.steps, "eval_episodes": args.eval_episodes,
        "seed": args.seed, "train_s": train_s, "eval_s": eval_s,
        "baseline_s": baseline_s, "shapes": shapes,
        "history": {k: v.tolist() for k, v in hist.items()},
        "lymdo": metrics, "baselines": baselines,
        "agent": agent, "train_state": state,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump({k: v for k, v in report.items() if k not in OBJECTS},
                      f, indent=1)
    return report


if __name__ == "__main__":
    main()
