"""LyMDO training with checkpoints: kill it mid-run and run it again, and
it resumes from the last checkpoint.

    PYTHONPATH=src python -m repro_torch.train_lymdo [--device cpu]
        [--episodes 300] [--chunk 25] [--steps 200] [--eval-episodes 5]
        [--ckpt-dir build/lymdo_ckpt] [--seed 0]

Trains PPO with the Gaussian cut head on the paper scenario (Sec. V-A) in
chunks of ``--chunk`` episodes, saving a checkpoint after each chunk
(``runtime.checkpoint``, keep-last-2), then evaluates at a fixed
2.5 req/s.  Each chunk draws from a generator seeded from
``(--seed, episodes done)``, so a run that is killed and resumed gives the
parameters of one that is not.  Runs on CUDA unless ``--device cpu``.
Port of ``examples/train_lymdo.py``; the defaults are its settings.
"""
from __future__ import annotations

import argparse

import numpy as np

from .core.env import LAM_FIXED, MecConfig, paper_env
from .core.lymdo import Runner
from .core.policies import GaussianTanhPolicy
from .core.ppo import PPO, PPOConfig
from .device import resolve_device
from .runtime.checkpoint import CheckpointManager


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--episodes", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eval-episodes", type=int, default=5)
    ap.add_argument("--ckpt-dir", default="build/lymdo_ckpt")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def chunk_seed(seed: int, done: int) -> int:
    """The seed of the chunk that starts after ``done`` episodes."""
    return int(np.random.SeedSequence([seed, done]).generate_state(1)[0])


def main(argv=None) -> dict:
    """Returns the report: settings, the episode it resumed from, each
    chunk's last reward and delay, the evaluation, and the trained
    ``train_state``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = paper_env(device=device)
    agent = PPO(GaussianTanhPolicy(env.obs_dim, env.L), env.obs_dim,
                PPOConfig())
    runner = Runner(env, agent, steps=args.steps)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    state = agent.init(env.generator(args.seed))
    start = 0
    if mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start = manifest["step"]
        print(f"[restore] resumed from episode {start}")

    chunks = []
    done = start
    while done < args.episodes:
        n = min(args.chunk, args.episodes - done)
        gen = env.generator(chunk_seed(args.seed, done))
        state, metrics = runner._train_chunk(state, gen, n)
        done += n
        reward = float(metrics["reward"][-1])
        delay = float(metrics["delay"][-1])
        chunks.append({"episodes": done, "reward": reward, "delay": delay})
        print(f"ep {done:4d}/{args.episodes} reward {reward:9.2f} "
              f"delay {delay * 1e3:7.1f} ms")
        mgr.save(done, state, extra={"episodes": done})
    mgr.wait()

    eval_env = paper_env(MecConfig(lam_mode=LAM_FIXED), device=device)
    m, _ = Runner(eval_env, agent, steps=args.steps).evaluate(
        state, episodes=args.eval_episodes)
    print(f"\nfinal eval @2.5 req/s: delay {m['delay'] * 1e3:.1f} ms, "
          f"reward {m['reward']:.2f} (checkpoints in {args.ckpt_dir})")
    return {"device": device.type, "episodes": args.episodes,
            "chunk": args.chunk, "steps": args.steps, "seed": args.seed,
            "resumed_from": start, "chunks": chunks, "eval": m,
            "train_state": state}


if __name__ == "__main__":
    main()
