"""LM data-plane driver: train a reduced qwen3 on the synthetic stream with
checkpoints and restart.

    PYTHONPATH=src python -m repro_torch.train_lm [--device cpu]
        [--steps 200] [--ckpt-dir build/lm_ckpt] [--ckpt-every 50]

Reduced qwen3-0.6b (4 layers, d_model 128, d_ff 256, 4 heads over 2 kv
heads of 32, vocabulary 512, float32) trains on ``for_arch``'s stream (B8,
S64) in 2 microbatches at lr 1e-3, saving a checkpoint every
``--ckpt-every`` steps (keep-last-2); run it again and it resumes from the
latest one, so a run that is killed and resumed gives the parameters of
one that is not.  Runs on CUDA unless ``--device cpu``.  Port of
``examples/train_lm.py``; the defaults are its settings, but for the
checkpoint directory, which stays inside the checkout.  The compressed
data-parallel sync waits for the mesh.
"""
from __future__ import annotations

import argparse

from .configs.base import get_config, reduced
from .data.pipeline import for_arch
from .device import resolve_device
from .models import transformer
from .models.steps import make_train_step
from .runtime.checkpoint import CheckpointManager
from .runtime.resilience import StragglerMonitor

SEED = 0


def model_config():
    return reduced(get_config("qwen3-0.6b"), n_layers=4, d_model=128,
                   d_ff=256, n_heads=4, n_kv=2, head_dim=32, vocab=512)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="build/lm_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config()
    params = transformer.init_params(SEED, cfg, device)
    print(f"model: {transformer.param_count(params) / 1e6:.2f}M params "
          f"on {device}")

    stream = for_arch(cfg, batch=8, seq=64, device=device)
    opt_init, train_step = make_train_step(cfg, lr=1e-3, microbatches=2)
    opt = opt_init(params)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    mon = StragglerMonitor(threshold=3.0)
    start = 0
    if mgr.latest_step() is not None:
        (params, opt), manifest = mgr.restore((params, opt))
        start = manifest["step"]
        print(f"[restore] resumed at step {start}")

    losses = {}
    for step in range(start, args.steps):
        mon.start_step(step)
        params, opt, metrics = train_step(params, opt, stream.get_batch(step))
        slow = mon.end_step()
        losses[step] = metrics["loss"]
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f}"
                  + ("  [straggler]" if slow else ""))
        if (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, (params, opt), extra={"data_step": step + 1})
    mgr.wait()
    print(f"done; checkpoints in {args.ckpt_dir}")
    return {"start": start, "params": params, "opt": opt,
            "losses": {s: float(v) for s, v in losses.items()}}


if __name__ == "__main__":
    main()
