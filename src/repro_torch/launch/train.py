"""LM training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b
        [--smoke] [--device cpu] [--steps 100] [--batch 8] [--seq 64]
        [--lr 1e-3] [--ckpt-dir DIR] [--ckpt-every 50]

Port of ``repro/launch/train.py`` for one device, on CUDA unless ``--device
cpu``: ``--arch`` from a seeded random init (``--smoke``: the reduced
config of the same family, float32; on CUDA its heads widen to the
attention kernels' smallest head dim, as ``launch.serve`` does) trains on
the synthetic stream with ``models.steps.make_train_step``, in the
microbatches the reference's sharding policy recommends, checkpointing
every ``--ckpt-every`` steps (with the stream's ``data_step``) and resuming
from the latest checkpoint in ``--ckpt-dir``; ``StragglerMonitor`` times
every step, each ended by a device synchronisation.  ``--multi-pod``
builds ``launch.mesh.make_production_mesh(multi_pod=True)``: on any world
but 512 ranks it raises ``ValueError``, as the reference's
``jax.make_mesh`` does; on 512 it raises ``NotImplementedError``, since
data-parallel training needs the gradient sync of
``runtime/compression.py`` (ROADMAP queue 1, item 7c).
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..configs.base import get_config, reduced
from ..data.pipeline import for_arch
from ..device import resolve_device
from ..models import transformer
from ..models.steps import default_microbatches, make_train_step
from ..profiling.roofline import param_count
from ..runtime.checkpoint import CheckpointManager
from ..runtime.resilience import StragglerMonitor
from .serve import kernel_head_dim

SEED = 0


def recommended_microbatches(cfg):
    """The training microbatch count of the reference's recommended
    sharding options (``repro/launch/sharding.py::recommended_options(cfg,
    "train").microbatches``), without the sharding itself: 4 for an MoE
    whose experts would be resident (over 8 GB of expert weights in bf16),
    2 for a dense, SSM or hybrid model under 8 B parameters, 8 for a larger
    dense one; None (take ``default_microbatches``) for the other MoE and
    the encoder-decoder."""
    if cfg.n_experts:
        expert_params = (cfg.n_experts * (3 if cfg.gated_ffn else 2)
                         * cfg.d_model * cfg.resolved_moe_dff)
        return 4 if expert_params * 2 > 8e9 else None
    if cfg.enc_layers:
        return None
    return 2 if param_count(cfg) < 8e9 else 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config (float32)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 512-rank production mesh (torchrun)")
    return ap.parse_args(argv)


def setup(args) -> dict:
    """The run's pieces: device, config, parameters and optimizer state
    (restored from ``--ckpt-dir``'s latest checkpoint where one exists),
    stream, train step, checkpoint manager and first step."""
    if args.multi_pod:
        from .mesh import init_group, make_production_mesh
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            init_group(device=args.device)      # torchrun's ranks
        make_production_mesh(multi_pod=True)
        raise NotImplementedError(
            "training on the production mesh needs the data-parallel "
            "gradient sync (runtime/compression.py), which is not ported "
            "yet (ROADMAP queue 1, item 7c)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg, **kernel_head_dim(device))
    params = transformer.init_params(SEED, cfg, device)
    stream = for_arch(cfg, batch=args.batch, seq=args.seq, device=device)
    mb = min(recommended_microbatches(cfg)
             or default_microbatches(cfg, args.batch), args.batch)
    opt_init, train_step = make_train_step(cfg, lr=args.lr, microbatches=mb)
    opt = opt_init(params)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        (params, opt), manifest = mgr.restore((params, opt))
        start = manifest["step"]
        print(f"[restore] resuming at step {start}")
    return {"device": device, "cfg": cfg, "params": params, "opt": opt,
            "stream": stream, "microbatches": mb, "train_step": train_step,
            "mgr": mgr, "start": start}


def main(argv=None) -> dict:
    args = parse_args(argv)
    run = setup(args)
    device, cfg = run["device"], run["cfg"]
    params, opt, mgr = run["params"], run["opt"], run["mgr"]
    print(f"[train] {cfg.name}: "
          f"{transformer.param_count(params) / 1e6:.2f}M params "
          f"({cfg.n_layers} layers, {cfg.param_dtype}) on {device}, "
          f"microbatches {run['microbatches']}")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    mon = StragglerMonitor()
    losses, step_s = {}, []
    t0 = time.time()
    for step in range(run["start"], args.steps):
        mon.start_step(step)
        params, opt, metrics = run["train_step"](
            params, opt, run["stream"].get_batch(step))
        sync()        # the step's time is the device's, not the enqueue's
        slow = mon.end_step()
        step_s.append(mon.window[-1])
        losses[step] = metrics["loss"]
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f}"
                  f" ({time.time() - t0:.1f}s)"
                  + ("  [straggler]" if slow else ""), flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, (params, opt), extra={"data_step": step + 1})
    if mgr:
        mgr.wait()
    if mon.events:
        print(f"[stragglers] {len(mon.events)} slow steps flagged")
    return {"arch": cfg.name, "device": str(device),
            "microbatches": run["microbatches"], "start": run["start"],
            "params": params, "opt": opt,
            "losses": {s: float(v) for s, v in losses.items()},
            "step_s": step_s, "stragglers": len(mon.events)}


if __name__ == "__main__":
    main()
