"""LM training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b
        [--smoke] [--device cpu] [--steps 100] [--batch 8] [--seq 64]
        [--lr 1e-3] [--ckpt-dir DIR] [--ckpt-every 50]

Port of ``repro/launch/train.py``, on CUDA unless ``--device cpu``:
``--arch`` from a seeded random init (``--smoke``: the reduced config of the
same family, float32; on CUDA its heads widen to the attention kernels'
smallest head dim, as ``launch.serve`` does) trains on the synthetic
stream with ``models.steps.make_train_step``, in the microbatches the
reference's sharding policy recommends, checkpointing every
``--ckpt-every`` steps (with the stream's ``data_step``) and resuming from
the latest checkpoint in ``--ckpt-dir``; ``StragglerMonitor`` times every
step, each ended by a device synchronisation.

On a mesh (``main(argv, mesh=...)`` with a ``("data", "model")`` or
``("pod", "data", "model")`` ``DeviceMesh``, one process a rank) each rank
draws its shard of the same initial parameters
(``launch.sharding.init_rank_params``) and steps with
``make_mesh_train_step``: its rows of each logical batch over the data
axes, tensor parallelism over "model", the gradients averaged over the
data axes once a step.  A checkpoint on a mesh is the whole tree,
gathered one leaf at a time by the first replica's ranks
(``sharding.gathered_leaves``) and written by rank 0 as each leaf comes
(``save_checkpoint``); it is restored with ``restore(shardings=)``, so one
device and a mesh read each other's.  ``--multi-pod`` builds ``launch.mesh.make_production_mesh(
multi_pod=True)``: 512 ranks train on it, and any other world raises
``ValueError``, as the reference's ``jax.make_mesh`` does.
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
from ..models.common import dtype_of
from ..models.steps import (default_microbatches, make_train_step,
                            microbatch_grads)
from ..optim.adam import adam
from ..profiling.roofline import param_count
from ..runtime.checkpoint import CheckpointManager
from ..runtime.compression import make_dp_step
from ..runtime.resilience import StragglerMonitor
from ..shardctx import RankConfig, activation_sharding, mesh_axes
from .mesh import data_axes, data_size, is_rank0
from .serve import kernel_head_dim
from .sharding import (gathered_leaves, global_norm, init_rank_params,
                       params_shardings, reduce_partial_grads)

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


def make_mesh_train_step(mesh, cfg, lr: float = 3e-4,
                         weight_decay: float = 0.1, grad_clip: float = 1.0,
                         microbatches: int = 1):
    """``models.steps.make_train_step`` on ``mesh``, a ``("data",
    "model")`` or ``("pod", "data", "model")`` ``DeviceMesh``: ``cfg`` is
    the rank's view and ``params`` its shard (``sharding.place_params`` or
    ``init_rank_params``).  Returns ``(opt_init, train_step)``, and
    ``train_step(params, opt_state, batch)`` takes the logical batch: each
    rank takes its rows over the data axes, accumulates its microbatches
    under tensor parallelism over "model", sums over "model" the gradients
    that ranks hold in part (``sharding.reduce_partial_grads``), then
    averages the gradients over the data axes once a step
    (``runtime.compression.make_dp_step`` in mode "none", the reference's
    float32 psum) and clips on the whole model's global norm
    (``sharding.global_norm``).  Loss, ce and aux are the means over the
    data ranks."""
    if not data_axes(mesh):
        raise ValueError(f"a train step's mesh needs a data axis; its axes "
                         f"are {tuple(mesh.mesh_dim_names)}")
    sharded = isinstance(cfg, RankConfig) and cfg.model_size > 1
    opt_init, opt_update = adam(
        lr, weight_decay=weight_decay, grad_clip=grad_clip,
        state_dtype=dtype_of(cfg.opt_state_dtype),
        norm=(lambda g: global_norm(cfg, g)) if sharded else None)
    grads_of = microbatch_grads(cfg, microbatches)

    def rank_grads(params, rows):
        loss, ce, aux, grads = grads_of(params, rows)
        if sharded:
            grads = reduce_partial_grads(cfg, grads)
        return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                            for v in (loss, ce, aux)]), grads

    step = make_dp_step(mesh, rank_grads, opt_update, data_axes(mesh),
                        "none", error_feedback=False)

    def train_step(params, opt_state, batch):
        with activation_sharding(mesh):
            params, opt_state, _, stats = step(params, opt_state, None,
                                               batch)
        loss, ce, aux = stats.unbind()
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux}

    return opt_init, train_step


def save_checkpoint(mgr, mesh, cfg, step: int, tree) -> None:
    """Checkpoint ``tree`` (params and moments) at ``step``.  On a mesh the
    checkpoint is the whole tree: the ranks of the first replica (every
    axis but "model" at 0) gather it one leaf at a time
    (``sharding.gathered_leaves``), rank 0 writing each leaf as it comes;
    the other replicas gather nothing.  Every rank returns once the
    checkpoint is on disk."""
    extra = {"data_step": step}
    if mesh is None:
        mgr.save(step, tree, extra=extra)
        return
    first = all(mesh.get_local_rank(a) == 0
                for a in mesh.mesh_dim_names if a != "model")
    if first:
        with activation_sharding(mesh):
            leaves = gathered_leaves(cfg, tree)
            if is_rank0():
                mgr.save_leaves(step, leaves, extra=extra)
            else:
                for _ in leaves:
                    pass
    dist.barrier()


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


def setup(args, mesh=None) -> dict:
    """The run's pieces: device, config (on a mesh the rank's view),
    parameters and optimizer state (restored from ``--ckpt-dir``'s latest
    checkpoint where one exists), stream, train step, checkpoint manager
    and first step."""
    if args.multi_pod and mesh is None:
        from .mesh import init_group, make_production_mesh
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            init_group(device=args.device)      # torchrun's ranks
        mesh = make_production_mesh(multi_pod=True)
    device = resolve_device(args.device)
    model_cfg = get_config(args.arch)
    if args.smoke:
        model_cfg = reduced(model_cfg, **kernel_head_dim(device))
    if mesh is None:
        cfg = model_cfg
        params = transformer.init_params(SEED, cfg, device)
        rows = args.batch
    else:
        params, cfg = init_rank_params(SEED, mesh, model_cfg, device)
        n_data = data_size(mesh)
        if args.batch % n_data:
            raise ValueError(f"--batch {args.batch} does not split over the "
                             f"{n_data} data ranks")
        rows = args.batch // n_data
    stream = for_arch(model_cfg, batch=args.batch, seq=args.seq,
                      device=device)
    mb = min(recommended_microbatches(model_cfg)
             or default_microbatches(model_cfg, rows), rows)
    if mesh is None:
        opt_init, train_step = make_train_step(cfg, lr=args.lr,
                                               microbatches=mb)
    else:
        opt_init, train_step = make_mesh_train_step(mesh, cfg, lr=args.lr,
                                                    microbatches=mb)
    opt = opt_init(params)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        shardings = (None if mesh is None else
                     params_shardings(mesh, model_cfg, (params, opt)))
        (params, opt), manifest = mgr.restore((params, opt),
                                              shardings=shardings)
        start = manifest["step"]
        if is_rank0():
            print(f"[restore] resuming at step {start}")
    return {"device": device, "cfg": cfg, "params": params, "opt": opt,
            "stream": stream, "microbatches": mb, "train_step": train_step,
            "mgr": mgr, "start": start, "mesh": mesh}


def main(argv=None, mesh=None) -> dict:
    """Train; on ``mesh`` every rank runs this, and returns its shard of
    the parameters and moments."""
    args = parse_args(argv)
    run = setup(args, mesh)
    device, cfg = run["device"], run["cfg"]
    params, opt, mgr = run["params"], run["opt"], run["mgr"]
    say = print if is_rank0() else (lambda *a, **k: None)
    say(f"[train] {cfg.name}: "
        f"{transformer.param_count(params) / 1e6:.2f}M params a rank "
        f"({cfg.n_layers} layers, {cfg.param_dtype}) on {device}, "
        f"microbatches {run['microbatches']}"
        + ("" if run["mesh"] is None else
           f", mesh {dict(mesh_axes(run['mesh']))}"))
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
            say(f"step {step:5d} loss {float(metrics['loss']):.4f}"
                f" ({time.time() - t0:.1f}s)"
                + ("  [straggler]" if slow else ""), flush=True)
        if mgr and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(mgr, run["mesh"], cfg, step + 1, (params, opt))
    if mgr:
        mgr.wait()
    if mon.events:
        say(f"[stragglers] {len(mon.events)} slow steps flagged")
    return {"arch": cfg.name, "device": str(device),
            "microbatches": run["microbatches"], "start": run["start"],
            "params": params, "opt": opt,
            "losses": {s: float(v) for s, v in losses.items()},
            "step_s": step_s, "stragglers": len(mon.events)}


if __name__ == "__main__":
    main()
