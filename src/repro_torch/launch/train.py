"""LM training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b
        [--smoke] [--device cpu] [--steps 100] [--batch 8] [--seq 64]
        [--lr 1e-3] [--ckpt-dir DIR] [--ckpt-every 50]

Port of ``repro/launch/train.py``, on CUDA unless ``--device cpu``:
``--arch`` from a seeded random init (``--smoke``: the reduced config of the
same family, float32; on CUDA its heads widen to the attention kernels'
smallest head dim, as ``launch.serve`` does) trains on the synthetic
stream with ``models.steps.make_train_step``, in the microbatches the
reference's sharding policy recommends
(``sharding.recommended_options(cfg, "train")``), checkpointing every
``--ckpt-every`` steps (with the stream's ``data_step``) and resuming from
the latest checkpoint in ``--ckpt-dir``; ``StragglerMonitor`` times every
step, each ended by a device synchronisation.

On a mesh (``main(argv, mesh=...)`` with a ``("data", "model")`` or
``("pod", "data", "model")`` ``DeviceMesh``, one process a rank) each rank
draws its shard of the same initial parameters
(``launch.sharding.init_rank_params``) under those same recommended
options (for a model under 8 B parameters: every layer whole on each
model rank, the vocabulary split over "model", ZeRO-3 storage over
("data", "model")) and steps with ``make_mesh_train_step``: its rows of
each logical batch over the data axes, tensor parallelism over "model",
the gradients averaged over the data axes once a step.  This goes further
than the reference, whose launcher places nothing (``jax.jit(train_step)``
without shardings): an explicit-TP port runs the layout its policy
describes by placing it.  ``main(argv, mesh, opts=)`` takes other
options.  A checkpoint on a mesh is the whole tree,
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

from .. import _tree
from ..configs.base import get_config, reduced
from ..data.pipeline import for_arch
from ..device import resolve_device
from ..models import transformer
from ..models.common import dtype_of
from ..models.steps import (default_microbatches, make_train_step,
                            microbatch_grads)
from ..optim.adam import adam
from ..runtime.checkpoint import CheckpointManager
from ..runtime.compression import make_dp_step, make_grad_sync
from ..runtime.resilience import StragglerMonitor
from ..shardctx import (RankConfig, activation_sharding, mesh_axes,
                        seq_block, seq_parallel)
from .mesh import data_axes, data_size, is_rank0
from .serve import kernel_head_dim
from .sharding import (BASELINE, ShardingOptions, context_knobs,
                       gathered_leaves, global_norm, init_rank_params,
                       map_with_paths, params_shardings, recommended_options,
                       reduce_partial_grads, seq_partial)

SEED = 0


def make_mesh_train_step(mesh, cfg, lr: float = 3e-4,
                         weight_decay: float = 0.1, grad_clip: float = 1.0,
                         microbatches: int = 1,
                         opts: ShardingOptions = BASELINE):
    """``models.steps.make_train_step`` on ``mesh``, a ``("data",
    "model")`` or ``("pod", "data", "model")`` ``DeviceMesh``: ``cfg`` is
    the rank's view and ``params`` its shard (``sharding.place_params`` or
    ``init_rank_params``, under the same ``opts``).  Returns ``(opt_init,
    train_step)``, and ``train_step(params, opt_state, batch)`` takes the
    logical batch.  Its microbatches are the reference's, rows
    [m b, (m + 1) b) of the batch (b = B / microbatches), and each rank
    takes its equal part of each over the data axes, in rank order
    (``reference_microbatches``), so that the MoE's dispatch groups,
    formed over each microbatch's whole token stream across the data
    ranks (``activation_sharding(..., data_rows=True)``), are the
    reference's.  The rank accumulates its microbatches under tensor
    parallelism over "model" (under ``shardctx.activation_sharding`` with
    ``opts``' knobs: ``remat_offload``, ``seq_shard`` and the MoE's), sums
    over "model" the gradients that ranks hold in part
    (``sharding.reduce_partial_grads``), then averages the gradients over
    the data axes once a step (``runtime.compression.make_dp_step`` in
    mode "none", the reference's float32 psum) and clips on the whole
    model's global norm (``sharding.global_norm``).  A ZeRO-3 slice's
    gradient arrives reduce-scattered, the sum over its storage axes, and
    is scaled to the data axes' mean instead (a "model" rank in those
    axes computed the same gradient as the others, or under
    ``seq_shard`` its part of it); so is an expert leaf
    that "data" splits (``expert_shard_dff``, ``expert_mesh="data"``),
    whose gradient sums every data rank's tokens.  Adam then works on the
    slices.  Loss, ce and aux are the means over the data ranks."""
    from ..shardctx import zero_entry
    from .sharding import expert_data_dim
    if not data_axes(mesh):
        raise ValueError(f"a train step's mesh needs a data axis; its axes "
                         f"are {tuple(mesh.mesh_dim_names)}")
    sharded = isinstance(cfg, RankConfig) and (
        cfg.model_size > 1 or bool(cfg.zero) or bool(cfg.moe_data))
    opt_init, opt_update = adam(
        lr, weight_decay=weight_decay, grad_clip=grad_clip,
        state_dtype=dtype_of(cfg.opt_state_dtype),
        norm=(lambda g: global_norm(cfg, g)) if sharded else None)
    grads_of = microbatch_grads(cfg, microbatches)
    axes = mesh_axes(mesh)
    # the leaves each data rank holds its own part of: ZeRO-3 slices (the
    # sum over their storage axes) and expert leaves split over "data"
    owned = isinstance(cfg, RankConfig) and (bool(cfg.zero)
                                             or bool(cfg.moe_data))
    outer = tuple(a for a in data_axes(mesh) if a != "data")
    # the replicas of a slice over "pod" take their mean
    pod_mean = (make_grad_sync(mesh, outer, "none", False)
                if owned and outer else None)
    stored: list = []

    def entries(grads):
        if not stored:
            def entry(path, g):
                e = zero_entry(cfg, path)
                if e is None and expert_data_dim(cfg, path) is not None:
                    e = (None, ("data",))
                if e is not None:
                    e = (*e, seq_partial(cfg, path))
                stored.append(e)
            map_with_paths(entry, grads)
        return stored

    def rank_grads(params, rows):
        loss, ce, aux, grads = grads_of(params, rows)
        seq = seq_block(seq_parallel(cfg, rows["tokens"].shape[1]))
        if sharded:
            grads = reduce_partial_grads(cfg, grads, seq=seq)
        if owned:
            grads = _owned_mean(grads, entries(grads), seq)
        return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                            for v in (loss, ce, aux)]), grads

    def _owned_mean(grads, where, seq: bool):
        leaves = _tree.leaves(grads)
        mine = [g for g, e in zip(leaves, where) if e is not None]
        if pod_mean is not None:
            mine = pod_mean(mine, None)[0]
        it = iter(mine)
        out = []
        for g, e in zip(leaves, where):
            if e is None:
                out.append(g)
                continue
            n = 1
            for a in e[1]:
                # under sequence parallelism a slice's "model" ranks held
                # parts of its gradient, and their sum is the whole one
                if not (a == "model" and seq and e[2]):
                    n *= axes[a]
            out.append(next(it) / n)
        return _tree.unflatten(grads, out)

    local = None
    if owned:
        local = lambda grads: [e is not None for e in entries(grads)]
    step = make_dp_step(mesh, rank_grads, opt_update, data_axes(mesh),
                        "none", error_feedback=False, local=local)
    knobs = context_knobs(opts)

    n_data = data_size(mesh)

    def train_step(params, opt_state, batch):
        batch = reference_microbatches(batch, n_data, microbatches)
        with activation_sharding(mesh, **knobs, data_rows=True):
            params, opt_state, _, stats = step(params, opt_state, None,
                                               batch)
        loss, ce, aux = stats.unbind()
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux}

    return opt_init, train_step


def reference_microbatches(batch: dict, n: int, microbatches: int) -> dict:
    """The logical batch with its rows reordered so that the n data
    ranks' equal contiguous blocks (``runtime.compression.rows``) are each
    rank's part of the reference's microbatches in turn: block i holds
    rows [m b + i b / n, m b + (i + 1) b / n) for m = 0 .. microbatches -
    1 (b = B / microbatches), which ``models.steps.microbatch_grads``
    then cuts in order.  A batch that does not split so is returned as it
    is, for the rows' and the microbatches' own checks to refuse."""
    if n == 1 or microbatches == 1:
        return batch
    out = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % (n * microbatches):
            return batch
        out[key] = x.reshape(microbatches, n, b // (n * microbatches),
                             *x.shape[1:]).transpose(0, 1).reshape(x.shape)
    return out


def save_checkpoint(mgr, mesh, cfg, step: int, tree) -> None:
    """Checkpoint ``tree`` (params and moments) at ``step``.  On a mesh the
    checkpoint is the whole tree: the ranks of the first replica (every
    axis but "model" at 0; and every "data" rank, where ``cfg`` stores
    ZeRO-3 slices or expert leaves split over it) gather it one leaf at a
    time
    (``sharding.gathered_leaves``), rank 0 writing each leaf as it comes;
    the other replicas gather nothing.  Every rank returns once the
    checkpoint is on disk."""
    extra = {"data_step": step}
    if mesh is None:
        mgr.save(step, tree, extra=extra)
        return
    held = (("model", "data") if getattr(cfg, "zero", ())
            or getattr(cfg, "moe_data", "") else ("model",))
    first = all(mesh.get_local_rank(a) == 0
                for a in mesh.mesh_dim_names if a not in held)
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


def setup(args, mesh=None, opts: ShardingOptions | None = None) -> dict:
    """The run's pieces: device, config (on a mesh the rank's view, under
    ``opts``, by default ``recommended_options(cfg, "train")``),
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
    if opts is None:
        opts = recommended_options(model_cfg, "train")
    if mesh is None:
        cfg = model_cfg
        params = transformer.init_params(SEED, cfg, device)
        rows = args.batch
    else:
        params, cfg = init_rank_params(SEED, mesh, model_cfg, device, opts)
        n_data = data_size(mesh)
        if args.batch % n_data:
            raise ValueError(f"--batch {args.batch} does not split over the "
                             f"{n_data} data ranks")
        rows = args.batch // n_data
    stream = for_arch(model_cfg, batch=args.batch, seq=args.seq,
                      device=device)
    mb = min(opts.microbatches or default_microbatches(model_cfg, rows),
             rows)
    if mesh is None:
        opt_init, train_step = make_train_step(cfg, lr=args.lr,
                                               microbatches=mb)
    else:
        opt_init, train_step = make_mesh_train_step(
            mesh, cfg, lr=args.lr, microbatches=mb, opts=opts)
    opt = opt_init(params)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        shardings = (None if mesh is None else
                     params_shardings(mesh, model_cfg, (params, opt), opts))
        (params, opt), manifest = mgr.restore((params, opt),
                                              shardings=shardings)
        start = manifest["step"]
        if is_rank0():
            print(f"[restore] resuming at step {start}")
    return {"device": device, "cfg": cfg, "params": params, "opt": opt,
            "stream": stream, "microbatches": mb, "train_step": train_step,
            "mgr": mgr, "start": start, "mesh": mesh, "opts": opts}


def main(argv=None, mesh=None, opts: ShardingOptions | None = None) -> dict:
    """Train; on ``mesh`` every rank runs this, and returns its shard of
    the parameters and moments.  ``opts``: the layout (default
    ``recommended_options(cfg, "train")``, as the reference's launcher
    takes them)."""
    args = parse_args(argv)
    run = setup(args, mesh, opts)
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
    return {"arch": cfg.name, "device": str(device), "cfg": cfg,
            "microbatches": run["microbatches"], "start": run["start"],
            "params": params, "opt": opt,
            "losses": {s: float(v) for s, v in losses.items()},
            "step_s": step_s, "stragglers": len(mon.events)}


if __name__ == "__main__":
    main()
