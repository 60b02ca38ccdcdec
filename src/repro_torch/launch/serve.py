"""Serving launcher: the ES-side serving engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
        [--smoke] [--device cpu] [--requests 6] [--slots 2]
        [--prompt-len 16] [--max-new 8] [--sync-batching] [--multi-pod]

Builds ``--arch`` from a seeded random init (``--smoke``: the reduced
config of the same family, float32; on CUDA its heads widen from 16 to
the attention kernels' smallest head dim, 32) and serves ``--requests``
synthetic prompts of ``--prompt-len`` tokens, ``--max-new`` tokens each,
printing each request's latency, through the continuous-batching engine
or, with ``--sync-batching``, the synchronized-batch engine.  It serves
stacks of g/l/m/r/s layers (MoE stacks with whole-prompt prefill); it
refuses encoder stacks and the engine refuses "x" stacks.  Port of
``repro/launch/serve.py``, on CUDA unless ``--device cpu``:

* ``--smoke`` serves under ``launch.mesh.make_host_mesh()`` (1 x 1
  ``("data", "model")``, on a one-rank group it joins where none exists
  and leaves after) inside its activation-sharding context, as the
  reference does;
* ``--multi-pod`` serves tensor-parallel on ``make_production_mesh(
  multi_pod=True)``, 512 ranks launched by torchrun; on any other world it
  raises ``ValueError``, as the reference's ``jax.make_mesh`` does;
* under a mesh each rank draws only its shard of the weights, one layer
  at a time on the host (``launch.sharding.init_rank_params``);
* otherwise it serves the full config on one device, with no mesh (where
  the reference takes the 256-rank production mesh): the smoke's phase 9
  serves recurrentgemma-2b so on the card.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs.base import get_config, reduced
from ..device import resolve_device
from ..models import transformer
from ..serving import kvpool
from ..serving.engine import Request, ServingEngine
from .sharding import SERVING, init_rank_params

SEED = 0


def kernel_head_dim(device) -> dict:
    """The ``reduced`` override that a reduced config needs to run on
    ``device``: on CUDA the attention kernels' smallest head dim (the
    reduced configs' 16 is below it), printed; nothing on the CPU."""
    from ..kernels.ops import HEAD_DIMS
    if torch.device(device).type != "cuda":
        return {}
    print(f"[reduced] head dim widened from 16 to {min(HEAD_DIMS)} on "
          f"{device}: the attention kernels take {HEAD_DIMS}")
    return {"head_dim": min(HEAD_DIMS)}


def make_engine(cfg, params, *, slots: int, prompt_len: int,
                max_new: int, sync_batching: bool = False,
                mesh=None) -> ServingEngine:
    """The engine the launcher serves with: ``s_max`` leaves room for a
    ``prompt_len`` prompt, ``max_new`` tokens and 8 more."""
    return ServingEngine(cfg, params, slots=slots,
                         s_max=prompt_len + max_new + 8,
                         sync_batching=sync_batching, mesh=mesh)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (float32)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--multi-pod", action="store_true",
                    help="serve on the 512-rank production mesh (torchrun)")
    ap.add_argument("--sync-batching", action="store_true",
                    help="the synchronized-batch compat engine")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .mesh import init_group, make_host_mesh, make_production_mesh
    if args.multi_pod:
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            init_group(device=args.device)      # torchrun's ranks
        mesh = make_production_mesh(multi_pod=True)
        joined = False
    elif args.smoke:
        joined = not dist.is_initialized()
        mesh = make_host_mesh()
    else:
        mesh, joined = None, False
    try:
        return _serve(args, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, mesh) -> dict:
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg, **kernel_head_dim(device))
    if cfg.enc_layers:
        raise SystemExit("enc-dec serving needs source embeddings; the "
                         "launcher serves decoder stacks")
    # the engine's own check, made before the weights exist: an "x" stack
    # is refused here rather than after a full-width init
    kvpool.check_pattern(cfg, sync=args.sync_batching)
    if mesh is None:
        params = transformer.init_params(SEED, cfg, device)
    else:   # the rank's shard, drawn layer by layer: no whole tree
        params, cfg = init_rank_params(SEED, mesh, cfg, device, SERVING)
    n_params = transformer.param_count(params)
    print(f"[serve] {cfg.name}: {n_params / 1e6:.2f}M params"
          f"{'' if mesh is None else ' on this rank'} "
          f"({cfg.n_layers} layers, {cfg.param_dtype}) on {device}, "
          f"{args.slots} slots")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    eng = make_engine(cfg, params, slots=args.slots,
                      prompt_len=args.prompt_len, max_new=args.max_new,
                      sync_batching=args.sync_batching, mesh=mesh)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len)
                    .astype(np.int32), max_new=args.max_new)
            for i in range(args.requests)]
    t_submit = {}
    for r in reqs:
        eng.submit(r)
        t_submit[r.rid] = time.perf_counter()
    t_done = {}
    while eng.step():
        sync()
        for r in reqs:
            if r.done and r.rid not in t_done:
                t_done[r.rid] = time.perf_counter()
    sync()
    latency = {}
    for r in reqs:
        latency[r.rid] = (t_done.get(r.rid, time.perf_counter())
                          - t_submit[r.rid]) * 1e3
        print(f"  req {r.rid}: {len(r.out)} tokens, {latency[r.rid]:7.1f} ms, "
              f"out[:4]={r.out[:4]}")
    mode = "sync" if args.sync_batching else "continuous"
    print(f"[serve] {len(reqs)} requests in {eng.clock} engine steps "
          f"({mode}: {eng.decode_steps} decode dispatches, "
          f"{eng.prefill_steps} prefills and chunks, "
          f"{eng.prefill_compiles} prefill shapes, "
          f"{eng.preemptions} preemptions)")
    return {"arch": cfg.name, "layers": cfg.n_layers, "mode": mode,
            "dtype": cfg.param_dtype, "device": str(device),
            "params": n_params, "ticks": eng.clock,
            "decode_steps": eng.decode_steps,
            "prefill_steps": eng.prefill_steps,
            "chunk_steps": eng.chunk_steps, "chunk_tokens": eng.chunk_tokens,
            "preemptions": eng.preemptions,
            "prefill_shapes": sorted(eng._prefill_shapes),
            "out": {r.rid: list(r.out) for r in reqs},
            "latency_ms": latency}


if __name__ == "__main__":
    main()
