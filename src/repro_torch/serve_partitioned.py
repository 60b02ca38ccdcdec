"""Partitioned LM serving: the paper's loop on an LM workload, on the card.

    PYTHONPATH=src python -m repro_torch.serve_partitioned [--arch NAME]
        [--layers N] [--device cpu] [--requests 16] [--max-new 32] ...

The LyMDO controller watches the per-slot MEC state of 3 UEs (channels,
arrivals, virtual queues) over the arch's layer profile and picks the
partition cut with the Oracle for 3 slots; a ``PartitionedLM`` runs the
split at the chosen unit cut and at the middle unit, each checked against
the monolithic forward pass; then the ES tier serves a burst of requests
through the continuous-batching engine.  The model (``--arch``: a config
that ``PartitionedLM`` takes: qwen3-0.6b by default, mamba2-1.3b, or the
MoE stacks moonshot-v1-16b-a3b and llama4-maverick-400b-a17b) runs
at full width from a seeded random init (its full depth unless
``--layers`` cuts it), in bf16, on CUDA unless ``--device cpu``.  Port of
``examples/serve_partitioned.py``, which runs a reduced qwen3 on JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .configs import get_config
from .configs.base import load_all
from .core import sweep
from .core.env import MecConfig, MecEnv
from .device import resolve_device
from .models import transformer
from .profiling.lmprofiles import lm_profile
from .serving import kvpool
from .serving.engine import Request
from .serving.partitioned import PartitionedLM, layer_cut_to_unit


DEFAULT_ARCH = "qwen3-0.6b"
UES = 3                # UEs the controller decides for
CTRL_SLOTS = 3         # controller slots decided before the split runs
PROMPT_MIN = 8         # shortest prompt of the served burst
SEED = 0               # weights, controller state, split tokens, prompts


def partitionable() -> list[str]:
    """The configs ``PartitionedLM`` takes: plain stacks (no tail, no
    encoder) of the layer kinds the engine serves (g/l/m/r/s)."""
    return sorted(name for name, cfg in load_all().items()
                  if not cfg.tail_pattern and not cfg.enc_layers
                  and set(cfg.block_pattern) <= set(kvpool.SERVED))


def model_config(arch: str = DEFAULT_ARCH, layers: int | None = None,
                 dtype: str | None = None):
    """``arch`` at full width, its depth cut to ``layers`` and its parameter
    and compute dtype set to ``dtype`` where given."""
    cfg = get_config(arch)
    over = {}
    if layers:
        over["n_layers"] = layers
    if dtype:
        over.update(param_dtype=dtype, compute_dtype=dtype)
    return dataclasses.replace(cfg, **over) if over else cfg


def make_requests(cfg, n: int, lo: int, hi: int, max_new: int, seed: int):
    """``n`` requests with prompts of lo..hi random tokens."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(
                        lo, hi + 1))).astype(np.int32), max_new=max_new)
            for i in range(n)]


def serve(engine, requests, sync) -> dict:
    """Submit every request, step the engine until idle timing each tick
    (``sync()`` waits for the device), and return the tick times split into
    ticks that only decoded and ticks that also ran prefill work."""
    for r in requests:
        engine.submit(r)
    decode_ms, prefill_ms = [], []
    done = []
    t_start = time.perf_counter()
    while True:
        pre, dec = engine.prefill_steps, engine.decode_steps
        t0 = time.perf_counter()
        alive = engine.step()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        done += engine.pop_completed()
        if not alive:
            break
        if engine.prefill_steps > pre:
            prefill_ms.append(ms)
        elif engine.decode_steps > dec:
            decode_ms.append(ms)
    wall = time.perf_counter() - t_start
    generated = sum(len(r.out) for r in done)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")
    return {"completed": len(done), "requests": len(requests),
            "ticks": engine.clock, "decode_steps": engine.decode_steps,
            "prefill_steps": engine.prefill_steps,
            "chunk_steps": engine.chunk_steps,
            "chunk_tokens": engine.chunk_tokens,
            "preemptions": engine.preemptions, "wall_s": wall,
            "generated_tokens": generated, "tokens_per_s": generated / wall,
            "decode_tick_ms_p50": pct(decode_ms, 50),
            "decode_tick_ms_p99": pct(decode_ms, 99),
            "prefill_tick_ms_p50": pct(prefill_ms, 50),
            "prefill_tick_ms_p99": pct(prefill_ms, 99),
            "out": {r.rid: list(r.out) for r in done}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=DEFAULT_ARCH, choices=partitionable())
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--split-seq", type=int, default=16,
                    help="tokens per row of the split-vs-monolithic check")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-max", type=int, default=300)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--s-max", type=int, default=512)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg_full = get_config(args.arch)
    cfg = model_config(args.arch, args.layers)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    params = transformer.init_params(SEED, cfg, device)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    report = {"arch": cfg.name, "layers": cfg.n_layers,
              "dtype": cfg.param_dtype, "device": str(device),
              "params": transformer.param_count(params),
              "param_bytes": sum(t.numel() * t.element_size()
                                 for t in transformer._leaves(params))}
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{report['params'] / 1e6:.1f}M parameters in {cfg.param_dtype} "
          f"on {device}")
    if cuda:
        report["init_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                     - base)
        print(f"init: peak {report['init_peak_bytes'] / 1e9:.2f} GB "
              f"allocated for {report['param_bytes'] / 1e9:.2f} GB of "
              f"parameters")

    # -- the LyMDO controller over the full arch's layer profile -------------
    profile = lm_profile(cfg_full, prompt_tokens=64)
    n = UES
    env = MecEnv([profile] * n, MecConfig(f_max_ue=4e9, f_max_es=100e9),
                 e_budget=[0.5] * n, c_budget=[1.5] * n, device=device)
    st = env.reset(env.generator(SEED))
    print(f"controller over {profile.name}: L={profile.num_layers} "
          f"logical layers")
    cuts = []
    for slot in range(CTRL_SLOTS):
        cut = sweep.oracle_cut(env, st)
        st, res = env.step(st, cut)
        cuts.append(res.cut.tolist())
        delay = [round(float(d), 4) for d in res.delay.tolist()]
        print(f" slot {slot}: cuts={cuts[-1]} delay={delay} s")
    report["controller_cuts"] = cuts

    # -- the split at the chosen cut, and at the middle unit -------------------
    layer_cut = int(res.cut[0])
    unit_cut = layer_cut_to_unit(cfg, min(layer_cut, cfg.n_layers + 1))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (2, args.split_seq), generator=gen,
                           device=device)
    ref_logits, _ = transformer.forward_train(params, cfg, {"tokens": tokens})
    report["unit_cut"] = unit_cut
    report["split"] = []
    for cut in sorted({unit_cut, cfg.n_units // 2}):
        plm = PartitionedLM(cfg, params, cut)
        logits, _ = plm.infer(tokens)
        err = float((logits - ref_logits).abs().max())
        report["split"].append({
            "unit_cut": cut, "max_abs_err": err,
            "max_abs_logit": float(ref_logits.abs().max()),
            "finite": bool(torch.isfinite(logits).all()),
            "boundary_bytes": plm.boundary_bytes(*tokens.shape)})
        print(f"partitioned execution at unit {cut}/{cfg.n_units}: "
              f"boundary={report['split'][-1]['boundary_bytes']} B, "
              f"max|split - monolithic| = {err:.2e}")
    del ref_logits

    # -- the ES tier serves a burst ----------------------------------------------
    engine = PartitionedLM(cfg, params, 0).es_engine(slots=args.slots,
                                                     s_max=args.s_max)
    reqs = make_requests(cfg, args.requests, PROMPT_MIN, args.prompt_max,
                         args.max_new, SEED)
    sync()
    stats = serve(engine, reqs, sync)
    report["serving"] = stats
    print(f"ES engine: {stats['completed']}/{stats['requests']} requests in "
          f"{stats['ticks']} ticks ({stats['decode_steps']} decode dispatches, "
          f"{stats['prefill_steps']} prefills and chunks, "
          f"{stats['preemptions']} preemptions); decode tick p50 "
          f"{stats['decode_tick_ms_p50']:.2f} ms p99 "
          f"{stats['decode_tick_ms_p99']:.2f} ms; prefill tick p50 "
          f"{stats['prefill_tick_ms_p50']:.2f} ms p99 "
          f"{stats['prefill_tick_ms_p99']:.2f} ms; "
          f"{stats['tokens_per_s']:.1f} generated tokens/s")
    return report


if __name__ == "__main__":
    main()
