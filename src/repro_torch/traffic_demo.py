"""Traffic tour: generators, trace record/replay, batched grids.

    PYTHONPATH=src python -m repro_torch.traffic_demo [--device cpu]
        [--layers N] [--sync] [--ticks 60] [--cells 16] [--steps 60]
        [--trace-out build/serving_trace.npz]

Walks the serving->trace->MEC loop in four steps:

1. sample the arrival-process catalogue (``repro_torch.traffic.processes``);
2. serve prompts on a ServingEngine with a TrafficRecorder and telemetry
   attached (``--sync``: the synchronized-batch engine), and split each
   request's E2E ticks into the paper's serial-queue stages;
3. bin the recorded lifecycle into a (T, N) trace, save and load it;
4. replay the trace as the arrival process of a ``--cells``-cell
   ScenarioGrid under the Oracle (each cell a de-phased rotation of the
   recording), which decides through the partition-sweep kernel on CUDA.

The model is qwen3-0.6b from a seeded random init: on the CPU the
reference's ``reduced`` config at ``--layers`` (default 4, float32), on
CUDA the full-width config at ``--layers`` (default: all 28, bf16).  Runs
on CUDA unless ``--device cpu``.  Port of ``examples/traffic_demo.py``; the
defaults are its settings.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from . import traffic
from .configs.base import get_config, reduced
from .core.lymdo import run_fixed_batched
from .core.scenarios import ScenarioGrid, make
from .device import resolve_device
from .models import transformer
from .obs import Telemetry, stage_summary
from .serving.engine import Request, ServingEngine

ARCH = "qwen3-0.6b"
SEED = 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: 4 on the CPU, the config's on CUDA)")
    ap.add_argument("--sync", action="store_true",
                    help="serve with the synchronized-batch engine")
    ap.add_argument("--ticks", type=int, default=60,
                    help="ticks of Poisson arrivals before the drain")
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--trace-out", default="build/serving_trace.npz")
    return ap.parse_args(argv)


def show_generators(device) -> dict:
    """Mean, peak and trough of four processes over 120 slots."""
    print("== arrival-process catalogue ==")
    print(traffic.processes.describe(), "\n")
    n = 4
    procs = {
        "poisson": traffic.PoissonArrivals(lam=traffic.per_ue(2.0, n),
                                           slot_s=torch.tensor(1.0)),
        "mmpp": traffic.make_mmpp(n, seed=0, rates=(0.5, 3.0)),
        "diurnal": traffic.Diurnal(base=traffic.per_ue(1.5, n),
                                   amp=traffic.per_ue(1.0, n),
                                   period=torch.tensor(100.0),
                                   phase=torch.tensor(0.0)),
        "flash_crowd": traffic.FlashCrowd(base=traffic.per_ue(1.0, n),
                                          spike=torch.tensor(3.0),
                                          t0=torch.tensor(40),
                                          decay=torch.tensor(15.0)),
    }
    out = {}
    for name, proc in procs.items():
        rates = traffic.materialize(proc, 120, torch.Generator().manual_seed(1))
        out[name] = {"mean": float(rates.mean()), "peak": float(rates.max()),
                     "trough": float(rates.min())}
        print(f"  {name:12s} mean {rates.mean():.2f} req/s, "
              f"peak {rates.max():.2f}, trough {rates.min():.2f}")
    print()
    return out


def model(layers: int | None, device):
    """The served model: reduced qwen3 (float32) on the CPU, full-width
    qwen3 (bf16) on CUDA, at ``layers`` where given."""
    if device.type == "cpu":
        cfg = reduced(get_config(ARCH), n_layers=layers or 4)
    else:
        cfg = get_config(ARCH)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, transformer.init_params(SEED, cfg, device)


def make_engine(cfg, params, *, sync: bool, slots: int,
                s_max: int) -> ServingEngine:
    """The demo's engine: a TrafficRecorder and per-tick telemetry."""
    return ServingEngine(cfg, params, slots=slots, s_max=s_max,
                         sync_batching=sync, recorder=traffic.TrafficRecorder(),
                         telemetry=Telemetry(sample_every=1))


def record_trace(eng: ServingEngine, ticks: int, n_ue: int):
    """Poisson arrivals of 6-token prompts (2 new tokens each) for
    ``ticks`` ticks, with a burst in the middle third; then drain.
    Returns the requests and the binned trace."""
    print("== record: ServingEngine + TrafficRecorder ==")
    rng = np.random.default_rng(0)
    reqs = []
    for tick in range(ticks):
        lam = 0.9 if ticks // 3 <= tick < 2 * ticks // 3 else 0.3
        for _ in range(rng.poisson(lam)):
            reqs.append(Request(rid=len(reqs), prompt=rng.integers(
                0, eng.cfg.vocab, 6).astype(np.int32), max_new=2,
                ue=len(reqs) % n_ue))
            eng.submit(reqs[-1])
        eng.step()
    eng.run_until_idle()
    rec = eng.recorder
    waits = [ev.queueing_ticks for ev in rec.events.values()]
    print(f"  served {len(reqs)} requests ("
          f"{'sync' if eng.sync_batching else 'continuous'} engine); "
          f"{eng.prefill_compiles} prefill shapes (bucketed); mean queueing "
          f"wait {np.mean(waits):.1f} ticks")
    trace = rec.to_trace(n_ue=n_ue, bin_ticks=2, slot_s=1.0,
                         horizon=ticks // 2)
    print(f"  trace: T={trace.n_slots} x N={trace.n_ue}, "
          f"mean {trace.rates.mean():.2f} req/s, "
          f"peak {trace.rates.max():.2f} req/s")
    return reqs, trace


def print_breakdown(rec) -> dict:
    """Per-stage tick means of the recorded requests."""
    summ = stage_summary(rec.delay_breakdowns())
    print("  delay breakdown (mean ticks): " + ", ".join(
        f"{stage} {s['mean']:.2f}" for stage, s in summ.items() if s["n"])
        + "\n")
    return summ


def replay(path: str, cells: int, steps: int, device) -> dict:
    """The saved trace as every cell's load, cell b rotated by 2b slots,
    under the Oracle for ``steps`` slots."""
    print(f"== replay: {cells}-cell batched grid under the recorded load ==")
    grid = ScenarioGrid([make("trace_replay", path=path, offset=2 * b, seed=b)
                         for b in range(cells)], device=device)
    metrics, results = run_fixed_batched(grid, "oracle", episodes=1,
                                         steps=steps)
    print(f"  per-cell mean delay  : {np.mean(metrics['delay']):.4f} s "
          f"(spread {np.min(metrics['delay']):.4f}.."
          f"{np.max(metrics['delay']):.4f})")
    print(f"  per-cell mean reward : {np.mean(metrics['reward']):.3f}")
    print(f"  results stack        : reward {tuple(results.reward.shape)} "
          f"(steps, B), delay {tuple(results.delay.shape)} (steps, B, N)")
    return {"metrics": metrics, "results": results}


def main(argv=None) -> dict:
    """Returns the generators' summary, the engine, its requests, the
    trace (as saved and as loaded back), the stage summary and the
    replay's metrics and results."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    report = {"generators": show_generators(device)}
    cfg, params = model(args.layers, device)
    eng = make_engine(cfg, params, sync=args.sync, slots=2, s_max=32)
    reqs, trace = record_trace(eng, args.ticks, n_ue=4)
    report.update(engine=eng, requests=reqs, trace=trace,
                  stages=print_breakdown(eng.recorder))
    os.makedirs(os.path.dirname(os.path.abspath(args.trace_out)),
                exist_ok=True)
    trace.save(args.trace_out)                    # the on-disk round trip
    report["loaded"] = traffic.Trace.load(args.trace_out)
    report.update(replay(args.trace_out, args.cells, args.steps, device))
    print(f"\nDone.  The trace is in {args.trace_out}; "
          f"python -m repro_torch.traffic --show {args.trace_out} reads it.")
    return report


if __name__ == "__main__":
    main()
