"""Scenario-registry demo: a whole Fig. 4 arrival-rate sweep plus a
multi-cell grid, each evaluated as one batched grid, then that grid sharded
over a cells mesh.

    PYTHONPATH=src python -m repro_torch.scenario_sweep [--device cpu]
        [--steps 200] [--episodes 3]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.scenario_sweep

Every (cell, rate) configuration is one cell of a ``ScenarioGrid`` and all
cells advance together; the Oracle decides through the partition-sweep
kernel on CUDA.  The last leg runs the 16-cell grid sharded over every rank
of the default process group (a one-rank group of its own when run
without torchrun, as the reference's one-device mesh) and prints its
largest delay drift from the unsharded run.  Only rank 0 prints.  Runs on
CUDA unless ``--device cpu`` (gloo then joins the ranks; NCCL on CUDA).
Port of ``examples/scenario_sweep.py``; the defaults are its settings.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch.distributed as dist

from .core.lymdo import run_fixed_batched
from .core.scenarios import (ScenarioGrid, describe, grid_from_names,
                             multicell_grid)
from .launch.mesh import init_group, is_rank0, make_cells_mesh, world_size

RATES = (0.5, 1.0, 1.5, 2.0, 2.5)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--episodes", type=int, default=3,
                    help="episodes of the Fig. 4 sweep (the grids run one)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the printed numbers: per-policy Fig. 4 delays, the 16-cell
    grid's per-cell delays, the sharded leg's and its drift."""
    args = parse_args(argv)
    own = not dist.is_initialized()
    device = init_group(device=args.device) if own else args.device
    say = print if is_rank0() else (lambda *a, **k: None)
    try:
        return _run(args, device, say)
    finally:
        if own:
            dist.destroy_process_group()


def _run(args, device, say) -> dict:
    out: dict = {"fig4": {}}
    say("registered scenarios:")
    say(describe(), "\n")

    # -- Fig. 4 sweep: five fixed-rate cells, one grid ----------------------
    grid = grid_from_names([("fixed_rate", {"rate": r}) for r in RATES],
                           device=device)
    for policy in ("oracle", "local", "edge"):
        metrics, _ = run_fixed_batched(grid, policy, episodes=args.episodes,
                                       steps=args.steps)
        out["fig4"][policy] = metrics["delay"].tolist()
        row = " ".join(f"@{r:g}:{d*1e3:6.1f}ms"
                       for r, d in zip(RATES, metrics["delay"]))
        say(f"{policy:>7s} E2E delay  {row}")

    # -- 16-cell heterogeneous grid under the batched Oracle ----------------
    cells = multicell_grid(cells=16, ues=8, seed=0)
    metrics, results = run_fixed_batched(ScenarioGrid(cells, device=device),
                                         "oracle", episodes=1,
                                         steps=args.steps)
    delays = metrics["delay"]
    out["grid16"] = delays.tolist()
    say(f"\n16-cell grid, oracle: mean delay {delays.mean()*1e3:.1f} ms "
        f"(best cell {delays.min()*1e3:.1f}, worst {delays.max()*1e3:.1f}); "
        f"results stacked {tuple(results.delay.shape)} = (slots, cells, UEs)")

    # -- the same grid sharded over the cells mesh --------------------------
    # One rank is a degenerate 1-way mesh; under torchrun the cells split
    # across every rank.  Either way the numbers match the unsharded run to
    # 1e-5.
    sharded = ScenarioGrid(cells, device=device, mesh=make_cells_mesh())
    m_sh, _ = run_fixed_batched(sharded, "oracle", episodes=1,
                                steps=args.steps)
    drift = float(np.max(np.abs(m_sh["delay"] - delays)))
    out.update(sharded=m_sh["delay"].tolist(), drift=drift,
               pad=sharded.gridshard.pad)
    say(f"sharded over {world_size()} rank(s) "
        f"(pad {sharded.gridshard.pad} cells): "
        f"max |delay drift| vs unsharded = {drift:.2e}")
    return out


if __name__ == "__main__":
    main()
