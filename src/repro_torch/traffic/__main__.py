"""CLI for the traffic subsystem (port of ``python -m repro.traffic``).

  python -m repro_torch.traffic --list           # generator + scenario catalogue
  python -m repro_torch.traffic --show trace.npz # inspect a saved trace
"""
from __future__ import annotations

import argparse

import numpy as np

TRAFFIC_SCENARIOS = ("mmpp_burst", "diurnal", "flash_crowd", "trace_replay",
                     "peak_window", "fixed_rate")


def _list() -> None:
    from . import processes
    print("Arrival processes (repro_torch.traffic.processes):")
    for line in processes.describe().splitlines():
        print(f"  {line}")
    from ..core import scenarios as sc
    print("\nTraffic-driven scenarios (repro_torch.core.scenarios):")
    for line in sc.describe().splitlines():
        if line.split(":")[0] in TRAFFIC_SCENARIOS:
            print(f"  {line}")


def _show(path: str) -> None:
    from .trace import Trace
    tr = Trace.load(path)
    print(f"{path}: T={tr.n_slots} slots x N={tr.n_ue} UEs, "
          f"slot_s={tr.slot_s:g}")
    print(f"  mean rate {np.mean(tr.rates):.3f} req/s, "
          f"peak {np.max(tr.rates):.3f} req/s")
    print(f"  meta: {tr.meta}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.traffic",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true",
                    help="print the generator/scenario catalogue")
    ap.add_argument("--show", metavar="TRACE_NPZ",
                    help="summarize a saved trace file")
    args = ap.parse_args(argv)
    if args.show:
        _show(args.show)
        return 0
    _list()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
