"""``python -m repro_torch.analysis`` -- the port's static-analysis CLI and
gate.

Port of ``repro/analysis/__main__.py``: the same flags, exit codes and
report keys.  Modes (combinable; ``--check`` is the union):

  --lint        reprolint's torch rules (``host-sync``, ``kernel-wrapper``)
                over src/repro_torch and chip_smoke.py (suppressions and
                the port's baseline applied)
  --contracts   every registry config through every serving path on meta
                tensors, and the param_spec divisibility sweep
  --shardcheck  the sharding policy, the rank-local layout and the dtypes
                over the registry on meta tensors, and the donation probe
  --retrace     the steady-state probes (serving, chunked prefill, grid
                rollouts)
  --sanitize    the sanitized serving engine through a flash-crowd schedule
  --check       all of the above; exit 1 on any finding or failure (also on
                baseline entries whose note is still the --write-baseline
                placeholder)

``--device`` (default: CUDA) is where ``--retrace``, ``--sanitize`` and
the donation probe run; lint, contracts and the rest of shardcheck need
no device.  The reference's ``key-reuse``, ``jit-branch`` and
``recompile-hazard`` rules have no torch meaning (``analysis.rules``):
asking for one is a usage error.

Baseline workflow:

  --write-baseline        grandfather the current lint findings into the
                          port's baseline (src/repro_torch/analysis/
                          baseline.json), then justify each note
  --baseline PATH         use a different baseline file

Exit status: 0 clean, 1 findings/failures, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import findings as F
from .linter import BASELINE_PATH, DEFAULT_PATHS, apply_baseline, lint_paths
from .rules import JAX_ONLY, RULES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="reprolint + meta-tensor contract harness for the port")
    p.add_argument("--check", action="store_true",
                   help="run everything; nonzero exit on any finding "
                        "(the gate)")
    p.add_argument("--lint", action="store_true", help="AST rules only")
    p.add_argument("--contracts", action="store_true",
                   help="meta-tensor registry sweep only")
    p.add_argument("--shardcheck", action="store_true",
                   help="sharding / rank-layout / dtype verification only")
    p.add_argument("--retrace", action="store_true",
                   help="steady-state probes only")
    p.add_argument("--sanitize", action="store_true",
                   help="sanitized-engine flash-crowd run only")
    p.add_argument("--paths", nargs="*", default=None,
                   help=f"files/dirs to lint (default: "
                        f"{' '.join(DEFAULT_PATHS)})")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: {BASELINE_PATH})")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather current lint findings")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default=None,
                   help="device of --retrace, --sanitize and the donation "
                        "probe (default: cuda)")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        for name, rule in sorted(RULES.items()):
            print(f"{name:18s} {rule.description}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        for name in rules:
            if name in JAX_ONLY:
                print(f"rule {name!r} is JAX-only and has no twin in the "
                      f"port: {JAX_ONLY[name]}", file=sys.stderr)
                return 2
        unknown = set(rules) - set(RULES)
        if unknown:
            print(f"unknown rules: {sorted(unknown)}; have {sorted(RULES)}",
                  file=sys.stderr)
            return 2

    do_lint = args.lint or args.check or args.write_baseline
    do_contracts = args.contracts or args.check
    do_shardcheck = args.shardcheck or args.check
    do_retrace = args.retrace or args.check
    do_sanitize = args.sanitize or args.check
    if not (do_lint or do_contracts or do_shardcheck or do_retrace
            or do_sanitize):
        do_lint = True                   # bare invocation: lint + report

    rc = 0
    report: dict = {}

    if do_lint:
        found = lint_paths(paths=args.paths or DEFAULT_PATHS, rules=rules)
        baseline_path = args.baseline or BASELINE_PATH
        if args.write_baseline:
            F.write_baseline(baseline_path, found)
            print(f"baseline written: {len(found)} finding(s) -> "
                  f"{baseline_path}")
            print("justify every 'note' entry or fix the finding")
            return 0
        new, old, baseline = apply_baseline(found, baseline_path)
        stale = F.placeholder_entries(baseline) if args.check else []
        report["lint"] = {"new": [f.render() for f in new],
                          "baselined": [f.render() for f in old],
                          "placeholder_notes": [
                              f"{e.get('path', '?')} [{e.get('rule', '?')}] "
                              f"{e.get('fingerprint', '?')}" for e in stale]}
        if not args.as_json:
            for f in new:
                print(f.render())
            if old and args.verbose:
                for f in old:
                    print(f"{f.render()}  [baselined]")
            for line in report["lint"]["placeholder_notes"]:
                print(f"baseline entry never justified (note is still the "
                      f"placeholder): {line}")
            print(f"reprolint: {len(new)} finding(s), "
                  f"{len(old)} baselined")
        if new or stale:
            rc = 1

    if do_contracts:
        from .contracts import run_contracts
        r = run_contracts(verbose=args.verbose and not args.as_json)
        report["contracts"] = {
            "covered": len(r.covered), "elapsed_s": round(r.elapsed_s, 2),
            "skipped": [list(s) for s in r.skipped],
            "failures": [f.render() for f in r.failures]}
        if not args.as_json:
            for f in r.failures:
                print(f.render())
            print(f"contracts: {len(r.covered)} arch-path legs in "
                  f"{r.elapsed_s:.1f}s, {len(r.failures)} failure(s), "
                  f"{len(r.skipped)} contract skip(s)")
        if r.failures:
            rc = 1

    if do_shardcheck:
        from .shardcheck import run_shardcheck
        r = run_shardcheck(device=args.device,
                           verbose=args.verbose and not args.as_json)
        report["shardcheck"] = {
            "covered": len(r.covered), "elapsed_s": round(r.elapsed_s, 2),
            "skipped": [list(s) for s in r.skipped],
            "failures": [f.render() for f in r.failures]}
        if not args.as_json:
            for f in r.failures:
                print(f.render())
            print(f"shardcheck: {len(r.covered)} arch-check legs in "
                  f"{r.elapsed_s:.1f}s, {len(r.failures)} failure(s), "
                  f"{len(r.skipped)} skip(s)")
        if r.failures:
            rc = 1

    if do_retrace:
        from .retrace import run_retrace
        fails = run_retrace(device=args.device)
        report["retrace"] = {"failures": [f.render() for f in fails]}
        if not args.as_json:
            for f in fails:
                print(f.render())
            print(f"retrace: {len(fails)} failure(s)")
        if fails:
            rc = 1

    if do_sanitize:
        from ..device import resolve_device
        from ..launch.serve import kernel_head_dim
        from .sanitize import run_sanitize
        device = resolve_device(args.device)
        r = run_sanitize(device=device, **kernel_head_dim(device))
        report["sanitize"] = {
            "ticks": r.ticks, "requests": r.requests,
            "preemptions": r.preemptions, "block_churn": r.block_churn,
            "elapsed_s": round(r.elapsed_s, 2),
            "failures": [f.render() for f in r.failures]}
        if not args.as_json:
            for f in r.failures:
                print(f.render())
            print(f"sanitize: {r.ticks} ticks, {r.requests} request(s), "
                  f"{r.preemptions} preemption(s), {r.block_churn} block "
                  f"event(s) in {r.elapsed_s:.1f}s, "
                  f"{len(r.failures)} failure(s)")
        if r.failures:
            rc = 1

    if args.as_json:
        print(json.dumps(report, indent=2))
    return rc


if __name__ == "__main__":
    sys.exit(main())
