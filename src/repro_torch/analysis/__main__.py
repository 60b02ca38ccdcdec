"""``python -m repro_torch.analysis --sanitize [--device cpu] [--json]``

Runs the sanitized serving engine through the flash-crowd schedule of
``analysis.sanitize.run_sanitize`` (KV-pool shadow ownership and the
dispatch guards) and prints its report.  Exit status: 0 clean, 1 on any
failure.  The reference CLI's other flags (``--lint``, ``--contracts``,
``--shardcheck``, ``--retrace``, ``--check`` and the lint options) are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json

# the reference CLI's flags that have no port yet
UNPORTED = ("check", "lint", "contracts", "shardcheck", "retrace", "paths",
            "rules", "baseline", "write-baseline", "list-rules", "verbose")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--sanitize", action="store_true",
                    help="sanitized-engine flash-crowd run")
    for name in UNPORTED:
        ap.add_argument(f"--{name}", nargs="*", default=None,
                        help="not ported yet")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)
    asked = [name for name in UNPORTED
             if getattr(args, name.replace("-", "_")) is not None]
    if asked:
        raise NotImplementedError(
            f"python -m repro_torch.analysis --{asked[0]} is not ported yet; "
            f"it comes with the analysis layers (ROADMAP queue 1, item 8)")
    if not args.sanitize:
        ap.error("nothing to run: pass --sanitize")

    from ..device import resolve_device
    from ..launch.serve import kernel_head_dim
    from .sanitize import run_sanitize
    device = resolve_device(args.device)
    r = run_sanitize(device=device, **kernel_head_dim(device))
    report = {"sanitize": {
        "ticks": r.ticks, "requests": r.requests,
        "preemptions": r.preemptions, "block_churn": r.block_churn,
        "elapsed_s": round(r.elapsed_s, 2),
        "failures": [f.render() for f in r.failures]}}
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        for f in r.failures:
            print(f.render())
        print(f"sanitize: {r.ticks} ticks, {r.requests} request(s), "
              f"{r.preemptions} preemption(s), {r.block_churn} block "
              f"event(s) in {r.elapsed_s:.1f}s, "
              f"{len(r.failures)} failure(s)")
    return 1 if r.failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
