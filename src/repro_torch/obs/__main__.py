"""``python -m repro_torch.obs`` -- telemetry smoke CLI + the overhead gate.

Port of ``python -m repro.obs`` with its flags, plus ``--device`` (CUDA
unless ``cpu``).

Default action: replay a small deterministic bursty schedule through a
telemetry-enabled :class:`ServingEngine` (reduced attention stack) and
print the per-request delay-breakdown summary table -- serving ticks
partitioned onto the paper's serial-queue stages (queue wait / prefill /
decode / preemption-recompute), stage sums exactly equal to E2E.  Add:

  --prom PATH      dump the metrics registry in Prometheus text exposition
                   format ("-" for stdout)
  --trace PATH     write the span ring buffer as Chrome-trace JSON (open
                   in https://ui.perfetto.dev)
  --jsonl PATH     same events as JSONL
  --grid           also run a small ScenarioGrid rollout (slots/sec,
                   cells/sec gauges + grid_rollout span)
  --sync           use the synchronized-batch compat engine
  --overhead       run the overhead gate instead: one warmed-up engine
                   replays a decode-heavy schedule with hooks off, on and
                   off again in interleaved repeats, timing the hook calls
                   themselves; it asserts that the hooks' time a tick is
                   within --gate (default 5%) of the disabled per-tick
                   p50, and prints the wall-clock p50 delta beside the
                   delta between the two disabled pools (the noise floor).

Exit status: 0 ok, 1 gate/exactness failure.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def make_schedule(requests: int, n_ue: int, seed: int, vocab: int,
                  rid_base: int = 0, new_range: tuple = (2, 9)):
    """Deterministic flash-crowd-ish schedule: ~60% of requests burst in
    at ticks 0-1, the rest straggle -- the mix that exercises queueing,
    per-tick admission, and (with a small pool) preemption.  ``new_range``
    is the half-open ``max_new`` draw range (long = decode-heavy)."""
    rng = np.random.default_rng(seed)
    sched = []
    for i in range(requests):
        tick = int(rng.integers(0, 2)) if i < requests * 0.6 \
            else int(rng.integers(2, 12))
        n = int(rng.integers(4, 11))
        sched.append((tick, rid_base + i,
                      rng.integers(0, vocab, n).astype(np.int32),
                      int(rng.integers(*new_range)), i % n_ue))
    sched.sort(key=lambda s: (s[0], s[1]))
    return sched


def replay(cfg, params, schedule, *, sync: bool, slots: int, s_max: int,
           kv_blocks=None, telemetry=None, recorder=None, engine=None,
           max_ticks: int = 5000):
    """Drive one engine through the schedule; returns (engine, recorder,
    per-tick wall durations in seconds; each tick ends in the engine's
    token sync).  Pass ``engine=`` to reuse a previous replay's engine (it
    stays warm -- the overhead gate measures instrumentation cost, not
    warm-up); schedule rids must be fresh then."""
    from ..serving.engine import Request, ServingEngine
    from ..traffic import TrafficRecorder

    if engine is not None:
        eng, rec = engine, engine.recorder
    else:
        rec = TrafficRecorder() if recorder is None else recorder
        eng = ServingEngine(cfg, params, slots=slots, s_max=s_max,
                            recorder=rec, sync_batching=sync,
                            telemetry=telemetry,
                            **({} if kv_blocks is None
                               else {"kv_blocks": kv_blocks}))
    reqs = [Request(rid=rid, prompt=p, max_new=m, ue=ue)
            for _, rid, p, m, ue in schedule]
    base = eng.clock                     # reused engines: shift the schedule
    pending = list(zip((t + base for t, *_ in schedule), reqs))
    ticks = []
    i = 0
    for _ in range(max_ticks):
        while i < len(pending) and pending[i][0] <= eng.clock:
            eng.submit(pending[i][1])
            i += 1
        t0 = time.perf_counter()
        busy = eng.step()
        ticks.append(time.perf_counter() - t0)
        if i == len(pending) and not busy:
            break
    assert all(r.done for r in reqs), "schedule did not drain"
    return eng, rec, ticks


def _build_model(arch: str, n_layers: int, seed: int, device=None):
    """``reduced(arch)`` at ``n_layers`` from ``seed`` on ``device``, its
    heads widened on CUDA (``launch.serve.kernel_head_dim``)."""
    from ..configs.base import get_config, reduced
    from ..device import resolve_device
    from ..launch.serve import kernel_head_dim
    from ..models import transformer
    device = resolve_device(device)
    cfg = reduced(get_config(arch), n_layers=n_layers,
                  **kernel_head_dim(device))
    return cfg, transformer.init_params(seed, cfg, device)


def print_summary(rec, eng, telemetry) -> bool:
    """Stage table + exactness check + headline metrics; True when every
    request's stage sum equals its recorded E2E latency."""
    from .breakdown import STAGES, stage_summary

    bds = rec.delay_breakdowns()
    summ = stage_summary(bds)
    print(f"\nper-request delay breakdown over {len(bds)} completed "
          f"requests (engine ticks; paper-stage mapping in "
          f"repro_torch/obs/breakdown.py):\n")
    hdr = f"{'stage':<11} {'n':>4} {'mean':>8} {'p50':>7} {'p90':>7} " \
          f"{'p99':>7} {'max':>6}"
    print(hdr)
    print("-" * len(hdr))
    for stage in STAGES:
        s = summ[stage]
        if not s["n"]:
            print(f"{stage:<11} {0:>4}")
            continue
        print(f"{stage:<11} {s['n']:>4} {s['mean']:>8.2f} {s['p50']:>7.1f} "
              f"{s['p90']:>7.1f} {s['p99']:>7.1f} {s['max']:>6d}")

    lats = {rid: int(lat) for (rid, lat) in zip(sorted(
        r for r, e in rec.events.items()
        if e.submit is not None and e.complete is not None),
        rec.latencies())}
    exact = sum(1 for rid, b in bds.items() if b.e2e == lats.get(rid))
    ok = exact == len(bds) and len(bds) > 0
    print(f"\nexactness: stage sums == recorded E2E for {exact}/{len(bds)} "
          f"requests {'OK' if ok else 'FAIL'}")

    snap = telemetry.metrics.snapshot()
    picks = [k for k in sorted(snap)
             if k.split("{")[0] in (
                 "serving_preemptions_total", "serving_tokens_total",
                 "serving_prefill_compiles", "serving_decode_compiles",
                 "kvpool_block_grows_total", "kvpool_utilization",
                 "kvpool_fragmentation", "grid_slots_per_s",
                 "grid_cells_per_s")]
    if picks:
        print("\nkey metrics:")
        for k in picks:
            v = snap[k]
            print(f"  {k} = {v:.4g}" if isinstance(v, float)
                  else f"  {k} = {v}")
    print(f"\nspans buffered: {len(telemetry.tracer.events())} "
          f"(capacity {telemetry.tracer.capacity})")
    return ok


class _TimedHooks:
    """The engine's hooks, with the wall time spent inside their calls
    summed in ``seconds``: the instrumentation's cost, read where it is
    spent rather than from the difference of two noisy tick pools."""

    def __init__(self, hooks):
        self._hooks = hooks
        self.seconds = 0.0

    def __getattr__(self, name):
        attr = getattr(self._hooks, name)
        if not callable(attr):
            return attr

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return attr(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self, name, timed)        # later calls skip __getattr__
        return timed


def overhead_gate(cfg, params, *, sync: bool, slots: int, s_max: int,
                  requests: int, n_ue: int, seed: int, repeats: int,
                  gate: float) -> int:
    """The hooks' cost a tick against the disabled per-tick p50, on a
    warm engine.

    ONE engine serves every mode: it is built with telemetry, warmed up
    once, then each repeat replays a fresh schedule three times with
    ``eng.obs`` off, on (wrapped in :class:`_TimedHooks`) and off again,
    the order rotating every repeat.  Toggling the same engine (rather
    than comparing separately-built engines) keeps allocator and cache
    placement out of the comparison.

    The gate reads the time spent inside the hook calls, over the ticks
    of the enabled replays, as a share of the pooled disabled p50.  The
    wall-clock p50 delta (enabled against both disabled pools) is printed
    beside the delta between the two disabled pools: on a host-bound tick
    of a few ms that A/A delta is of the order of the whole budget, so a
    wall-clock gate would pass or fail on the sign of the noise.

    The gate schedule is decode-heavy (few requests, long ``max_new``):
    decode ticks are the clear majority, so each p50 sits inside the
    decode mass rather than straddling the gap to the admission ticks.
    """
    from . import Telemetry

    tel = Telemetry()
    n_req = max(4, requests // 4)
    s_max = max(s_max, 64)
    kw = dict(sync=sync, slots=slots, s_max=s_max)
    sched = make_schedule(n_req, n_ue, seed, cfg.vocab, new_range=(40, 49))
    eng, _, _ = replay(cfg, params, sched, telemetry=tel,
                       **kw)               # warm-up
    hooks = eng.obs
    timed = _TimedHooks(hooks)
    modes = ("off", "on", "off2")
    pools = {m: [] for m in modes}
    for r in range(repeats):
        for k, mode in enumerate(modes[r % 3:] + modes[:r % 3]):
            eng.obs = timed if mode == "on" else None
            sched = make_schedule(
                n_req, n_ue, seed, cfg.vocab, new_range=(40, 49),
                rid_base=(3 * (r + 1) + k) * 100_000)
            eng, _, ticks = replay(cfg, params, sched, engine=eng, **kw)
            pools[mode].extend(ticks)
    eng.obs = hooks
    p50 = {m: float(np.percentile(pools[m], 50)) for m in modes}
    off = float(np.percentile(pools["off"] + pools["off2"], 50))
    hook_s = timed.seconds / len(pools["on"])
    share = hook_s / off
    ok = share <= gate
    print(f"overhead gate: per-tick p50 disabled={off * 1e6:.0f}us "
          f"enabled={p50['on'] * 1e6:.0f}us "
          f"delta={(p50['on'] - off) / off * 100:+.1f}% (A/A between the "
          f"disabled pools {(p50['off2'] - p50['off']) / off * 100:+.1f}%); "
          f"hooks {hook_s * 1e6:.1f}us a tick = {share * 100:.2f}% of the "
          f"disabled p50 (pooled over {repeats} rotated repeats, "
          f"{len(pools['on'])} ticks/side; gate {gate * 100:.0f}%) "
          f"{'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--s-max", type=int, default=32)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--ues", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync", action="store_true",
                    help="synchronized-batch compat engine")
    ap.add_argument("--prom", default=None, metavar="PATH",
                    help='Prometheus text exposition ("-" for stdout)')
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome-trace JSON (Perfetto-openable)")
    ap.add_argument("--jsonl", default=None, metavar="PATH")
    ap.add_argument("--grid", action="store_true",
                    help="also run a small ScenarioGrid rollout")
    ap.add_argument("--overhead", action="store_true",
                    help="run the enabled-vs-disabled overhead gate")
    ap.add_argument("--gate", type=float, default=0.05,
                    help="max allowed enabled/disabled p50 delta")
    ap.add_argument("--repeats", type=int, default=10,
                    help="overhead gate: pooled interleaved repeats")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg, params = _build_model(args.arch, args.layers, args.seed,
                               args.device)

    if args.overhead:
        return overhead_gate(cfg, params, sync=args.sync, slots=args.slots,
                             s_max=args.s_max, requests=args.requests,
                             n_ue=args.ues, seed=args.seed,
                             repeats=args.repeats, gate=args.gate)

    from . import Telemetry
    tel = Telemetry()
    sched = make_schedule(args.requests, args.ues, args.seed, cfg.vocab)
    eng, rec, ticks = replay(cfg, params, sched, sync=args.sync,
                             slots=args.slots, s_max=args.s_max,
                             telemetry=tel)
    print(f"replayed {len(sched)} requests over {eng.clock} ticks "
          f"(engine={'sync' if args.sync else 'continuous'}, "
          f"decode_steps={eng.decode_steps}, "
          f"preemptions={eng.preemptions})")

    if args.grid:
        from ..core.scenarios import ScenarioGrid, multicell_grid
        grid = ScenarioGrid(multicell_grid(cells=4, ues=3, seed=args.seed),
                            device=params["embed"].device)
        grid.rollout("local", steps=8, seed=args.seed, telemetry=tel)

    ok = print_summary(rec, eng, tel)

    if args.prom == "-":
        print("\n" + tel.metrics.to_prometheus(), end="")
    elif args.prom:
        with open(args.prom, "w") as f:
            f.write(tel.metrics.to_prometheus())
        print(f"wrote {args.prom}")
    if args.trace:
        tel.tracer.export_chrome(args.trace)
        print(f"wrote {args.trace} (open in https://ui.perfetto.dev)")
    if args.jsonl:
        tel.tracer.export_jsonl(args.jsonl)
        print(f"wrote {args.jsonl}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
