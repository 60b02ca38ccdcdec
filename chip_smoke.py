#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path -- the LyMDO controller deciding and scoring
slots for a 4096-cell x 8-UE grid (32,768 UEs) -- through its public entry
points, and checks every kernel of that path against its plain PyTorch
version on the card:

1. builds the CUDA kernels from the sources in this checkout;
2. holds each kernel against its plain version at the main path's shapes
   and three more -- an LM-shaped fleet (C = 103), a ragged row count and a
   grid whose cells have their own MEC constants (rtol 1e-4 / atol 1e-3 on
   feasible cells, the same infeasible set, argmins equal wherever the plain
   table has no near tie), and times kernel and plain on the device (the
   profiler's kernel durations) and per call with the host issuing (CUDA
   events), against the bound of the work this run's inputs need;
3. runs the grid for MAIN_SLOTS slots with each of the oracle, local, edge
   and random policies, counting kernel launches over that run, checks the
   results are finite and in range, and checks a small grid against the
   port's CPU path on the same draws, and profiles PROFILE_SLOTS Oracle
   slots with torch.profiler (device-busy share of the window, device ops
   per slot, the kernels that take the most device time);
4. runs the single-cell paper scenario with the four baseline cut
   functions and prints the quickstart comparison.

It exits nonzero, printing no result, where CUDA is unavailable or any
check fails.  The last lines are the card's name and power limit, one JSON
line of per-kernel numbers and one JSON status line.  A longer report goes
to build/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
RTOL, ATOL = 1e-4, 1e-3          # the sweep tolerance of the reference's tests
BIG = 1e29
GRID_CELLS, GRID_UES = 4096, 8
MAIN_SLOTS = 50
SINGLE_SLOTS = 50
SMALL_CELLS, SMALL_SLOTS = 8, 20
PROFILE_SLOTS = 3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 non-tensor FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def call_ms(torch, fn, iters: int) -> float:
    """Wall time per call, device work included: CUDA events around
    ``iters`` calls issued from the host after a warm-up.  Where the host
    issues more slowly than the device runs, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the summed duration of the CUDA kernels that
    ``iters`` calls launch, from torch.profiler, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        fail("the profiler recorded no device time")
    return us / 1e3 / iters


def check_sweep(torch, got, want, label: str) -> float:
    """Kernel vs plain table; returns the largest abs error on feasible cells."""
    feasible = want < BIG
    diff = (got - want).abs()
    bad = feasible & (diff > ATOL + RTOL * want.abs())
    if bool(bad.any()):
        fail(f"{label}: {int(bad.sum())} feasible cells outside tolerance, "
             f"max abs err {float(diff[feasible].max()):.3e}")
    if not bool(((got > BIG) == ~feasible).all()):
        fail(f"{label}: infeasible sets differ")
    srt = torch.sort(want, dim=-1).values
    tol = ATOL + RTOL * srt[..., 0].abs()
    clear = (srt[..., 1] - srt[..., 0]) > tol
    k_arg, p_arg = torch.argmin(got, -1), torch.argmin(want, -1)
    if not bool((k_arg[clear] == p_arg[clear]).all()):
        fail(f"{label}: argmin differs where the plain table has no near tie")
    picked = torch.gather(want, -1, k_arg[..., None])[..., 0]
    if not bool((picked <= srt[..., 0] + tol).all()):
        fail(f"{label}: kernel argmin scores worse than the plain minimum")
    err = float(diff[feasible].max()) if bool(feasible.any()) else 0.0
    log(f"  {label}: ok  rows={got.numel() // got.shape[-1]} C={got.shape[-1]} "
        f"feasible={int(feasible.sum())} near_ties={int((~clear).sum())} "
        f"max_abs_err={err:.3e}")
    return err


def profile_grid(torch, grid, slots: int) -> dict:
    """Device time of ``slots`` Oracle slots under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    run = grid.make_rollout("oracle", slots)
    run(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.device_time_total)[:6]
    sweep = [e for e in rows if "partition_sweep" in e.key]
    return {
        "sweep_device_ms": (sum(e.device_time_total for e in sweep) / 1e3
                            / sum(e.count for e in sweep)) if sweep else None,
        "slots": slots, "wall_s": wall_s,
        "device_s": device_us / 1e6 if rows else None,
        "device_busy_share": device_us / 1e6 / wall_s if rows else None,
        "device_ops_per_slot": launches / slots if rows else None,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": e.device_time_total / 1e3} for e in top],
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import env as menv
    from repro_torch.core import lymdo, scenarios
    from repro_torch.core.lyapunov import VirtualQueues
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import partition_sweep as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report: dict = {}

    # -- 1. build ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1] card: {kind} x{count}; nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib = ps.build()
    build_s = time.perf_counter() - t0
    log(f"    built {lib.relative_to(ROOT)} in {build_s:.1f} s")
    for line in ps.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")
    report.update(card=kind, count=count, nvidia_smi=smi, build_s=build_s)

    # -- 2. kernel vs plain on the card --------------------------------------
    log("[2] partition_sweep: CUDA kernel vs plain PyTorch")
    t0 = time.perf_counter()
    grid = scenarios.ScenarioGrid(
        scenarios.multicell_grid(cells=GRID_CELLS, ues=GRID_UES))
    log(f"    grid {GRID_CELLS}x{GRID_UES} built in "
        f"{time.perf_counter() - t0:.1f} s (C={grid.num_cuts})")

    def with_queues(states, seed):
        g = grid.generator(seed)
        shape = states.lam.shape
        q = VirtualQueues(
            50.0 * torch.rand(shape, generator=g, device=grid.device),
            5.0 * torch.rand(shape, generator=g, device=grid.device))
        return dataclasses.replace(states, queues=q)

    def grid_args(g, states):
        p = g.params
        return (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, states.lam,
                states.gain, states.queues.energy, states.queues.memory,
                g.sweep_scalars)

    main_args = grid_args(grid, with_queues(grid.reset(grid.generator(1)), 2))
    main_plain = ref.partition_sweep_batched_ref(*main_args)
    errs = [check_sweep(torch, ops.partition_sweep_batched(*main_args),
                        main_plain, f"(a) grid {GRID_CELLS}x{GRID_UES}")]

    # (b) the LM-profile fleet's shape: 256 UEs whose layer counts are those
    # of the repo's ten LM profiles (C = 103), per-layer costs from a seed
    rng = np.random.default_rng(0)
    layer_counts = np.array([50, 50, 28, 30, 82, 34, 28, 50, 102, 50])
    n_lm, c_lm = 256, 103
    L = layer_counts[np.arange(n_lm) % len(layer_counts)]
    live = np.arange(c_lm)[None, :] <= L[:, None]
    macs = rng.uniform(1e7, 5e8, (n_lm, c_lm)) * live
    prm = rng.uniform(1e6, 5e7, (n_lm, c_lm)) * live
    macs[:, 0] = prm[:, 0] = 0.0
    acts = rng.uniform(1e4, 1e6, (n_lm, c_lm)) * live
    psi = np.where(np.arange(c_lm)[None, :] < L[:, None], acts, 0.0)
    dev = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a)[None], dtype=dt, device="cuda").contiguous()
    lm_args = (dev(macs), dev(prm), dev(acts), dev(psi),
               dev(L, torch.int64), dev(rng.uniform(0.5, 2.5, n_lm)),
               dev(rng.exponential(1.0, n_lm) * 1.6e-11),
               dev(rng.uniform(0, 50, n_lm)), dev(rng.uniform(0, 50, n_lm)),
               ref.pack_scalars(dict(
                   rho=0.12, kappa=1e-28, p_tx=0.1, w_hz=5e6,
                   n0=10 ** (-17.4) / 1000, f_max_ue=5e9, f_max_es=200e9,
                   v=10.0, gamma_ue=0.2, gamma_es=0.8, stability_margin=1e-3),
                   "cuda"))
    errs.append(check_sweep(torch, ops.partition_sweep_batched(*lm_args),
                            ref.partition_sweep_batched_ref(*lm_args),
                            f"(b) LM-shaped fleet {n_lm}x{c_lm}"))

    # (c) a row count that is not a multiple of the 8 rows of a block
    rag = scenarios.ScenarioGrid(scenarios.multicell_grid(cells=13, ues=7,
                                                          seed=5))
    rag_args = grid_args(rag, with_queues(rag.reset(rag.generator(3)), 4))
    errs.append(check_sweep(torch, ops.partition_sweep_batched(*rag_args),
                            ref.partition_sweep_batched_ref(*rag_args),
                            "(c) ragged 13x7 = 91 rows"))

    # (d) cells with their own Lyapunov weight V: one launch, one row of
    # constants per cell
    mixed = scenarios.ScenarioGrid(scenarios.multicell_grid(
        cells=512, ues=GRID_UES, seed=11, uniform_scalars=False))
    v_col = mixed.sweep_scalars[:, ref.SCALAR_NAMES.index("v")]
    if int(torch.unique(v_col).numel()) < 2:
        fail("(d) the mixed grid's cells share V")
    mix_args = grid_args(mixed, with_queues(mixed.reset(mixed.generator(5)), 6))
    errs.append(check_sweep(torch, ops.partition_sweep_batched(*mix_args),
                            ref.partition_sweep_batched_ref(*mix_args),
                            "(d) per-cell constants 512x8"))

    rows, c = GRID_CELLS * GRID_UES, grid.num_cuts
    run_kernel = lambda: ops.partition_sweep_batched(*main_args)
    run_plain = lambda: ref.partition_sweep_batched_ref(*main_args)
    kernel_ms, plain_ms = device_ms(torch, run_kernel, 50), device_ms(torch, run_plain, 5)
    kernel_call_ms, plain_call_ms = call_ms(torch, run_kernel, 50), call_ms(torch, run_plain, 5)
    n_feasible = int((main_plain < BIG).sum())
    n_bytes = ps.byte_count(rows, c, GRID_CELLS)
    n_ops = ps.op_count(rows, c, n_feasible)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"    at {GRID_CELLS}x{GRID_UES}x{c} ({n_feasible} of {rows * c} cuts "
        f"feasible), device time per call: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({n_ops / 1e9:.3f} GFLOP, "
        f"{n_bytes / 1e6:.2f} MB); wall per call: kernel "
        f"{kernel_call_ms:.4f} ms, plain {plain_call_ms:.3f} ms")
    report["partition_sweep"] = {
        "feasible": n_feasible, "cuts": rows * c, "gflop": n_ops / 1e9,
        "mbytes": n_bytes / 1e6, "ms": kernel_ms, "plain_ms": plain_ms,
        "call_ms": kernel_call_ms, "plain_call_ms": plain_call_ms,
        "bound_ms": bound_ms, "max_abs_err": errs}

    # -- 3. main path ----------------------------------------------------------
    log(f"[3] main path: ScenarioGrid {GRID_CELLS}x{GRID_UES}, "
        f"{MAIN_SLOTS} slots per policy")
    L_grid = grid.params.L
    policies = {}
    ps.partition_sweep_cuda.launches = 0
    for policy in ("oracle", "local", "edge", "random"):
        t0 = time.perf_counter()
        states, res, summary = grid.make_rollout(policy, MAIN_SLOTS)(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for name in ("reward", "delay", "energy", "mem_cost", "alpha", "f_ue"):
            if not bool(torch.isfinite(getattr(res, name)).all()):
                fail(f"{policy}: non-finite {name}")
        if not bool(((res.cut >= 0) & (res.cut <= L_grid)).all()):
            fail(f"{policy}: cut outside [0, L]")
        for q in (res.q_energy, res.q_memory, states.queues.energy,
                  states.queues.memory):
            if not bool((q >= 0).all()):
                fail(f"{policy}: negative virtual queue")
        row = {"delay_ms": float(summary["delay"].mean()) * 1e3,
               "energy_mJ": float(summary["energy"].mean()) * 1e3,
               "reward": float(summary["reward"].mean()),
               "cut_mean": float(summary["cut_mean"].mean()),
               "slots_per_s": MAIN_SLOTS / dt, "slot_ms": dt / MAIN_SLOTS * 1e3}
        policies[policy] = row
        log(f"    {policy:7s} delay {row['delay_ms']:8.2f} ms  energy "
            f"{row['energy_mJ']:6.2f} mJ  reward {row['reward']:9.3f}  "
            f"{row['slots_per_s']:.2f} slots/s ({row['slot_ms']:.1f} ms/slot)")
    launches = ps.partition_sweep_cuda.launches
    if launches != MAIN_SLOTS:
        fail(f"partition_sweep launched {launches} times over the main path, "
             f"expected one per oracle slot ({MAIN_SLOTS})")
    log(f"    partition_sweep launches over the main path: {launches}")
    report["main_path"] = policies

    log(f"    card vs the port's CPU path: {SMALL_CELLS}x{GRID_UES} grid, "
        f"{SMALL_SLOTS} slots on the same draws")
    cells = scenarios.multicell_grid(cells=SMALL_CELLS, ues=GRID_UES, seed=9)
    g_gpu = scenarios.ScenarioGrid(cells)
    g_cpu = scenarios.ScenarioGrid(cells, device="cpu")
    mean_gain = g_cpu.params.mean_gain.numpy()[None, :, None]
    gains = (rng.exponential(1.0, (SMALL_SLOTS + 1, SMALL_CELLS, GRID_UES))
             * mean_gain).astype(np.float32)
    lams = np.stack([g_cpu.params.arrival(None, t).numpy()
                     for t in range(SMALL_SLOTS + 1)])
    for policy in ("oracle", "local", "edge"):
        outs = [g.make_rollout(policy, SMALL_SLOTS, draws=(gains, lams))(0)
                for g in (g_gpu, g_cpu)]
        (_, r_gpu, s_gpu), (_, r_cpu, s_cpu) = outs
        same_cut = float((r_gpu.cut.cpu() == r_cpu.cut).float().mean())
        worst = max(float(((s_gpu[k].cpu() - s_cpu[k]).abs()
                           / s_cpu[k].abs().clamp_min(1e-12)).max())
                    for k in ("reward", "delay", "energy", "mem"))
        log(f"      {policy:7s} same cuts {same_cut:.3f}, worst summary rel "
            f"diff {worst:.2e}")
        if same_cut < 0.95 or worst > 1e-2:
            fail(f"{policy}: card and CPU paths disagree")

    prof = profile_grid(torch, grid, PROFILE_SLOTS)
    report["profile"] = prof
    if prof["device_s"] is None:
        log("    profiler: no device time recorded (not measured)")
    else:
        log(f"    profiler over {PROFILE_SLOTS} oracle slots: wall "
            f"{prof['wall_s']:.3f} s, device busy "
            f"{prof['device_busy_share']:.3f}, "
            f"{prof['device_ops_per_slot']:.0f} device ops/slot, "
            f"partition_sweep {prof['sweep_device_ms']} ms per launch")
        for row in prof["top"]:
            log(f"      {row['device_ms']:9.3f} ms  x{row['count']:<7d} "
                f"{row['name']}")

    # -- 4. single cell --------------------------------------------------------
    log(f"[4] single cell: paper_env @2.5 req/s, run_fixed, {SINGLE_SLOTS} slots")
    env = menv.paper_env(menv.MecConfig(lam_mode=menv.LAM_FIXED))
    single = {}
    for name, fn in [("Local", lymdo.local_cut_fn(env)),
                     ("Edge", lymdo.edge_cut_fn(env)),
                     ("Random", lymdo.random_cut_fn(env)),
                     ("Oracle", lymdo.oracle_cut_fn(env))]:
        m, res = lymdo.run_fixed(env, fn, episodes=1, steps=SINGLE_SLOTS)
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"single cell {name}: non-finite metrics")
        if res.delay.shape != (SINGLE_SLOTS, env.n_ue):
            fail(f"single cell {name}: result shape {tuple(res.delay.shape)}")
        single[name] = m
        log(f"{name:7s} @2.5req/s: delay {m['delay'] * 1e3:7.1f} ms  "
            f"energy {m['energy'] * 1e3:5.1f} mJ  reward {m['reward']:8.2f}")
    if single["Oracle"]["reward"] < max(single["Local"]["reward"],
                                        single["Edge"]["reward"]) - 1e-3:
        fail("the oracle scores worse than a fixed baseline")
    report["single_cell"] = single

    kernels = [{
        "name": "partition_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/partition_sweep.cu",
        "replaces": "src/repro/kernels/partition_sweep.py:175",
        "launches": launches, "max_abs_err": max(errs), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    report["kernels"] = kernels
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
