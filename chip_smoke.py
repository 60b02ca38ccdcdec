#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through their public entry points -- the
LyMDO controller deciding and scoring slots for a 4096-cell x 8-UE grid
(32,768 UEs), its PPO agent training and evaluating, and LMs served at
full width on the ES tier: qwen3-0.6b, mamba2-1.3b and the MoE
moonshot-v1-16b-a3b through the partitioned server, recurrentgemma-2b
through the serving launcher, and llama4-maverick, llama-3.2-vision and
seamless-m4t through the model's entry points; qwen3-0.6b, mamba2-1.3b
and recurrentgemma-2b trained at full width through the training
launcher; the grid sharded over a cells mesh
of processes; qwen3-0.6b served tensor-parallel over two ranks; the
grid's per-cell model axis; qwen3-0.6b trained over a (data, model) mesh
of processes -- and
checks every kernel of those paths against its plain PyTorch version on
the card:

1. builds the five CUDA kernel sources in this checkout (flash
   attention's, the SSD scan's and the RG-LRU scan's hold their backwards
   too), one nvcc process per source, all at once;
2. holds each kernel against its plain version at the main path's shapes
   and more -- the learning loop's one-cell Oracle (5 UEs, through the
   one-cell entry) and its 4096 x 5 grid of Fig. 4 cells, an LM-shaped
   fleet (C = 103), a ragged row count, a grid whose cells have their own
   MEC constants, and C = 1, 8, 16, 17, 32, 33
   (the rows a warp packs: 32, 4, 2, 1) at row counts no block's rows
   divide (rtol 1e-4 / atol 1e-3 on
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
4. runs the learning loop: ``python -m repro_torch.quickstart``'s ``main``
   (``QS_ARGS``: PPO with the categorical head trains on the paper scenario
   for 1 episode of 4 slots, is evaluated at 2.5 req/s, and the Local,
   Edge, Random and Oracle baselines run beside it; the sweep's launches
   must equal the Oracle's slots, Adam's step epochs x episodes, the
   metrics finite and the Oracle no worse than Local or Edge), joint mode
   (the paper's "PPO" baseline) for 2 episodes at K = 200, one PPO update
   at K = 200 on the card against the same update on the CPU (each head),
   the trained agent through ``eval_policy_batched`` beside the Oracle on
   a 4096-cell grid of Fig. 4's fixed rates for 3 slots (the Oracle also
   for 10 slots on the card and on a CPU copy of that grid on the same
   draws, held as phase 3 holds its small grid), and profiles of
   PROFILE_SLOTS rollout slots and of one K = 200 update, composed into a
   training slot (a rollout slot and 1/K of an update);
5. holds the flash and decode attention kernels against their plain
   versions at the serving path's shapes (phase 11's among them) and at
   the reference's own kernel test cases, each float32 case with a bf16 twin for flash's tensor-core
   body, and at phase 10's sync waves (flash at B8 with a pad per row, the
   dense decode under the wave's pad mask) in both types (2e-5 in
   float32, 2e-2 in bf16; rows of a left pad, which see no key, are
   compared only for being finite and zero), split-K decode with a
   row whose keys are all masked and a split whose keys are, and the paged
   decode entry against the gather and the plain version over a scattered
   block table; and times each at the main path's shape: device time, wall
   time per call, the plain version, torch's scaled_dot_product_attention
   as a yardstick, and the bound (the paged entry also beside the gather +
   dense kernel it replaces);
6. runs ``python -m repro_torch.serve_partitioned``'s ``main`` at full width
   (qwen3-0.6b, 28 layers, bf16, seeded random weights): the controller
   decides 3 slots, the split runs at the chosen and the middle unit cut
   against the monolithic pass, and the continuous-batching engine serves
   16 requests of 8-300 prompt tokens, counting the attention kernels'
   launches over that run; then checks, on the card, that a float32 copy
   at 4 layers gives each request the tokens of its solo run, and that a
   2-layer bf16 prefill agrees with the port's CPU path;
7. holds the SSD and RG-LRU scan kernels against their plain versions
   (the reference's kernel test cases, resets mid-tile and on the tile
   boundary, odd lengths, G = 2 and 3, the SSD's chunk edges S = T - 1, T,
   T + 1, 3T + 5 with resets at step 0, on a chunk boundary and twice in
   one chunk, and the shapes of mamba2's and recurrentgemma's solo
   prefills and split check, in float32 and bf16; the RG-LRU kernel's
   segment and tile edges: S = 1, odd S, resets on a segment's first and
   last step, on a tile boundary and twice in one segment, R not a
   multiple of its channel tile; 1e-4 in float32 and for the SSD state,
   2e-2 for an output rounded to bf16) and the attention kernels at
   recurrentgemma's shapes (10 heads over 1 kv head, hd 256, a
   2048 window and a 64 one, a scattered 2048-slot ring), the RG-LRU scan
   and hd-256 flash at phase 10 (d)'s sync waves (B8 R2560 with each
   row's pad-reset run; a pad per row) and the ring decode under a wave's
   pad mask, and times both
   scans at the split check's shape and at their engine shapes (a 32-token
   solo prefill with a left pad of 3), the RG-LRU at the split shape once
   more with the L2 flushed before each call, decode over the ring and
   flash at recurrentgemma's prefill shapes;
8. runs ``serve_partitioned.main`` with ``--arch mamba2-1.3b`` (48 layers,
   bf16): controller, split at the chosen and middle unit, a ragged burst
   of 6 requests of 8-48 tokens (12 of 8-160 before phase 17 was added);
   SSD launches must be exactly 48 per monolithic or split pass and per
   solo prefill or first chunk (later chunks replay the decode step);
   then profiles 3 decode ticks of 8 slots, checks float32
   engine tokens == solo tokens at 4 layers with preemption, and a 2-layer
   bf16 prefill on the card against the CPU;
9. runs ``python -m repro_torch.launch.serve``'s ``main`` for
   recurrentgemma-2b (26 layers, bf16), then a ragged burst of 8 requests
   of 8-160 prompt tokens through an engine built as the launcher builds
   it; RG-LRU launches must be exactly 18 and flash 8 per solo prefill or
   first chunk, decode attention 8 per decode tick and per prompt token a
   later chunk replays; then the same profile and float32 checks at 5
   layers, and card against CPU: two bf16 evaluations of this stack part
   by more than the 2e-2 band, so the card's bf16 logits are held by their
   distance from a float32 evaluation, and its float32 logits to the CPU's
   at 1e-4;
10. drives the engine's other modes and the traffic loop: (a) qwen3-0.6b at
   full width through the sync engine that ``traffic_demo --sync`` builds
   (telemetry and a traffic recorder; phase 6's mix of 16 requests), its
   float32 tokens at 4 layers held to solo runs; (b) the same mix on the
   continuous engine with telemetry and the sanitizer, then the
   sanitizer's flash crowd (3 slots, 7 blocks: preemption must fire) on
   the same model and ``python -m repro_torch.analysis --sanitize``; (c)
   (a)'s recorded trace replayed on a 16-cell ``trace_replay`` grid under
   the Oracle and read back by ``python -m repro_torch.traffic --show``;
   (d) recurrentgemma-2b through ``launch.serve --sync-batching`` and
   phase 9's burst through a sync engine, its float32 tokens at 5 layers
   held to solo runs; every wave (a) and (d) prefill must be one that
   phases 5 and 7 held the kernels at; (e) ``train_lymdo`` killed
   after its first chunk and resumed, against an uninterrupted run
   (parameters within 1e-5); (f) ``train_compare`` at 1 episode x 4
   slots per agent; (g) ``python -m repro_torch.obs --overhead`` (the
   hooks' own time a tick within 5 % of the disabled tick p50).  Kernel
   launches are held to exact counts (flash 28 per wave prefill and
   decode attention 28 per decode tick in (a); the sweep one per Oracle
   slot in (c) and (f); RG-LRU 18 per wave prefill in (d));
   every request's delay-breakdown stages sum to its E2E ticks, the
   Prometheus text parses and the Chrome trace round-trips;
11. drives the remaining layer kinds at full width: (a) moonshot-v1-16b-a3b
   (48 "m" layers, 56.3 GB in bf16) through ``serve_partitioned.main``
   (``MOON_ARGS``: controller, split, 8 requests with whole-prompt
   prefill; its init may peak at the parameters plus one layer) and the
   same burst through the sync engine ``launch.serve --sync-batching``
   builds, a profile of 3 decode ticks, float32 engine tokens == solo
   tokens at 4 layers (with preemption, at the no-drop capacity factor),
   card against CPU in bf16 at 2 layers with the MoE routes compared
   first; (b) llama4-maverick, one unit (g, m), (c) llama-3.2-vision, two
   units (g g g g x) with 1,024 image embeddings, and (d) seamless-m4t,
   24 encoder + 24 decoder layers over 512 source frames, each through
   ``prefill`` (B4, 128 tokens) and greedy ``decode_step``s, with
   float32 greedy == teacher-forced tokens and card against CPU.  Flash
   and decode launches are held to exact counts (moonshot 48 a prefill
   and a tick; llama4 2 and 2; vision 10 and 10; seamless 72 and 48), and
   the phase fails if it launches either kernel at a shape phase 5 did
   not hold;
12. trains the LM on the card: (a) holds the flash backward kernel (through
   ``ops.flash_attention`` with a gradient wanted) against autograd through
   the float32 plain version at the training shape (B4 S512 H16/8 hd128,
   causal), gemma3's window at hd 256, cross attention with Sq != Sk, GQA
   groups of 1, 5 and 8, hd 32 and 64, S = 333 and left pads whose rows
   see no key (1e-4 in float32, 2e-2 in bf16, of max(1, max |g|); such a
   row's dO zeroed on both sides, then restored: dq = 0 there and dk, dv
   unchanged bit for bit), and times forward + backward and the backward
   alone beside the plain version, SDPA and the bound; (b) runs
   ``python -m repro_torch.launch.train``'s ``main`` (``TRAIN_ARGS``:
   qwen3-0.6b at full width, 28 layers, bf16, remat, 2 microbatches, B8
   S512, 8 steps; 12 before phase 17 was added) with exact launches
   (flash 112 forwards and 56 backwards a step, no other kernel), a
   falling loss, and a checkpoint at step 5, from which a second run
   resumes (until phase 20 a third run, stopped at step 4, wrote it);
   the resumed run's parameters and moments must equal the uninterrupted
   run's bit for bit; step time p50,
   tokens/s, MFU (``roofline.step_flops``' model flops over the step time
   and ``roofline.PEAK_FLOPS``), peak memory and a profile of 3 steps;
   (c) one float32 step card against CPU at 4 layers and full width
   (qwen3-0.6b, the whole ``make_train_step`` step; gemma3-1b as (l, g);
   moonshot at the no-drop capacity factor); (d) ``python -m
   repro_torch.train_lm --steps 100``, whose loss must fall;
13. drives the cells mesh (``launch.mesh``, ``core.gridshard``,
   ``ScenarioGrid.use_mesh``): (a) ``python -m repro_torch.scenario_sweep``'s
   ``main`` (``MESH_SWEEP_ARGS``) on a one-rank NCCL mesh, its sharded leg
   with no drift and one sweep launch per Oracle slot; (b) three processes
   on the one card, joined over gloo (NCCL takes one rank a device), run
   phase 3's grid padded to 4,098 cells (1,366 a rank) under the Oracle
   and Random for MAIN_SLOTS slots, and every rank's gathered results,
   states and summaries must equal phase 3's unsharded ones (cuts
   identical, floats within rtol 1e-5 / atol 1e-7), with one sweep launch
   a rank per Oracle slot over its 1,366 cells; each rank's slot time is
   logged beside phase 3's, and one gather timed alone; (c)
   ``train_compare`` on a two-rank world on the card (gloo), whose Fig. 4
   must equal phase 10 (f)'s one-rank run to 1e-5.  A rank that fails or a
   world that outlives its deadline fails the run; the phase logs its
   seconds against a 90 s budget;
14. drives the model axis (``launch.sharding``, ``shardctx``,
   ``ServingEngine(mesh=)``, ``PartitionedLM(mesh=)``): two processes on
   the one card, joined over gloo, on ``make_cells_mesh(model=2)``: (a)
   qwen3-0.6b at full width and depth (bf16; 8 of 16 query heads, 4 of 8
   kv heads, 1,536 of 3,072 FFN columns and 75,968 of 151,936 vocabulary
   rows a rank) through ``PartitionedLM(mesh=).es_engine()`` on phase 6's
   burst cut to 4 requests (8 before phase 17 was added), with exact
   launches a rank (flash 28 a
   prefill, decode 28 a tick), tick p50/p99 and tokens/s beside phase 6's
   one-rank numbers, and a profile of 3 decode ticks for the collectives'
   share; (b) float32 engines at 4 layers and full width -- qwen3 (g),
   recurrentgemma (r, r, l, r), mamba2 (s), moonshot (m, no-drop) --
   whose tokens, chunked prefill and preemption included, must equal the
   one-rank card engine's on every rank, and qwen3's bf16 prefill logits at
   full width, which may stand at most ``BF16_DRIFT`` times as far from the
   one-rank float32 logits as the one-rank bf16 logits do.  Every kernel
   call a rank makes must be at a shape phase 5 (attention) or phase 7
   (scans) held; a failing rank or a world past its deadline fails the
   run; the phase logs its seconds against a 90 s budget;
15. drives the grid's model axis and the mesh's training half, on one card
   over gloo: (a) two processes on ``make_cells_mesh(model=2)`` run phase
   3's grid with 4 of each cell's 8 UEs a rank for 3 slots of the Oracle
   and Random, whose gathered results must equal phase 3's first 3
   slots, with one sweep launch a rank per Oracle slot over 4096 x 4 rows
   and the even split over 8; (b) four processes on a (data 2, model 2)
   mesh run ``launch.train.main`` (``TM_ARGS``: qwen3-0.6b at full width,
   bf16, remat, B8 S512 over the world, 2 microbatches, 4 steps, at
   ``TM_LAYERS`` of its 28 layers) with exact flash launches a rank and a
   finite loss, logging step p50 a rank, tokens/s over the world, the
   collectives' share of a step and peak memory a rank; (c) in the same
   world, one float32 step of qwen3 and gemma3-1b (l, g) at 4 layers and
   moonshot (no-drop) at 1, at full width, equal to the one-rank card
   step (Adam's moments within 1e-4 / 2e-4 of each leaf's max, the next
   batch's loss within 1e-5), and ``make_grad_sync`` in modes bf16 and
   int8 on card tensors equal to the same call on CPU ones, bit for bit.
   Every shape a rank launches flash at must be one phase 5 and phase 12
   (a) held; the phase logs its seconds against a 90 s budget;
16. drives ZeRO-3 training in the rank-local layout, in phase 15's world
   after its (c): (a) ``launch.train.main(TZ_ARGS)`` (15 (b)'s run, 3
   steps) under qwen3's recommended options (every layer whole on each model rank, the
   vocabulary over "model", ZeRO-3 storage over ("data", "model"), 2
   microbatches) with exact flash launches a rank and a finite, falling
   loss, logging step p50, the collectives' share and peak memory a rank
   beside phase 15 (b)'s; (b) one float32 step of qwen3 at 4 layers under
   those options against the one-rank card step (phase 15 (c)'s bars),
   and the same step with ``remat_offload`` equal to it bit for bit; (c)
   ``python -m repro_torch.launch.dryrun`` in a subprocess off the card
   (started after the build, so that it runs beside the earlier phases):
   qwen3-0.6b's cells on the single-pod mesh under ``--recommended``
   (memory, flops and collective bytes printed), and (a)'s cell on a
   (data 2, model 2) fake world, whose argument bytes and one step's
   collective ledger must equal (a)'s rank's, kind for kind, count for
   count and byte for byte; its predicted peak is printed beside (a)'s
   ``torch.cuda.max_memory_allocated``.  The phase logs its seconds
   against a 60 s budget;
17. drives the MoE's knobs on the "data" axis, in phase 15's world after
   phase 16: moonshot-v1-16b-a3b at full width (1 of its 48 layers, 64
   experts of F 1,408, top-6, a shared expert, capacity 1.25), B4 S384,
   so that its 1,024-token dispatch group 0 straddles the two data ranks'
   768 tokens and group 1 holds 512 zero pads, under (a) the baseline
   layout, (b) llama4-maverick's recommended training options
   ("moe-only", ``expert_shard_dff``, ``remat_offload``) and (c)
   ``expert_mesh="data"``, each with ZeRO-3 off: 3 bf16 steps (exact
   flash launches, step p50, the collectives' share, peak memory) and one
   float32 step whose loss, ce and aux (1e-6 relative), router and expert
   0 gradients (1e-5 of each leaf's max) and kept slots (exactly) are
   held to one rank's float32 step on the card.  The phase logs its
   seconds against a 120 s budget.
18. drives ``seq_shard`` (qwen3-0.6b trained sequence-parallel) and the
   sequence-split KV caches (gemma3-1b's sync engine) in phase 15's
   world; the phase logs its seconds against a 120 s budget.
19. runs ``repro_torch.analysis``'s probes on the card, in this process:
   (a) the retrace probes' serving and chunked engines (reduced
   qwen3-0.6b, float32, the reference's two waves each) stay within their
   prefill-signature bounds and give every request the greedy tokens the
   same probe gives on the CPU; (b) three Oracle rollouts of a 3-cell
   grid build no kernel and load no library again; (c) the donation
   probe: every pool leaf keeps its storage over a tick and both commits,
   and the tick's peak memory grows by less than one pool (both figures
   logged); (d) ``--lint --json`` exits 0.  Its launches are counted
   exactly, each shape is one phase 5 held, and
   at the end every kernel library is loaded once in this process.  The
   phase logs its seconds against a 30 s budget.
20. trains the "s" and "r" kinds on the card, in this process: (a) holds
   the SSD and RG-LRU backward kernels (through ``ops.ssd_scan`` /
   ``ops.rglru_scan`` with a gradient wanted, so ``SsdScan`` /
   ``RglruScan``) against autograd through the float32 plain versions
   (1e-4 of max(1, max |g|) in float32, 2e-2 for a gradient that comes out
   in bf16; each case twice, equal bit for bit): the SSD at mamba2's
   training shape (B4 S512 H64 P64 N128) in bf16 and float32, S = 1, 63,
   64, 65 and 333 (the one-kernel path and the chunk edges), G 2 over 4
   heads, resets at step 0, on a chunk boundary and twice in one chunk,
   the final state's cotangent absent (as in training), zero and drawn;
   the RG-LRU at B4 S512 R2560 in float32 and bf16, S = 1, an odd S with
   resets on a segment's first and last step and on a tile boundary, R
   not a multiple of the channel tile; flash's backward at
   recurrentgemma's "l" shape (B4 S512 H10/1 hd256, window 2,048); and
   times each backward alone at its training shape beside the plain
   version's autograd and the bound; (b) ``launch.train.main``
   (``MAMBA_TRAIN_ARGS``: mamba2-1.3b at full width and depth, 48 "s"
   layers, bf16, remat, B8 S512 in 2 microbatches, 5 steps, lr 3e-4) with
   exact launches (SSD forward 2 x 48 a microbatch, backward 48, no other
   kernel), a falling loss, step p50, tokens/s, MFU, peak memory and a
   profile of 3 steps; (c) the same for recurrentgemma-2b at full width
   and ``RG_TRAIN_LAYERS`` = 5 layers, one (r, r, l) unit and the (r, r)
   tail (RG-LRU forward 6 and backward 4 a microbatch, flash 2 and 1); (d)
   one float32 step card against CPU at full width and 4 layers
   (``train_card_vs_cpu``; mamba2's "s" x 4, recurrentgemma's (r, r, l,
   r)) with exact launches.  (a) also checks that decode attention (dense
   and paged) and the sweep, which have no backward, still raise
   NotImplementedError on the card where a gradient is wanted through
   them, and run under no_grad.  The phase logs its
   seconds against a 75 s budget.  To pay for it, phase 12 (b) resumes
   from its uninterrupted run's checkpoint instead of a third run stopped
   at step 4, phases 3 and 4 (e) profile one slot instead of 3, and every
   profile traces the device's activity only (``profiled``).

It exits nonzero, printing no result, where CUDA is unavailable or any
check fails.  It logs the seconds each phase takes.  The last lines are the
card's name and power limit, one JSON line of per-kernel numbers and one
JSON status line.  A longer report goes to build/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 SXM's peaks (NVIDIA data sheet), from the port's one source of
# them: HBM bytes/s, float32 FLOP/s outside the tensor cores, dense bf16
from repro_torch.profiling.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_S, PEAK_F32_FLOPS as PEAK_F32_S,
    PEAK_FLOPS as PEAK_BF16_S)
RTOL, ATOL = 1e-4, 1e-3          # the sweep tolerance of the reference's tests
ATT_TOL_F32, ATT_TOL_BF16 = 2e-5, 2e-2   # the attention tolerances of the same tests
BIG = 1e29
GRID_CELLS, GRID_UES = 4096, 8
# timed (8 before PR 25, which cut it to make room for phase 16);
# SMALL_SLOTS hold card vs CPU
MAIN_SLOTS = 5
SMALL_CELLS, SMALL_SLOTS = 8, 20
# card against the port's CPU path on the same draws: the P3/P5 minimizers
# are flat to float32 rounding, so cuts may differ in a few places
SAME_CUT_MIN, SUMMARY_RTOL = 0.95, 1e-2
# the grid's and the training loop's profiles: one slot (3 before phase
# 20 was added; every slot issues the same ~33,800 device ops, and the
# profiler took ~0.35 ms an op to average them)
PROFILE_SLOTS = 1
# the card's bf16 logits may stand this many times as far from a float32
# evaluation as the CPU's bf16 logits (1.015-1.027 in the chip runs that
# set it, on qwen3-0.6b, mamba2-1.3b and recurrentgemma-2b)
BF16_DRIFT = 1.25
SERVE_ARGS = ["--split-seq", "512"]   # full width, 28 layers, bf16, 16 requests
PROFILE_TICKS = 5


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


PROFILE_TRIES = 5     # a profile on an H100 once recorded nothing 3 times running


def profiled(torch, run):
    """(the CUDA kernels' rows of ``key_averages``, wall seconds) of
    ``run()`` under torch.profiler, tracing the device's activity only:
    every caller reads the device's rows, and tracing the host's ops too
    made a 3-step profile of a mamba2-1.3b training step take ~50 s on an
    H100 (20 s without them), its wall time inflated with it.  A profile
    that records no device time is taken again, PROFILE_TRIES times in
    all; then the run fails."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        if rows:
            return rows, wall_s
        log(f"    the profiler recorded no device time (try {attempt + 1})")
    fail(f"the profiler recorded no device time in {PROFILE_TRIES} tries")


def flushed_device_ms(torch, fn, iters: int, name: str) -> float:
    """Device time per call of the kernels whose name holds ``name``, each
    call after a FLUSH_BYTES write that pushes its inputs out of the 50 MB
    L2 (the write's own kernel is not counted)."""
    scratch = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def run():
        for _ in range(iters):
            scratch.fill_(1.0)
            fn()
    run()
    torch.cuda.synchronize()
    rows, _ = profiled(torch, run)
    picked = [e for e in rows if name in e.key]
    if not picked:
        fail(f"no kernel named like {name!r} in the flushed profile")
    return per_call_ms(picked, iters)


def per_call_ms(rows, iters: int) -> float:
    """Device ms per call from the kernel rows of a profile of ``iters``
    identical calls: each kernel's mean duration per record times its
    launches per call, ceil(records / iters).  After a large profile
    (phase 3's), later torch.profiler sessions in the same process drop
    kernel records (on an H100: 2 of 50 after 100,000 profiled kernels,
    up to 25 of 50 in phases 5-9), so the records' sum over ``iters``
    under-reads the time; the mean of the kept records does not.  The
    launches per call come out exact while a kernel launched k times a
    call keeps more than (k - 1) x iters of its k x iters records."""
    total, kept, launched = 0.0, 0, 0
    for e in rows:
        per_call = -(-e.count // iters)
        total += e.device_time_total / e.count * per_call
        kept, launched = kept + e.count, launched + per_call * iters
    if kept < launched:
        log(f"    (the profiler kept {kept} of {launched} kernel records; "
            f"time per call from the kept records' means)")
    return total / 1e3


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call of the CUDA kernels that ``iters`` calls
    launch, from torch.profiler, after a warm-up (``per_call_ms``)."""
    fn()
    torch.cuda.synchronize()
    rows, _ = profiled(torch, lambda: [fn() for _ in range(iters)])
    return per_call_ms(rows, iters)


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
    # with one cut there is no second best: every row's argmin is clear
    clear = ((srt[..., 1] - srt[..., 0]) > tol if got.shape[-1] > 1
             else torch.ones_like(tol, dtype=torch.bool))
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


def random_sweep_args(torch, np, cells: int, ues: int, c: int, seed: int):
    """(cells, ues, C) sweep inputs drawn from ``seed``, zero past each UE's
    layer count L (L < C; L = 0 at C = 1), with one row of MEC constants."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    lead = (cells, ues)
    L = np.minimum(rng.integers(max(1, c // 3), max(c, 2), lead), c - 1)
    L.reshape(-1)[0] = c - 1
    live = np.arange(c) <= L[..., None]
    macs = rng.uniform(1e6, 5e7, lead + (c,)) * live
    prm = rng.uniform(1e3, 5e6, lead + (c,)) * live
    macs[..., 0] = prm[..., 0] = 0.0
    acts = rng.uniform(1e4, 2e6, lead + (c,)) * live
    psi = np.where(np.arange(c) < L[..., None], acts, 0.0)
    dev = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device="cuda").contiguous()
    return (dev(macs), dev(prm), dev(acts), dev(psi), dev(L, torch.int64),
            dev(rng.uniform(0.5, 2.5, lead)),
            dev(rng.exponential(1.0, lead) * 1.6e-11),
            dev(rng.uniform(0, 50, lead)), dev(rng.uniform(0, 50, lead)),
            ref.pack_scalars(dict(
                rho=0.12, kappa=1e-28, p_tx=0.1, w_hz=5e6,
                n0=10 ** (-17.4) / 1000, f_max_ue=1.5e9, f_max_es=15e9,
                v=10.0, gamma_ue=0.2, gamma_es=0.8, stability_margin=1e-3),
                "cuda"))


def sweep_cases(torch, grid, rng) -> list:
    """Phase 2's sweep inputs, (label, entry arguments) each, (B, N, C)
    tables for the batched entry and (N, C) ones for the one-cell entry:
    (a) the main path's grid (``grid``, 4096 x 8, C = 11) with queues drawn
    from a seed; (b) an LM-shaped fleet (C = 103) drawn from ``rng``; (c) a
    ragged row count; (d) a
    grid whose cells have their own Lyapunov weight V; (e) C = 1, 8, 16,
    17, 32, 33 (32, 4, 2, 1, 1, 1 rows a warp) at row counts that no
    block's rows divide; (f) phase 4's one-cell Oracle, the quickstart's
    evaluation cell (5 UEs, C = 11); (g) phase 4's grid of EVAL_CELLS
    fixed_rate cells (5 UEs each)."""
    import numpy as np
    from repro_torch.core import env as menv
    from repro_torch.core import scenarios, sweep
    from repro_torch.core.lyapunov import VirtualQueues
    from repro_torch.kernels import partition_sweep as ps
    from repro_torch.kernels import ref

    def with_queues(g, states, seed):
        gen = g.generator(seed)
        shape = states.lam.shape
        q = VirtualQueues(
            50.0 * torch.rand(shape, generator=gen, device=g.device),
            5.0 * torch.rand(shape, generator=gen, device=g.device))
        return dataclasses.replace(states, queues=q)

    def grid_args(g, seed):
        st = with_queues(g, g.reset(g.generator(seed)), seed + 1)
        p = g.params
        return (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, st.lam,
                st.gain, st.queues.energy, st.queues.memory, g.sweep_scalars)

    cases = [(f"(a) grid {GRID_CELLS}x{GRID_UES}", grid_args(grid, 1))]

    # (b) the LM-profile fleet's shape: 256 UEs whose layer counts are those
    # of the repo's ten LM profiles (C = 103), per-layer costs from rng
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
    cases.append((f"(b) LM-shaped fleet {n_lm}x{c_lm}", (
        dev(macs), dev(prm), dev(acts), dev(psi), dev(L, torch.int64),
        dev(rng.uniform(0.5, 2.5, n_lm)),
        dev(rng.exponential(1.0, n_lm) * 1.6e-11),
        dev(rng.uniform(0, 50, n_lm)), dev(rng.uniform(0, 50, n_lm)),
        ref.pack_scalars(dict(
            rho=0.12, kappa=1e-28, p_tx=0.1, w_hz=5e6,
            n0=10 ** (-17.4) / 1000, f_max_ue=5e9, f_max_es=200e9,
            v=10.0, gamma_ue=0.2, gamma_es=0.8, stability_margin=1e-3),
            "cuda"))))

    # (c) a row count that is not a multiple of a block's 16 rows at C = 11
    rag = scenarios.ScenarioGrid(scenarios.multicell_grid(cells=13, ues=7,
                                                          seed=5))
    cases.append(("(c) ragged 13x7 = 91 rows", grid_args(rag, 3)))

    # (d) cells with their own Lyapunov weight V: one launch, one row of
    # constants per cell
    mixed = scenarios.ScenarioGrid(scenarios.multicell_grid(
        cells=512, ues=GRID_UES, seed=11, uniform_scalars=False))
    v_col = mixed.sweep_scalars[:, ref.SCALAR_NAMES.index("v")]
    if int(torch.unique(v_col).numel()) < 2:
        fail("(d) the mixed grid's cells share V")
    cases.append((f"(d) per-cell constants 512x{GRID_UES}",
                  grid_args(mixed, 5)))

    # (e) every width of row packing, at row counts no block's rows divide
    for cells, ues, cuts in ((37, 3, 1), (19, 5, 8), (23, 3, 16), (7, 9, 17),
                             (5, 11, 32), (3, 13, 33)):
        cases.append((f"(e) C={cuts}, {cells}x{ues} = {cells * ues} rows, "
                      f"{ps.lanes_per_row(cuts)} lanes a row, "
                      f"{ps.rows_per_block(cuts)} rows a block",
                      random_sweep_args(torch, np, cells, ues, cuts, cuts)))

    # (f) and (g): the shapes the learning loop's Oracles give the kernel
    env = menv.paper_env(menv.MecConfig(lam_mode=menv.LAM_FIXED))
    st = with_queues(env, env.reset(env.generator(7)), 8)
    p = env.params
    cases.append((f"(f) the quickstart's cell, {env.n_ue} UEs, one-cell entry",
                  (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, st.lam,
                   st.gain, st.queues.energy, st.queues.memory,
                   sweep.scalar_rows_p(p))))
    fig4, _ = fig4_grid()
    cases.append((f"(g) {EVAL_CELLS} fixed_rate cells x {env.n_ue} UEs",
                  grid_args(fig4, 9)))

    # (h) phase 15 (a)'s rank: GM_COLS of each cell's GRID_UES UEs, the even
    # split over all GRID_UES
    for r in range(GM_RANKS):
        cols = slice(r * GM_COLS, (r + 1) * GM_COLS)
        cases.append((f"(h) a model rank's UEs {cols.start}-{cols.stop - 1} "
                      f"of the {GRID_CELLS}x{GRID_UES} grid, split over "
                      f"{GRID_UES}",
                      tuple(t[:, cols] for t in cases[0][1][:9])
                      + (cases[0][1][9], GRID_UES)))
    return cases


def fig4_grid(device=None):
    """(a ScenarioGrid of EVAL_CELLS fixed_rate cells at Fig. 4's rates,
    repeated; each cell's rate)."""
    import numpy as np
    from repro_torch.core import scenarios
    rates = [FIG4_RATES[b % len(FIG4_RATES)] for b in range(EVAL_CELLS)]
    grid = scenarios.ScenarioGrid([scenarios.fixed_rate(rate=r)
                                   for r in rates], device=device)
    return grid, np.asarray(rates)


def compare_rollouts(torch, grids, policy: str, slots: int, draws):
    """``policy``'s rollout on a card grid and on its CPU copy, on the same
    ``draws``: (share of equal cuts, worst relative difference of the
    reward, delay, energy and memory summaries)."""
    outs = [g.make_rollout(policy, slots, draws=draws)(0) for g in grids]
    (_, r_gpu, s_gpu), (_, r_cpu, s_cpu) = outs
    same_cut = float((r_gpu.cut.cpu() == r_cpu.cut).float().mean())
    worst = max(float(((s_gpu[k].cpu() - s_cpu[k]).abs()
                       / s_cpu[k].abs().clamp_min(1e-12)).max())
                for k in ("reward", "delay", "energy", "mem"))
    return same_cut, worst


def grid_draws(np, grid, slots: int, rng):
    """(gains, lams), each (slots + 1, B, N), for ``make_rollout(draws=)``:
    exponential fading about each cell's mean gain from ``rng``, and the
    arrival process's rates."""
    mean_gain = grid.params.mean_gain.cpu().numpy()[None, :, None]
    gains = (rng.exponential(1.0, (slots + 1,) + tuple(grid.params.L.shape))
             * mean_gain).astype(np.float32)
    lams = np.stack([grid.params.arrival(None, t).cpu().numpy()
                     for t in range(slots + 1)])
    return gains, lams


def profile_grid(torch, grid, slots: int) -> dict:
    """Device time of ``slots`` Oracle slots under torch.profiler."""
    run = grid.make_rollout("oracle", slots)
    run(0)
    torch.cuda.synchronize()
    rows, wall_s = profiled(torch, lambda: run(0))
    device_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.device_time_total)[:6]
    sweep = [e for e in rows if "partition_sweep" in e.key]
    return {
        "sweep_device_ms": (sum(e.device_time_total for e in sweep) / 1e3
                            / sum(e.count for e in sweep)) if sweep else None,
        "slots": slots, "wall_s": wall_s,
        "device_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall_s,
        "device_ops_per_slot": launches / slots,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": e.device_time_total / 1e3} for e in top],
    }



# -- phase 4: the learning loop ----------------------------------------------

# the quickstart twin at the paper's widths and batch shape; the episode
# counts are cut (the reference's 60 x 200 training slots and 3 x 200
# evaluation slots per method would take over an hour of eager slots), and
# so are phases 3, 4 and 10's slot counts, to keep the smoke inside its
# time limit on a slow host (PERF.md lists the cuts)
# one training episode (two before PR 25, which cut it for phase 16)
# and 4 slots an episode (8 before phase 19 was added)
QS_ARGS = ["--episodes", "1", "--steps", "4", "--eval-episodes", "1"]
JOINT_EPISODES, PAPER_K = 2, 200
EVAL_CELLS, EVAL_SLOTS = 4096, 3     # timed
EVAL_CHECK_SLOTS = 10                # the Oracle card vs CPU on that grid
FIG4_RATES = (0.5, 1.0, 1.5, 2.0, 2.5)     # req/s, Fig. 4's sweep
UPDATE_RTOL, UPDATE_ATOL = 1e-4, 1e-5     # tests/test_torch_ppo.py's update band
UPDATE_ITERS = 5


def finite_tree(torch, tree) -> bool:
    from repro_torch import _tree
    return all(bool(torch.isfinite(x).all()) for x in _tree.leaves(tree))


def window(torch, run, calls: int) -> dict:
    """Per call of ``run()``, which makes ``calls`` calls (slots, updates):
    wall ms, device ms, device ops and the busy share under torch.profiler
    (``profiled``), and the kernels that take the most device time over
    the window."""
    rows, wall_s = profiled(torch, run)
    device_ms = sum(e.device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.device_time_total)[:6]
    return {"calls": calls, "wall_ms": wall_s * 1e3 / calls,
            "device_ms": device_ms / calls,
            "device_ops": sum(e.count for e in rows) / calls,
            "device_busy_share": device_ms / (wall_s * 1e3),
            "top": [{"name": e.key[:80], "count": e.count,
                     "device_ms": e.device_time_total / 1e3} for e in top]}


def check_update(torch, label, agents, state, traj) -> dict:
    """One PPO update on the card and on the CPU from the same parameters
    and trajectory; metrics within rtol UPDATE_RTOL, parameters within
    UPDATE_ATOL (+ UPDATE_RTOL); then the card's update timed."""
    from repro_torch import _tree
    card, cpu = agents
    got_state, got = card.update(state, traj)
    want_state, want = cpu.update(_tree.to_device(state, "cpu"),
                                  _tree.to_device(traj, "cpu"))
    worst = {}
    for name in want:
        g, w = float(got[name]), float(want[name])
        worst[name] = abs(g - w) / max(abs(w), 1e-12)
        if not (abs(g - w) <= 1e-6 + UPDATE_RTOL * abs(w)):
            fail(f"{label}: update {name} {g} on the card, {w} on the CPU")
    err = 0.0
    for a, b in zip(_tree.leaves(got_state.params),
                    _tree.leaves(want_state.params)):
        d = (a.cpu() - b).abs()
        err = max(err, float(d.max()))
        if bool((d > UPDATE_ATOL + UPDATE_RTOL * b.abs()).any()):
            fail(f"{label}: updated parameters differ, card against CPU, "
                 f"by up to {float(d.max()):.3e}")
    if int(got_state.opt_state.step) != int(state.opt_state.step) + card.cfg.epochs:
        fail(f"{label}: Adam step {int(got_state.opt_state.step)}")
    ms = call_ms(torch, lambda: card.update(state, traj), UPDATE_ITERS)
    log(f"    (c) {label}: update at K={traj.reward.shape[0]}, "
        f"{card.cfg.epochs} epochs: card vs CPU metrics rel diff "
        f"{max(worst.values()):.2e}, params max abs diff {err:.2e}; "
        f"{ms:.2f} ms an update on the card")
    return {"ms": ms, "params_max_abs_diff": err, "metrics_rel_diff": worst}


def learning_phase(torch, smi) -> dict:
    """Phase 4: the quickstart twin trains and evaluates LyMDO and runs the
    four baselines; joint mode trains at K = 200; one PPO update, card
    against CPU; the trained agent and the Oracle on a 4096-cell grid, the
    Oracle also against the CPU path; a profile of a rollout and an update,
    composed into a training slot."""
    import numpy as np
    from repro_torch import _tree, quickstart
    from repro_torch.core import env as menv
    from repro_torch.core import lymdo
    from repro_torch.core.policies import CategoricalPolicy, JointGaussianPolicy
    from repro_torch.core.ppo import PPO, Trajectory
    from repro_torch.kernels import partition_sweep as ps

    out: dict = {"card": smi}
    # (a) the quickstart twin, with the sweep's launches counted over it
    log(f"[4] (a) python -m repro_torch.quickstart {' '.join(QS_ARGS)}")
    ps.partition_sweep_cuda.launches = 0
    t0 = time.perf_counter()
    rep = quickstart.main(QS_ARGS)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ps.partition_sweep_cuda.launches
    episodes, steps = rep["episodes"], rep["steps"]
    oracle_slots = rep["eval_episodes"] * steps
    if launches != oracle_slots:
        fail(f"partition_sweep launched {launches} times over the quickstart, "
             f"expected one per Oracle slot ({oracle_slots})")
    methods = {"LyMDO": rep["lymdo"], **rep["baselines"]}
    for name, m in methods.items():
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"quickstart {name}: non-finite metrics")
        if rep["shapes"][name] != [steps, 5]:
            fail(f"quickstart {name}: result shape {rep['shapes'][name]}")
    b = rep["baselines"]
    if b["Oracle"]["reward"] < max(b["Local"]["reward"],
                                   b["Edge"]["reward"]) - 1e-3:
        fail("the oracle scores worse than a fixed baseline")
    agent, state = rep["agent"], rep["train_state"]
    if int(state.opt_state.step) != agent.cfg.epochs * episodes:
        fail(f"Adam step {int(state.opt_state.step)}, expected "
             f"{agent.cfg.epochs} x {episodes}")
    for name in ("loss", "actor_loss", "critic_loss", "ratio_max", "reward"):
        h = np.asarray(rep["history"][name])
        if h.shape != (episodes,) or not np.isfinite(h).all():
            fail(f"training history {name}: {h}")
    init = agent.init(torch.Generator(device="cuda").manual_seed(rep["seed"]))
    moved = max(float((a - b).abs().max()) for a, b in
                zip(_tree.leaves(state.params), _tree.leaves(init.params)))
    if not moved > 0 or not finite_tree(torch, state.params):
        fail(f"trained parameters: moved {moved}, or not finite")
    train_slot_ms = rep["train_s"] / (episodes * steps) * 1e3
    log(f"    {main_s:.1f} s: trained {episodes} x {steps} slots in "
        f"{rep['train_s']:.1f} s ({train_slot_ms:.1f} ms a slot, updates "
        f"included), evaluated in {rep['eval_s']:.1f} s, baselines "
        + ", ".join(f"{k} {v:.1f} s" for k, v in rep["baseline_s"].items())
        + f"; partition_sweep launches {launches} (= Oracle slots); "
        f"parameters moved by up to {moved:.3e} ({smi})")
    out["quickstart"] = {k: v for k, v in rep.items()
                         if k not in quickstart.OBJECTS}
    out.update(main_s=main_s, sweep_launches=launches,
               oracle_slots=oracle_slots, train_slot_ms=train_slot_ms,
               adam_step=int(state.opt_state.step), params_moved=moved)

    # (b) joint mode at the paper's K
    env = menv.paper_env()
    joint = PPO(JointGaussianPolicy(env.obs_dim, env.L, env.cfg.f_max_ue,
                                    env.cfg.f_max_es), env.obs_dim)
    runner = lymdo.Runner(env, joint, steps=PAPER_K, mode="joint")
    t0 = time.perf_counter()
    j_state, j_hist = runner.train(lymdo.RunConfig(
        episodes=JOINT_EPISODES, steps=PAPER_K, chunk=1, log=False))
    torch.cuda.synchronize()
    joint_s = time.perf_counter() - t0
    if int(j_state.opt_state.step) != joint.cfg.epochs * JOINT_EPISODES or not all(
            np.isfinite(v).all() for v in j_hist.values()):
        fail("joint-mode training: Adam step or a non-finite history")
    joint_slot_ms = joint_s / (JOINT_EPISODES * PAPER_K) * 1e3
    log(f"    (b) joint mode: {JOINT_EPISODES} x {PAPER_K} slots in "
        f"{joint_s:.2f} s ({joint_slot_ms:.2f} ms a slot, updates included); "
        f"last reward {j_hist['reward'][-1]:.3f}, delay "
        f"{j_hist['delay'][-1] * 1e3:.1f} ms ({smi})")
    out["joint"] = {"slot_ms": joint_slot_ms, "s": joint_s,
                    "history": {k: v.tolist() for k, v in j_hist.items()}}

    # (c) one PPO update at K = 200, card against CPU: the joint head on a
    # trajectory of its own, and the quickstart's head on a K = 200 batch
    # of its own actions at drawn observations
    j_cpu = PPO(JointGaussianPolicy(env.obs_dim, env.L.cpu(), env.cfg.f_max_ue,
                                    env.cfg.f_max_es), env.obs_dim)
    traj, _, _ = runner.episode(j_state.params, env.generator(5))
    out["update_joint"] = check_update(torch, "joint head", (joint, j_cpu),
                                       j_state, traj)
    gen = torch.Generator(device="cuda").manual_seed(6)
    obs = torch.randn((PAPER_K, env.obs_dim), generator=gen, device="cuda")
    with torch.no_grad():
        action, logp, value = agent.act(state.params, obs, gen)
    traj = Trajectory(obs=obs, action=action, logp=logp,
                      reward=-30.0 * torch.rand(PAPER_K, generator=gen,
                                                device="cuda"),
                      value=value, last_value=value[-1])
    c_cpu = PPO(CategoricalPolicy(env.obs_dim, env.L.cpu()), env.obs_dim)
    out["update_categorical"] = check_update(
        torch, "categorical head", (agent, c_cpu), state, traj)

    # (d) the trained agent and the Oracle on a 4096-cell Fig. 4 grid
    t0 = time.perf_counter()
    grid, rates = fig4_grid()
    log(f"    (d) grid of {EVAL_CELLS} fixed_rate cells built in "
        f"{time.perf_counter() - t0:.1f} s")
    delays, slot_ms = {}, {}
    for name, run in (
            ("LyMDO", lambda: lymdo.eval_policy_batched(
                grid, agent, state, episodes=1, steps=EVAL_SLOTS)),
            ("Oracle", lambda: lymdo.run_fixed_batched(
                grid, "oracle", episodes=1, steps=EVAL_SLOTS))):
        ps.partition_sweep_cuda.launches = 0
        t0 = time.perf_counter()
        m, res = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want = EVAL_SLOTS if name == "Oracle" else 0
        if ps.partition_sweep_cuda.launches != want:
            fail(f"{name} on the grid: {ps.partition_sweep_cuda.launches} "
                 f"partition_sweep launches, expected {want}")
        if res.delay.shape != (EVAL_SLOTS, EVAL_CELLS, 5):
            fail(f"{name} on the grid: result shape {tuple(res.delay.shape)}")
        if not all(np.isfinite(v).all() for v in m.values()):
            fail(f"{name} on the grid: non-finite metrics")
        if not bool(((res.cut >= 0) & (res.cut <= grid.params.L)).all()):
            fail(f"{name} on the grid: cut outside [0, L]")
        slot_ms[name] = dt / EVAL_SLOTS * 1e3
        delays[name] = {str(r): float(m["delay"][rates == r].mean()) * 1e3
                        for r in FIG4_RATES}
        log(f"      {name:6s} {slot_ms[name]:.1f} ms a grid slot; delay ms at "
            + ", ".join(f"{r} req/s {d:.1f}" for r, d in delays[name].items())
            + f" ({smi})")
    # the Oracle on this grid on the card and on a CPU copy, same draws
    t0 = time.perf_counter()
    grids = (grid, fig4_grid("cpu")[0])
    same_cut, worst = compare_rollouts(
        torch, grids, "oracle", EVAL_CHECK_SLOTS,
        grid_draws(np, grids[1], EVAL_CHECK_SLOTS, np.random.default_rng(12)))
    log(f"      Oracle card vs the port's CPU path, {EVAL_CHECK_SLOTS} slots on the "
        f"same draws: same cuts {same_cut:.4f}, worst summary rel diff "
        f"{worst:.2e} ({time.perf_counter() - t0:.1f} s)")
    if same_cut < SAME_CUT_MIN or worst > SUMMARY_RTOL:
        fail("the Oracle on the Fig. 4 grid: card and CPU paths disagree")
    out["grid"] = {"cells": EVAL_CELLS, "slots": EVAL_SLOTS,
                   "slot_ms": slot_ms, "delay_ms": delays,
                   "oracle_vs_cpu": {"slots": EVAL_CHECK_SLOTS,
                                     "same_cut": same_cut,
                                     "summary_rel_diff": worst}}

    # (e) where a training slot's time goes: a rollout of PROFILE_SLOTS
    # slots and (c)'s K = 200 update of the quickstart's head, each under
    # the profiler; a training slot is a rollout slot and 1/K of an update
    train_env = menv.paper_env()
    probe = lymdo.Runner(train_env, agent, steps=PROFILE_SLOTS)
    probe.episode(state.params, train_env.generator(7))
    torch.cuda.synchronize()
    prof = {
        "rollout": window(torch, lambda: probe.episode(
            state.params, train_env.generator(7)), PROFILE_SLOTS),
        "update": window(torch, lambda: agent.update(state, traj), 1)}
    roll, upd = prof["rollout"], prof["update"]
    slot = prof["training_slot"] = {
        k: roll[k] + upd[k] / PAPER_K
        for k in ("wall_ms", "device_ms", "device_ops")}
    slot["device_busy_share"] = slot["device_ms"] / slot["wall_ms"]
    out["profile"] = prof
    for name, w in (("rollout slot", roll), (f"PPO update at K={PAPER_K}", upd)):
        log(f"    (e) profiler, {name}: wall {w['wall_ms']:.2f} ms, device "
            f"{w['device_ms']:.2f} ms (busy {w['device_busy_share']:.3f}), "
            f"{w['device_ops']:.0f} device ops ({smi})")
        for row in w["top"]:
            log(f"      {row['device_ms']:9.3f} ms  x{row['count']:<7d} "
                f"{row['name']}")
    log(f"    (e) a training slot at K={PAPER_K} (rollout slot + update / K): "
        f"wall {slot['wall_ms']:.2f} ms, device {slot['device_ms']:.2f} ms, "
        f"busy {slot['device_busy_share']:.3f}, {slot['device_ops']:.0f} "
        f"device ops ({smi})")
    log(f"    timings ({smi}): training slot {train_slot_ms:.1f} ms (lymdo), "
        f"{joint_slot_ms:.2f} ms (joint); PPO update at K={PAPER_K} "
        f"{out['update_joint']['ms']:.1f} ms (joint), "
        f"{out['update_categorical']['ms']:.1f} ms (categorical); grid "
        f"evaluation slot {slot_ms['LyMDO']:.1f} ms (LyMDO), "
        f"{slot_ms['Oracle']:.1f} ms (Oracle)")
    return out


# -- phase 5: the attention kernels ------------------------------------------

# phase 10's sync waves (B, width, each row's left pad; None where no row is
# padded), as the sync engine builds them from (a)'s mix on qwen3-0.6b and
# from (d)'s burst and launcher run on recurrentgemma-2b: the kernels are
# held to their plain versions at these shapes, and phase 10 fails if its
# engines prefill a wave that is not listed here
QWEN3_WAVES = [(8, 275, [18, 39, 0, 27, 255, 181, 229, 129]),
               (8, 274, [135, 115, 0, 67, 189, 125, 31, 99])]
RG_WAVES = [(8, 144, [6, 120, 72, 8, 0, 16, 109, 74]), (2, 16, None)]

FLASH_CASES = [
    # (label, B, Sq, Sk, H, KV, hd, dtype, kind, window, pad)
    ("engine solo prefill, 27-token prompt in the 32 bucket",
     1, 32, 32, 16, 8, 128, "bf16", "causal", 0, [5]),
    ("engine first chunk", 1, 32, 32, 16, 8, 128, "bf16", "causal", 0, None),
    ("split check", 2, 512, 512, 16, 8, 128, "bf16", "causal", 0, None),
    ("padded batch at s_max", 4, 512, 512, 16, 8, 128, "bf16", "causal", 0,
     [0, 100, 311, 500]),
    ("padded batch, odd S", 4, 300, 300, 16, 8, 128, "bf16", "causal", 0,
     [0, 13, 40, 299]),
    ("test_kernels causal", 2, 256, 256, 8, 4, 64, "f32", "causal", 0, None),
    ("test_kernels local", 2, 256, 256, 8, 4, 64, "f32", "local", 96, None),
    ("test_kernels full", 2, 256, 256, 8, 4, 64, "f32", "full", 0, None),
    ("test_kernels kv 1", 1, 128, 128, 4, 1, 128, "f32", "causal", 0, None),
    ("test_kernels G 3", 2, 192, 192, 6, 2, 64, "f32", "local", 96, None),
    ("odd length causal", 2, 100, 100, 4, 2, 32, "f32", "causal", 0, None),
    ("odd length local", 2, 100, 100, 4, 2, 32, "f32", "local", 24, None),
    ("odd length full", 2, 100, 100, 4, 2, 32, "f32", "full", 0, None),
    ("odd Sq != Sk", 2, 37, 75, 4, 2, 32, "f32", "full", 0, None),
    ("ragged pad causal", 3, 64, 64, 4, 2, 32, "f32", "causal", 0, [0, 13, 40]),
    ("ragged pad local", 3, 50, 50, 4, 2, 32, "f32", "local", 24, [0, 13, 40]),
    ("ragged pad full", 3, 50, 50, 4, 2, 32, "f32", "full", 0, [0, 13, 40]),
    ("hd 256", 1, 128, 128, 4, 1, 256, "f32", "causal", 0, [7]),
    ("hd 256 bf16", 2, 96, 96, 10, 1, 256, "bf16", "local", 32, None),
]
# bf16 twins of the float32 cases: the tensor-core body covered as widely
FLASH_CASES += [(c[0] + ", bf16 twin", *c[1:7], "bf16", *c[8:])
                for c in FLASH_CASES if c[7] == "f32"]
FLASH_CASES += [("sync wave of phase 10 (a)", b, s, s, 16, 8, 128, dt,
                 "causal", 0, pad)
                for b, s, pad in QWEN3_WAVES for dt in ("bf16", "f32")]
DECODE_CASES = [
    # (label, B, S, H, KV, hd, dtype, all-invalid row?)
    ("engine tick: 8 slots x table width 32 x 16", 8, 512, 16, 8, 128, "bf16",
     False),
    ("test_kernels", 2, 256, 8, 4, 64, "f32", False),
    ("test_kernels kv 1", 1, 512, 4, 1, 128, "f32", False),
    ("test_kernels kv == heads", 3, 128, 2, 2, 64, "f32", False),
    ("ragged tail S 10", 3, 10, 4, 2, 32, "f32", False),
    ("ragged tail S 17", 3, 17, 4, 2, 32, "f32", False),
    ("ragged tail S 33", 3, 33, 4, 2, 32, "f32", True),
    ("ragged tail S 5", 3, 5, 4, 2, 32, "f32", False),
    ("hd 256, G 10", 2, 100, 10, 1, 256, "f32", True),
    ("hd 256 bf16", 2, 300, 10, 1, 256, "bf16", False),
    ("S 1000: not a multiple of a split", 3, 1000, 4, 2, 32, "f32", True),
    ("recurrentgemma's ring shape", 8, 2048, 10, 1, 256, "bf16", True),
    ("recurrentgemma's ring shape", 8, 2048, 10, 1, 256, "f32", True),
    ("G 20: two head groups", 1, 777, 40, 2, 64, "f32", True),
] + [
    # (..., left pads): the sync decode under its wave's pad mask, dense
    # (a) and on recurrentgemma's ring (d)
    (label, *shape, dt, False, pad) for dt in ("bf16", "f32")
    for label, *shape, pad in [
        ("sync decode of phase 10 (a)", 8, 512, 16, 8, 128, QWEN3_WAVES[0][2]),
        ("sync decode of phase 10 (d), the ring", 8, 2048, 10, 1, 256,
         RG_WAVES[0][2]),
    ]]
PAGED_CASES = [
    # (label, B, M, bs, H, KV, hd, dtype, seq_lens): lengths of 0, of a
    # block boundary and of the table's end, over a scattered table
    ("engine tick: 8 slots x 32 blocks of 16", 8, 32, 16, 16, 8, 128, "bf16",
     [0, 15, 16, 511, 100, 300, 1, 64]),
    ("engine tick, float32", 8, 32, 16, 16, 8, 128, "f32",
     [511, 0, 16, 31, 200, 2, 480, 64]),
    ("hd 256, G 10", 4, 9, 16, 10, 1, 256, "bf16", [0, 143, 16, 70]),
    ("hd 32, blocks of 8", 3, 5, 8, 4, 2, 32, "f32", [39, 0, 8]),
]


# phase 11's shapes: the flash and decode kernels at every shape the
# remaining layer kinds launch them at on phase 11's main runs, each in
# bf16 and float32 -- moonshot's solo prefills (G 1, the burst's bucket
# widths, as MOON_ARGS' requests fill them), its split check and sync waves,
# its paged and sync decode; llama4's G 5, vision's G 8 causal and cross
# (Sq 128, Sk 1024), seamless's encoder (full, hd 64), causal and cross
# self-attention; decode over the 1,024- and 512-key contexts.  Phase 11
# fails if it launches either kernel at a shape that is not held here.
MOON_SOLO = [64, 128, 256]                 # each with a left pad
MOON_WAVES = [(8, 256, [37, 203, 43, 41, 159, 163, 67, 158]),
              (8, 256, [26, 32, 105, 204, 132, 52, 27, 74])]
MOON_SYNC_S_MAX = 256 + 32 + 8           # launch.serve's: prompt + new + 8
KINDS_B = 4
LLAMA4_PAD = [0, 51, 96, 27]             # (b)'s prompts, left-padded to 128
VISION_PAD = [0, 96, 38, 71]             # (c)'s
KINDS_PROMPT, IMAGE_TOKENS, SRC_FRAMES = 128, 1024, 512
LLAMA4_STEPS, KINDS_STEPS = 16, 32
KINDS_FLASH = (
    [(f"moonshot solo prefill at bucket {w}", 1, w, w, 16, 16, 128, "causal",
      0, [w // 3]) for w in MOON_SOLO]
    + [("moonshot split check", 2, 512, 512, 16, 16, 128, "causal", 0, None)]
    + [("moonshot sync wave", b, w, w, 16, 16, 128, "causal", 0, pad)
       for b, w, pad in MOON_WAVES[:1]]
    + [("llama4 G 5, left-padded prefill", KINDS_B, KINDS_PROMPT,
        KINDS_PROMPT, 40, 8, 128, "causal", 0, LLAMA4_PAD),
       ("vision G 8, left-padded prefill", KINDS_B, KINDS_PROMPT,
        KINDS_PROMPT, 64, 8, 128, "causal", 0, VISION_PAD),
       ("vision cross-attention", KINDS_B, KINDS_PROMPT, IMAGE_TOKENS, 64, 8,
        128, "full", 0, None),
       ("seamless encoder", KINDS_B, SRC_FRAMES, SRC_FRAMES, 16, 16, 64,
        "full", 0, None),
       ("seamless decoder self-attention", KINDS_B, KINDS_PROMPT,
        KINDS_PROMPT, 16, 16, 64, "causal", 0, None),
       ("seamless cross-attention", KINDS_B, KINDS_PROMPT, SRC_FRAMES, 16,
        16, 64, "full", 0, None)])
KINDS_DECODE = [
    # (label, B, S, H, KV, hd, left pads, or "all" for an all-valid context)
    ("moonshot sync decode", 8, MOON_SYNC_S_MAX, 16, 16, 128,
     MOON_WAVES[0][2]),
    ("llama4 decode", KINDS_B, KINDS_PROMPT + LLAMA4_STEPS, 40, 8, 128,
     LLAMA4_PAD),
    ("vision self decode", KINDS_B, KINDS_PROMPT + KINDS_STEPS, 64, 8, 128,
     VISION_PAD),
    ("vision cross decode, 1,024-key context", KINDS_B, IMAGE_TOKENS, 64, 8,
     128, "all"),
    ("seamless self decode", KINDS_B, KINDS_PROMPT + KINDS_STEPS, 16, 16, 64,
     [0] * KINDS_B),
    ("seamless cross decode, 512-key context", KINDS_B, SRC_FRAMES, 16, 16,
     64, "all")]
FLASH_CASES += [(label, *shape, dt, kind, window, pad) for dt in ("bf16", "f32")
                for label, *shape, kind, window, pad in KINDS_FLASH]
DECODE_CASES += [(label, *shape, dt, False, pad) for dt in ("bf16", "f32")
                 for label, *shape, pad in KINDS_DECODE]
PAGED_CASES += [
    ("moonshot engine tick: 8 slots x 32 blocks of 16, H16/KV16", 8, 32, 16,
     16, 16, 128, dt, [0, 15, 16, 511, 100, 300, 1, 64])
    for dt in ("bf16", "f32")]


# phase 14's shapes: a rank's share of the heads on a 2-way model axis --
# qwen3 at H8/4 (its solo prefills, first chunks and engine ticks in bf16
# and float32, and the bf16 prefill check), recurrentgemma's local
# attention and ring at H5/1 hd256, moonshot's G 1 at H8/8 (every bucket
# width, no chunking); phase 14 fails if a rank launches either kernel at
# a shape not held here (or, for the scans, in phase 7's TP_SSD_CASES and
# TP_RGLRU_CASES)
TP_BUCKETS = (8, 16, 32)
FLASH_CASES += (
    [(f"phase 14 qwen3 rank, bucket {w}", 1, w, w, 8, 4, 128, dt, "causal",
      0, pad) for dt in ("bf16", "f32") for w in TP_BUCKETS
     for pad in ([w // 3], None)]
    + [("phase 14 qwen3 rank, bf16 prefill check", 2, 64, 64, 8, 4, 128,
        "bf16", "causal", 0, [0, 20])]
    + [(f"phase 14 recurrentgemma rank, bucket {w}", 1, w, w, 5, 1, 256,
        "f32", "local", 2048, pad) for w in TP_BUCKETS
       for pad in ([w // 3], None)]
    + [(f"phase 14 moonshot rank, bucket {w}", 1, w, w, 8, 8, 128, "f32",
        "causal", 0, pad) for w in (*TP_BUCKETS, 64)
       for pad in ([w // 3], None)])
# phase 15: (b)'s rank trains qwen3 (B2 a microbatch, 8 of 16 heads); (c)'s
# float32 steps, one rank (B2), a rank of the mesh (its row, half the
# heads) and the mesh's next-batch loss (B2, half the heads)
TM_FLASH = (
    [("phase 15 (b) qwen3 training rank", 2, 512, 512, 8, 4, 128, "bf16",
      "causal", 0, None)]
    + [(f"phase 15 (c) {label}", b, s, s, h, kv, hd, "f32", kind, 64, None)
       for label, s, heads, hd, kinds in (
           ("qwen3", 128, (16, 8), 128, ("causal",)),
           ("gemma3 (l, g)", 128, (4, 1), 256, ("local", "causal")),
           ("moonshot", 1024, (16, 16), 128, ("causal",)))
       for b, h, kv in ((2, *heads),
                        *((b, heads[0] // 2, max(heads[1] // 2, 1))
                          for b in (1, 2)))
       for kind in kinds])
# phase 16: (a)'s rank trains qwen3 with every layer whole (B2 a
# microbatch, all 16 heads); (b)'s float32 mesh step, a data rank's row
TZ_FLASH = [
    ("phase 16 (a) qwen3 ZeRO-3 rank", 2, 512, 512, 16, 8, 128, "bf16",
     "causal", 0, None),
    ("phase 16 (b) qwen3 ZeRO-3 rank", 1, 128, 128, 16, 8, 128, "f32",
     "causal", 0, None)]
TM_FLASH += TZ_FLASH
# phase 17: moonshot's layer on a (data 2, model 2) rank (B2 of the B4
# batch; 8 of 16 heads under full TP, all 16 under "moe-only"), in bf16
# and float32, and the one-rank float32 step (B4, 16 heads)
TMOE_FLASH = (
    [(f"phase 17 moonshot rank, H{h}", 2, 384, 384, h, h, 128, dt, "causal",
      0, None) for h in (8, 16) for dt in ("bf16", "f32")]
    + [("phase 17 moonshot one rank", 4, 384, 384, 16, 16, 128, "f32",
        "causal", 0, None)])
TM_FLASH += TMOE_FLASH
# phase 18 (b): gemma3-1b's wave (KV_PROMPTS left-padded to 1,100) on a
# rank (2 of 4 heads) and on one rank, float32, the rings' local layers
# and the global ones; its decode ticks on one rank, against the whole
# 1,160-position cache and the 1,024-slot ring
KV_PROMPTS = (1100, 700, 300, 60)
KV_PAD = [max(KV_PROMPTS) - n for n in KV_PROMPTS]
TM_FLASH += [
    (f"phase 18 (b) gemma3-1b {who}", 4, 1100, 1100, h, 1, 256, "f32", kind,
     1024 if kind == "local" else 0, KV_PAD)
    for who, h in (("rank", 2), ("one rank", 4))
    for kind in ("local", "causal")]
DECODE_CASES += [
    ("phase 18 (b) gemma3-1b one rank: the dense cache", 4, 1160, 4, 1, 256,
     "f32", False),
    ("phase 18 (b) gemma3-1b one rank: the ring", 4, 1024, 4, 1, 256, "f32",
     False)]
FLASH_CASES += TM_FLASH
DECODE_CASES += [
    ("phase 14 recurrentgemma rank: the ring, 3 slots", 3, 2048, 5, 1, 256,
     "f32", True),
    ("phase 14 recurrentgemma rank: a chunk's replay", 1, 2048, 5, 1, 256,
     "f32", False)]
# the decode kernel's partial entry (``with_ml``), which the sequence-split
# caches run (ROADMAP 7d): each case is also cut in two halves whose
# merged partials are held to the whole-S kernel.  Phase 14's
# recurrentgemma rank replays a chunk's tokens against its half of the
# 2,048-slot ring with all 10 heads; phase 18 (b)'s gemma3-1b rank decodes
# 4 slots against its half of the 1,160-position cache and of the
# 1,024-slot ring, all 4 heads over the one kv head
DECODE_ML_CASES = [
    ("phase 14 recurrentgemma rank: a chunk's replay, half the ring", 1,
     1024, 10, 1, 256, "f32", False),
    ("phase 18 gemma3-1b rank: half the dense cache", 4, 580, 4, 1, 256,
     "f32", True),
    ("phase 18 gemma3-1b rank: half the ring", 4, 512, 4, 1, 256, "f32",
     True),
    ("bf16, a kv head each", 3, 300, 16, 8, 128, "bf16", True)]
PAGED_CASES += [
    ("phase 14 qwen3 rank: 8 slots x 32 blocks of 16", 8, 32, 16, 8, 4, 128,
     "bf16", [0, 15, 16, 511, 100, 300, 1, 64]),
    ("phase 14 qwen3 rank: 3 slots x 8 blocks of 16", 3, 8, 16, 8, 4, 128,
     "f32", [0, 16, 127]),
    ("phase 14 moonshot rank: 3 slots x 8 blocks of 16", 3, 8, 16, 8, 8, 128,
     "f32", [100, 0, 31])]
# phase 19: the analysis probes' engines, reduced qwen3-0.6b in float32 at
# the kernels' head dim 32 (H4/4): solo prefills in the 8, 16 and 32
# buckets (ragged) and a first chunk of 16 (whole); the paged tick of 2
# slots over 4 blocks of 16 (s_max 64), and the donation probe's over 2
# (s_max 32).  Phase 19 fails if it launches at any other shape.
FLASH_CASES += [
    (f"phase 19 probes, bucket {w}", 1, w, w, 4, 4, 32, "f32", "causal", 0,
     pad) for w, pad in ((8, [3]), (16, [5]), (16, None), (32, [15]))]
PAGED_CASES += [
    ("phase 19 probes: 2 slots x 4 blocks of 16", 2, 4, 16, 4, 4, 32, "f32",
     [63, 9]),
    ("phase 19 donation probe: 2 slots x 2 blocks of 16", 2, 2, 16, 4, 4, 32,
     "f32", [0, 31])]


def held_shapes() -> set:
    """The launch keys (``recorded_launches``') of every phase-5 case and
    of phase 7's scan cases."""
    held = {("flash", dt, b, sq, sk, h, kv, hd, kind, pad is not None)
            for _, b, sq, sk, h, kv, hd, dt, kind, _, pad in FLASH_CASES}
    held |= {("decode", c[6], *c[1:6]) for c in DECODE_CASES}
    held |= {("decode_ml", c[6], *c[1:6]) for c in DECODE_ML_CASES}
    held |= {("paged", c[7], *c[1:7]) for c in PAGED_CASES}
    held |= {("ssd", c[8], *c[1:7]) for c in SSD_CASES}
    held |= {("rglru", c[4], *c[1:4]) for c in RGLRU_CASES}
    return held


def att_tol(torch, dtype) -> float:
    return ATT_TOL_F32 if dtype == torch.float32 else ATT_TOL_BF16


def attention_inputs(torch, gen, b, sq, sk, h, kv, hd, dtype):
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(b, sq, h, hd), rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)


def check_flash(torch, fa, ref, gen, case) -> float:
    label, b, sq, sk, h, kv, hd, dt, kind, window, pad = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v = attention_inputs(torch, gen, b, sq, sk, h, kv, hd, dtype)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    got = fa.flash_attention_cuda(q, k, v, kind=kind, window=window, pad=pad_t)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, kind=kind, window=window, pad=pad_t)
    tol = att_tol(torch, dtype)
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"flash {label}: non-finite output")
    err = 0.0
    for i in range(b):
        p0 = 0 if pad is None else min(pad[i], sq)
        g_i, w_i = got[i, p0:].float(), want[i, p0:].float()
        if g_i.numel():
            err = max(err, float((g_i - w_i).abs().max()))
            if not torch.allclose(g_i, w_i, rtol=tol, atol=tol):
                fail(f"flash {label}: row {i} outside {tol} (max abs err "
                     f"{float((g_i - w_i).abs().max()):.3e})")
        if kind != "full" and p0 and bool((got[i, :p0] != 0).any()):
            fail(f"flash {label}: a query row that sees no key is not zero")
    log(f"  flash  {dt:4s} {kind:6s} B{b} Sq{sq} Sk{sk} H{h}/{kv} hd{hd} "
        f"pad={pad}: ok, max abs err {err:.3e} ({label})")
    return err


def check_decode(torch, da, ref, gen, case, with_ml: bool = False) -> float:
    """The dense entry against the plain version; ``with_ml`` the partial
    entry (its output, and each (row, head)'s softmax max and sum within
    1e-4), and the merge of its two halves' partials
    (``ref.merge_partials``) against the whole-S kernel."""
    label, b, s, h, kv, hd, dt, dead_row, *pad = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v = attention_inputs(torch, gen, b, 1, s, h, kv, hd, dtype)
    keys = torch.arange(s, device="cuda")[None, :]
    if pad and pad[0] == "all":  # a cross-attention context: every key
        valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    elif pad:                    # a sync wave: keys below its pads masked
        pad_t = torch.tensor(pad[0], device="cuda")[:, None]
        lens = torch.randint(int(pad_t.max()) + 1, s + 1, (b, 1),
                             generator=gen, device="cuda")
        valid = (keys >= pad_t) & (keys < lens)
    else:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        valid = keys < lens[:, None]
    if s >= 192 and not pad:
        valid[0] = True          # a real row whose second split is all masked
        valid[0, 64:128] = False
    if dead_row:
        valid[-1] = False        # no valid key: the uniform average
    tol = att_tol(torch, dtype)
    if with_ml:
        got, m, l = da.decode_attention_cuda(q, k, v, valid, with_ml=True)
        torch.cuda.synchronize()
        want, m_ref, l_ref = ref.decode_attention_ref(q, k, v, valid,
                                                      with_ml=True)
        for name, g_t, w_t in (("max", m, m_ref), ("sum", l, l_ref)):
            if not torch.allclose(g_t, w_t, rtol=1e-4, atol=1e-4):
                fail(f"decode (partial) {label}: softmax {name} outside "
                     f"1e-4 ({float((g_t - w_t).abs().max()):.3e})")
        half = s // 2
        parts = [da.decode_attention_cuda(
            q, k[:, a:e].contiguous(), v[:, a:e].contiguous(),
            valid[:, a:e].contiguous(), with_ml=True)
            for a, e in ((0, half), (half, s))]
        merged = ref.merge_partials(*(torch.stack(t) for t in zip(
            *((o[:, 0], mm, ll) for o, mm, ll in parts))))
        whole = da.decode_attention_cuda(q, k, v, valid)[:, 0].float()
        merr = float((merged.to(dtype).float() - whole).abs().max())
        if not torch.allclose(merged.to(dtype).float(), whole, rtol=tol,
                              atol=tol):
            fail(f"decode (partial) {label}: two halves merged part from "
                 f"the whole-S kernel ({merr:.3e})")
    else:
        got = da.decode_attention_cuda(q, k, v, valid)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"decode {label}: outside {tol} (max abs err {err:.3e})")
    log(f"  decode{' (partial)' if with_ml else ''} {dt:4s} B{b} S{s} "
        f"H{h}/{kv} hd{hd}"
        f"{' all-invalid row' if dead_row else ''}"
        f"{f' pad={pad[0]}' if pad else ''}: ok, max abs err "
        f"{err:.3e}{f', halves merged {merr:.3e}' if with_ml else ''} "
        f"({label})")
    return err


def paged_inputs(torch, gen, b, m, bs, h, kv, hd, dtype):
    """q, K/V pools of b * m + 3 blocks and a scattered (b, m) table."""
    n_blocks = b * m + 3
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)
    table = torch.randperm(n_blocks, generator=gen, device="cuda")[:b * m]
    return (rnd(b, 1, h, hd), rnd(n_blocks, bs, kv, hd),
            rnd(n_blocks, bs, kv, hd), table.reshape(b, m).to(torch.int32))


def gather_rows(torch, pool, table):
    """The (B, M * bs, KV, hd) rows a table maps out of a pool."""
    b, m = table.shape
    return pool[table.long()].reshape(b, m * pool.shape[1], *pool.shape[2:])


def paged_valid(torch, table, bs, lens):
    return (torch.arange(table.shape[1] * bs, device="cuda")[None, :]
            <= lens[:, None])


def check_paged(torch, da, ref, gen, case) -> float:
    label, b, m, bs, h, kv, hd, dt, seq_lens = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, kp, vp, table = paged_inputs(torch, gen, b, m, bs, h, kv, hd, dtype)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    got = da.decode_attention_paged_cuda(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, gather_rows(torch, kp, table),
                                    gather_rows(torch, vp, table),
                                    paged_valid(torch, table, bs, lens))
    tol = att_tol(torch, dtype)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"paged decode {label}: outside {tol} (max abs err {err:.3e})")
    log(f"  paged  {dt:4s} B{b} M{m} bs{bs} H{h}/{kv} hd{hd} seq_lens="
        f"{seq_lens}: ok, max abs err {err:.3e} ({label})")
    return err


def to_heads(torch, t, group):
    """(B, S, KV, hd) -> (B, H, S, hd) with each kv head repeated G times."""
    return t.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()


def time_kernel(torch, kernel, plain, library, n_flops, n_bytes, peak_s,
                iters=50):
    """Device and wall time of kernel, plain and (where one PyTorch call
    computes the same function) library calls; the bound."""
    ops_ms, bytes_ms = n_flops / peak_s * 1e3, n_bytes / PEAK_BYTES_S * 1e3
    lib = (None, None) if library is None else (
        device_ms(torch, library, iters), call_ms(torch, library, iters))
    return {"ms": device_ms(torch, kernel, iters),
            "call_ms": call_ms(torch, kernel, iters),
            "plain_ms": device_ms(torch, plain, 5),
            "plain_call_ms": call_ms(torch, plain, 5),
            "library_ms": lib[0], "library_call_ms": lib[1],
            "gflop": n_flops / 1e9, "mbytes": n_bytes / 1e6,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def time_flash(torch, fa, ref, gen, b, s, h, kv, hd, pad, window=0) -> dict:
    """Flash in bf16 at B x S (causal, or local under ``window``, which at
    these lengths masks what causal masks), beside SDPA and the bound."""
    import torch.nn.functional as F
    kind = "local" if window else "causal"
    q, k, v = attention_inputs(torch, gen, b, s, s, h, kv, hd, torch.bfloat16)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    kt, vt, qt = to_heads(torch, k, h // kv), to_heads(torch, v, h // kv), \
        q.transpose(1, 2).contiguous()
    if pad is None and (not window or window >= s - 1):
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                         is_causal=True)
    else:
        allowed = ref.build_mask(kind, s, s, window, device="cuda")[None]
        if pad is not None:
            allowed = allowed & (torch.arange(s, device="cuda")[None, None, :]
                                 >= pad_t[:, None, None])
        allowed = allowed[:, None]
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed)
    pairs = fa.live_pairs(b, s, s, kind, window, pad=pad)
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + b * 4 * (pad is not None)
    t = time_kernel(
        torch, lambda: fa.flash_attention_cuda(q, k, v, kind=kind,
                                               window=window, pad=pad_t),
        lambda: ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                        pad=pad_t), library,
        4 * h * hd * pairs, n_bytes, PEAK_BF16_S)
    t["shape"] = (f"B{b} S{s} H{h}/{kv} hd{hd} bf16 {kind}"
                  f"{f' {window}' if window else ''} pad={pad}")
    return t


def time_flash_full(torch, fa, ref, gen, b, sq, sk, h, kv, hd) -> dict:
    """Flash in bf16 of kind "full" (every query sees every key; Sq may
    differ from Sk: the encoder and cross-attention), beside SDPA and the
    bound."""
    import torch.nn.functional as F
    q = attention_inputs(torch, gen, b, sq, 1, h, kv, hd, torch.bfloat16)[0]
    _, k, v = attention_inputs(torch, gen, b, 1, sk, h, kv, hd, torch.bfloat16)
    kt, vt, qt = to_heads(torch, k, h // kv), to_heads(torch, v, h // kv), \
        q.transpose(1, 2).contiguous()
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    t = time_kernel(
        torch, lambda: fa.flash_attention_cuda(q, k, v, kind="full"),
        lambda: ref.flash_attention_ref(q, k, v, kind="full"),
        lambda: F.scaled_dot_product_attention(qt, kt, vt),
        4 * h * hd * fa.live_pairs(b, sq, sk, "full"), n_bytes, PEAK_BF16_S)
    t["shape"] = f"B{b} Sq{sq} Sk{sk} H{h}/{kv} hd{hd} bf16 full"
    return t


def time_decode(torch, da, ref, gen, b, s, h, kv, hd, valid, label) -> dict:
    """Dense decode in bf16 under ``valid`` (B, S), beside SDPA and the
    bound of the valid keys' bytes."""
    import torch.nn.functional as F
    q, k, v = attention_inputs(torch, gen, b, 1, s, h, kv, hd, torch.bfloat16)
    kt, vt, qt = to_heads(torch, k, h // kv), to_heads(torch, v, h // kv), \
        q.transpose(1, 2).contiguous()
    mask4 = valid[:, None, None, :]
    n_valid = int(valid.sum())
    n_bytes = (2 * q.numel() + 2 * n_valid * kv * hd) * 2 + valid.numel()
    t = time_kernel(
        torch, lambda: da.decode_attention_cuda(q, k, v, valid),
        lambda: ref.decode_attention_ref(q, k, v, valid),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4),
        4 * h * hd * n_valid, n_bytes, PEAK_BF16_S)
    t["shape"] = (f"B{b} S{s} H{h}/{kv} hd{hd} bf16, {n_valid} valid keys"
                  f" ({label})")
    return t


def time_paged(torch, da, ref, gen, b, m, bs, h, kv, hd, lens) -> dict:
    """The paged entry in bf16 over a scattered table (row b sees keys 0 ..
    lens[b]), beside the gather + dense kernel it replaces and SDPA."""
    import torch.nn.functional as F
    q, kp, vp, table = paged_inputs(torch, gen, b, m, bs, h, kv, hd,
                                    torch.bfloat16)
    valid = paged_valid(torch, table, bs, lens)
    rows = lambda: (gather_rows(torch, kp, table), gather_rows(torch, vp, table))
    kr, vr = rows()
    kt, vt, qt = to_heads(torch, kr, h // kv), to_heads(torch, vr, h // kv), \
        q.transpose(1, 2).contiguous()
    mask4 = valid[:, None, None, :]
    n_valid = int(valid.sum())
    n_bytes = ((2 * q.numel() + 2 * n_valid * kv * hd) * 2
               + (table.numel() + lens.numel()) * 4)
    t = time_kernel(
        torch, lambda: da.decode_attention_paged_cuda(q, kp, vp, table, lens),
        lambda: ref.decode_attention_ref(q, *rows(), valid),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask4),
        4 * h * hd * n_valid, n_bytes, PEAK_BF16_S)
    gather_dense = lambda: da.decode_attention_cuda(q, *rows(), valid)
    t["gather_dense_ms"] = device_ms(torch, gather_dense, 50)
    t["gather_dense_call_ms"] = call_ms(torch, gather_dense, 50)
    t["shape"] = (f"B{b} M{m} bs{bs} H{h}/{kv} hd{hd} bf16 paged, {n_valid} "
                  f"valid keys")
    return t


def time_decode_ml(torch, da, ref, gen, b, s, h, kv, hd, dtype,
                   label) -> dict:
    """The partial entry (``with_ml``) under prefix lengths, beside the
    plain version's partial and the bound of the valid keys' bytes (and
    the (m, l) it writes); no single PyTorch call returns the softmax's
    max and sum."""
    q, k, v = attention_inputs(torch, gen, b, 1, s, h, kv, hd, dtype)
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    n_valid = int(valid.sum())
    size = q.element_size()
    n_bytes = ((2 * q.numel() + 2 * n_valid * kv * hd) * size
               + valid.numel() + 2 * b * h * 4)
    peak = PEAK_F32_S if dtype == torch.float32 else PEAK_BF16_S
    t = time_kernel(
        torch, lambda: da.decode_attention_cuda(q, k, v, valid, with_ml=True),
        lambda: ref.decode_attention_ref(q, k, v, valid, with_ml=True),
        None, 4 * h * hd * n_valid, n_bytes, peak)
    t["shape"] = (f"B{b} S{s} H{h}/{kv} hd{hd} "
                  f"{'f32' if dtype == torch.float32 else 'bf16'}, "
                  f"{n_valid} valid keys ({label})")
    return t


def log_timed(key: str, t: dict) -> None:
    lib = ("no single PyTorch call" if t["library_ms"] is None else
           f"sdpa {t['library_ms']:.4f} ms device, "
           f"{t['library_call_ms']:.4f} wall")
    log(f"    {key} at {t['shape']}: device {t['ms']:.4f} ms, wall "
        f"{t['call_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms device, "
        f"{t['plain_call_ms']:.4f} wall; {lib}; bound {t['bound_ms']:.5f} ms "
        f"({t['bound_by']}: {t['gflop']:.4f} GFLOP, {t['mbytes']:.3f} MB)")


def attention_phase(torch, fa, da, ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    log("[5] attention kernels vs plain PyTorch on the card")
    flash_errs = [check_flash(torch, fa, ref, gen, c) for c in FLASH_CASES]
    decode_errs = [check_decode(torch, da, ref, gen, c) for c in DECODE_CASES]
    decode_errs += [check_decode(torch, da, ref, gen, c, with_ml=True)
                    for c in DECODE_ML_CASES]
    paged_errs = [check_paged(torch, da, ref, gen, c) for c in PAGED_CASES]
    out = {"flash_max_abs_err": max(flash_errs),
           "decode_max_abs_err": max(decode_errs + paged_errs)}

    # flash at the split check's shape and at the engine's solo prefill
    out["flash"] = time_flash(torch, fa, ref, gen, 2, 512, 16, 8, 128, None)
    out["flash_engine"] = time_flash(torch, fa, ref, gen, 1, 32, 16, 8, 128,
                                     [5])

    # decode at the engine tick's shape: 8 slots, the gathered 512 keys,
    # cache lengths of prompts of 8-300 tokens plus up to 32 new ones
    b, s, h, kv, hd = 8, 512, 16, 8, 128
    lens = torch.randint(8, 333, (b,), generator=gen, device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    out["decode"] = time_decode(torch, da, ref, gen, b, s, h, kv, hd, valid,
                                "qwen3's engine tick")
    # the paged entry at the same tick: 8 slots x 32 blocks of 16 over a
    # scattered table, beside the gather + dense kernel it replaces and SDPA
    lens = (lens - 1).to(torch.int32)            # keys 0 .. seq_lens[b]
    out["decode_paged"] = t = time_paged(torch, da, ref, gen, b, 32, 16, h,
                                         kv, hd, lens)
    # the partial entry at phase 18 (b)'s rank shape: gemma3-1b's half of
    # the dense cache, 4 slots, float32 (the run's type)
    out["decode_ml"] = time_decode_ml(torch, da, ref, gen, 4, 580, 4, 1, 256,
                                      torch.float32,
                                      "phase 18's gemma3-1b rank")
    for key in ("flash", "flash_engine", "decode", "decode_paged",
                "decode_ml"):
        log_timed(key, out[key])
    log(f"    gather + dense kernel at the paged shape: device "
        f"{t['gather_dense_ms']:.4f} ms, wall {t['gather_dense_call_ms']:.4f} "
        f"ms")

    # phase 11's new shapes: the encoder and cross-attention (full), GQA
    # groups of 1, 5 and 8, decode over a 1,024-key context, moonshot's
    # paged tick (H16/KV16)
    all_valid = torch.ones(KINDS_B, IMAGE_TOKENS, dtype=torch.bool,
                           device="cuda")
    moon_lens = torch.randint(7, 288, (8,), generator=gen, device="cuda"
                              ).to(torch.int32)
    out["kinds"] = kinds = {
        "flash_encoder": time_flash_full(torch, fa, ref, gen, KINDS_B,
                                         SRC_FRAMES, SRC_FRAMES, 16, 16, 64),
        "flash_cross": time_flash_full(torch, fa, ref, gen, KINDS_B,
                                       KINDS_PROMPT, IMAGE_TOKENS, 64, 8, 128),
        "flash_g1_solo": time_flash(torch, fa, ref, gen, 1, 256, 16, 16, 128,
                                    [85]),
        "flash_g5": time_flash(torch, fa, ref, gen, KINDS_B, KINDS_PROMPT, 40,
                               8, 128, LLAMA4_PAD),
        "flash_g8": time_flash(torch, fa, ref, gen, KINDS_B, KINDS_PROMPT, 64,
                               8, 128, VISION_PAD),
        "decode_cross": time_decode(torch, da, ref, gen, KINDS_B,
                                    IMAGE_TOKENS, 64, 8, 128, all_valid,
                                    "vision's cross decode"),
        "decode_paged_g1": time_paged(torch, da, ref, gen, 8, 32, 16, 16, 16,
                                      128, moon_lens)}
    for key, t in kinds.items():
        log_timed(key, t)
    return out


# -- phase 6: the partitioned qwen3-0.6b served on the card ------------------

def solo_tokens(torch, transformer, params, cfg, prompt, max_new, s_max):
    """Greedy tokens of one request run alone: prefill, then decode_step;
    and the top-2 logit gap at each step."""
    toks = torch.as_tensor(prompt[None], dtype=torch.int64, device="cuda")
    logits, cache = transformer.prefill(params, cfg, {"tokens": toks},
                                        s_max=s_max)
    out, gaps = [], []
    for _ in range(max_new):
        top = torch.topk(logits[0], 2).values
        gaps.append(float(top[0] - top[1]))
        out.append(int(torch.argmax(logits[0])))
        if len(out) == max_new:
            break
        logits, cache = transformer.decode_step(
            params, cfg, cache, torch.tensor([out[-1]], device="cuda"))
    return out, gaps


# decode attention's CUDA kernels: the split pass, which runs once a launch,
# and the merge, which runs where there is more than one split
DECODE_KERNELS = ("decode_split_kernel", "decode_merge_kernel")


def profile_ticks(torch, eng, ticks: int, kernel=DECODE_KERNELS,
                  key: str = "decode_attention_ms") -> dict:
    """Device time of ``ticks`` engine ticks under torch.profiler, and the
    mean device time of one launch of ``kernel`` under ``key``: the CUDA
    kernels whose names hold one of ``kernel``'s strings, summed, over the
    launches of the first.  PyTorch's index kernels (gathers, scatters) are
    listed per tick under "index_kernels"."""
    eng.step()
    torch.cuda.synchronize()
    rows, wall_s = profiled(torch, lambda: [eng.step() for _ in range(ticks)])
    device_us = sum(e.device_time_total for e in rows)
    out = {
        "ticks": ticks, "wall_ms_per_tick": wall_s * 1e3 / ticks,
        "device_ms_per_tick": device_us / 1e3 / ticks,
        "device_busy_share": device_us / 1e6 / wall_s,
        "device_ops_per_tick": sum(e.count for e in rows) / ticks,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": e.device_time_total / 1e3}
                for e in sorted(rows, key=lambda e: -e.device_time_total)[:8]],
    }
    out["index_kernels"] = [
        {"name": e.key[:80], "per_tick": e.count / ticks,
         "device_ms_per_tick": e.device_time_total / 1e3 / ticks}
        for e in rows if "index" in e.key.lower() or "gather" in e.key.lower()]
    if kernel is not None:
        counted = [e for e in rows if kernel[0] in e.key]
        hits = [e for e in rows if any(n in e.key for n in kernel)]
        if not counted:
            fail(f"no {kernel[0]} in the profiled decode ticks")
        out[key] = (sum(e.device_time_total for e in hits) / 1e3
                    / sum(e.count for e in counted))
    return out


def log_profile(t: dict, slots: int) -> None:
    log(f"    profiler over {t['ticks']} decode ticks ({slots} slots): wall "
        f"{t['wall_ms_per_tick']:.2f} ms/tick, device "
        f"{t['device_ms_per_tick']:.3f} ms/tick, device busy "
        f"{t['device_busy_share']:.3f}, {t['device_ops_per_tick']:.0f} device "
        f"ops/tick")
    for row in t["top"]:
        log(f"      {row['device_ms']:9.3f} ms  x{row['count']:<6d} "
            f"{row['name']}")
    for row in t["index_kernels"]:
        log(f"      index kernel: {row['per_tick']:.1f} a tick, "
            f"{row['device_ms_per_tick']:.4f} ms a tick  {row['name']}")


def f32_identity(torch, cfg32, sync: bool = False) -> dict:
    """float32 at full width and a cut depth: the engine's tokens are each
    request's solo tokens (prefill + decode_step) through chunked prefill,
    buckets and preemption (a pool of 11 allocatable blocks of 16 for 3
    slots); with ``sync``, the sync engine's, through left-padded waves."""
    from repro_torch import serve_partitioned as sp
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    p32 = transformer.init_params(7, cfg32, "cuda")
    eng = ServingEngine(cfg32, p32, slots=3, s_max=256, kv_blocks=12,
                        sync_batching=sync)
    reqs = sp.make_requests(cfg32, 8, 5, 150, 12, 3)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    bad = []
    for r in reqs:
        solo, gaps = solo_tokens(torch, transformer, p32, cfg32, r.prompt,
                                 12, 256)
        if solo != r.out:
            bad.append({"rid": r.rid, "len": len(r.prompt),
                        "min_top2_gap": min(gaps)})
    log(f"    float32 {'sync ' if sync else ''}engine vs solo, {cfg32.name} "
        f"at {cfg32.n_layers} layers: {len(reqs) - len(bad)}/{len(reqs)} "
        f"requests identical ({eng.preemptions} preemptions, "
        f"{eng.prefill_steps} prefills and chunks)")
    if bad:
        fail(f"float32 engine tokens differ from the solo runs: {bad}")
    if eng.preemptions == 0 and not sync:
        fail("the pool sized to force preemption preempted nothing")
    return {"f32_identical": len(reqs), "f32_preemptions": eng.preemptions}


def card_vs_cpu(torch, cfg2, bf16_check: bool = True,
                context: bool = False) -> dict:
    """The card against the port's CPU path: the same bf16 weights, a
    ragged batch of 2 x 64 tokens (left pad 20) through ``prefill``, and a
    float32 evaluation of the same weights on the CPU that each bf16 path
    is measured against.  The card's bf16 logits may stand at most
    ``BF16_DRIFT`` times as far from the float32 evaluation as the CPU's,
    and must agree with the CPU's within 2e-2.  Where ``bf16_check`` is
    False (two bf16 evaluations of the stack part by more than that band,
    both as far from float32), the band is replaced by the card's float32
    prefill held to the CPU's at 1e-4.  With ``context``, the batch
    carries the stack's image embeddings or source frames
    (``kinds_batch``)."""
    from repro_torch import _tree
    from repro_torch.models import transformer

    p_cpu = transformer.init_params(11, cfg2, "cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg2.vocab, (2, 64), generator=g)
    pad = torch.tensor([0, 20], dtype=torch.int32)
    batch = kinds_batch(torch, cfg2, 2, 1, 5, "cpu") if context else {}
    batch["tokens"] = toks

    def logits(params, cfg, device):
        lg, _ = transformer.prefill(
            _tree.to_device(params, device), cfg,
            {k: v.to(device) for k, v in batch.items()}, s_max=64,
            pad=pad.to(device))
        return lg.cpu()

    lg_cpu = logits(p_cpu, cfg2, "cpu")
    lg_gpu = logits(p_cpu, cfg2, "cuda")
    cfg32 = dataclasses.replace(cfg2, param_dtype="float32",
                                compute_dtype="float32")
    p32 = _tree.map_tensors(
        lambda t: t.float() if t.is_floating_point() else t, p_cpu)
    del p_cpu
    lg_f32 = logits(p32, cfg32, "cpu")
    diff = (lg_gpu - lg_cpu).abs()
    # the share of its allclose limit that each logit's error uses; the
    # check passes while the worst share is <= 1
    share = diff / (ATT_TOL_BF16 + ATT_TOL_BF16 * lg_cpu.abs())
    worst = int(share.argmax())
    out = {"card_vs_cpu_max_abs_err": float(diff.max()),
           "card_vs_cpu_worst_share": float(share.flatten()[worst]),
           "card_bf16_vs_f32": float((lg_gpu - lg_f32).abs().max()),
           "cpu_bf16_vs_f32": float((lg_cpu - lg_f32).abs().max())}
    out["bf16_drift"] = out["card_bf16_vs_f32"] / out["cpu_bf16_vs_f32"]
    log(f"    card vs CPU prefill logits, {cfg2.name} at {cfg2.n_layers} "
        f"layers bf16: max abs err {float(diff.max()):.3e} (max |logit| "
        f"{float(lg_cpu.abs().max()):.3f}); worst element: err "
        f"{float(diff.flatten()[worst]):.3e} at |logit| "
        f"{float(lg_cpu.abs().flatten()[worst]):.3f}, "
        f"{out['card_vs_cpu_worst_share']:.3f} of its limit; from the "
        f"float32 evaluation: card {out['card_bf16_vs_f32']:.3e}, CPU "
        f"{out['cpu_bf16_vs_f32']:.3e}, {out['bf16_drift']:.3f} of the "
        f"CPU's (limit {BF16_DRIFT})")
    if out["bf16_drift"] > BF16_DRIFT:
        fail(f"{cfg2.name}: the card's bf16 prefill logits stand further "
             f"from float32 than {BF16_DRIFT} x the CPU's")
    if bf16_check:
        if not torch.allclose(lg_gpu, lg_cpu, rtol=ATT_TOL_BF16,
                              atol=ATT_TOL_BF16):
            fail(f"{cfg2.name}: card and CPU prefill logits disagree beyond "
                 f"the bf16 tolerance")
        return out
    lg32_gpu = logits(p32, cfg32, "cuda")
    err32 = float((lg32_gpu - lg_f32).abs().max())
    out["card_vs_cpu_f32_max_abs_err"] = err32
    log(f"    card vs CPU prefill logits in float32, same weights: max abs "
        f"err {err32:.3e} (tolerance 1e-4, the reference's logit tolerance)")
    if not torch.allclose(lg32_gpu, lg_f32, rtol=1e-4, atol=1e-4):
        fail(f"{cfg2.name}: card and CPU float32 prefill logits disagree")
    return out


def serving_phase(torch) -> dict:
    from repro_torch import serve_partitioned as sp
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    log("[6] main path: python -m repro_torch.serve_partitioned "
        + " ".join(SERVE_ARGS) + " (qwen3-0.6b, full width, bf16)")
    rep = run_partitioned(torch, SERVE_ARGS, 16)
    # the split check runs the whole stack once monolithic and once per cut;
    # "g" chunks after the first attend without a kernel
    layers, srv = rep["layers"], rep["serving"]
    check_counts("the qwen3 run", rep["launches"], srv,
                 per_prefill={"flash_attention": layers},
                 per_tick={"decode_attention": layers},
                 extra={"flash_attention": layers * (1 + len(rep["split"]))})

    cfg = sp.model_config(layers=rep["layers"])
    params = transformer.init_params(sp.SEED, cfg, "cuda")   # main()'s weights
    reqs = sp.make_requests(cfg, 16, sp.PROMPT_MIN, 300, 32, sp.SEED)
    parted = []
    for r in reqs[:4]:
        solo, gaps = solo_tokens(torch, transformer, params, cfg, r.prompt,
                                 32, 512)
        got = srv["out"][r.rid]
        if solo != got:
            i = next(j for j, (a, b) in enumerate(zip(solo, got)) if a != b)
            parted.append({"rid": r.rid, "len": len(r.prompt), "step": i,
                           "top2_gap": gaps[i]})
    rep["bf16_parted_from_solo"] = parted
    log(f"    bf16 engine vs solo on 4 requests: {len(parted)} parted "
        f"{parted}")

    # where a decode tick's time goes: 8 slots decoding, profiled
    eng = ServingEngine(cfg, params, slots=8, s_max=512)
    for r in sp.make_requests(cfg, 8, 100, 300, 150, 1):
        eng.submit(r)
    while eng.queue or eng._stream_req is not None:
        eng.step()
    rep["tick_profile"] = profile_ticks(torch, eng, PROFILE_TICKS)
    log_profile(rep["tick_profile"], 8)
    log(f"    decode_attention {rep['tick_profile']['decode_attention_ms']}"
        f" ms per launch")
    del params, eng

    rep.update(f32_identity(torch, sp.model_config(layers=4,
                                                   dtype="float32")))
    rep.update(card_vs_cpu(torch, sp.model_config(layers=2)))
    return rep


# -- phase 7: the scan kernels, and attention at recurrentgemma's shapes ------

SCAN_TOL_F32 = 1e-4     # the reference's scan tolerance (tests/test_kernels.py)
SCAN_TOL_BF16 = 2e-2    # an output rounded to bf16 (about 3 bf16 ulps)
PAD3 = [(0, t) for t in range(4)]    # a left pad of 3: pads + first real token
SSD_CASES = [
    # (label, B, S, H, P, G, N, plain chunk, dtype, resets [(row, step)])
    ("test_kernels", 2, 64, 4, 16, 2, 8, 16, "f32", None),
    ("test_kernels", 1, 128, 2, 32, 1, 16, 32, "f32", None),
    ("test_kernels, G 3", 2, 96, 3, 16, 3, 8, 24, "f32", None),
    ("test_kernels resets", 2, 64, 3, 8, 1, 4, 16, "f32",
     [(0, 5), (0, 16), (1, 37)]),
    ("resets mid-tile, on the tile boundary, per row", 2, 160, 3, 8, 1, 4,
     16, "f32", [(0, 5), (0, 64), (0, 100), (1, 127), (1, 128)]),
    ("odd length", 1, 13, 2, 8, 1, 4, 1, "f32", None),
    ("odd length over tiles, G 2", 2, 300, 4, 16, 2, 8, 75, "f32", [(1, 70)]),
    ("mamba2 solo prefill, pad 3", 1, 8, 64, 64, 1, 128, 8, "bf16", PAD3),
    ("mamba2 solo prefill, pad 3", 1, 16, 64, 64, 1, 128, 16, "bf16", PAD3),
    ("mamba2 solo prefill, pad 3", 1, 32, 64, 64, 1, 128, 32, "bf16", PAD3),
    ("mamba2 split check", 2, 512, 64, 64, 1, 128, 256, "bf16", None),
    ("mamba2 split check", 2, 512, 64, 64, 1, 128, 256, "f32", None),
    ("mamba2 solo prefill, pad 3", 1, 32, 64, 64, 1, 128, 32, "f32", PAD3),
] + [
    # the chunk passes (T = 64 steps a chunk) at their edges, each dtype
    (label, *shape, dt, at) for dt in ("f32", "bf16") for label, *shape, at in [
        ("S = T - 1, reset at step 0, G 2", 1, 63, 4, 16, 2, 8, 63, [(0, 0)]),
        ("S = T, resets twice in one chunk, G 3", 2, 64, 3, 16, 3, 8, 64,
         [(0, 10), (0, 40), (1, 63)]),
        ("S = T + 1, reset on the chunk boundary, G 2", 2, 65, 4, 16, 2, 8,
         65, [(0, 64), (1, 0)]),
        ("S = 3T + 5, resets on boundaries and twice in a chunk, G 2", 2, 197,
         4, 32, 2, 16, 197, [(0, 64), (0, 128), (1, 70), (1, 100), (1, 196)]),
        ("S = 3T + 5 at mamba2's widths, G 2", 1, 197, 8, 64, 2, 128, 197,
         [(0, 0), (0, 128)]),
    ]]
RGLRU_CASES = [
    # (label, B, S, R, dtype, resets)
    ("test_kernels", 2, 128, 64, "f32", None),
    ("test_kernels", 1, 64, 128, "f32", None),
    ("test_kernels", 3, 256, 32, "f32", None),
    ("test_kernels resets", 2, 64, 16, "f32", [(0, 5), (0, 16), (1, 37)]),
    ("test_kernels odd length", 2, 37, 16, "f32", [(0, 20), (1, 20)]),
    ("recurrentgemma solo prefill, pad 3", 1, 8, 2560, "f32", PAD3),
    ("recurrentgemma solo prefill, pad 3", 1, 16, 2560, "f32", PAD3),
    ("recurrentgemma solo prefill, pad 3", 1, 32, 2560, "f32", PAD3),
    ("recurrentgemma split shape", 2, 512, 2560, "f32", None),
    ("recurrentgemma split shape", 2, 512, 2560, "bf16", None),
    ("recurrentgemma solo prefill, pad 3", 1, 32, 2560, "bf16", PAD3),
] + [
    # the segmented kernel's edges (rglru_scan.plan: 16-channel tiles, 4
    # steps a segment up to S = 64, tiles of 16 x 8 steps above), each dtype
    (label, *shape, dt, at) for dt in ("f32", "bf16") for label, *shape, at in [
        ("S = 1", 2, 1, 16, [(1, 0)]),
        ("resets on segments' first and last steps, R 37", 2, 32, 37,
         [(0, 4), (0, 7), (1, 11), (1, 12)]),
        ("S = 197: a tile boundary, twice in a segment, R 37", 2, 197, 37,
         [(0, 8), (0, 15), (0, 128), (1, 127), (1, 130), (1, 133)]),
        ("S = 300: step 0, a tile boundary, the last step, R 40", 1, 300, 40,
         [(0, 0), (0, 256), (0, 299)]),
    ]]
RGLRU_CASES += [
    # phase 10 (d)'s sync waves: resets through each row's pad and on its
    # first real token (models.common.pad_reset); 32-channel blocks at B8
    ("sync wave of phase 10 (d)", b, s, 2560, dt,
     None if pad is None else [(i, t) for i, p in enumerate(pad) if p
                               for t in range(p + 1)])
    for b, s, pad in RG_WAVES for dt in ("f32", "bf16")]
# phase 14's scan shapes: a rank's 32 of mamba2's 64 SSD heads and 1,280 of
# recurrentgemma's 2,560 RG-LRU channels, at the float32 engine's solo
# prefills (a left pad of 3) and first chunk
TP_SSD_CASES = [("phase 14 mamba2 rank, pad 3", 1, w, 32, 64, 1, 128, w,
                 "f32", PAD3) for w in (8, 16, 32)] + [
    ("phase 14 mamba2 rank, first chunk", 1, 32, 32, 64, 1, 128, 32, "f32",
     None)]
TP_RGLRU_CASES = [("phase 14 recurrentgemma rank, pad 3", 1, w, 1280, "f32",
                   PAD3) for w in (8, 16, 32)]
SSD_CASES += TP_SSD_CASES
RGLRU_CASES += TP_RGLRU_CASES
FLUSH_BYTES = 64 << 20          # written before each call to empty the 50 MB L2
RG_FLASH_CASES = [
    # recurrentgemma's "l" prefill: 10 query heads over 1 kv head, hd 256
    ("recurrentgemma, window 2048", 2, 512, 512, 10, 1, 256, "bf16", "local",
     2048, None),
    ("recurrentgemma, window 64: the band bites", 2, 512, 512, 10, 1, 256,
     "bf16", "local", 64, None),
    ("recurrentgemma solo prefill", 1, 32, 32, 10, 1, 256, "bf16", "local",
     2048, [5]),
] + [("sync wave of phase 10 (d)", b, s, s, 10, 1, 256, dt, "local", 2048, pad)
     for b, s, pad in RG_WAVES for dt in ("bf16", "f32")]


def resets_tensor(torch, b, s, at):
    if at is None:
        return None
    r = torch.zeros(b, s, dtype=torch.bool)
    for row, t in at:
        r[row, t] = True
    return r.cuda()


def ssd_inputs(torch, gen, b, s, h, p, g, n, dtype):
    """The reference's SSD test inputs, drawn on the card: x, dt (softplus
    of a normal), a_log (mamba2's log 1..16), b, c, d_skip."""
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    return (rnd(b, s, h, p).to(dtype),
            torch.nn.functional.softplus(rnd(b, s, h)),
            torch.log(torch.linspace(1.0, 16.0, h, device="cuda")),
            (rnd(b, s, g, n) * 0.5).to(dtype), (rnd(b, s, g, n) * 0.5).to(dtype),
            torch.linspace(0.5, 1.5, h, device="cuda"))


def rglru_inputs(torch, gen, b, s, r, dtype):
    rnd = lambda: torch.randn((b, s, r), generator=gen, device="cuda")
    return (rnd() * 0.3).to(dtype), torch.sigmoid(rnd() + 2.0).to(dtype)


def ssd_plan(ssd, b, s, h, p) -> dict:
    """The SSD call's chunks, column groups of P, blocks a chunk pass and
    device kernels."""
    chunks, groups = ssd.plan(b, s, h, p)
    return {"chunks": chunks, "col_groups": groups,
            "blocks": chunks * groups * h * b,
            "kernels_per_call": ssd.kernels_per_call(s)}


def scan_tol(torch, dtype) -> float:
    return SCAN_TOL_F32 if dtype == torch.float32 else SCAN_TOL_BF16


def check_ssd(torch, ssd, ref, gen, case) -> float:
    label, b, s, h, p, g, n, chunk, dt, at = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    args = ssd_inputs(torch, gen, b, s, h, p, g, n, dtype)
    reset = resets_tensor(torch, b, s, at)
    y, st = ssd.ssd_scan_cuda(*args, reset=reset)
    torch.cuda.synchronize()
    y_w, st_w = ref.ssd_scan_ref(*args, chunk=chunk, reset=reset)
    tol = scan_tol(torch, dtype)
    err_y = float((y.float() - y_w.float()).abs().max())
    err_s = float((st - st_w).abs().max())
    if not torch.allclose(y.float(), y_w.float(), rtol=tol, atol=tol):
        fail(f"ssd {label}: y outside {tol} (max abs err {err_y:.3e})")
    if not torch.allclose(st, st_w, rtol=SCAN_TOL_F32, atol=SCAN_TOL_F32):
        fail(f"ssd {label}: state outside {SCAN_TOL_F32} (max abs err "
             f"{err_s:.3e})")
    log(f"  ssd    {dt:4s} B{b} S{s} H{h} P{p} G{g} N{n} resets={at}: ok, "
        f"max abs err y {err_y:.3e} (tol {tol}), state {err_s:.3e} ({label}, "
        f"plain at chunk {chunk})")
    if dtype == torch.float32 and s >= 512:
        # both float32 paths against the plain scan evaluated in float64
        y64, _ = ref.ssd_scan_ref(*[t.double() for t in args], chunk=chunk,
                                  reset=reset)
        for name, t in (("kernel", y), ("plain", y_w)):
            d64 = (t.double() - y64).abs()
            log(f"    {name} against a float64 evaluation: max abs err "
                f"{float(d64.max()):.3e}, worst element "
                f"{float((d64 / (tol + tol * y64.abs())).max()):.3f} of the "
                f"{tol} limit")
    return max(err_y, err_s)


def check_rglru(torch, rg, ref, gen, case) -> float:
    label, b, s, r, dt, at = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x, a = rglru_inputs(torch, gen, b, s, r, dtype)
    reset = resets_tensor(torch, b, s, at)
    got = rg.rglru_scan_cuda(x, a, reset=reset)
    torch.cuda.synchronize()
    want = ref.rglru_scan_ref(x, a, reset)
    tol = scan_tol(torch, dtype)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"rglru {label}: outside {tol} (max abs err {err:.3e})")
    shown = at if at is None or len(at) <= 8 else f"{len(at)} steps"
    log(f"  rglru  {dt:4s} B{b} S{s} R{r} resets={shown}: ok, max abs err "
        f"{err:.3e} (tol {tol}) ({label}; plan {rg.plan(b, s, r)})")
    return err


def ring_decode_inputs(torch, gen):
    """recurrentgemma's "l" decode: 8 slots over a 2048-slot ring, 10 query
    heads over 1 kv head, hd 256, bf16; valid slots scattered (ring wrap,
    pads), one row with a short window."""
    b, s, h, kv, hd = 8, 2048, 10, 1, 256
    q, k, v = attention_inputs(torch, gen, b, 1, s, h, kv, hd, torch.bfloat16)
    valid = torch.rand((b, s), generator=gen, device="cuda") < 0.5
    valid[0] = False
    valid[0, 1000:1010] = True
    return q, k, v, valid


def check_ring_decode(torch, da, ref, gen) -> float:
    q, k, v, valid = ring_decode_inputs(torch, gen)
    b, s, h, kv, hd = *valid.shape, q.shape[2], k.shape[2], k.shape[3]
    got = da.decode_attention_cuda(q, k, v, valid)
    torch.cuda.synchronize()
    want = ref.decode_attention_ref(q, k, v, valid)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=ATT_TOL_BF16,
                          atol=ATT_TOL_BF16):
        fail(f"decode over a scattered ring: outside {ATT_TOL_BF16} (max abs "
             f"err {err:.3e})")
    log(f"  decode bf16 B{b} S{s} H{h}/{kv} hd{hd} scattered ring: ok, max "
        f"abs err {err:.3e}")
    return err


def scan_phase(torch, ssd, rg, fa, da, ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    log("[7] scan kernels vs plain PyTorch on the card (y and h: "
        f"{SCAN_TOL_F32} in float32, the reference's scan tolerance; "
        f"{SCAN_TOL_BF16} where the output is rounded to bf16; the SSD state, "
        f"float32 either way, {SCAN_TOL_F32})")
    out = {"ssd_max_abs_err": max(check_ssd(torch, ssd, ref, gen, c)
                                  for c in SSD_CASES),
           "rglru_max_abs_err": max(check_rglru(torch, rg, ref, gen, c)
                                    for c in RGLRU_CASES)}
    log("    attention at recurrentgemma's shapes (2e-2 in bf16)")
    out["rg_attention_max_abs_err"] = max(
        [check_flash(torch, fa, ref, gen, c) for c in RG_FLASH_CASES]
        + [check_ring_decode(torch, da, ref, gen)])

    b, s, h, p, g, n = 2, 512, 64, 64, 1, 128
    args = ssd_inputs(torch, gen, b, s, h, p, g, n, torch.bfloat16)
    out["ssd"] = time_kernel(
        torch, lambda: ssd.ssd_scan_cuda(*args),
        lambda: ref.ssd_scan_ref(*args, chunk=256), None,
        ssd.op_count(b, s, h, p, n), ssd.byte_count(b, s, h, p, g, n, 2,
                                                    False), PEAK_BF16_S)
    out["ssd"]["shape"] = (f"B{b} S{s} H{h} P{p} G{g} N{n} bf16 (ops over the "
                           f"bf16 peak)")
    out["ssd"]["plan"] = ssd_plan(ssd, b, s, h, p)
    # the engine's shape: a 32-token solo prefill with a left pad of 3
    b, s = 1, 32
    args = ssd_inputs(torch, gen, b, s, h, p, g, n, torch.bfloat16)
    pad = resets_tensor(torch, b, s, PAD3)
    out["ssd_engine"] = time_kernel(
        torch, lambda: ssd.ssd_scan_cuda(*args, reset=pad),
        lambda: ref.ssd_scan_ref(*args, chunk=s, reset=pad), None,
        ssd.op_count(b, s, h, p, n), ssd.byte_count(b, s, h, p, g, n, 2,
                                                    True), PEAK_BF16_S)
    out["ssd_engine"]["shape"] = (f"B{b} S{s} H{h} P{p} G{g} N{n} bf16, pad 3 "
                                  f"(ops over the bf16 peak)")
    out["ssd_engine"]["plan"] = ssd_plan(ssd, b, s, h, p)
    b, s, r = 2, 512, 2560
    x, a = rglru_inputs(torch, gen, b, s, r, torch.float32)
    out["rglru"] = time_kernel(
        torch, lambda: rg.rglru_scan_cuda(x, a), lambda: ref.rglru_scan_ref(x, a),
        None, rg.op_count(b, s, r), rg.byte_count(b, s, r, 4, False),
        PEAK_F32_S)
    out["rglru"]["shape"] = f"B{b} S{s} R{r} float32"
    out["rglru"]["plan"] = rg.plan(b, s, r)
    out["rglru"]["l2_flushed_ms"] = flushed_device_ms(
        torch, lambda: rg.rglru_scan_cuda(x, a), 50, "rglru")
    # the engine's shape: its gates are float32 (models/rglru.py)
    b, s = 1, 32
    x, a = rglru_inputs(torch, gen, b, s, r, torch.float32)
    pad = resets_tensor(torch, b, s, PAD3)
    out["rglru_engine"] = time_kernel(
        torch, lambda: rg.rglru_scan_cuda(x, a, reset=pad),
        lambda: ref.rglru_scan_ref(x, a, pad), None, rg.op_count(b, s, r),
        rg.byte_count(b, s, r, 4, True), PEAK_F32_S)
    out["rglru_engine"]["shape"] = f"B{b} S{s} R{r} float32, pad 3"
    out["rglru_engine"]["plan"] = rg.plan(b, s, r)
    # decode attention at recurrentgemma's decode tick, beside SDPA
    q, k, v, valid = ring_decode_inputs(torch, gen)
    h, n_valid = q.shape[2], int(valid.sum())
    kt, vt, qt = to_heads(torch, k, h), to_heads(torch, v, h), \
        q.transpose(1, 2).contiguous()
    mask4 = valid[:, None, None, :]
    out["decode_ring"] = time_kernel(
        torch, lambda: da.decode_attention_cuda(q, k, v, valid),
        lambda: ref.decode_attention_ref(q, k, v, valid),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask4),
        4 * h * 256 * n_valid,
        (2 * q.numel() + 2 * n_valid * 256) * 2 + valid.numel(), PEAK_BF16_S)
    out["decode_ring"]["shape"] = (f"B8 S2048 H{h}/1 hd256 bf16, {n_valid} "
                                   f"valid keys")
    splits, chunk = da.decode_splits(8, 1, 2048)
    out["decode_ring"]["splits"] = splits
    if splits < 2:
        fail(f"decode at the ring runs {splits} split")
    log(f"    decode at the ring: {splits} splits of {chunk} keys, "
        f"{8 * splits} blocks")
    # flash at recurrentgemma's prefill shapes: a 32-token solo prefill
    # with a left pad, and B 2 x S 512 (window 2048: causal at this length)
    out["flash_rg_engine"] = time_flash(torch, fa, ref, gen, 1, 32, 10, 1,
                                        256, [5], window=2048)
    out["flash_rg"] = time_flash(torch, fa, ref, gen, 2, 512, 10, 1, 256,
                                 None, window=2048)
    for key in ("decode_ring", "flash_rg_engine", "flash_rg", "ssd",
                "ssd_engine", "rglru", "rglru_engine"):
        log_timed(key, out[key])
    for key in ("ssd", "ssd_engine", "rglru", "rglru_engine"):
        log(f"    {key} plan: {out[key]['plan']}")
    log(f"    rglru at {out['rglru']['shape']}, L2 flushed before each call "
        f"({FLUSH_BYTES >> 20} MB written): device "
        f"{out['rglru']['l2_flushed_ms']:.4f} ms")
    return out


# -- phases 8 and 9: mamba2-1.3b and recurrentgemma-2b served on the card ----

# full width, 48 layers, bf16; 6 requests of at most 48 tokens (12 of
# 160 before phase 17: the run took 57.9-58.9 s of the smoke, nearly all
# of it in the chunks that replay the decode step a token at a time, ~3 s
# a 32-token chunk on the card, whatever the request count)
MAMBA_REQUESTS = 6
MAMBA_ARGS = ["--arch", "mamba2-1.3b", "--split-seq", "512", "--requests",
              str(MAMBA_REQUESTS), "--prompt-max", "48"]
RG_ARGS = ["--arch", "recurrentgemma-2b", "--requests", "6", "--slots", "2",
           "--prompt-len", "16", "--max-new", "8"]   # 26 layers, bf16
# the first 8 of 12 requests before phase 18 (the same draws' prefix:
# RG_WAVES' first wave, a subset of the held shapes), a timed run cut to
# make room, as MOON_BURST's
RG_BURST = dict(n=8, lo=8, hi=160, max_new=32, slots=8)


def scan_counters():
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     rglru_scan, ssd_scan)
    return {"ssd_scan": ssd_scan.ssd_scan_cuda,
            "rglru_scan": rglru_scan.rglru_scan_cuda,
            "flash_attention": flash_attention.flash_attention_cuda,
            "flash_attention_backward":
                flash_attention.flash_attention_backward_cuda,
            "decode_attention": decode_attention.decode_attention_cuda,
            "ssd_scan_backward": ssd_scan.ssd_scan_backward_cuda,
            "rglru_scan_backward": rglru_scan.rglru_scan_backward_cuda}


def launches_of(**counts) -> dict:
    """The launches expected of every counted kernel: ``counts``, 0 for
    each kernel they do not name."""
    return {name: counts.get(name, 0) for name in scan_counters()}


def zero_counts() -> None:
    for fn in scan_counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in scan_counters().items()}


def check_counts(label: str, got: dict, stats: dict, per_prefill=None,
                 per_tick=None, per_token=None, extra=None) -> None:
    """Launches must be exactly: ``per_prefill`` per solo prefill or first
    chunk, ``per_tick`` per decode tick, ``per_token`` per prompt token that
    a later chunk replays through the decode step, plus ``extra``; 0 for
    every other kernel."""
    prefills = stats["prefill_steps"] - stats["chunk_steps"]
    terms = ((per_prefill, prefills), (per_tick, stats["decode_steps"]),
             (per_token, stats["chunk_tokens"]), (extra, 1))
    want = {name: sum((per or {}).get(name, 0) * n for per, n in terms)
            for name in got}
    log(f"    launches over {label}: {got} ({prefills} prefills and first "
        f"chunks, {stats['decode_steps']} decode ticks, "
        f"{stats['chunk_tokens']} tokens replayed by later chunks)")
    if got != want:
        fail(f"{label}: kernel launches {got}, expected {want}")


def run_partitioned(torch, argv, n_requests: int) -> dict:
    """``serve_partitioned.main(argv)`` with every kernel's launch count
    set to 0 before and read after; the burst must complete with 32 tokens
    a request and each split agree with the monolithic pass (bf16)."""
    from repro_torch import serve_partitioned as sp

    zero_counts()
    t0 = time.perf_counter()
    rep = sp.main(argv)
    torch.cuda.synchronize()
    rep["main_s"] = time.perf_counter() - t0
    rep["launches"] = read_counts()
    srv = rep["serving"]
    if srv["completed"] != srv["requests"] or srv["requests"] < n_requests:
        fail(f"{rep['arch']}: served {srv['completed']} of "
             f"{srv['requests']} requests")
    if any(len(o) != 32 for o in srv["out"].values()):
        fail(f"{rep['arch']}: a request did not get its 32 tokens")
    for row in rep["split"]:
        if not row["finite"] or row["max_abs_err"] > (
                ATT_TOL_BF16 + ATT_TOL_BF16 * row["max_abs_logit"]):
            fail(f"{rep['arch']}: split at unit {row['unit_cut']} disagrees "
                 f"with the monolithic pass: {row}")
    log_serving("ES engine", srv)
    log(f"    {rep['main_s']:.1f} s")
    return rep


def log_serving(label: str, stats: dict) -> None:
    log(f"    {label}: {stats['completed']}/{stats['requests']} requests in "
        f"{stats['ticks']} ticks ({stats['decode_steps']} decode, "
        f"{stats['prefill_steps']} prefills and chunks, "
        f"{stats['preemptions']} preemptions); decode tick p50 "
        f"{stats['decode_tick_ms_p50']:.2f} ms p99 "
        f"{stats['decode_tick_ms_p99']:.2f} ms; prefill tick p50 "
        f"{stats['prefill_tick_ms_p50']:.2f} ms p99 "
        f"{stats['prefill_tick_ms_p99']:.2f} ms; "
        f"{stats['tokens_per_s']:.1f} generated tokens/s")


def decoding_profile(torch, cfg, params, kernel) -> dict:
    """3 decode ticks of 8 slots, each past its prompt, under the profiler."""
    from repro_torch import serve_partitioned as sp
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, slots=8, s_max=512)
    for r in sp.make_requests(cfg, 8, 8, 32, 150, 1):
        eng.submit(r)
    while eng.queue or eng._stream_req is not None:
        eng.step()
    t = profile_ticks(torch, eng, 3, kernel=kernel, key="kernel_ms")
    log_profile(t, 8)
    return t


def mamba2_phase(torch) -> dict:
    from repro_torch import serve_partitioned as sp
    from repro_torch.models import transformer

    log("[8] mamba2-1.3b: python -m repro_torch.serve_partitioned "
        + " ".join(MAMBA_ARGS) + " (full width, 48 layers, bf16)")
    rep = run_partitioned(torch, MAMBA_ARGS, MAMBA_REQUESTS)
    srv = rep["serving"]
    # the split check runs the whole stack once monolithic and once per
    # cut; chunks after the first replay the decode step, no scan
    check_counts("the mamba2 run", rep["launches"], srv,
                 per_prefill={"ssd_scan": rep["layers"]},
                 extra={"ssd_scan": rep["layers"] * (1 + len(rep["split"]))})
    cfg = sp.model_config("mamba2-1.3b")
    params = transformer.init_params(sp.SEED, cfg, "cuda")
    rep["tick_profile"] = decoding_profile(torch, cfg, params, None)
    del params
    rep.update(f32_identity(torch, sp.model_config("mamba2-1.3b", layers=4,
                                                   dtype="float32")))
    rep.update(card_vs_cpu(torch, sp.model_config("mamba2-1.3b", layers=2)))
    return rep


def recurrentgemma_phase(torch) -> dict:
    from repro_torch import serve_partitioned as sp
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as ls
    from repro_torch.models import transformer

    per = dict(per_prefill={"rglru_scan": 18, "flash_attention": 8},
               per_tick={"decode_attention": 8},
               per_token={"decode_attention": 8})
    log("[9] recurrentgemma-2b: python -m repro_torch.launch.serve "
        + " ".join(RG_ARGS) + " (full width, 26 layers, bf16)")
    zero_counts()
    t0 = time.perf_counter()
    rep = ls.main(RG_ARGS)
    torch.cuda.synchronize()
    rep["main_s"] = time.perf_counter() - t0
    rep["launches"] = read_counts()
    if len(rep["out"]) != 6 or any(len(o) != 8 for o in rep["out"].values()):
        fail("recurrentgemma: a request did not get its 8 tokens")
    check_counts("the launcher's run", rep["launches"], rep, **per)
    log(f"    {rep['main_s']:.1f} s")

    cfg = get_config("recurrentgemma-2b")
    params = transformer.init_params(ls.SEED, cfg, "cuda")
    b = RG_BURST
    eng = ls.make_engine(cfg, params, slots=b["slots"], prompt_len=b["hi"],
                         max_new=b["max_new"])
    reqs = sp.make_requests(cfg, b["n"], b["lo"], b["hi"], b["max_new"],
                            sp.SEED)
    log(f"    ragged burst: {b['n']} requests of {b['lo']}-{b['hi']} prompt "
        f"tokens, {b['max_new']} new, {b['slots']} slots, s_max "
        f"{eng.s_max}, chunks of {eng.prefill_chunk}")
    zero_counts()
    stats = sp.serve(eng, reqs, torch.cuda.synchronize)
    rep["burst"] = stats
    rep["burst_launches"] = read_counts()
    if stats["completed"] != b["n"] or any(
            len(o) != b["max_new"] for o in stats["out"].values()):
        fail("recurrentgemma: the burst did not complete")
    check_counts("the burst", rep["burst_launches"], stats, **per)
    log_serving("burst", stats)
    rep["tick_profile"] = decoding_profile(torch, cfg, params,
                                           DECODE_KERNELS)
    del params, eng
    rep.update(f32_identity(torch, dataclasses.replace(
        cfg, n_layers=5, param_dtype="float32", compute_dtype="float32")))
    # two bf16 evaluations at this width part by about 3x the 2e-2 band
    # (each about 0.09 from float32 at 5 layers): the bf16 path is held by
    # its distance from float32, and float32 is held to the CPU at 1e-4
    rep.update(card_vs_cpu(torch, dataclasses.replace(cfg, n_layers=5),
                           bf16_check=False))
    return rep


# -- phase 10: the engine's modes and the traffic loop -----------------------

SYNC_MIX = dict(n=16, lo=8, hi=300, max_new=32, slots=8, s_max=512)  # phase 6's
TRACE_CELLS, TRACE_STEPS = 16, 20
TL_ARGS = ["--chunk", "1", "--steps", "4", "--eval-episodes", "1"]
TC_STEPS = 4                  # slots per episode; 1 episode each
TC_ARGS = ["--episodes", "1", "--steps", str(TC_STEPS), "--eval-episodes",
           "1"]
CHECKPOINT_ATOL = 1e-5
OVERHEAD_ARGS = ["--overhead", "--repeats", "4"]     # gate 5 %, the CLI's


def sweep_launches() -> int:
    from repro_torch.kernels import partition_sweep as ps
    return ps.partition_sweep_cuda.launches


def zero_all_counts() -> None:
    from repro_torch.kernels import partition_sweep as ps
    zero_counts()
    ps.partition_sweep_cuda.launches = 0


def check_prometheus(text: str) -> int:
    """The exposition parses: every sample line is ``series value`` with a
    number, and every metric name has one HELP and one TYPE line.  Returns
    the number of names."""
    helps, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            seen = helps if line.startswith("# HELP") else types
            name = line.split()[2]
            seen[name] = seen.get(name, 0) + 1
            continue
        float(line.rsplit(" ", 1)[1])
    if set(helps) != set(types) or any(
            n != 1 for n in (*helps.values(), *types.values())):
        fail(f"prometheus: HELP {helps} / TYPE {types} not one per name")
    return len(types)


def check_observed(label: str, eng, n: int, max_new: int) -> dict:
    """Every request completed with its tokens; each breakdown's stage sum
    is its E2E ticks; the Prometheus text parses; the Chrome trace
    round-trips through a file."""
    import numpy as np
    from repro_torch.obs import SpanTracer
    rec, tel = eng.recorder, eng.obs.tracer
    bds = rec.delay_breakdowns()
    if len(bds) != n:
        fail(f"{label}: {len(bds)} breakdowns for {n} requests")
    for rid, b in bds.items():
        ev = rec.events[rid]
        if b.e2e != ev.complete - ev.submit or min(
                b.queue_wait, b.prefill, b.decode, b.preempted) < 0:
            fail(f"{label}: request {rid}'s stages {b.as_dict()} do not sum "
                 f"to its E2E ticks {ev.complete - ev.submit}")
    names = check_prometheus(eng.obs.metrics.to_prometheus())
    path = ROOT / "build" / f"phase10_{label}_trace.json"
    tel.export_chrome(path)
    if SpanTracer.load_chrome(path) != tel.events():
        fail(f"{label}: the Chrome trace did not round-trip")
    snap = eng.obs.metrics.snapshot()
    mode = "sync" if eng.sync_batching else "continuous"
    if snap[f'serving_completed_total{{engine="{mode}"}}'] != n or snap[
            f'serving_tokens_total{{engine="{mode}"}}'] != n * max_new:
        fail(f"{label}: completion and token counters disagree")
    return {"breakdowns": len(bds), "metric_names": names,
            "trace_events": len(tel.events()),
            "e2e_ticks_p50": float(np.median([b.e2e for b in bds.values()]))}


def check_waves(label: str, shapes, waves) -> None:
    """Every wave the run prefilled, (B, width, padded?), is one whose
    shape phases 5 and 7 held its kernels at."""
    held = {(b, s, pad is not None) for b, s, pad in waves}
    missed = set(map(tuple, shapes)) - held
    if missed:
        fail(f"{label}: waves {sorted(missed)} were not held to the plain "
             f"kernels (QWEN3_WAVES / RG_WAVES list {sorted(held)})")


def sync_vs_continuous(label: str, sync: dict, cont: dict) -> dict:
    keys = ("decode_tick_ms_p50", "decode_tick_ms_p99", "prefill_tick_ms_p50",
            "prefill_tick_ms_p99", "tokens_per_s")
    log(f"    {label}, sync against continuous: " + "; ".join(
        f"{k} {sync[k]:.2f} / {cont[k]:.2f}" for k in keys))
    return {k: {"sync": sync[k], "continuous": cont[k]} for k in keys}


def engines_phase(torch, report: dict, smi: str) -> dict:
    """Phase 10: the sync engine with telemetry and a recorder, the
    continuous engine with telemetry and the sanitizer, the recorded trace
    replayed under the Oracle, recurrentgemma through the launcher's sync
    mode, the training entry points and the telemetry overhead gate."""
    import shutil

    import numpy as np
    from repro_torch import _tree
    from repro_torch import serve_partitioned as sp
    from repro_torch import traffic_demo, train_compare, train_lymdo
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.sanitize import run_sanitize
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as ls
    from repro_torch.models import transformer
    from repro_torch.obs import Telemetry
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.traffic import TrafficRecorder
    from repro_torch.traffic.__main__ import main as traffic_main

    out: dict = {"card": smi}
    m = SYNC_MIX
    cfg = sp.model_config(layers=None)
    layers = cfg.n_layers
    params = transformer.init_params(sp.SEED, cfg, "cuda")   # phase 6's

    # (a) the sync engine, as traffic_demo --sync builds it
    log(f"[10] (a) {cfg.name} ({layers} layers, bf16) through "
        f"ServingEngine(sync_batching=True, telemetry=, recorder=): "
        f"{m['n']} requests of {m['lo']}-{m['hi']} prompt tokens, "
        f"{m['max_new']} new, {m['slots']} slots, s_max {m['s_max']}")
    eng = traffic_demo.make_engine(cfg, params, sync=True, slots=m["slots"],
                                   s_max=m["s_max"])
    reqs = sp.make_requests(cfg, m["n"], m["lo"], m["hi"], m["max_new"],
                            sp.SEED)
    zero_all_counts()
    stats = sp.serve(eng, reqs, torch.cuda.synchronize)
    got = {**read_counts(), "partition_sweep": sweep_launches()}
    if stats["completed"] != m["n"] or any(
            len(o) != m["max_new"] for o in stats["out"].values()):
        fail("sync engine: a request did not complete with its tokens")
    check_counts("the sync engine's run", got, stats,
                 per_prefill={"flash_attention": layers},
                 per_tick={"decode_attention": layers})
    log_serving("sync engine", stats)
    check_waves("the sync engine's run", eng._prefill_shapes, QWEN3_WAVES)
    out["sync"] = {**stats, "launches": got,
                   "prefill_shapes": sorted(eng._prefill_shapes),
                   **check_observed("sync", eng, m["n"], m["max_new"])}
    out["sync_vs_continuous"] = sync_vs_continuous(
        "qwen3", stats, report["serving"]["serving"])
    sync_rec = eng.recorder
    parted = []
    for r in reqs[:4]:
        solo, gaps = solo_tokens(torch, transformer, params, cfg, r.prompt,
                                 m["max_new"], m["s_max"])
        if solo != r.out:
            i = next(j for j, (a, b) in enumerate(zip(solo, r.out)) if a != b)
            parted.append({"rid": r.rid, "step": i, "top2_gap": gaps[i]})
    out["sync"]["bf16_parted_from_solo"] = parted
    log(f"    bf16 sync engine vs solo on 4 requests: {len(parted)} parted "
        f"{parted}")
    out["sync"].update(f32_identity(torch, sp.model_config(
        layers=4, dtype="float32"), sync=True))

    # (b) the continuous engine with telemetry and the sanitizer, then the
    # sanitizer's flash crowd on the same model
    log("    (b) the same mix on ServingEngine(telemetry=, sanitize=True)")
    eng = ServingEngine(cfg, params, slots=m["slots"], s_max=m["s_max"],
                        recorder=TrafficRecorder(),
                        telemetry=Telemetry(sample_every=1), sanitize=True)
    reqs = sp.make_requests(cfg, m["n"], m["lo"], m["hi"], m["max_new"],
                            sp.SEED)
    zero_all_counts()
    stats = sp.serve(eng, reqs, torch.cuda.synchronize)
    got = {**read_counts(), "partition_sweep": sweep_launches()}
    if stats["completed"] != m["n"]:
        fail("sanitized engine: a request did not complete")
    check_counts("the sanitized engine's run", got, stats,
                 per_prefill={"flash_attention": layers},
                 per_tick={"decode_attention": layers})
    log_serving("sanitized continuous engine", stats)
    out["sanitized"] = {**stats, "launches": got,
                        **check_observed("sanitized", eng, m["n"],
                                         m["max_new"])}
    rep = run_sanitize(cfg=cfg, params=params)
    log(f"    run_sanitize's flash crowd at full width: {rep.ticks} ticks, "
        f"{rep.requests} requests, {rep.preemptions} preemptions, "
        f"{rep.block_churn} block events, {len(rep.failures)} failures "
        f"in {rep.elapsed_s:.1f} s")
    if not rep.ok or rep.preemptions == 0 or rep.requests != 10:
        fail(f"run_sanitize at full width: {[f.render() for f in rep.failures]}"
             f", {rep.preemptions} preemptions")
    out["flash_crowd"] = {"ticks": rep.ticks, "preemptions": rep.preemptions,
                          "block_churn": rep.block_churn,
                          "s": rep.elapsed_s}
    log("    python -m repro_torch.analysis --sanitize")
    if analysis_main(["--sanitize"]) != 0:
        fail("python -m repro_torch.analysis --sanitize reported failures")
    del eng

    # (c) the recorder of (a) -> trace -> the Oracle on a trace_replay grid
    trace = sync_rec.to_trace(n_ue=4, bin_ticks=4, which="complete")
    path = ROOT / "build" / "phase10_trace.npz"
    trace.save(path)
    log(f"    (c) trace of (a)'s completions: T={trace.n_slots} x "
        f"N={trace.n_ue}; {TRACE_CELLS}-cell trace_replay grid under the "
        f"Oracle, {TRACE_STEPS} slots")
    zero_all_counts()
    t0 = time.perf_counter()
    rp = traffic_demo.replay(str(path), TRACE_CELLS, TRACE_STEPS, "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if sweep_launches() != TRACE_STEPS:
        fail(f"trace replay: {sweep_launches()} partition_sweep launches, "
             f"expected one per Oracle slot ({TRACE_STEPS})")
    if not all(np.isfinite(v).all() for v in rp["metrics"].values()):
        fail("trace replay: non-finite metrics")
    if traffic_main(["--show", str(path)]) != 0:
        fail("python -m repro_torch.traffic --show failed")
    out["replay"] = {"slots": TRACE_STEPS, "cells": TRACE_CELLS,
                     "slot_ms": dt / TRACE_STEPS * 1e3,
                     "sweep_launches": TRACE_STEPS,
                     "delay_ms": float(np.mean(rp["metrics"]["delay"])) * 1e3}
    del params

    # (d) recurrentgemma through the launcher's sync mode, then phase 9's
    # burst through a sync engine built as the launcher builds it
    per = dict(per_prefill={"rglru_scan": 18, "flash_attention": 8},
               per_tick={"decode_attention": 8})
    log("    (d) python -m repro_torch.launch.serve " + " ".join(RG_ARGS)
        + " --sync-batching")
    zero_all_counts()
    rep = ls.main(RG_ARGS + ["--sync-batching"])
    torch.cuda.synchronize()
    got = {**read_counts(), "partition_sweep": sweep_launches()}
    if rep["mode"] != "sync" or len(rep["out"]) != 6 or any(
            len(o) != 8 for o in rep["out"].values()):
        fail("recurrentgemma sync: a request did not get its 8 tokens")
    check_counts("the launcher's sync run", got, rep, **per)
    check_waves("the launcher's sync run", rep["prefill_shapes"], RG_WAVES)
    out["rg_launcher"] = {"launches": got, "prefill_steps": rep["prefill_steps"],
                          "decode_steps": rep["decode_steps"]}
    rg_cfg = get_config("recurrentgemma-2b")
    rg_params = transformer.init_params(ls.SEED, rg_cfg, "cuda")
    b = RG_BURST
    eng = ls.make_engine(rg_cfg, rg_params, slots=b["slots"],
                         prompt_len=b["hi"], max_new=b["max_new"],
                         sync_batching=True)
    zero_all_counts()
    stats = sp.serve(eng, sp.make_requests(rg_cfg, b["n"], b["lo"], b["hi"],
                                           b["max_new"], sp.SEED),
                     torch.cuda.synchronize)
    got = {**read_counts(), "partition_sweep": sweep_launches()}
    if stats["completed"] != b["n"]:
        fail("recurrentgemma sync burst did not complete")
    check_counts("the recurrentgemma sync burst", got, stats, **per)
    check_waves("the recurrentgemma sync burst", eng._prefill_shapes,
                RG_WAVES)
    log_serving("recurrentgemma sync burst", stats)
    out["rg_sync_burst"] = {**stats, "launches": got}
    out["rg_sync_vs_continuous"] = sync_vs_continuous(
        "recurrentgemma burst", stats, report["recurrentgemma"]["burst"])
    del rg_params, eng
    out["rg_sync_burst"].update(f32_identity(torch, dataclasses.replace(
        rg_cfg, n_layers=5, param_dtype="float32", compute_dtype="float32"),
        sync=True))

    # (e) train_lymdo killed after its first chunk and resumed, against an
    # uninterrupted run
    dirs = [ROOT / "build" / f"phase10_ckpt_{x}" for x in "ab"]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    log("    (e) python -m repro_torch.train_lymdo " + " ".join(TL_ARGS)
        + ": --episodes 1, then 2 resumed, against 2 in one run")
    zero_all_counts()
    t0 = time.perf_counter()
    runs = [train_lymdo.main(TL_ARGS + ["--episodes", str(n), "--ckpt-dir",
                                        str(d)])
            for n, d in ((1, dirs[0]), (2, dirs[0]), (2, dirs[1]))]
    torch.cuda.synchronize()
    tl_s = time.perf_counter() - t0
    if [r["resumed_from"] for r in runs] != [0, 1, 0] or sweep_launches():
        fail(f"train_lymdo: resumed from {[r['resumed_from'] for r in runs]}")
    worst = max(float((a - c).abs().max()) for a, c in zip(
        _tree.leaves(runs[1]["train_state"]),
        _tree.leaves(runs[2]["train_state"])))
    log(f"    resumed vs uninterrupted parameters: max abs diff {worst:.3e} "
        f"(atol {CHECKPOINT_ATOL}); {tl_s:.1f} s for the three runs")
    if worst > CHECKPOINT_ATOL:
        fail("train_lymdo: the resumed run's parameters differ")
    out["train_lymdo"] = {"max_abs_diff": worst, "s": tl_s,
                          "eval": runs[2]["eval"]}

    # (f) train_compare at 1 episode x TC_STEPS slots per agent
    art_path = ROOT / "build" / "phase10_paper_artifacts.json"
    log("    (f) python -m repro_torch.train_compare " + " ".join(TC_ARGS))
    zero_all_counts()
    t0 = time.perf_counter()
    art = train_compare.main(TC_ARGS + ["--out", str(art_path)])
    torch.cuda.synchronize()
    tc_s = time.perf_counter() - t0
    written = json.loads(art_path.read_text())
    if set(written) != set(art) - {"agents"} or len(written) != 9:
        fail(f"train_compare wrote keys {sorted(written)}")
    if sweep_launches() != TC_STEPS:
        fail(f"train_compare: {sweep_launches()} partition_sweep launches, "
             f"expected one per Oracle slot ({TC_STEPS})")
    for rate, row in written["fig4"].items():
        if row["oracle"]["reward"] < max(row["local"]["reward"],
                                         row["edge"]["reward"]) - 1e-3:
            fail(f"train_compare: the Oracle scores worse than a fixed "
                 f"baseline at {rate} req/s")
    log(f"    {tc_s:.1f} s; headline {written['headline_delay_reduction_vs_ppo']:.3f}"
        f"; Oracle delay ms " + ", ".join(
            f"{r} {row['oracle']['delay'] * 1e3:.1f}"
            for r, row in written["fig4"].items()))
    out["train_compare"] = {"s": tc_s, "keys": sorted(written),
                            "sweep_launches": TC_STEPS,
                            "fig4": written["fig4"]}

    # (g) the telemetry overhead gate at the CLI's depth
    log("    (g) python -m repro_torch.obs " + " ".join(OVERHEAD_ARGS))
    if obs_main(OVERHEAD_ARGS) != 0:
        fail("the telemetry overhead gate failed")
    return out


# -- phase 11: the remaining layer kinds -------------------------------------

# full width, 48 layers, bf16; the first 8 of serve_partitioned's 16
# requests (16 before phase 18: its 44 s, and the sync engine's, were the
# timed runs cut to make room; the same draws' prefix, so one wave of
# MOON_WAVES' and a subset of the solo buckets)
MOON_ARGS = ["--arch", "moonshot-v1-16b-a3b", "--split-seq", "512",
             "--prompt-max", "256", "--requests", "8"]
MOON_BURST = dict(n=8, lo=8, hi=256, max_new=32, slots=8)   # MOON_ARGS'
INIT_SLACK = 256 << 20        # temporaries beside the stack and one layer
F32_STEPS = 8                 # greedy steps of the float32 token checks
SEED_KINDS = 0                # (b)-(d)'s weights


@contextlib.contextmanager
def recorded_launches(seen: set):
    """Add to ``seen`` the key of every flash, decode, paged-decode, SSD and
    RG-LRU call the model makes through ``kernels.ops`` while the block
    runs: on CUDA each call launches its kernel once (the launch counts stay
    with the kernels' wrappers).  The keys are those ``held_shapes`` makes
    of the phase-5 and phase-7 cases."""
    import torch
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in
             ("flash_attention", "decode_attention", "decode_attention_paged",
              "ssd_scan", "rglru_scan")}
    dt = lambda t: "bf16" if t.dtype == torch.bfloat16 else "f32"

    def flash(q, k, v, *, kind="causal", window=0, pad_mask=None):
        seen.add(("flash", dt(q), q.shape[0], q.shape[1], k.shape[1],
                  q.shape[2], k.shape[2], q.shape[3], kind,
                  pad_mask is not None))
        return saved["flash_attention"](q, k, v, kind=kind, window=window,
                                        pad_mask=pad_mask)

    def decode(q, k, v, valid_mask, *, with_ml=False):
        seen.add(("decode_ml" if with_ml else "decode", dt(q), q.shape[0],
                  k.shape[1], q.shape[2], k.shape[2], q.shape[3]))
        return saved["decode_attention"](q, k, v, valid_mask,
                                         with_ml=with_ml)

    def paged(q, k_pool, v_pool, block_table, seq_lens):
        seen.add(("paged", dt(q), q.shape[0], block_table.shape[1],
                  k_pool.shape[1], q.shape[2], k_pool.shape[2], q.shape[3]))
        return saved["decode_attention_paged"](q, k_pool, v_pool,
                                               block_table, seq_lens)

    def ssd_scan(x, dt_, a_log, b, c, d_skip, chunk, reset=None):
        seen.add(("ssd", dt(x), *x.shape, *b.shape[2:]))
        return saved["ssd_scan"](x, dt_, a_log, b, c, d_skip, chunk, reset)

    def rglru_scan(x, a, reset=None):
        seen.add(("rglru", dt(x), *x.shape))
        return saved["rglru_scan"](x, a, reset)

    ops.flash_attention, ops.decode_attention = flash, decode
    ops.decode_attention_paged = paged
    ops.ssd_scan, ops.rglru_scan = ssd_scan, rglru_scan
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def captured_routes(routes: list):
    """Append to ``routes``, for every MoE layer call while the block runs,
    the (tokens, E) mask of the experts each token was routed to and kept
    at (from ``models.ffn.route``), on the CPU."""
    from repro_torch.models import ffn
    route = ffn.route

    def spy(*args):
        out = route(*args)
        kept = out[0].sum(-1) > 0
        routes.append(kept.reshape(-1, kept.shape[-1]).cpu())
        return out
    ffn.route = spy
    try:
        yield routes
    finally:
        ffn.route = route


def kinds_batch(torch, cfg, b: int, s: int, seed: int, device="cuda"):
    """Tokens (b, s) and the context a stack needs: 1,024 image embeddings
    (vision) or ``SRC_FRAMES`` source frames (an encoder), float32 normal
    draws from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g)}
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.randn(b, IMAGE_TOKENS, cfg.d_model,
                                            generator=g)
    elif cfg.enc_layers:
        batch["src_embeds"] = torch.randn(b, SRC_FRAMES, cfg.d_model,
                                          generator=g)
    return {k: v.to(device) for k, v in batch.items()}


def greedy_vs_teacher(torch, cfg32, b: int, s: int) -> dict:
    """float32 on the card: greedy prefill + decode_step tokens equal the
    argmax of the teacher-forced ``forward_train`` logits over the prompt
    and those tokens (the reference's own serving invariant)."""
    from repro_torch.models import transformer
    params = transformer.init_params(7, cfg32, "cuda")
    batch = kinds_batch(torch, cfg32, b, s, 3)
    lg, cache = transformer.prefill(params, cfg32, batch, s_max=s + F32_STEPS)
    out = [torch.argmax(lg, -1)]
    for _ in range(F32_STEPS - 1):
        lg, cache = transformer.decode_step(params, cfg32, cache, out[-1])
        out.append(torch.argmax(lg, -1))
    got = torch.stack(out, 1)
    full = dict(batch, tokens=torch.cat([batch["tokens"], got[:, :-1]], 1))
    tf, _ = transformer.forward_train(params, cfg32, full)
    tf = tf[:, s - 1:]
    want = torch.argmax(tf, -1)
    same = int((want == got).sum())
    log(f"    float32 greedy decode vs teacher forcing, {cfg32.name} at "
        f"{cfg32.n_layers} layers{f' + {cfg32.enc_layers} encoder' if cfg32.enc_layers else ''}"
        f"{f', {cfg32.n_experts} experts at capacity factor {cfg32.capacity_factor:g}' if cfg32.n_experts else ''}: "
        f"{same}/{got.numel()} tokens equal")
    if same != got.numel():
        top = torch.topk(tf, 2, dim=-1).values
        gaps = (top[..., 0] - top[..., 1])[want != got]
        fail(f"{cfg32.name}: greedy decode parts from teacher forcing "
             f"(top-2 gaps there {gaps.tolist()})")
    del params
    return {"f32_tokens_equal": same}


def moe_card_vs_cpu(torch, cfg2) -> dict:
    """The card against the port's CPU path on an MoE stack, bf16, through
    ``forward_train`` on 4 x 64 tokens, beside a float32 evaluation of the
    same weights on the CPU.  The routes come first: a near tie in the
    float32 router flips an expert between two evaluations and moves that
    token's output far beyond any rounding band, so each token's kept
    expert set at every MoE layer is compared across the three runs, the
    share that differs is logged, and the drift (the card's bf16 logits at
    most ``BF16_DRIFT`` times as far from float32 as the CPU's) is held on
    the tokens whose routes agree in all three."""
    from repro_torch import _tree
    from repro_torch.models import transformer
    params = transformer.init_params(11, cfg2, "cuda")
    p_cpu = _tree.to_device(params, "cpu")
    del params
    toks = torch.randint(0, cfg2.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(0))

    def run(params, cfg, device):
        routes = []
        with captured_routes(routes):
            lg, _ = transformer.forward_train(_tree.to_device(params, device),
                                              cfg, {"tokens": toks.to(device)})
        return lg.cpu().reshape(-1, lg.shape[-1]), routes

    lg_gpu, r_gpu = run(p_cpu, cfg2, "cuda")
    lg_cpu, r_cpu = run(p_cpu, cfg2, "cpu")
    cfg32 = dataclasses.replace(cfg2, param_dtype="float32",
                                compute_dtype="float32")
    p32 = _tree.map_tensors(
        lambda t: t.float() if t.is_floating_point() else t, p_cpu)
    del p_cpu
    lg_f32, r_f32 = run(p32, cfg32, "cpu")
    del p32
    flip = lambda a, b: torch.stack([(x != y).any(-1) for x, y in zip(a, b)])
    card_cpu = flip(r_gpu, r_cpu)                       # (layers, tokens)
    clean = ~(card_cpu | flip(r_gpu, r_f32) | flip(r_cpu, r_f32)).any(0)
    out = {"route_differ_card_cpu": float(card_cpu.float().mean()),
           "route_differ_bf16_f32": float(flip(r_cpu, r_f32).float().mean()),
           "clean_tokens": int(clean.sum()), "tokens": clean.numel()}
    if not clean.any():
        fail(f"{cfg2.name}: no token keeps its routes in all three runs")
    d_gpu = (lg_gpu - lg_f32).abs()[clean]
    d_cpu = (lg_cpu - lg_f32).abs()[clean]
    out.update(card_bf16_vs_f32=float(d_gpu.max()),
               cpu_bf16_vs_f32=float(d_cpu.max()),
               card_vs_cpu_max_abs_err=float(
                   (lg_gpu - lg_cpu).abs()[clean].max()))
    out["bf16_drift"] = out["card_bf16_vs_f32"] / out["cpu_bf16_vs_f32"]
    log(f"    card vs CPU, {cfg2.name} at {cfg2.n_layers} layers bf16: "
        f"expert sets differ for {out['route_differ_card_cpu']:.4f} of "
        f"(token, layer) routes card vs CPU, "
        f"{out['route_differ_bf16_f32']:.4f} bf16 vs float32; on the "
        f"{out['clean_tokens']}/{out['tokens']} tokens whose routes agree in "
        f"all three: card vs CPU max abs err "
        f"{out['card_vs_cpu_max_abs_err']:.3e}, from float32 card "
        f"{out['card_bf16_vs_f32']:.3e}, CPU {out['cpu_bf16_vs_f32']:.3e}, "
        f"{out['bf16_drift']:.3f} of the CPU's (limit {BF16_DRIFT})")
    if out["bf16_drift"] > BF16_DRIFT:
        fail(f"{cfg2.name}: the card's bf16 logits stand further from "
             f"float32 than {BF16_DRIFT} x the CPU's")
    return out


def kinds_run(torch, cfg, pad, steps: int, seen: set, per_prefill: int,
              per_step: int) -> dict:
    """(b)-(d): ``cfg`` at full width from a seeded init; a prefill of
    ``KINDS_B`` prompts of ``KINDS_PROMPT`` tokens (left pads ``pad``) with
    the stack's context, then ``steps`` greedy ``decode_step``s, each timed
    on the host around a sync; flash and decode launches held exactly."""
    import numpy as np
    from repro_torch.models import transformer
    t0 = time.perf_counter()
    params = transformer.init_params(SEED_KINDS, cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = kinds_batch(torch, cfg, KINDS_B, KINDS_PROMPT, 1)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    with recorded_launches(seen):
        zero_counts()
        t0 = time.perf_counter()
        lg, cache = transformer.prefill(params, cfg, batch,
                                        s_max=KINDS_PROMPT + steps, pad=pad_t)
        tok = torch.argmax(lg, -1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_ms, finite = [], bool(torch.isfinite(lg).all())
        for _ in range(steps):
            t0 = time.perf_counter()
            lg, cache = transformer.decode_step(params, cfg, cache, tok)
            tok = torch.argmax(lg, -1)
            finite = finite and bool(torch.isfinite(lg).all())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        got = read_counts()
    want = {name: 0 for name in got}
    want.update(flash_attention=per_prefill, decode_attention=per_step * steps)
    out = {"params": transformer.param_count(params), "init_s": init_s,
           "prefill_ms": prefill_ms,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "tokens_per_s": KINDS_B * steps / (sum(step_ms) / 1e3),
           "launches": got}
    log(f"    {cfg.name} ({cfg.n_layers} layers"
        f"{f' + {cfg.enc_layers} encoder' if cfg.enc_layers else ''}, "
        f"{out['params'] / 1e9:.2f} B parameters, init {init_s:.1f} s): "
        f"prefill B{KINDS_B} S{KINDS_PROMPT} pad={pad} {prefill_ms:.1f} ms; "
        f"{steps} decode steps p50 {out['step_ms_p50']:.2f} ms p99 "
        f"{out['step_ms_p99']:.2f} ms, {out['tokens_per_s']:.1f} tokens/s; "
        f"launches {got}")
    if not finite:
        fail(f"{cfg.name}: non-finite logits")
    if got != want:
        fail(f"{cfg.name}: kernel launches {got}, expected {want}")
    del params, cache
    return out


def kinds_phase(torch) -> dict:
    """Phase 11: moonshot-v1-16b-a3b through ``serve_partitioned`` and a
    sync engine, llama4-maverick (one unit), llama-3.2-vision (two units)
    and seamless-m4t (full depth) through the model's entry points, the
    float32 token checks and card against CPU."""
    from repro_torch import serve_partitioned as sp
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as ls
    from repro_torch.models import transformer

    out: dict = {}
    seen: set = set()
    total = {"flash_attention": 0, "decode_attention": 0}

    def add(counts):
        for name in total:
            total[name] += counts[name]

    # (a) moonshot at full width and depth: controller, split, burst
    log("[11] (a) moonshot-v1-16b-a3b: python -m repro_torch.serve_partitioned "
        + " ".join(MOON_ARGS) + " (full width, 48 layers, bf16)")
    with recorded_launches(seen):
        rep = run_partitioned(torch, MOON_ARGS, MOON_BURST["n"])
    layers, srv = rep["layers"], rep["serving"]
    check_counts("the moonshot run", rep["launches"], srv,
                 per_prefill={"flash_attention": layers},
                 per_tick={"decode_attention": layers},
                 extra={"flash_attention": layers * (1 + len(rep["split"]))})
    add(rep["launches"])
    if srv["chunk_steps"] or srv["prefill_steps"] != MOON_BURST["n"]:
        fail(f"moonshot: {srv['prefill_steps']} prefills and "
             f"{srv['chunk_steps']} chunks for {MOON_BURST['n']} requests: "
             f"MoE stacks prefill whole prompts")
    cfg = sp.model_config("moonshot-v1-16b-a3b")
    embed_bytes = cfg.vocab * cfg.d_model * 2
    layer_bytes = (rep["param_bytes"] - embed_bytes - cfg.d_model * 2) // layers
    limit = rep["param_bytes"] + layer_bytes + INIT_SLACK
    log(f"    init peak {rep['init_peak_bytes'] / 1e9:.3f} GB allocated for "
        f"{rep['param_bytes'] / 1e9:.3f} GB of parameters (limit: those, "
        f"one layer of {layer_bytes / 1e9:.3f} GB and "
        f"{INIT_SLACK >> 20} MiB)")
    if rep["init_peak_bytes"] > limit:
        fail("moonshot's init peaked above its parameters and one layer")
    out["moonshot"] = rep

    params = transformer.init_params(sp.SEED, cfg, "cuda")   # main()'s
    m = MOON_BURST
    eng = ls.make_engine(cfg, params, slots=m["slots"], prompt_len=m["hi"],
                         max_new=m["max_new"], sync_batching=True)
    log(f"    the same burst through the sync engine launch.serve "
        f"--sync-batching builds (s_max {eng.s_max})")
    reqs = sp.make_requests(cfg, m["n"], m["lo"], m["hi"], m["max_new"],
                            sp.SEED)
    with recorded_launches(seen):
        zero_counts()
        stats = sp.serve(eng, reqs, torch.cuda.synchronize)
        got = read_counts()
    if stats["completed"] != m["n"] or any(
            len(o) != m["max_new"] for o in stats["out"].values()):
        fail("moonshot sync: a request did not complete with its tokens")
    check_counts("the moonshot sync run", got, stats,
                 per_prefill={"flash_attention": layers},
                 per_tick={"decode_attention": layers})
    add(got)
    check_waves("the moonshot sync run", eng._prefill_shapes, MOON_WAVES)
    log_serving("moonshot sync engine", stats)
    out["moonshot_sync"] = {**stats, "launches": got,
                            "prefill_shapes": sorted(eng._prefill_shapes)}
    out["moonshot_sync_vs_continuous"] = sync_vs_continuous(
        "moonshot", stats, srv)
    del eng
    out["moonshot_tick_profile"] = decoding_profile(torch, cfg, params,
                                                    DECODE_KERNELS)
    del params
    torch.cuda.empty_cache()
    out["moonshot_f32"] = f32_identity(torch, no_drop(
        sp.model_config("moonshot-v1-16b-a3b", layers=4, dtype="float32")))
    out["moonshot_card_vs_cpu"] = moe_card_vs_cpu(
        torch, sp.model_config("moonshot-v1-16b-a3b", layers=2))
    torch.cuda.empty_cache()

    # (b) llama4-maverick, one unit (g, m) at full width
    log("    (b) llama4-maverick-400b-a17b, one unit (g, m), full width")
    l4 = get_config("llama4-maverick-400b-a17b")
    out["llama4"] = kinds_run(torch, dataclasses.replace(l4, n_layers=2),
                              LLAMA4_PAD, LLAMA4_STEPS, seen, 2, 2)
    add(out["llama4"]["launches"])
    torch.cuda.empty_cache()
    out["llama4"].update(greedy_vs_teacher(torch, no_drop(dataclasses.replace(
        l4, n_layers=2, n_experts=16, param_dtype="float32",
        compute_dtype="float32")), KINDS_B, 32))
    out["llama4"].update(moe_card_vs_cpu(torch, reduced_for_card(l4)))
    torch.cuda.empty_cache()

    # (c) llama-3.2-vision, two units (8 "g" + 2 "x") at full width
    log("    (c) llama-3.2-vision-90b, two units (g g g g x), full width, "
        f"{IMAGE_TOKENS} image embeddings")
    vi = get_config("llama-3.2-vision-90b")
    out["vision"] = kinds_run(torch, dataclasses.replace(vi, n_layers=10),
                              VISION_PAD, KINDS_STEPS, seen, 10, 10)
    add(out["vision"]["launches"])
    torch.cuda.empty_cache()
    out["vision"].update(greedy_vs_teacher(torch, dataclasses.replace(
        vi, n_layers=5, param_dtype="float32", compute_dtype="float32"),
        KINDS_B, 32))
    out["vision"].update(card_vs_cpu(torch, reduced_for_card(vi),
                                     context=True))
    torch.cuda.empty_cache()

    # (d) seamless-m4t at full width and depth: 24 "e" + 24 "d"
    log(f"    (d) seamless-m4t-large-v2, 24 encoder + 24 decoder layers, "
        f"{SRC_FRAMES} source frames, prompts of {KINDS_PROMPT}")
    se = get_config("seamless-m4t-large-v2")
    out["seamless"] = kinds_run(torch, se, None, KINDS_STEPS, seen, 72, 48)
    add(out["seamless"]["launches"])
    out["seamless"].update(greedy_vs_teacher(torch, dataclasses.replace(
        se, n_layers=4, enc_layers=4, param_dtype="float32",
        compute_dtype="float32"), KINDS_B, 32))
    out["seamless"].update(card_vs_cpu(
        torch, dataclasses.replace(se, n_layers=2, enc_layers=2),
        context=True))

    missed = seen - held_shapes()
    log(f"    phase 11 launched the attention kernels at {len(seen)} shapes; "
        f"{len(seen) - len(missed)} held in phase 5")
    if missed:
        fail(f"phase 11 launched kernels at shapes phase 5 did not hold: "
             f"{sorted(missed)}")
    out["shapes"] = sorted(map(list, seen))
    out["launches"] = total
    return out


# -- phase 12: LM training on the card ---------------------------------------

GRAD_TOL_F32, GRAD_TOL_BF16 = 1e-4, 2e-2   # x max(1, max |plain grad|)
# (label, B, Sq, Sk, H, KV, hd, dtype, kind, window, pad): the training
# shape (qwen3-0.6b at its 2-microbatch B4 S512), gemma3's window at its hd
# 256 and MQA, cross attention (full, Sq != Sk; vision's H64/KV8), GQA
# groups of 1, 5 and 8, hd 32 (the train_lm twin) and 64, a length no tile
# divides, and left pads with query rows that see no key; then the edges of
# the backward's tiling: Sq or Sk under one 64-row tile, a group of 64
# (one position a dQ block), an odd number of key tiles under causal
FLASH_GRAD_CASES = [
    ("train", 4, 512, 512, 16, 8, 128, "bf16", "causal", 0, None),
    ("train", 4, 512, 512, 16, 8, 128, "f32", "causal", 0, None),
    ("gemma3 local", 1, 1100, 1100, 4, 1, 256, "bf16", "local", 1024, None),
    ("gemma3 local", 1, 1100, 1100, 4, 1, 256, "f32", "local", 1024, None),
    ("cross g8", 2, 100, 300, 64, 8, 128, "bf16", "full", 0, None),
    ("cross g8", 2, 100, 300, 64, 8, 128, "f32", "full", 0, None),
    ("encoder g1", 2, 256, 256, 16, 16, 64, "bf16", "full", 0, None),
    ("g5", 2, 130, 130, 10, 2, 64, "bf16", "causal", 0, None),
    ("g5", 2, 130, 130, 10, 2, 64, "f32", "causal", 0, None),
    ("S333", 2, 333, 333, 16, 8, 128, "bf16", "causal", 0, None),
    ("S333", 2, 333, 333, 16, 8, 128, "f32", "causal", 0, None),
    ("hd32", 2, 64, 64, 4, 2, 32, "bf16", "causal", 0, None),
    ("hd32", 2, 64, 64, 4, 2, 32, "f32", "causal", 0, None),
    ("pad", 3, 96, 96, 8, 2, 64, "bf16", "causal", 0, [0, 17, 40]),
    ("pad", 3, 96, 96, 8, 2, 64, "f32", "causal", 0, [0, 17, 40]),
    ("local pad", 2, 200, 200, 4, 1, 256, "bf16", "local", 64, [0, 30]),
    ("local pad", 2, 200, 200, 4, 1, 256, "f32", "local", 64, [0, 30]),
    ("S17", 2, 17, 17, 8, 2, 64, "bf16", "causal", 0, None),
    ("S17", 2, 17, 17, 8, 2, 64, "f32", "causal", 0, None),
    ("Sq17 cross", 2, 17, 300, 16, 8, 128, "bf16", "full", 0, None),
    ("Sk17 cross", 2, 300, 17, 16, 8, 128, "bf16", "full", 0, None),
    ("g64", 1, 40, 40, 64, 1, 64, "bf16", "causal", 0, None),
    ("g64", 1, 40, 40, 64, 1, 64, "f32", "causal", 0, None),
    ("5 key tiles", 2, 320, 320, 8, 4, 128, "bf16", "causal", 0, None),
] + TM_FLASH


def seen_rows(torch, b, sq, sk, kind, window, pad):
    """(B, Sq) bool: the query rows that see at least one key."""
    from repro_torch.kernels import ref
    mask = ref.build_mask(kind, sq, sk, window, device="cuda")
    mask = (torch.ones(sq, sk, dtype=torch.bool, device="cuda")
            if mask is None else mask)[None].expand(b, sq, sk)
    if pad is not None:
        keys = torch.arange(sk, device="cuda")[None, None, :]
        mask = mask & (keys >= torch.tensor(pad, device="cuda")[:, None, None])
    return mask.any(-1)


def check_flash_grad(torch, gen, case) -> float:
    """The flash backward (through ``ops.flash_attention`` with a gradient
    wanted) against autograd through the float32 plain version on the same
    inputs.  Rows that see no key are zeros from the kernel but the uniform
    average from the plain version: their dO is zeroed on both sides, then
    the kernel runs once more with it and must give those rows dq = 0 and
    change no bit of dk, dv."""
    from repro_torch.kernels import ops, ref
    label, b, sq, sk, h, kv, hd, dt, kind, window, pad = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    q, k, v = attention_inputs(torch, gen, b, sq, sk, h, kv, hd, dtype)
    dout = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(dtype)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    pad_mask = None if pad is None else (
        torch.arange(sk, device="cuda")[None, :] >= pad_t[:, None])
    seen = seen_rows(torch, b, sq, sk, kind, window, pad)
    dout_seen = dout * seen[:, :, None, None].to(dtype)

    def kernel_grads(d):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = ops.flash_attention(*leaves, kind=kind, window=window,
                                  pad_mask=pad_mask)
        return torch.autograd.grad(out, leaves, d)

    got = kernel_grads(dout_seen)
    plain = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*plain, kind=kind, window=window, pad=pad_t),
        plain, dout_seen.float())
    torch.cuda.synchronize()
    tol = GRAD_TOL_F32 if dtype == torch.float32 else GRAD_TOL_BF16
    err = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not bool(torch.isfinite(g.float()).all()):
            fail(f"flash backward {label} {dt}: non-finite {name}")
        e = float((g.float() - w).abs().max())
        bound = tol * max(1.0, float(w.abs().max()))
        if e > bound:
            fail(f"flash backward {label} {dt}: {name} max abs err {e:.3e} "
                 f"above {bound:.3e}")
        err = max(err, e)
    dead = int((~seen).sum())
    if dead:
        again = kernel_grads(dout)
        if bool((again[0][~seen] != 0).any()):
            fail(f"flash backward {label} {dt}: a row that sees no key has "
                 f"dq != 0")
        if not (torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])):
            fail(f"flash backward {label} {dt}: rows that see no key moved "
                 f"dk or dv")
    log(f"  flash bwd {dt:4s} {kind:6s} B{b} Sq{sq} Sk{sk} H{h}/{kv} hd{hd} "
        f"pad={pad}: ok, max abs err {err:.3e}"
        f"{f'; {dead} rows see no key' if dead else ''} ({label})")
    return err


def flash_bwd_calls(torch, gen, b, s, h, kv, hd, kind="causal", window=0):
    """The bf16 flash backward alone at B x S (causal, or local under
    ``window``), from a saved forward, with what it is timed against: the
    plain version's backward and SDPA's (a boolean mask for local), each
    from its own saved graph; its flops (8 hd H a live pair) and bytes (q,
    k, v, out, dO and lse read, dq, dk and dv written).  Returns (calls,
    flops, bytes, shape); ``calls["kernel"](lib)`` launches through the
    library ``lib`` (``flash_attention.LIBRARY`` or an earlier build with
    the same C interface)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    q, k, v = attention_inputs(torch, gen, b, s, s, h, kv, hd, torch.bfloat16)
    dout = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = fa.flash_attention_cuda(q, k, v, kind=kind, window=window,
                                       with_lse=True)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    plain_out = ref.flash_attention_ref(*leaves, kind=kind, window=window)
    heads = [to_heads(torch, k, h // kv), to_heads(torch, v, h // kv),
             q.transpose(1, 2).contiguous()]
    kt, vt, qt = [t.detach().requires_grad_(True) for t in heads]
    if kind == "causal":
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        allowed = ref.build_mask(kind, s, s, window, device="cuda")
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=allowed)
    dout_h = dout.transpose(1, 2).contiguous()

    def kernel(lib):
        def call():
            saved, fa.LIBRARY = fa.LIBRARY, lib
            try:
                return fa.flash_attention_backward_cuda(
                    q, k, v, out, lse, dout, kind=kind, window=window)
            finally:
                fa.LIBRARY = saved
        return call

    calls = {
        "kernel": kernel,
        "plain": lambda: torch.autograd.grad(plain_out, leaves, dout,
                                             retain_graph=True),
        "library": lambda: torch.autograd.grad(sdpa_out, [kt, vt, qt], dout_h,
                                               retain_graph=True)}
    pairs = fa.live_pairs(b, s, s, kind, window)
    n_bytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
    shape = (f"B{b} S{s} H{h}/{kv} hd{hd} bf16 {kind}"
             f"{f' W{window}' if window else ''}, backward")
    return calls, 8 * h * hd * pairs, n_bytes, shape


def time_flash_bwd(torch, gen, b, s, h, kv, hd, kind="causal",
                   window=0) -> dict:
    """The backward alone (``flash_bwd_calls``) beside the plain version's
    and SDPA's backward, and its bound."""
    from repro_torch.kernels import flash_attention as fa
    calls, n_flops, n_bytes, shape = flash_bwd_calls(torch, gen, b, s, h, kv,
                                                     hd, kind, window)
    t = time_kernel(torch, calls["kernel"](fa.LIBRARY), calls["plain"],
                    calls["library"], n_flops, n_bytes, PEAK_BF16_S)
    t["shape"] = shape
    return t


def time_flash_grad(torch, gen, b, s, h, kv, hd) -> dict:
    """Causal bf16 flash forward + backward at the training shape against
    the plain version's and SDPA's forward + backward, and the backward
    alone against the same three; bounds: every input read and output
    written once, 4 hd H (forward) and 8 hd H (backward) flops per live
    pair."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    q, k, v = attention_inputs(torch, gen, b, s, s, h, kv, hd, torch.bfloat16)
    dout = torch.randn(b, s, h, hd, generator=gen, device="cuda").to(torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    heads = [to_heads(torch, k, h // kv), to_heads(torch, v, h // kv),
             q.transpose(1, 2).contiguous()]
    sdpa_leaves = [t.detach().requires_grad_(True) for t in heads]
    dout_h = dout.transpose(1, 2).contiguous()

    def kernel():
        out = ops.flash_attention(*leaves, kind="causal")
        return torch.autograd.grad(out, leaves, dout)

    def plain():
        out = ref.flash_attention_ref(*leaves, kind="causal")
        return torch.autograd.grad(out, leaves, dout)

    def library():
        kt, vt, qt = sdpa_leaves
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(out, sdpa_leaves, dout_h)

    pairs = fa.live_pairs(b, s, s, "causal")
    tensor_bytes = (4 * q.numel() + 4 * k.numel()) * 2
    t = time_kernel(torch, kernel, plain, library, 12 * h * hd * pairs,
                    tensor_bytes, PEAK_BF16_S)
    t["shape"] = f"B{b} S{s} H{h}/{kv} hd{hd} bf16 causal, forward + backward"
    t["backward"] = time_flash_bwd(torch, gen, b, s, h, kv, hd)
    return t


# the backward alone is also timed at gemma3-1b's "l" layers: hd 256, one
# kv head for 4 query heads, window 1,024, over 1,100 positions (one batch
# row and one kv head: the fewest blocks a pass gets, so the cluster split)
FLASH_BWD_LOCAL = (1, 1100, 4, 1, 256, "local", 1024)


def flash_grad_phase(torch) -> dict:
    """Phase 12 (a): the flash backward at every listed shape, then timed
    at the training shape and at gemma3's local one."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    log("[12] (a) flash backward vs autograd through the plain version")
    errs = [check_flash_grad(torch, gen, c) for c in FLASH_GRAD_CASES]
    t = time_flash_grad(torch, gen, 4, 512, 16, 8, 128)
    log_timed("flash fwd+bwd", t)
    log_timed("flash bwd", t["backward"])
    t["local_backward"] = time_flash_bwd(torch, gen, *FLASH_BWD_LOCAL)
    log_timed("flash bwd", t["local_backward"])
    return {"max_err": max(errs), "timed": t}


# lr 3e-4 (make_train_step's default): at the launcher's 1e-3 (the
# reference's default) the loss fell for 6 steps, then rose past its start
# (12.134 -> 12.053 -> 12.186, measured on one H100)
# (b): 8 steps, whose checkpoint at step 5 a second run resumes from (12
# steps and a resume at 6 before phase 17 was added: the three runs took
# 86.6 s of the smoke; until phase 20 was added a third run, stopped at
# step 4, wrote the checkpoint the resumed run started from)
TRAIN_STEPS, TRAIN_RESUME_AT = 8, 5
TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "512",
              "--steps", str(TRAIN_STEPS), "--ckpt-every",
              str(TRAIN_RESUME_AT), "--lr", "3e-4"]
TRAIN_PROFILE_STEPS = 3
# per step at qwen3-0.6b's 28 "g" layers in 2 microbatches with remat: a
# flash forward per layer and microbatch, the same again when the backward
# recomputes each unit, and one backward
TRAIN_FLASH_FWD, TRAIN_FLASH_BWD = 2 * 28 * 2, 2 * 28
LM_STEPS = 100                           # (d): the train_lm twin
LOSS_RTOL = 1e-5                         # (c): card vs CPU in float32
MOMENT2_TOL = 2e-4    # (c): (1 - b2) g^2 doubles the gradients' 1e-4
# (c)'s float32 stacks at full width, 4 layers: gemma3-1b's unit cut to (l,
# g) and its window to 64 so that (c)'s 128 tokens reach past it (its
# 1,024 at a 262,144-word vocabulary is minutes of CPU); moonshot at the
# no-drop capacity factor, so the card's and the CPU's routes keep the
# same tokens
CARD_CPU_SEQ = 128


def max_tree_diff(torch, a, b) -> float:
    from repro_torch import _tree
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_tree.leaves(a), _tree.leaves(b)))


@contextlib.contextmanager
def train_depth(layers: int):
    """``launch.train`` builds its configs at ``layers`` layers while the
    block runs (its CLI has no depth flag, as the reference's has none)."""
    from repro_torch.launch import train
    full = train.get_config
    train.get_config = lambda name: dataclasses.replace(full(name),
                                                        n_layers=layers)
    try:
        yield
    finally:
        train.get_config = full


def train_card_vs_cpu(torch, label, cfg, full_step: bool,
                      part: str = "c") -> dict:
    """One float32 training step of ``cfg`` on the card and on the CPU from
    the same parameters (drawn on the card) and batch: the loss within
    LOSS_RTOL, each gradient leaf within 1e-4 of its max |g|; with
    ``full_step`` the whole ``make_train_step`` step: Adam's first moments
    within 1e-4 of each leaf's max, its second moments within
    MOMENT2_TOL, and the loss on the next batch within LOSS_RTOL.
    ``part`` names the phase's part in the log."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import for_arch
    from repro_torch.models import steps, transformer
    params = transformer.init_params(SEED_KINDS, cfg, "cuda")
    cpu_params = _tree.to_device(params, "cpu")
    stream = for_arch(cfg, batch=2, seq=CARD_CPU_SEQ, seed=3)
    out = {}
    t0 = time.perf_counter()
    (loss, _), grads = steps.value_and_grad(
        params, cfg, _tree.to_device(stream.get_batch(0), "cuda"))
    torch.cuda.synchronize()
    out["card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (cpu_loss, _), cpu_grads = steps.value_and_grad(
        cpu_params, cfg, stream.get_batch(0))
    out["cpu_s"] = time.perf_counter() - t0
    rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    worst = 0.0
    for g, w in zip(_tree.leaves(grads), _tree.leaves(cpu_grads)):
        scale = float(w.abs().max())
        err = float((g.cpu() - w).abs().max())
        if err > 1e-4 * scale:
            fail(f"({part}) {label}: a gradient leaf {tuple(w.shape)} off by "
                 f"{err:.3e}, above 1e-4 of its max {scale:.3e}")
        worst = max(worst, err / max(scale, 1e-30))
    if rel > LOSS_RTOL:
        fail(f"({part}) {label}: card loss {float(loss):.7f} vs CPU "
             f"{float(cpu_loss):.7f} ({rel:.2e} relative)")
    del grads, cpu_grads
    out.update(loss=float(loss), loss_rel=rel, grad_rel=worst)
    if full_step:
        # a first Adam step moves each entry by lr * g / |g| (+ decay): an
        # entry whose gradient is near 0 may move either way on the two
        # devices, so the parameters are not held; the moments, (1 - b1) g
        # and (1 - b2) g^2, are, and the step by the loss its parameters
        # give on the next batch (LOSS_RTOL)
        opt_init, step = steps.make_train_step(cfg, lr=1e-3)
        new, opt, _ = step(params, opt_init(params),
                           _tree.to_device(stream.get_batch(0), "cuda"))
        cpu_new, cpu_opt, _ = step(cpu_params, opt_init(cpu_params),
                                   stream.get_batch(0))
        for name, tol, tree, cpu_tree in (
                ("first", 1e-4, opt.mu, cpu_opt.mu),
                ("second", MOMENT2_TOL, opt.nu, cpu_opt.nu)):
            rel = 0.0
            for a, w in zip(_tree.leaves(tree), _tree.leaves(cpu_tree)):
                scale = float(w.abs().max())
                err = float((a.cpu() - w).abs().max())
                if err > tol * scale:
                    fail(f"({part}) {label}: a {name} moment leaf "
                         f"{tuple(w.shape)} off by {err:.3e}, above {tol} "
                         f"of its max {scale:.3e}")
                rel = max(rel, err / max(scale, 1e-30))
            out[f"moment{name[0]}_rel"] = rel
        after = float(steps.loss_fn(new, cfg, _tree.to_device(
            stream.get_batch(1), "cuda"))[0])
        cpu_after = float(steps.loss_fn(cpu_new, cfg, stream.get_batch(1))[0])
        out["loss_after_rel"] = abs(after - cpu_after) / abs(cpu_after)
        if out["loss_after_rel"] > LOSS_RTOL:
            fail(f"({part}) {label}: after a step the next batch's loss "
                 f"differs by {out['loss_after_rel']:.2e} relative")
    step_note = (f"; after a step moments within {out['momentf_rel']:.2e} "
                 f"and {out['moments_rel']:.2e} of their max, next loss "
                 f"{out['loss_after_rel']:.2e} relative"
                 if full_step else "")
    log(f"    ({part}) {label}: loss {out['loss']:.6f}, {rel:.2e} relative; "
        f"worst gradient leaf {worst:.2e} of its max{step_note} (card "
        f"{out['card_s']:.1f} s, CPU {out['cpu_s']:.1f} s)")
    return out


def train_run(torch, args: list, smi: str, launches: dict,
              depth: int | None = None):
    """``launch.train.main(args)`` (at ``depth`` layers where given) with
    every kernel's launches held to ``launches`` (0 for the others), a
    finite loss that falls (the last 3 steps' sum below the first 3's), and
    its numbers: step p50 (step 0, which warms up, left out), tokens/s,
    MFU (``roofline.step_flops``' model flops over the p50 and the dense
    bf16 peak) and peak memory.  Returns (the run's result, the numbers)."""
    from types import SimpleNamespace

    from repro_torch.launch import train
    from repro_torch.profiling import roofline
    zero_all_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with train_depth(depth) if depth else contextlib.nullcontext():
        run = train.main(args)
    run_s = time.perf_counter() - t0
    got = {**read_counts(), "partition_sweep": sweep_launches()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: launches.get(k, 0) for k in got}
    if got != want:
        fail(f"{run['arch']}: launches {got}, expected {want}")
    losses = [run["losses"][k] for k in sorted(run["losses"])]
    if not all(map(lambda x: x == x and abs(x) < 1e30, losses)):
        fail(f"{run['arch']}: non-finite loss: {losses}")
    if not sum(losses[-3:]) < sum(losses[:3]):
        fail(f"{run['arch']}: the loss did not fall: {losses}")
    cfg = run["cfg"]
    a = train.parse_args(args)
    step_s = run["step_s"][1:]
    p50 = sorted(step_s)[len(step_s) // 2]
    model_flops = roofline.step_flops(
        cfg, SimpleNamespace(batch=a.batch, seq=a.seq), "train")["model"]
    stats = {
        "args": args, "layers": cfg.n_layers, "losses": losses,
        "launches": got, "microbatches": run["microbatches"], "run_s": run_s,
        "step_p50_ms": p50 * 1e3, "step_min_ms": min(step_s) * 1e3,
        "step_max_ms": max(step_s) * 1e3,
        "tokens_per_s": a.batch * a.seq / p50,
        "model_tflop_per_step": model_flops / 1e12,
        "mfu": model_flops / p50 / roofline.PEAK_FLOPS,
        "peak_memory_gb": peak_gb, "stragglers": run["stragglers"],
        "nvidia_smi": smi}
    log(f"    {cfg.name} at {cfg.n_layers} layers: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps, {run['microbatches']} "
        f"microbatches; launches {got}")
    log(f"    step p50 {p50 * 1e3:.1f} ms (min {min(step_s) * 1e3:.1f}, max "
        f"{max(step_s) * 1e3:.1f}), {a.batch * a.seq / p50:,.0f} tokens/s, "
        f"MFU {stats['mfu']:.4f} ({model_flops / 1e12:.2f} TFLOP of model "
        f"flops a step over {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s), peak "
        f"memory {peak_gb:.2f} GB ({smi})")
    return run, stats


def train_profile(torch, args: list, depth: int | None = None) -> dict:
    """A profile of TRAIN_PROFILE_STEPS steps of ``launch.train``'s step
    (at ``depth`` layers where given), after one step that warms up."""
    from repro_torch.launch import train
    with train_depth(depth) if depth else contextlib.nullcontext():
        run = train.setup(train.parse_args(args))
    state = [run["params"], run["opt"]]

    def one(step):
        state[0], state[1], _ = run["train_step"](
            state[0], state[1], run["stream"].get_batch(step))

    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof = window(torch, lambda: [one(i) for i in range(
        1, 1 + TRAIN_PROFILE_STEPS)], TRAIN_PROFILE_STEPS)
    prof["profile_s"] = time.perf_counter() - t0
    del run, state
    log(f"    profile of {TRAIN_PROFILE_STEPS} steps ("
        f"{prof['profile_s']:.1f} s): {prof['wall_ms']:.1f} "
        f"ms wall, {prof['device_ms']:.1f} ms device a step, device busy "
        f"{prof['device_busy_share']:.3f}, {prof['device_ops']:.0f} device "
        f"ops a step")
    for row in prof["top"]:
        log(f"      {row['device_ms']:9.3f} ms  x{row['count']:<6d} "
            f"{row['name']}")
    return prof


def training_phase(torch, smi: str) -> dict:
    """Phase 12: the flash backward (a), then LM training on the card: (b)
    ``launch.train`` at full width, resumed from its own checkpoint,
    profiled; (c) float32 steps card against CPU; (d) the ``train_lm``
    twin."""
    import shutil

    from repro_torch import train_lm
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    t_part = time.perf_counter()
    out = {"flash_grad": flash_grad_phase(torch), "part_s": {}}

    def part_done(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        log(f"    ({name}) took {now - t_part:.1f} s")
        t_part = now

    part_done("a")

    # (b) full width: uninterrupted, writing a checkpoint at
    # TRAIN_RESUME_AT, then resumed from it
    log(f"[12] (b) python -m repro_torch.launch.train {' '.join(TRAIN_ARGS)}")
    ckpt = ROOT / "build" / "phase12_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    part = ["--ckpt-dir", str(ckpt)]
    whole, train_out = train_run(torch, TRAIN_ARGS + part, smi, {
        "flash_attention": TRAIN_FLASH_FWD * TRAIN_STEPS,
        "flash_attention_backward": TRAIN_FLASH_BWD * TRAIN_STEPS})
    # the resumed run writes no checkpoint of its own: 6 GB less to disk
    resumed = train.main([*TRAIN_ARGS, "--ckpt-every", str(TRAIN_STEPS + 1),
                          *part])
    shutil.rmtree(ckpt, ignore_errors=True)
    if resumed["start"] != TRAIN_RESUME_AT:
        fail(f"(b) the resumed run started at {resumed['start']}")
    resume_diff = max(max_tree_diff(torch, resumed["params"], whole["params"]),
                      max_tree_diff(torch, resumed["opt"], whole["opt"]))
    if resume_diff != 0.0:
        fail(f"(b) the resumed run's parameters or moments differ from the "
             f"uninterrupted run's by {resume_diff:.3e}")
    out["train"] = train_out
    train_out["resume_max_diff"] = resume_diff
    del whole, resumed
    log(f"    resumed from the uninterrupted run's checkpoint at step "
        f"{TRAIN_RESUME_AT}: == uninterrupted, bit for bit")
    train_out["profile"] = train_profile(torch, TRAIN_ARGS)

    part_done("b")

    # (c) float32, card against CPU
    log("[12] (c) float32 training steps, card vs CPU (4 layers, full width)")
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               opt_state_dtype="float32")
    qwen = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=4, **f32)
    gemma = dataclasses.replace(get_config("gemma3-1b"), n_layers=4,
                                block_pattern=("l", "g"), tail_pattern=(),
                                window=64, **f32)
    moon = no_drop(dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                                       n_layers=4, **f32))
    out["card_vs_cpu"] = {
        "qwen3": train_card_vs_cpu(torch, "qwen3-0.6b", qwen, True),
        "gemma3": train_card_vs_cpu(torch, "gemma3-1b (l, g)", gemma, False),
        "moonshot": train_card_vs_cpu(torch, "moonshot-v1-16b-a3b", moon,
                                      False)}

    part_done("c")

    # (d) the train_lm twin
    log(f"[12] (d) python -m repro_torch.train_lm --steps {LM_STEPS}")
    lm_dir = ROOT / "build" / "phase12_lm_ckpt"
    shutil.rmtree(lm_dir, ignore_errors=True)
    t0 = time.perf_counter()
    lm = train_lm.main(["--steps", str(LM_STEPS), "--ckpt-dir", str(lm_dir)])
    lm_s = time.perf_counter() - t0
    shutil.rmtree(lm_dir, ignore_errors=True)
    lm_losses = [lm["losses"][s] for s in range(LM_STEPS)]
    first10, last10 = sum(lm_losses[:10]) / 10, sum(lm_losses[-10:]) / 10
    if not (all(x == x for x in lm_losses) and last10 < first10):
        fail(f"(d) the twin's loss did not fall: first 10 mean {first10:.4f}, "
             f"last 10 {last10:.4f}")
    out["train_lm"] = {"first10": first10, "last10": last10, "run_s": lm_s}
    log(f"    loss mean over steps 0-9 {first10:.4f} -> over steps 90-99 "
        f"{last10:.4f} (ln 512 = 6.2383), {lm_s:.1f} s")
    part_done("d")
    return out


# -- phase 13: the cells mesh --------------------------------------------------

MESH_POLICIES = ("oracle", "random")
MESH_RANKS, MESH_PAD = 3, 2           # (b): 4,096 cells padded to 4,098: 1,366 a rank
MESH_SWEEP_ARGS = ["--steps", "4", "--episodes", "1"]
MESH_SWEEP_ORACLE_SLOTS = 3 * 4       # (a): Fig. 4's, the 16-cell grid's, the sharded leg's
MESH_TC_RANKS = 2                     # (c)
MESH_RTOL, MESH_ATOL = 1e-5, 1e-7     # the reference's sharded == unsharded contract
MESH_DEADLINE_S = 180.0               # a spawned world still running then is ended
MESH_BUDGET_S = 90.0                  # the phase's share of the smoke's time limit


def rollout_on_host(states, res, summary) -> dict:
    """A rollout's tensors on the host, by name (the generator dropped)."""
    out = {"states.t": states.t, "states.gain": states.gain,
           "states.lam": states.lam, "states.q_energy": states.queues.energy,
           "states.q_memory": states.queues.memory}
    out.update({f"results.{k}": v for k, v in res._asdict().items()})
    out.update({f"summary.{k}": v for k, v in summary.items()})
    return {k: v.detach().cpu() for k, v in out.items()}


def mesh_mismatch(torch, got: dict, want: dict) -> str | None:
    """Where ``got`` parts from ``want``: cuts and integers must be equal,
    floats within MESH_RTOL / MESH_ATOL; None where they agree."""
    if set(got) != set(want):
        return f"leaves {sorted(set(got) ^ set(want))}"
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            return f"{name}: {g.dtype} {tuple(g.shape)} for {w.dtype} {tuple(w.shape)}"
        if not w.is_floating_point():
            if not torch.equal(g, w):
                return f"{name}: {int((g != w).sum())} entries differ"
        elif not torch.allclose(g, w, rtol=MESH_RTOL, atol=MESH_ATOL):
            return f"{name}: worst |diff| {float((g - w).abs().max()):.3e}"
    return None


def mesh_grid_rank(slots: int, pad_to: int) -> dict:
    """A rank of phase 13 (b): phase 3's grid sharded over the world's cells
    mesh and rolled out under each of MESH_POLICIES for ``slots`` slots from
    seed 0, the sweep's launches counted and the cells of each recorded;
    then one gather of the results' slot stack timed alone."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import gridshard, scenarios
    from repro_torch.kernels import ops
    from repro_torch.kernels import partition_sweep as ps
    from repro_torch.launch.mesh import make_cells_mesh

    t0 = time.perf_counter()
    grid = scenarios.ScenarioGrid(
        scenarios.multicell_grid(cells=GRID_CELLS, ues=GRID_UES))
    grid.use_mesh(make_cells_mesh(), pad_to=pad_to)
    out = {"rank": dist.get_rank(), "device": torch.cuda.current_device(),
           "b_local": grid.b_local, "build_s": time.perf_counter() - t0}
    cells, plain = [], ops.partition_sweep_batched

    def recorded(macs, *args):
        cells.append(macs.shape[0])
        return plain(macs, *args)

    ops.partition_sweep_batched = recorded
    try:
        for policy in MESH_POLICIES:
            cells.clear()
            ps.partition_sweep_cuda.launches = 0
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, res, summary = grid.make_rollout(policy, slots)(0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            out[policy] = {"slot_ms": dt / slots * 1e3,
                           "launches": ps.partition_sweep_cuda.launches,
                           "cells": list(cells),
                           "rollout": rollout_on_host(states, res, summary)}
    finally:
        ops.partition_sweep_batched = plain
    mine = gridshard.local(res, grid.gridshard, lead=1)
    gather_ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gridshard.gather(mine, grid.gridshard, lead=1)
        torch.cuda.synchronize()
        gather_ms.append((time.perf_counter() - t0) * 1e3)
    out["gather_ms"] = gather_ms
    return out


def mesh_train_compare_rank(argv: list) -> dict:
    """A rank of phase 13 (c): ``train_compare.main(argv)``, the sweep's
    launches counted."""
    from repro_torch import train_compare
    from repro_torch.kernels import partition_sweep as ps
    ps.partition_sweep_cuda.launches = 0
    art = train_compare.main(argv)
    return {"fig4": art["fig4"], "launches": ps.partition_sweep_cuda.launches}


def fig4_drift(got: dict, want: dict) -> float:
    """Worst relative difference over two Fig. 4 artifacts' numbers; inf
    where their keys differ."""
    worst = 0.0
    for rate, algs in want.items():
        for alg, metrics in algs.items():
            for name, w in metrics.items():
                try:
                    g = got[rate][alg][name]
                except KeyError:
                    return float("inf")
                if abs(g - w) > MESH_ATOL + MESH_RTOL * abs(w):
                    worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
    return worst


def mesh_phase(torch, held: dict, phase3: dict, tc: dict) -> dict:
    """Phase 13: the cells mesh.  (a) ``scenario_sweep.main`` on a one-rank
    NCCL mesh; (b) MESH_RANKS processes on the one card over gloo, phase 3's
    grid padded by MESH_PAD, held to phase 3's unsharded results (``held``)
    under the Oracle and Random; (c) ``train_compare`` on a two-rank world,
    its Fig. 4 held to phase 10 (f)'s one-rank run (``tc``)."""
    import torch.distributed as dist
    from repro_torch import scenario_sweep
    from repro_torch.launch.mesh import init_group, run_world

    t_phase = time.perf_counter()
    out: dict = {}

    def part_done(tag: str, t0: float) -> None:
        out[f"{tag}_s"] = time.perf_counter() - t0
        log(f"    ({tag}) took {out[tag + '_s']:.1f} s")

    # (a) the twin of examples/scenario_sweep.py on a one-rank NCCL mesh
    log("[13] (a) python -m repro_torch.scenario_sweep "
        + " ".join(MESH_SWEEP_ARGS) + " on a one-rank NCCL cells mesh")
    t0 = time.perf_counter()
    init_group("nccl", "cuda")
    try:
        zero_all_counts()
        swept = scenario_sweep.main(MESH_SWEEP_ARGS)
        torch.cuda.synchronize()
        launched_a = sweep_launches()
    finally:
        dist.destroy_process_group()
    numbers = swept["grid16"] + swept["sharded"] + sum(swept["fig4"].values(), [])
    if not all(x == x and 0 < x < float("inf") for x in numbers):
        fail("(a) scenario_sweep gave a delay that is not finite and positive")
    if swept["pad"] != 0 or swept["drift"] > MESH_RTOL * max(swept["grid16"]):
        fail(f"(a) the sharded leg drifted {swept['drift']:.3e} (pad "
             f"{swept['pad']})")
    if launched_a != MESH_SWEEP_ORACLE_SLOTS:
        fail(f"(a) {launched_a} partition_sweep launches, expected one per "
             f"Oracle slot ({MESH_SWEEP_ORACLE_SLOTS})")
    out["sweep"] = {"drift": swept["drift"], "launches": launched_a}
    log(f"    drift {swept['drift']:.2e}, {launched_a} sweep launches")
    part_done("a", t0)

    # (b) phase 3's grid over MESH_RANKS processes on one card (gloo: NCCL
    # takes one rank a device)
    b_padded = GRID_CELLS + MESH_PAD
    b_local = b_padded // MESH_RANKS
    log(f"[13] (b) {GRID_CELLS}x{GRID_UES} grid padded to {b_padded} over "
        f"{MESH_RANKS} ranks on one card (gloo), {MAIN_SLOTS} slots of "
        + " and ".join(MESH_POLICIES) + ", against phase 3")
    t0 = time.perf_counter()
    ranks = run_world(mesh_grid_rank, MESH_RANKS,
                      args=(MAIN_SLOTS, b_padded), backend="gloo",
                      device="cuda:0", deadline_s=MESH_DEADLINE_S)
    launched_b = 0
    for r in ranks:
        if r["b_local"] != b_local or r["device"] != 0:
            fail(f"(b) rank {r['rank']} held {r['b_local']} cells on cuda:"
                 f"{r['device']}, expected {b_local} on cuda:0")
        for policy in MESH_POLICIES:
            got = r[policy]
            want = MAIN_SLOTS if policy == "oracle" else 0
            if got["launches"] != want or got["cells"] != [b_local] * want:
                fail(f"(b) rank {r['rank']} {policy}: {got['launches']} "
                     f"sweep launches over cells {got['cells']}, expected "
                     f"{want} over {b_local} each")
            launched_b += got["launches"]
            bad = mesh_mismatch(torch, got["rollout"], held[policy])
            if bad:
                fail(f"(b) rank {r['rank']} {policy} parts from phase 3: {bad}")
        log(f"    rank {r['rank']}: grid built in {r['build_s']:.1f} s; "
            + "; ".join(f"{p} {r[p]['slot_ms']:.1f} ms/slot (phase 3 "
                        f"{phase3[p]['slot_ms']:.1f})" for p in MESH_POLICIES)
            + "; gather of the results' slot stack "
            + ", ".join(f"{x:.1f}" for x in r["gather_ms"]) + " ms")
    log(f"    every rank equals phase 3 (cuts identical, rtol {MESH_RTOL:g}, "
        f"atol {MESH_ATOL:g}); one sweep launch a rank per Oracle slot over "
        f"{b_local} cells")
    out["grid"] = [{"rank": r["rank"], "build_s": r["build_s"],
                    "gather_ms": r["gather_ms"],
                    **{f"{p}_slot_ms": r[p]["slot_ms"] for p in MESH_POLICIES}}
                   for r in ranks]
    out["phase3_slot_ms"] = {p: phase3[p]["slot_ms"] for p in MESH_POLICIES}
    part_done("b", t0)

    # (c) train_compare on a two-rank world against phase 10 (f)'s one rank
    log(f"[13] (c) python -m repro_torch.train_compare {' '.join(TC_ARGS)} "
        f"on {MESH_TC_RANKS} ranks on one card (gloo), against phase 10 (f)")
    t0 = time.perf_counter()
    art = ROOT / "build" / "phase13_paper_artifacts.json"
    ranks = run_world(mesh_train_compare_rank, MESH_TC_RANKS,
                      args=(TC_ARGS + ["--out", str(art)],), backend="gloo",
                      device="cuda:0", deadline_s=MESH_DEADLINE_S)
    launched_c = 0
    for r in ranks:
        drift = fig4_drift(r["fig4"], tc["fig4"])
        if drift:
            fail(f"(c) a rank's Fig. 4 parts from the one-rank run's "
                 f"(worst relative difference {drift:.3e})")
        if r["launches"] != TC_STEPS:
            fail(f"(c) {r['launches']} sweep launches on a rank, expected "
                 f"one per Oracle slot ({TC_STEPS})")
        launched_c += r["launches"]
    log(f"    Fig. 4 on every rank equals the one-rank run's (rtol "
        f"{MESH_RTOL:g}); {launched_c} sweep launches")
    part_done("c", t0)

    out["sweep_launches"] = launched_a + launched_b + launched_c
    out["s"] = time.perf_counter() - t_phase
    log(f"    phase 13: {out['s']:.1f} s of its {MESH_BUDGET_S:.0f} s budget"
        + ("" if out["s"] <= MESH_BUDGET_S else " (OVER)"))
    return out


# -- phase 14: the model axis --------------------------------------------------

TP_RANKS = 2                          # one card: gloo, host copies (NCCL takes one rank a device)
# (a): phase 6's burst cut to its first 4 requests (8 before phase 17:
# the burst took 35.6 s of the phase on a slow host; a prefix of the same
# draws, so its kernel shapes are a subset of those held)
TP_REQUESTS = 4
TP_SLOTS, TP_S_MAX = 8, 512           # (a): serve_partitioned's engine
TP_PROFILE_TICKS = 3
TP_F32_LAYERS = 4                     # (b)
TP_F32_ENGINE = dict(slots=3, s_max=128, kv_blocks=8)    # a pool that preempts
TP_F32_REQUESTS = (8, 5, 64, 8, 3)    # make_requests' n, lo, hi, max_new, seed
TP_F32_SEED = 7
TP_DEADLINE_S = 300.0                 # a spawned world still running then is ended
TP_BUDGET_S = 90.0                    # the phase's share of the smoke's time limit
COLLECTIVES = ("model_all_reduce", "model_all_gather")


def tp_f32_configs() -> list:
    """(b)'s float32 stacks at TP_F32_LAYERS layers and full width: qwen3
    (g), recurrentgemma as (r, r, l, r) (one unit and a one-layer tail),
    mamba2 (s) and moonshot (m, at the no-drop capacity factor)."""
    from repro_torch import serve_partitioned as sp
    from repro_torch.configs.base import get_config
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    return [
        ("qwen3-0.6b", sp.model_config(layers=TP_F32_LAYERS,
                                       dtype="float32")),
        ("recurrentgemma-2b", dataclasses.replace(
            get_config("recurrentgemma-2b"), n_layers=TP_F32_LAYERS,
            tail_pattern=("r",), **f32)),
        ("mamba2-1.3b", sp.model_config("mamba2-1.3b", TP_F32_LAYERS,
                                        "float32")),
        ("moonshot-v1-16b-a3b", no_drop(sp.model_config(
            "moonshot-v1-16b-a3b", TP_F32_LAYERS, "float32")))]


def tp_engine_tokens(cfg, mesh=None, device="cuda") -> dict:
    """(b)'s float32 engine run: TP_F32_ENGINE (a pool sized to preempt,
    chunked prefill but for MoE stacks) on TP_F32_REQUESTS, the weights
    from TP_F32_SEED; each request's tokens and the engine's counters."""
    from repro_torch import serve_partitioned as sp
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    params = transformer.init_params(TP_F32_SEED, cfg, device)
    eng = ServingEngine(cfg, params, mesh=mesh, **TP_F32_ENGINE)
    del params
    reqs = sp.make_requests(cfg, *TP_F32_REQUESTS)
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    return {"out": [list(r.out) for r in reqs],
            "preemptions": eng.preemptions,
            "prefill_steps": eng.prefill_steps,
            "chunk_steps": eng.chunk_steps}


def tp_prefill_batch(torch, cfg, device="cuda"):
    """card_vs_cpu's ragged batch: 2 x 64 tokens, a left pad of 20."""
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    return toks.to(device), torch.tensor([0, 20], dtype=torch.int32,
                                         device=device)


def tp_profile(torch, eng, ticks: int) -> dict:
    """``ticks`` decode ticks of ``eng`` under torch.profiler: wall and
    device time a tick, and the host time inside the model axis's
    collectives (the D2H copy, which waits for the work queued before it,
    gloo, and the H2D copy), from their ``record_function`` spans."""
    from torch.profiler import ProfilerActivity, profile
    eng.step()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.step()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        rows = prof.key_averages()
        # the spans' GPU-side annotations (device rows of the same names)
        # are ranges, not kernels
        device = [e for e in rows
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.key not in COLLECTIVES and e.device_time_total > 0]
        device_us = sum(e.device_time_total for e in device)
        if device_us > 0:
            break
    else:
        fail(f"the profiler recorded no device time in {PROFILE_TRIES} tries")
    coll = {e.key: (e.count, e.cpu_time_total) for e in rows
            if e.key in COLLECTIVES
            and e.device_type == torch.autograd.DeviceType.CPU}
    coll_us = sum(us for _, us in coll.values())
    return {"ticks": ticks, "wall_ms_per_tick": wall_s * 1e3 / ticks,
            "device_ms_per_tick": device_us / 1e3 / ticks,
            "device_busy_share": device_us / 1e6 / wall_s,
            "device_ops_per_tick": sum(e.count for e in device) / ticks,
            "collective_calls_per_tick": {k: c / ticks
                                          for k, (c, _) in coll.items()},
            "collective_ms_per_tick": coll_us / 1e3 / ticks,
            "collective_share": coll_us / 1e6 / wall_s,
            "top": [{"name": e.key[:80], "count": e.count,
                     "device_ms": e.device_time_total / 1e3}
                    for e in sorted(device,
                                    key=lambda e: -e.device_time_total)[:6]]}


def gloo_all_reduce_ms(torch, mesh, rows: int, cfg, calls: int = 50):
    """Host ms of one gloo all-reduce over the "model" sub-group of a
    decode tick's (rows, d_model) bf16 activations, already on the host:
    what a collective costs without the device copies around it."""
    import torch.distributed as dist
    group = mesh.get_group("model")
    x = torch.zeros(rows, cfg.d_model, dtype=torch.bfloat16)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(calls):
        dist.all_reduce(x, group=group)
    return (time.perf_counter() - t0) * 1e3 / calls


def tp_rank(go_file: str) -> dict:
    """A rank of phase 14, on a ``make_cells_mesh(model=TP_RANKS)`` mesh:
    (a) qwen3-0.6b at full width and depth in bf16 through
    ``PartitionedLM(cfg, params, 0, mesh=).es_engine()`` on phase 6's burst
    cut to TP_REQUESTS requests, the kernels' launches counted, then a
    profile of TP_PROFILE_TICKS decode ticks of 8 slots; (b) each of
    ``tp_f32_configs`` through ``tp_engine_tokens``, then qwen3's bf16
    prefill logits on ``tp_prefill_batch`` at full width.  Every call to
    the kernels is recorded (``recorded_launches``).  The timed burst
    waits for ``go_file``, which the phase writes once its one-rank runs
    are done, so that nothing else shares the card then."""
    import torch
    import torch.distributed as dist
    from repro_torch import serve_partitioned as sp
    from repro_torch.launch.mesh import make_cells_mesh
    from repro_torch.launch.sharding import place_params
    from repro_torch.models import transformer
    from repro_torch.serving.partitioned import PartitionedLM
    from repro_torch.shardctx import activation_sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_cells_mesh(model=TP_RANKS)
    seen: set = set()
    out: dict = {"rank": dist.get_rank(), "seen": seen}
    t0 = time.perf_counter()
    cfg = sp.model_config()
    params = transformer.init_params(sp.SEED, cfg, "cuda")
    with recorded_launches(seen):
        plm = PartitionedLM(cfg, params, 0, mesh=mesh)
        eng = plm.es_engine(slots=TP_SLOTS, s_max=TP_S_MAX)
        out["view"] = {k: getattr(plm.cfg, k) for k in (
            "n_heads", "n_kv", "d_ff", "local_vocab", "split")}
        reqs = sp.make_requests(cfg, TP_REQUESTS, sp.PROMPT_MIN, 300, 32,
                                sp.SEED)
        out["setup_s"] = time.perf_counter() - t0
        while not os.path.exists(go_file):
            time.sleep(0.05)
        out["waited_s"] = time.perf_counter() - t0 - out["setup_s"]
        dist.barrier()
        zero_counts()
        out["serving"] = sp.serve(eng, reqs, torch.cuda.synchronize)
        out["launches"] = read_counts()
        t0 = time.perf_counter()
        # every slot decoding (prompts of one solo prefill each)
        for r in sp.make_requests(cfg, TP_SLOTS, sp.PROMPT_MIN, 16, 150, 1):
            eng.submit(r)
        while eng.queue or eng._stream_req is not None:
            eng.step()
        out["profile"] = tp_profile(torch, eng, TP_PROFILE_TICKS)
        out["profile_s"] = time.perf_counter() - t0
        out["gloo_ms"] = gloo_all_reduce_ms(torch, mesh, TP_SLOTS, cfg)
        del eng
        t0 = time.perf_counter()
        zero_counts()
        out["f32"] = {label: tp_engine_tokens(c, mesh)
                      for label, c in tp_f32_configs()}
        out["f32_launches"] = read_counts()
        local, view = place_params(mesh, cfg, params)
        del params, plm
        toks, pad = tp_prefill_batch(torch, cfg)
        with activation_sharding(mesh):
            lg, _ = transformer.prefill(local, view, {"tokens": toks},
                                        s_max=64, pad=pad)
        out["bf16_logits"] = lg.cpu()
        out["f32_s"] = time.perf_counter() - t0
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def tp_one_rank(torch) -> dict:
    """The one-rank card references of phase 14 (b): each float32 stack's
    engine tokens, and qwen3's bf16 and float32 prefill logits at full
    width on the same weights."""
    from repro_torch import _tree
    from repro_torch import serve_partitioned as sp
    from repro_torch.models import transformer

    out = {"f32": {label: tp_engine_tokens(c) for label, c in
                   tp_f32_configs()}}
    cfg = sp.model_config()
    params = transformer.init_params(sp.SEED, cfg, "cuda")
    toks, pad = tp_prefill_batch(torch, cfg)
    lg, _ = transformer.prefill(params, cfg, {"tokens": toks}, s_max=64,
                                pad=pad)
    out["bf16_logits"] = lg.cpu()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    p32 = _tree.map_tensors(
        lambda t: t.float() if t.is_floating_point() else t, params)
    del params
    lg32, _ = transformer.prefill(p32, cfg32, {"tokens": toks}, s_max=64,
                                  pad=pad)
    out["f32_logits"] = lg32.cpu()
    return out


def model_phase(torch, phase6: dict) -> dict:
    """Phase 14: the model axis.  TP_RANKS processes on the one card over
    gloo run ``tp_rank``; their greedy tokens, kernel launches and shapes,
    and bf16 logits are held here to the one-rank card runs
    (``tp_one_rank``) and to phase 5's and phase 7's cases."""
    from repro_torch import serve_partitioned as sp
    from repro_torch.launch.mesh import run_world

    from concurrent.futures import ThreadPoolExecutor

    t_phase = time.perf_counter()
    out: dict = {}
    log(f"[14] the model axis: {TP_RANKS} ranks on one card (gloo), "
        f"make_cells_mesh(model={TP_RANKS}); (a) qwen3-0.6b at full width "
        f"and depth (bf16) through PartitionedLM(mesh=).es_engine(), "
        f"{TP_REQUESTS} requests of phase 6's burst; (b) float32 engine "
        f"tokens at {TP_F32_LAYERS} layers and full width against one rank")
    # the one-rank references run here while the world's ranks start;
    # the ranks' timed burst waits for them (go_file)
    go_file = ROOT / "build" / "phase14_go"
    go_file.parent.mkdir(exist_ok=True)
    go_file.unlink(missing_ok=True)
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, tp_rank, TP_RANKS,
                            args=(str(go_file),), backend="gloo",
                            device="cuda:0", deadline_s=TP_DEADLINE_S)
        try:
            one = tp_one_rank(torch)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["one_rank_s"] = time.perf_counter() - t_phase
        finally:
            go_file.touch()
        ranks = world.result()
    go_file.unlink()
    out["world_s"] = time.perf_counter() - t_phase
    log(f"    one-rank references {out['one_rank_s']:.1f} s, beside the "
        f"{TP_RANKS}-rank world's start; the world {out['world_s']:.1f} s")

    cfg = sp.model_config()
    layers = cfg.n_layers
    view = ranks[0]["view"]
    log(f"    rank view: {view}")
    if view["n_heads"] * TP_RANKS != cfg.n_heads or \
            view["local_vocab"] * TP_RANKS != cfg.vocab:
        fail(f"(a) a rank's view {view} is not 1/{TP_RANKS} of qwen3's")
    # (a) the served burst: the same tokens on every rank, exact launches
    srv = [r["serving"] for r in ranks]
    if any(s["out"] != srv[0]["out"] for s in srv):
        fail("(a) the ranks served different tokens")
    if srv[0]["completed"] != TP_REQUESTS or any(
            len(o) != 32 for o in srv[0]["out"].values()):
        fail(f"(a) served {srv[0]['completed']} of {TP_REQUESTS} requests, "
             f"or a request did not get its 32 tokens")
    launched = {"flash_attention": 0, "decode_attention": 0,
                "ssd_scan": 0, "rglru_scan": 0}
    for r in ranks:
        check_counts(f"(a) rank {r['rank']}", r["launches"], r["serving"],
                     per_prefill={"flash_attention": layers},
                     per_tick={"decode_attention": layers})
        log_serving(f"(a) rank {r['rank']}", r["serving"])
        p = r["profile"]
        log(f"    rank {r['rank']}: set up in {r['setup_s']:.1f} s, waited "
            f"{r['waited_s']:.1f} s for the one-rank runs, burst "
            f"{r['serving']['wall_s']:.1f} s, profile {r['profile_s']:.1f} s, "
            f"(b) {r['f32_s']:.1f} s")
        log(f"    rank {r['rank']} profile of {p['ticks']} decode ticks (8 "
            f"slots): wall {p['wall_ms_per_tick']:.2f} ms/tick, device "
            f"{p['device_ms_per_tick']:.3f} ms/tick (busy "
            f"{p['device_busy_share']:.3f}, "
            f"{p['device_ops_per_tick']:.0f} device ops/tick); host time in "
            f"the collectives {p['collective_ms_per_tick']:.2f} ms/tick = "
            f"{p['collective_share']:.3f} of the tick "
            f"({p['collective_calls_per_tick']} calls a tick); a gloo "
            f"all-reduce of the tick's activations on the host alone "
            f"{r['gloo_ms']:.3f} ms")
        for row in p["top"]:
            log(f"      {row['device_ms']:9.3f} ms  x{row['count']:<6d} "
                f"{row['name']}")
        for k in launched:
            launched[k] += r["launches"].get(k, 0) \
                + r["f32_launches"].get(k, 0)
    one_srv = phase6["serving"]
    log(f"    phase 6 on one rank (16 requests): decode tick p50 "
        f"{one_srv['decode_tick_ms_p50']:.2f} / p99 "
        f"{one_srv['decode_tick_ms_p99']:.2f} ms, prefill tick p50 "
        f"{one_srv['prefill_tick_ms_p50']:.2f} / p99 "
        f"{one_srv['prefill_tick_ms_p99']:.2f} ms, "
        f"{one_srv['tokens_per_s']:.1f} tokens/s")
    out["serving"] = [{k: v for k, v in s.items() if k != "out"}
                      for s in srv]
    out["profile"] = [r["profile"] for r in ranks]
    out["gloo_ms"] = [r["gloo_ms"] for r in ranks]
    out["phase6_serving"] = {k: v for k, v in one_srv.items() if k != "out"}

    # (b) float32 tokens == the one-rank card engine's
    for label, want in one["f32"].items():
        for r in ranks:
            got = r["f32"][label]
            if got["out"] != want["out"]:
                bad = [i for i, (a, b) in enumerate(zip(got["out"],
                                                        want["out"]))
                       if a != b]
                fail(f"(b) {label}: rank {r['rank']}'s float32 tokens part "
                     f"from one rank's on requests {bad}")
            if got["preemptions"] != want["preemptions"]:
                fail(f"(b) {label}: {got['preemptions']} preemptions, one "
                     f"rank {want['preemptions']}")
        log(f"    (b) {label} at {TP_F32_LAYERS} layers, float32: "
            f"{len(want['out'])} requests, tokens identical to one rank's on "
            f"every rank ({want['preemptions']} preemptions, "
            f"{want['prefill_steps']} prefills and chunks)")
        if want["preemptions"] == 0:
            fail(f"(b) {label}: the pool sized to preempt preempted nothing")
    # qwen3's bf16 prefill logits at full width: as far from float32 as one
    # rank's, within BF16_DRIFT
    lg32 = one["f32_logits"]
    d_one = float((one["bf16_logits"] - lg32).abs().max())
    out["bf16"] = {"one_rank_vs_f32": d_one}
    for r in ranks:
        d_tp = float((r["bf16_logits"] - lg32).abs().max())
        drift = d_tp / d_one
        out["bf16"][f"rank{r['rank']}_vs_f32"] = d_tp
        out["bf16"]["drift"] = max(out["bf16"].get("drift", 0.0), drift)
        log(f"    (b) qwen3 bf16 prefill logits, rank {r['rank']}: "
            f"{d_tp:.3e} from float32, one rank {d_one:.3e}: {drift:.3f} of "
            f"it (limit {BF16_DRIFT})")
        if drift > BF16_DRIFT:
            fail(f"(b) the {TP_RANKS}-rank bf16 logits stand further from "
                 f"float32 than {BF16_DRIFT} x one rank's")
    # every per-rank shape must be one phase 5 or phase 7 held
    held = held_shapes()
    seen = set().union(*(r["seen"] for r in ranks))
    missed = sorted(seen - held)
    log(f"    phase 14 launched the kernels at {len(seen)} shapes; "
        f"{len(seen) - len(missed)} held in phases 5 and 7")
    if missed:
        fail(f"phase 14 launched kernels at shapes phases 5 and 7 did not "
             f"hold: {missed}")
    out["launches"] = launched
    out["peak_gb"] = [r["peak_bytes"] / 1e9 for r in ranks]
    out["s"] = time.perf_counter() - t_phase
    log(f"    phase 14: {out['s']:.1f} s of its {TP_BUDGET_S:.0f} s budget"
        + ("" if out["s"] <= TP_BUDGET_S else " (OVER)"))
    return out


# -- phase 15: the model mesh's training half and the grid's model axis --------

GM_RANKS = 2                          # (a): make_cells_mesh(model=2) on one card
GM_SLOTS = 3                          # (a): timed slots a policy
GM_COLS = GRID_UES // GM_RANKS        # (a): a rank's UEs of each cell
TM_RANKS, TM_DATA, TM_MODEL = 4, 2, 2  # (b), (c): one world, (data 2, model 2)
TM_STEPS = 4
TM_ARGS = ["--arch", "qwen3-0.6b", "--batch", "8", "--seq", "512", "--lr",
           "3e-4", "--steps", str(TM_STEPS)]
TM_MICRO = 2                          # launch.train's for qwen3-0.6b
# (b)'s depth, cut from 28 so that the phase keeps within its budget: on
# an H100 80GB HBM3 at 700 W, with the vocabulary-parallel loss, a step
# took 8.0 s at 28 layers (1,176 all-reduces on gloo host copies over 4
# steps, 41 % of the steps' time; the phase 103 s) and 1.6 s at 4
TM_LAYERS = 4
# a rank's launches a step: a flash forward per layer and microbatch, again
# in the remat recompute, and one backward
TM_FLASH_FWD, TM_FLASH_BWD = 2 * TM_LAYERS * TM_MICRO, TM_LAYERS * TM_MICRO
TM_ROWS = 8 // TM_DATA // TM_MICRO    # a microbatch's rows on a rank
TM_F32_LAYERS = 4                     # (c)
# (c)'s moonshot: 1 layer (the one-rank reference beside four ranks'
# float32 training state ran the card out of memory at 2), and 1,024
# tokens a data rank so that each rank's MoE dispatch groups (1,024
# tokens) are the whole batch's
TM_F32_MOON_LAYERS, TM_F32_MOON_SEQ = 1, 1024
TM_F32_SEQ = 128                      # (c)'s qwen3 and gemma3, B2 over data 2
TM_SYNC_MODES = ("bf16", "int8")
TM_DEADLINE_S = 600.0                 # a spawned world still running then is ended
TM_READY_S = 120.0                    # (a) waits at most this for (b)'s ranks
MM_BUDGET_S = 90.0                    # the phase's share of the smoke's time limit
DIST_CALLS = ("all_reduce", "all_gather", "all_to_all_single", "broadcast",
              "barrier", "all_gather_single", "all_gather_into_tensor")


@contextlib.contextmanager
def timed_collectives(spent: dict):
    """Add to ``spent`` the count and host seconds of every
    ``torch.distributed`` collective called while the block runs (gloo
    here: the host copies are outside it)."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in DIST_CALLS if hasattr(dist, n)}

    def wrap(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                calls, s = spent.get(name, (0, 0.0))
                spent[name] = (calls + 1, s + time.perf_counter() - t0)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def gm_rank(slots: int, ready: str) -> dict:
    """A rank of phase 15 (a): phase 3's grid on ``make_cells_mesh(model=
    GM_RANKS)``, each cell's UEs split over "model", rolled out under each
    of MESH_POLICIES for ``slots`` slots from seed 0; the sweep's calls
    (rows, cells and split count) and launches counted, and the model
    axis's collectives a slot timed.  It starts beside (b)'s world,
    builds its grid, and times nothing until that world's TM_RANKS ranks
    are up (a file each under ``ready``; at most TM_READY_S), so that no
    start shares the host with its timed work."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import gridshard, scenarios
    from repro_torch.kernels import ops
    from repro_torch.kernels import partition_sweep as ps
    from repro_torch.launch.mesh import make_cells_mesh

    mesh = make_cells_mesh(model=GM_RANKS)
    t0 = time.perf_counter()
    grid = scenarios.ScenarioGrid(
        scenarios.multicell_grid(cells=GRID_CELLS, ues=GRID_UES))
    grid.use_mesh(mesh)
    gs = grid.ue_sharding
    out = {"rank": dist.get_rank(), "device": torch.cuda.current_device(),
           "cols": None if gs is None else (gs.ue_cols.start, gs.ue_cols.stop),
           "b_local": grid.b_local, "build_s": time.perf_counter() - t0}
    end = time.perf_counter() + TM_READY_S
    while (len(os.listdir(ready)) < TM_RANKS
           and time.perf_counter() < end):
        time.sleep(0.05)
    dist.barrier()
    calls, plain = [], ops.partition_sweep_batched
    whole, spent = gridshard.GridSharding.ue_whole, []

    def recorded(macs, *args):
        calls.append((*macs.shape, args[9] if len(args) > 9 else None))
        return plain(macs, *args)

    def timed(self, xs):
        t1 = time.perf_counter()
        try:
            return whole(self, xs)
        finally:
            spent.append(time.perf_counter() - t1)

    ops.partition_sweep_batched = recorded
    gridshard.GridSharding.ue_whole = timed
    try:
        for policy in MESH_POLICIES:
            calls.clear()
            spent.clear()
            ps.partition_sweep_cuda.launches = 0
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states, res, summary = grid.make_rollout(policy, slots)(0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            out[policy] = {
                "slot_ms": dt / slots * 1e3,
                "launches": ps.partition_sweep_cuda.launches,
                "calls": list(calls),
                "collectives_per_slot": len(spent) / slots,
                "collective_ms_per_slot": sum(spent) * 1e3 / slots,
                "results": {f"results.{k}": v.detach().cpu()
                            for k, v in res._asdict().items()}}
    finally:
        ops.partition_sweep_batched = plain
        gridshard.GridSharding.ue_whole = whole
    return out


def tm_f32_configs() -> list:
    """(c)'s float32 stacks at full width: qwen3 (g) and gemma3-1b as (l, g)
    with window 64 at TM_F32_LAYERS layers and TM_F32_SEQ tokens, moonshot
    (m, at the no-drop capacity factor) at TM_F32_MOON_LAYERS layers and
    TM_F32_MOON_SEQ tokens."""
    from repro_torch.configs.base import get_config
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               opt_state_dtype="float32")
    return [
        ("qwen3-0.6b", dataclasses.replace(
            get_config("qwen3-0.6b"), n_layers=TM_F32_LAYERS, **f32),
         TM_F32_SEQ),
        ("gemma3-1b (l, g)", dataclasses.replace(
            get_config("gemma3-1b"), n_layers=TM_F32_LAYERS,
            block_pattern=("l", "g"), tail_pattern=(), window=64, **f32),
         TM_F32_SEQ),
        ("moonshot-v1-16b-a3b", no_drop(dataclasses.replace(
            get_config("moonshot-v1-16b-a3b"),
            n_layers=TM_F32_MOON_LAYERS, **f32)), TM_F32_MOON_SEQ)]


def tm_f32_case(torch, mesh, cfg, seq: int) -> dict:
    """(c): one float32 step of ``cfg`` from the same weights (drawn on the
    card) and batch (B2), on one rank and on the mesh.  Every rank draws
    the whole weights and keeps its shard; the two ranks of data index 0
    also take the one-rank step with the whole model and keep their shard
    of its moments on the host.  Then every rank takes the mesh's step.  Returns, on
    those two ranks, each moment leaf's worst error over its max (the
    whole leaf's) and the next batch's loss both ways; on every rank a
    digest of its moments, which data ranks must share."""
    import torch.distributed as dist
    from repro_torch import _tree, shardctx
    from repro_torch.data.pipeline import for_arch
    from repro_torch.launch import sharding, train
    from repro_torch.models import steps, transformer

    stream = for_arch(cfg, batch=2, seq=seq, seed=3)
    b0 = _tree.to_device(stream.get_batch(0), "cuda")
    b1 = _tree.to_device(stream.get_batch(1), "cuda")
    out: dict = {}
    ref = None
    t0 = time.perf_counter()
    params = transformer.init_params(SEED_KINDS, cfg, "cuda")
    # the model axis alone, as in PR 24 (moonshot's BASELINE would store
    # ZeRO-3 slices over "data"; phase 16 (b) holds that layout)
    opts = sharding.ShardingOptions(fsdp_override=False)
    local, view = sharding.place_params(mesh, cfg, params, opts)
    if mesh.get_local_rank("data") == 0:
        init, step = steps.make_train_step(cfg, lr=1e-3)
        new, opt, _ = step(params, init(params), b0)
        out["loss_after_one"] = float(steps.loss_fn(new, cfg, b1)[0])
        scale = {k: [float(t.abs().max()) for t in _tree.leaves(tree)]
                 for k, tree in (("mu", opt.mu), ("nu", opt.nu))}
        # on the host: four ranks' float32 training state fills the card
        ref = {k: _tree.to_device(sharding.place_params(mesh, cfg, tree,
                                                        opts)[0], "cpu")
               for k, tree in (("mu", opt.mu), ("nu", opt.nu))}
        del new, opt
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    out["one_s"] = time.perf_counter() - t0
    init, step = train.make_mesh_train_step(mesh, view, lr=1e-3, opts=opts)
    t0 = time.perf_counter()
    new, opt, metrics = step(local, init(local), b0)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with shardctx.activation_sharding(mesh):
        out["loss_after_mesh"] = float(steps.loss_fn(new, view, b1)[0])
    out["loss"] = float(metrics["loss"])
    out["digest"] = [float(t.sum()) for t in
                     _tree.leaves(opt.mu) + _tree.leaves(opt.nu)]
    if ref is not None:          # a leaf at a time, back on the card
        for k in ("mu", "nu"):
            out[f"{k}_rel"] = max(
                float((got.float() - want.to(got.device)).abs().max())
                / max(sc, 1e-30)
                for got, want, sc in zip(_tree.leaves(getattr(opt, k)),
                                         _tree.leaves(ref[k]), scale[k]))
    del new, opt, local, ref
    torch.cuda.empty_cache()
    dist.barrier()
    out["check_s"] = time.perf_counter() - t0
    return out


def tm_grad_sync(torch, mesh) -> dict:
    """(c): ``make_grad_sync`` over the data axis in modes bf16 and int8 on
    card tensors and on the same tensors on the CPU: every output must be
    equal, bit for bit."""
    from repro_torch import _tree
    from repro_torch.runtime import compression
    gen = torch.Generator().manual_seed(100 + mesh.get_local_rank("data"))
    cpu = {"w": torch.randn(512, 1024, generator=gen),
           "b": torch.randn(3000, generator=gen) * 1e-3}
    zeros = _tree.map_tensors(torch.zeros_like, cpu)
    card = _tree.to_device(cpu, "cuda")
    out = {}
    for mode in TM_SYNC_MODES:
        sync = compression.make_grad_sync(mesh, "data", mode)
        c_mean, c_res = sync(card, _tree.to_device(zeros, "cuda"))
        h_mean, h_res = sync(cpu, zeros)
        out[mode] = all(torch.equal(a.cpu(), b) for a, b in zip(
            _tree.leaves(c_mean) + _tree.leaves(c_res),
            _tree.leaves(h_mean) + _tree.leaves(h_res)))
    return out


def tm_rank(go_file: str, ready: str) -> dict:
    """A rank of phase 15 (b) and (c), on ``elastic_mesh(TM_MODEL)`` over
    TM_RANKS ranks: (data TM_DATA, model TM_MODEL).  Up (a file under
    ``ready``), it waits for ``go_file``, which the phase writes when (a)
    is done, so that the two worlds start together and nothing else runs
    beside (b); then (b) ``launch.train.
    main(TM_ARGS, mesh=)``, the kernels' launches counted and their shapes
    recorded, the collectives timed; (c) ``tm_f32_case`` of each
    ``tm_f32_configs`` stack, and ``tm_grad_sync``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.launch.sharding import ShardingOptions

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = elastic_mesh(TM_MODEL)
    out = {"rank": dist.get_rank(),
           "coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")),
           "shape": tuple(mesh.mesh.shape)}
    torch.zeros(1, device="cuda")      # the rank's CUDA context is up
    pathlib.Path(ready, f"tm{out['rank']}").touch()
    t0 = time.perf_counter()
    while not os.path.exists(go_file):
        time.sleep(0.05)
    dist.barrier()
    out["waited_s"] = time.perf_counter() - t0
    seen: set = set()
    spent: dict = {}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorded_launches(seen), timed_collectives(spent), \
            train_depth(TM_LAYERS):
        # the baseline layout (full TP, no ZeRO-3), which phase 16 (a)'s
        # recommended one stands beside
        run = train.main(TM_ARGS, mesh=mesh,
                         opts=ShardingOptions(microbatches=TM_MICRO))
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["losses"] = [run["losses"][s] for s in range(TM_STEPS)]
    out["step_s"] = run["step_s"]
    out["microbatches"] = run["microbatches"]
    out["collectives"] = spent
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["train_seen"] = set(seen)
    del run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with recorded_launches(seen):
        out["f32"] = {label: tm_f32_case(torch, mesh, cfg, seq)
                      for label, cfg, seq in tm_f32_configs()}
    out["sync"] = tm_grad_sync(torch, mesh)
    out["f32_s"] = time.perf_counter() - t0
    out["seen"] = seen
    out["zero"] = tz_rank(torch, mesh)
    out["moe"] = moe_rank(torch, mesh)
    out["seq"] = seq_rank(torch, mesh)
    return out


# -- phase 16: ZeRO-3 training in the rank-local layout, and the dry run -----

TZ_BUDGET_S = 60.0                    # the phase's share of the smoke's limit
TZ_LEDGER_STEP = 1                    # (a): the step whose collectives (c) holds
TZ_ROWS = 8 // TM_DATA                # (a): a rank's rows of each batch
TZ_LOSS_RTOL = 1e-3                   # (a) against phase 15 (b), both bf16
TZ_STEPS = 2                          # (a): step 1 timed (3 before phase 18)
TZ_ARGS = TM_ARGS[:-1] + [str(TZ_STEPS)]
DRY_OUT = ROOT / "build" / "dryrun"
# (c): (a)'s cell on its mesh, then qwen3's cells on the single-pod mesh
DRY_CARD = ["--arch", "qwen3-0.6b", "--shape", "train_4k", "--mesh-shape",
            f"{TM_DATA}x{TM_MODEL}", "--layers", str(TM_LAYERS), "--batch",
            "8", "--seq", "512", "--recommended", "--tag", "card"]
DRY_PROD = ["--arch", "qwen3-0.6b", "--mesh", "single", "--recommended"]
DRY_DEADLINE_S = 600.0


def tree_bytes(tree) -> int:
    from repro_torch import _tree
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))


def tz_f32_case(torch, mesh) -> dict:
    """(b): one float32 step of qwen3 at TM_F32_LAYERS layers (remat) from
    the same weights and batch (B2) on one rank and on the mesh under the
    recommended options; then the mesh's step again with
    ``remat_offload``.  Returns the rank's worst moment errors over each
    leaf's max (its ZeRO-3 slices against its slices of the one-rank
    step's), the next batch's loss both ways, and whether the offloaded
    step equals the other bit for bit."""
    from repro_torch import _tree, shardctx
    from repro_torch.data.pipeline import for_arch
    from repro_torch.launch import sharding, train
    from repro_torch.models import steps, transformer

    cfg = dataclasses.replace(tm_f32_configs()[0][1], remat=True)
    opts = sharding.recommended_options(cfg, "train")
    stream = for_arch(cfg, batch=2, seq=TM_F32_SEQ, seed=3)
    b0 = _tree.to_device(stream.get_batch(0), "cuda")
    b1 = _tree.to_device(stream.get_batch(1), "cuda")
    out: dict = {}
    params = transformer.init_params(SEED_KINDS, cfg, "cuda")
    local, view = sharding.place_params(mesh, cfg, params, opts)
    init, step = steps.make_train_step(cfg, lr=1e-3)
    new, opt, _ = step(params, init(params), b0)
    out["loss_after_one"] = float(steps.loss_fn(new, cfg, b1)[0])
    scale = {k: [float(t.abs().max()) for t in _tree.leaves(tree)]
             for k, tree in (("mu", opt.mu), ("nu", opt.nu))}
    ref = {k: _tree.to_device(sharding.place_params(mesh, cfg, tree,
                                                    opts)[0], "cpu")
           for k, tree in (("mu", opt.mu), ("nu", opt.nu))}
    del params, new, opt
    torch.cuda.empty_cache()
    mine = {}
    for offload in (False, True):
        o = dataclasses.replace(opts, remat_offload=offload)
        init, step = train.make_mesh_train_step(mesh, view, lr=1e-3, opts=o)
        new, opt, metrics = step(local, init(local), b0)
        mine[offload] = _tree.leaves([new, opt.mu, opt.nu])
        if not offload:
            with shardctx.activation_sharding(mesh):
                out["loss_after_mesh"] = float(steps.loss_fn(new, view,
                                                             b1)[0])
            out["loss"] = float(metrics["loss"])
            for k in ("mu", "nu"):
                out[f"{k}_rel"] = max(
                    float((got.float() - want.to(got.device)).abs().max())
                    / max(sc, 1e-30)
                    for got, want, sc in zip(_tree.leaves(getattr(opt, k)),
                                             _tree.leaves(ref[k]), scale[k]))
    out["offload_equal"] = all(torch.equal(a, b)
                               for a, b in zip(mine[False], mine[True]))
    out["zero_leaves"] = len(view.zero)
    out["split"] = view.split
    del mine, local, ref
    torch.cuda.empty_cache()
    return out


def tz_rank(torch, mesh) -> dict:
    """A rank of phase 16, in phase 15's world after its (c): (a)
    ``launch.train.main(TZ_ARGS, mesh=)`` under the recommended options,
    launches counted and shapes recorded, the collectives timed, the
    ledger of step TZ_LEDGER_STEP kept, the bytes the rank holds; (b)
    ``tz_f32_case``."""
    from repro_torch import shardctx
    from repro_torch.launch import train

    t_rank = time.perf_counter()
    out: dict = {}
    seen: set = set()
    spent: dict = {}
    ledgers: list = []
    real = train.make_mesh_train_step

    def keeping_a_ledger(*a, **k):
        init, step = real(*a, **k)
        calls = [0]

        def step_kept(*sa):
            calls[0] += 1
            if calls[0] != TZ_LEDGER_STEP + 1:
                return step(*sa)
            with shardctx.collective_ledger() as ledger:
                got = step(*sa)
            ledgers.append(list(ledger))
            return got
        return init, step_kept

    torch.cuda.empty_cache()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train.make_mesh_train_step = keeping_a_ledger
    try:
        with recorded_launches(seen), timed_collectives(spent), \
                train_depth(TM_LAYERS):
            run = train.main(TZ_ARGS, mesh=mesh)
    finally:
        train.make_mesh_train_step = real
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = read_counts()
    out["losses"] = [run["losses"][s] for s in range(TZ_STEPS)]
    out["step_s"] = run["step_s"]
    out["microbatches"] = run["microbatches"]
    out["collectives"] = spent
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["held_bytes"] = (tree_bytes(run["params"]) + tree_bytes(run["opt"])
                         + 2 * TZ_ROWS * 512 * 4)   # tokens, targets: int32
    # the first batch's loss after the run (its step-0 loss was before it):
    # each step draws a new batch of near-uniform tokens, so the loss a
    # step reports need not fall over 4 steps, but the trained weights fit
    # the batches they saw
    from repro_torch.data.pipeline import for_arch
    from repro_torch.models import steps
    first = for_arch(run["cfg"].whole, batch=8, seq=512,
                     device="cuda").get_batch(0)
    with shardctx.activation_sharding(mesh), torch.no_grad():
        out["first_batch_after"] = float(
            steps.loss_fn(run["params"], run["cfg"], first)[0])
    out["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    out["ledger"] = ledgers[0] if ledgers else []
    out["train_seen"] = set(seen)
    del run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with recorded_launches(seen):
        out["f32"] = tz_f32_case(torch, mesh)
    out["f32_s"] = time.perf_counter() - t0
    out["seen"] = seen
    out["s"] = time.perf_counter() - t_rank
    return out


class DryRun:
    """(c)'s dry run, off the card (no CUDA device visible to it, one
    thread, the lowest priority): DRY_CARD,
    then DRY_PROD, each ``python -m repro_torch.launch.dryrun`` into
    DRY_OUT, one after the other on a thread of this process, their output
    in build/dryrun.log.  Started after the build, it runs beside the
    phases before 16; ``wait`` returns the records, and ``stop`` ends a
    process still running (at the smoke's exit too)."""

    def __init__(self):
        import shutil
        import threading
        shutil.rmtree(DRY_OUT, ignore_errors=True)
        self.env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                        CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                        MKL_NUM_THREADS="1")
        self.log = open(ROOT / "build" / "dryrun.log", "w")
        self.procs: list = []
        self.seconds: list = []
        self.codes: list = []
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        for args in (DRY_CARD, DRY_PROD):
            t0 = time.perf_counter()
            # one thread at the lowest priority: the timed phases it
            # runs beside keep the host's cores
            proc = subprocess.Popen(
                ["nice", "-n", "19", sys.executable, "-m",
                 "repro_torch.launch.dryrun", *args, "--out", str(DRY_OUT)],
                cwd=ROOT, env=self.env, stdout=self.log,
                stderr=subprocess.STDOUT)
            self.procs.append(proc)
            self.codes.append(proc.wait())
            self.seconds.append(time.perf_counter() - t0)

    def wait(self) -> dict:
        self.thread.join(DRY_DEADLINE_S)
        if self.thread.is_alive():
            self.stop()
            fail(f"(c) the dry run ran past {DRY_DEADLINE_S:.0f} s")
        self.log.close()
        if self.codes != [0, 0]:
            fail(f"(c) the dry run exited {self.codes}; see build/dryrun.log")
        out = {}
        for path in sorted(DRY_OUT.glob("*.json")):
            out[path.stem] = json.loads(path.read_text())
        return out

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def zero_phase(torch, ranks: list, p15: dict, dry: DryRun) -> dict:
    """Phase 16: (a) and (b) held on the ranks' results (``tz_rank``),
    and (c), the dry run's records against (a)'s rank."""
    t_phase = time.perf_counter()
    in_world = max(r["s"] for r in ranks)
    out: dict = {"in_world_s": in_world}
    tokens = 8 * 512
    want = launches_of(flash_attention=TM_FLASH_FWD * TZ_STEPS,
                       flash_attention_backward=TM_FLASH_BWD * TZ_STEPS)
    log(f"[16] (a) python -m repro_torch.launch.train {' '.join(TZ_ARGS)} "
        f"under qwen3's recommended options (every layer whole on each "
        f"model rank, the vocabulary over \"model\", ZeRO-3 over (\"data\", "
        f"\"model\"), {TM_MICRO} microbatches) on phase 15's (data "
        f"{TM_DATA}, model {TM_MODEL}) world, full width at {TM_LAYERS} of "
        f"28 layers; (b) float32 against one rank, remat_offload; (c) the "
        f"dry run")
    launched = {"flash_attention": 0, "flash_attention_backward": 0}
    for r, base in zip(ranks, p15["train"]["ranks"]):
        if r["launches"] != want:
            fail(f"(a) rank {r['coords']}: launches {r['launches']}, "
                 f"expected {want}")
        if r["microbatches"] != TM_MICRO:
            fail(f"(a) rank {r['coords']}: {r['microbatches']} microbatches")
        losses = r["losses"]
        if not all(x == x and abs(x) < 1e30 for x in losses):
            fail(f"(a) rank {r['coords']}: a loss is not finite: {losses}")
        if losses != ranks[0]["losses"]:
            fail("(a) the ranks report different losses")
        if not r["first_batch_after"] < losses[0]:
            fail(f"(a) the first batch's loss did not fall: {losses[0]} "
                 f"before the run, {r['first_batch_after']} after it")
        # the same function of the same weights and batches as phase 15
        # (b)'s baseline layout: bf16 sums in other orders
        drift = max(abs(a - b) / abs(b) for a, b in
                    zip(losses, p15["train"]["losses"][:TZ_STEPS]))
        if drift > TZ_LOSS_RTOL:
            fail(f"(a) rank {r['coords']}'s losses {losses} part from phase "
                 f"15 (b)'s {p15['train']['losses']} by {drift:.2e}")
        for k in launched:
            launched[k] += r["launches"][k]
        steps_s = r["step_s"][1:]
        p50 = sorted(steps_s)[len(steps_s) // 2]
        share = sum(s for _, s in r["collectives"].values()) / sum(
            r["step_s"])
        r["p50_s"], r["share"] = p50, share
        log(f"    rank {r['coords']}: step p50 {p50 * 1e3:.1f} ms "
            f"(phase 15 (b) {base['p50_s'] * 1e3:.1f}), "
            f"{tokens / p50:,.0f} tokens/s over the world, collectives "
            f"{share:.3f} of the steps' time (phase 15 (b) "
            f"{base['share']:.3f}; "
            + ", ".join(f"{k} x{c} {s:.2f} s" for k, (c, s)
                        in sorted(r["collectives"].items()))
            + f"), peak memory {r['peak_bytes'] / 1e9:.2f} GB (phase 15 "
            f"(b) {base['peak_bytes'] / 1e9:.2f}), held "
            f"{r['held_bytes'] / 1e9:.3f} GB")
    base = p15["train"]["losses"][:TZ_STEPS]
    log(f"    losses {['%.6f' % x for x in ranks[0]['losses']]} (phase 15 "
        f"(b) {['%.6f' % x for x in base]}, within {TZ_LOSS_RTOL:g}); the "
        f"first batch's {ranks[0]['losses'][0]:.6f} "
        f"before the run, {ranks[0]['first_batch_after']:.6f} after; "
        f"launches a rank {ranks[0]['launches']}")
    train_seen = set().union(*(r["train_seen"] for r in ranks))
    want_seen = {("flash", "bf16", TM_ROWS, 512, 512, 16, 8, 128, "causal",
                  False)}
    if train_seen != want_seen:
        fail(f"(a) flash launched at {sorted(train_seen)}, expected "
             f"{sorted(want_seen)}")
    out["train"] = {
        "losses": ranks[0]["losses"],
        "launches_per_rank": ranks[0]["launches"],
        "step_p50_ms": [r["p50_s"] * 1e3 for r in ranks],
        "tokens_per_s": tokens / max(r["p50_s"] for r in ranks),
        "collective_share": [r["share"] for r in ranks],
        "collectives": [r["collectives"] for r in ranks],
        "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
        "held_gb": [r["held_bytes"] / 1e9 for r in ranks]}
    # (b)
    for r in ranks:
        c = r["f32"]
        rel = abs(c["loss_after_mesh"] - c["loss_after_one"]) / abs(
            c["loss_after_one"])
        if c["mu_rel"] > 1e-4 or c["nu_rel"] > 2e-4 or rel > LOSS_RTOL:
            fail(f"(b) rank {r['coords']}: moments {c['mu_rel']:.2e} / "
                 f"{c['nu_rel']:.2e} of their max, next loss {rel:.2e} "
                 f"relative, past 1e-4 / 2e-4 / {LOSS_RTOL:g}")
        if not c["offload_equal"]:
            fail(f"(b) rank {r['coords']}: the step with remat_offload "
                 f"parts from the step without it")
        log(f"    (b) rank {r['coords']} ({c['zero_leaves']} ZeRO-3 "
            f"leaves, split {c['split']}): moments within "
            f"{c['mu_rel']:.2e} and {c['nu_rel']:.2e} of their max, next "
            f"batch's loss {c['loss_after_mesh']:.6f} vs one rank "
            f"{c['loss_after_one']:.6f} ({rel:.2e}); remat_offload equal "
            f"bit for bit; {r['f32_s']:.1f} s")
    out["f32"] = [r["f32"] for r in ranks]
    seen = set().union(*(r["seen"] for r in ranks))
    grad_held = {("flash", dt, b, sq, sk, h, kv, hd, kind, pad is not None)
                 for _, b, sq, sk, h, kv, hd, dt, kind, _, pad
                 in FLASH_GRAD_CASES}
    missed = sorted(seen - held_shapes()) + sorted(seen - grad_held)
    if missed:
        fail(f"phase 16 launched flash at shapes phases 5 and 12 (a) did "
             f"not hold: {missed}")
    log(f"    phase 16 trained at {len(seen)} flash shapes, forward and "
        f"backward held in phases 5 and 12 (a)")
    # (c)
    t0 = time.perf_counter()
    records = dry.wait()
    waited = time.perf_counter() - t0
    log(f"    (c) the dry run (off the card, started after the build): "
        f"{' + '.join(f'{x:.1f}' for x in dry.seconds)} s, waited "
        f"{waited:.1f} s for it here")
    for name, rec in sorted(records.items()):
        if rec["status"] != "ok":
            if rec["status"] == "skipped":
                log(f"    {name}: skipped ({rec['reason']})")
                continue
            fail(f"(c) {name}: {rec['status']}: {rec.get('traceback', '')}")
        mem = rec["memory"]
        coll = rec["collectives"]
        log(f"    {name}: rank {rec['rank']} of {rec['devices']}, "
            f"arguments {mem['argument_bytes'] / 1e9:.3f} GB (policy "
            f"{rec['policy_argument_bytes'] / 1e9:.3f}), temp "
            f"{mem['temp_bytes'] / 1e9:.3f} GB, output "
            f"{mem['output_bytes'] / 1e9:.3f} GB, flops {rec['flops']:.4e}, "
            f"bytes accessed {rec['bytes_accessed']:.4e}, collectives "
            f"{coll['total_bytes']:.4e} B ("
            + ", ".join(f"{k} x{coll['ops_by_kind'][k]} {v:.3e}"
                        for k, v in coll["bytes_by_kind"].items() if v)
            + f"), run {rec['compile_s']} s")
    card = records.get(f"qwen3-0.6b__train_4k__{TM_DATA}x{TM_MODEL}__card")
    if card is None or card["status"] != "ok":
        fail("(c) the dry run wrote no record of (a)'s cell")
    twin = next(r for r in ranks
                if r["coords"] == (0, card["rank"] % TM_MODEL))
    if card["memory"]["argument_bytes"] != twin["held_bytes"]:
        fail(f"(c) the dry run's argument bytes "
             f"{card['memory']['argument_bytes']} differ from the "
             f"{twin['held_bytes']} (a)'s rank {twin['coords']} holds")
    fake = [tuple(e) for e in card["ledger"]]
    for r in ranks:
        if [tuple(e) for e in r["ledger"]] != fake:
            fail(f"(c) rank {r['coords']}'s ledger of step "
                 f"{TZ_LEDGER_STEP} ({len(r['ledger'])} collectives) "
                 f"differs from the dry run's ({len(fake)})")
    predicted = card["memory"]["argument_bytes"] + card["memory"]["temp_bytes"]
    ratio = predicted / twin["peak_bytes"]
    log(f"    (c) (a)'s cell on a fake (data {TM_DATA}, model {TM_MODEL}) "
        f"world: arguments {card['memory']['argument_bytes']:,} B = what "
        f"(a)'s rank holds; its {len(fake)} collectives a step equal every "
        f"rank's of step {TZ_LEDGER_STEP}, kind for kind, count for count "
        f"and byte for byte ({card['collectives']['ops_by_kind']}); "
        f"predicted peak {predicted / 1e9:.3f} GB (the plain program) vs "
        f"the card's max_memory_allocated {twin['peak_bytes'] / 1e9:.3f} "
        f"GB: ratio {ratio:.3f}")
    out["dryrun"] = {name: {k: rec.get(k) for k in (
        "status", "rank", "devices", "memory", "flops", "bytes_accessed",
        "collectives", "policy_argument_bytes", "departure_bytes",
        "compile_s")} for name, rec in records.items()}
    out["dryrun_s"] = dry.seconds
    out["peak_ratio"] = ratio
    out["launches"] = launched
    out["s"] = in_world + time.perf_counter() - t_phase
    log(f"    phase 16: {out['s']:.1f} s of its {TZ_BUDGET_S:.0f} s budget "
        f"({in_world:.1f} s of it in phase 15's world)"
        + ("" if out["s"] <= TZ_BUDGET_S else " (OVER)"))
    return out


# -- phase 17: the MoE's knobs on the "data" axis -----------------------------

TMOE_ROWS, TMOE_SEQ = 4, 384          # 1,536 tokens: 768 a data rank, so
# dispatch group 0 (1,024) straddles the two data ranks and group 1 holds
# their last 512 tokens and 512 zero pads
TMOE_STEPS = 2                        # bf16 steps a layout, step 1 timed (3 before phase 18)
TMOE_BUDGET_S = 120.0                 # the phase's share of the smoke's limit
TMOE_GRAD_TOL = 1e-5                  # tests/test_torch_model_axis_train.py's
TMOE_LOSS_RTOL = 1e-6                 # step tolerances, float32
TMOE_LAYOUTS = ("a", "b", "c")


def tmoe_options(layout: str):
    """Phase 17's layouts, each with ZeRO-3 off (phase 16 drives it) and
    one microbatch (the 1,536-token stream): (a) the baseline (F2's
    groups), (b) llama4-maverick's recommended training options
    ("moe-only", expert_shard_dff, remat_offload), (c) expert_mesh="data"."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import sharding
    base = {"a": sharding.BASELINE,
            "b": sharding.recommended_options(
                get_config("llama4-maverick-400b-a17b"), "train"),
            "c": sharding.ShardingOptions(expert_mesh="data")}[layout]
    return dataclasses.replace(base, fsdp_override=False, microbatches=1)


@contextlib.contextmanager
def kept_slots(counts: list):
    """Append to ``counts`` the kept (token, expert) pairs of every
    ``models.ffn.route`` call while the block runs (a rank's routed
    positions: its tokens, and the pad on the last data rank)."""
    from repro_torch.models import ffn
    route = ffn.route

    def spy(*args):
        out = route(*args)
        counts.append(int(out[0].sum()))
        return out
    ffn.route = spy
    try:
        yield counts
    finally:
        ffn.route = route


def tmoe_grads(tree, view=None) -> dict:
    """The router's and expert 0's leaves of a moonshot tree (one unit),
    on the host: the whole expert where ``view`` is None, else the
    rank's F columns of it where the rank holds expert 0 (None where it
    does not)."""
    moe = tree["units"]["slot0"]["moe"]
    out = {"router": moe["router"][0].float().cpu()}
    if view is None or view.expert_offset == 0:
        out.update({k: moe[k][0, 0].float().cpu() for k in ("wi", "wg", "wo")})
        if view is not None:
            out["cols"] = (view.dff_offset, view.local_dff)
    return out


def moe_rank(torch, mesh) -> dict:
    """A rank of phase 17, in phase 15's world after phase 16: moonshot-
    v1-16b-a3b at full width, one of its 48 layers, B4 S384.  Rank 0
    first takes the one-rank float32 gradient (its kept-slot counts, loss,
    ce, aux, the router's and expert 0's gradients, to the host) while
    the others wait.  Then under each of TMOE_LAYOUTS: TMOE_STEPS bf16
    steps of ``make_mesh_train_step`` (launches counted, shapes recorded,
    collectives timed), and one float32 step whose Adam first moment
    (0.1 of the unclipped gradient) and kept-slot counts are kept."""
    import torch.distributed as dist
    from repro_torch import _tree
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import for_arch
    from repro_torch.launch import sharding, train
    from repro_torch.models import steps, transformer

    t_rank = time.perf_counter()
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=1)
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32",
                              opt_state_dtype="float32")
    batch = _tree.to_device(for_arch(cfg, batch=TMOE_ROWS, seq=TMOE_SEQ,
                                     seed=5).get_batch(0), "cuda")
    out: dict = {"coords": (mesh.get_local_rank("data"),
                            mesh.get_local_rank("model"))}
    seen: set = set()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if dist.get_rank() == 0:
        params = transformer.init_params(SEED_KINDS, f32, "cuda")
        kept: list = []
        with kept_slots(kept), recorded_launches(seen):
            (loss, (ce, aux)), grads = steps.value_and_grad(params, f32,
                                                            batch)
        out["one"] = {"loss": float(loss), "ce": float(ce),
                      "aux": float(aux), "kept": kept,
                      "grads": tmoe_grads(grads)}
        del params, grads
        torch.cuda.empty_cache()
    dist.barrier()
    out["one_s"] = time.perf_counter() - t0
    for layout in TMOE_LAYOUTS:
        opts = tmoe_options(layout)
        row: dict = {}
        t0 = time.perf_counter()
        whole = transformer.init_params(SEED_KINDS, cfg, "cuda")
        local, view = sharding.place_params(mesh, cfg, whole, opts)
        del whole
        torch.cuda.empty_cache()
        init, step = train.make_mesh_train_step(mesh, view, lr=1e-4,
                                                microbatches=1, opts=opts)
        opt = init(local)
        row["setup_s"] = time.perf_counter() - t0
        spent: dict = {}
        step_s, losses = [], []
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        with recorded_launches(seen), timed_collectives(spent):
            for _ in range(TMOE_STEPS):
                dist.barrier()
                t0 = time.perf_counter()
                local, opt, metrics = step(local, opt, batch)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
        row.update(launches=read_counts(), step_s=step_s, losses=losses,
                   collectives=spent,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   held_bytes=tree_bytes(local) + tree_bytes(opt),
                   split=view.split, moe_data=view.moe_data,
                   expert_mesh=view.expert_mesh)
        del local, opt
        torch.cuda.empty_cache()
        # the float32 step, held against the one-rank gradient
        t0 = time.perf_counter()
        whole = transformer.init_params(SEED_KINDS, f32, "cuda")
        local, view = sharding.place_params(mesh, f32, whole, opts)
        del whole
        torch.cuda.empty_cache()
        init, step = train.make_mesh_train_step(
            mesh, view, lr=1e-3, grad_clip=None, microbatches=1, opts=opts)
        kept = []
        with kept_slots(kept), recorded_launches(seen):
            new, opt, metrics = step(local, init(local), batch)
        row["f32"] = {k: float(v) for k, v in metrics.items()}
        row["f32"]["kept"] = kept
        row["f32"]["grads"] = {k: v / 0.1 if isinstance(v, torch.Tensor)
                               else v for k, v in
                               tmoe_grads(opt.mu, view).items()}
        del new, opt, local
        torch.cuda.empty_cache()
        dist.barrier()
        row["f32_s"] = time.perf_counter() - t0
        out[layout] = row
    out["seen"] = seen
    out["s"] = time.perf_counter() - t_rank
    return out


def moe_phase(torch, ranks: list) -> dict:
    """Phase 17: each layout's steps and holds (``moe_rank``) on phase 15's
    world."""
    t_phase = time.perf_counter()
    in_world = max(r["s"] for r in ranks)
    out: dict = {"in_world_s": in_world}
    tokens = TMOE_ROWS * TMOE_SEQ
    one = next(r["one"] for r in ranks if "one" in r)
    log(f"[17] moonshot-v1-16b-a3b at full width (1 of 48 layers, 64 "
        f"experts of F 1,408, top-6, a shared expert, capacity 1.25, "
        f"dispatch groups of 1,024), B{TMOE_ROWS} S{TMOE_SEQ} on phase 15's "
        f"(data {TM_DATA}, model {TM_MODEL}) world: (a) the baseline, (b) "
        f"llama4's recommended options, (c) expert_mesh=\"data\"; "
        f"{TMOE_STEPS} bf16 steps each, and a float32 step against one "
        f"rank's (loss {one['loss']:.6f}, ce {one['ce']:.6f}, aux "
        f"{one['aux']:.6f}, {one['kept']} kept slots)")
    want_launch = launches_of(flash_attention=2 * TMOE_STEPS,
                              flash_attention_backward=TMOE_STEPS)
    launched = {"flash_attention": 0, "flash_attention_backward": 0}
    for layout in TMOE_LAYOUTS:
        rows = [r[layout] for r in ranks]
        for r, row in zip(ranks, rows):
            where = f"({layout}) rank {r['coords']}"
            if row["launches"] != want_launch:
                fail(f"{where}: launches {row['launches']}, expected "
                     f"{want_launch}")
            if not all(x == x and abs(x) < 1e30 for x in row["losses"]):
                fail(f"{where}: a loss is not finite: {row['losses']}")
            if row["losses"] != rows[0]["losses"]:
                fail(f"({layout}) the ranks report different losses")
            for k in launched:
                launched[k] += row["launches"][k]
            c = row["f32"]
            for k in ("loss", "ce", "aux"):
                rel = abs(c[k] - one[k]) / abs(one[k])
                if rel > TMOE_LOSS_RTOL:
                    fail(f"{where}: float32 {k} {c[k]} vs one rank "
                         f"{one[k]} ({rel:.2e} relative)")
            g, w = c["grads"], one["grads"]
            errs = {"router": float((g["router"] - w["router"]).abs().max())
                    / float(w["router"].abs().max())}
            if "wi" in g:
                at, n = g["cols"]
                for k in ("wi", "wg", "wo"):
                    ref = (w[k][:, at:at + n] if k != "wo"
                           else w[k][at:at + n])
                    errs[k] = float((g[k] - ref).abs().max()) / float(
                        ref.abs().max())
            bad = {k: v for k, v in errs.items() if v > TMOE_GRAD_TOL}
            if bad:
                fail(f"{where}: float32 gradients past {TMOE_GRAD_TOL:g} of "
                     f"each leaf's max: {bad}")
            row["grad_err"] = errs
        # the kept slots: each data rank's, summed, on the model rank 0s
        kept = [sum(x) for x in zip(*(r[layout]["f32"]["kept"] for r in ranks
                                      if r["coords"][1] == 0))]
        if kept != one["kept"]:
            fail(f"({layout}) kept slots {kept}, one rank {one['kept']}")
        p50s, shares = [], []
        for r, row in zip(ranks, rows):
            steps_s = row["step_s"][1:]
            p50 = sorted(steps_s)[len(steps_s) // 2]
            share = sum(x for _, x in row["collectives"].values()) / sum(
                row["step_s"])
            p50s.append(p50)
            shares.append(share)
            log(f"    ({layout}) rank {r['coords']} (split {row['split']}, "
                f"experts over {row['expert_mesh']}, data splits "
                f"{row['moe_data'] or 'nothing'}): step p50 "
                f"{p50 * 1e3:.1f} ms ({tokens / p50:,.0f} tokens/s over the "
                f"world), collectives {share:.3f} of the steps' time ("
                + ", ".join(f"{k} x{n} {x:.2f} s" for k, (n, x)
                            in sorted(row["collectives"].items()))
                + f"), peak {row['peak_bytes'] / 1e9:.2f} GB, held "
                f"{row['held_bytes'] / 1e9:.3f} GB; float32 gradients "
                + ", ".join(f"{k} {v:.1e}" for k, v in row["grad_err"].items())
                + " of their max")
        slowest = lambda f: max(f(row) for row in rows)
        log(f"    ({layout}) set-up {slowest(lambda x: x['setup_s']):.1f} s, "
            f"{TMOE_STEPS} bf16 steps "
            f"{slowest(lambda x: sum(x['step_s'])):.1f} s (step 0 "
            f"{slowest(lambda x: x['step_s'][0]):.1f}), the float32 step "
            f"and its set-up {slowest(lambda x: x['f32_s']):.1f} s; losses "
            f"{['%.5f' % x for x in rows[0]['losses']]}; "
            f"float32 loss {rows[0]['f32']['loss']:.6f}, ce "
            f"{rows[0]['f32']['ce']:.6f}, aux {rows[0]['f32']['aux']:.6f}, "
            f"kept slots {kept} = one rank's")
        out[layout] = {
            "losses": rows[0]["losses"],
            "step_p50_ms": [x * 1e3 for x in p50s],
            "tokens_per_s": tokens / max(p50s), "collective_share": shares,
            "collectives": [row["collectives"] for row in rows],
            "peak_gb": [row["peak_bytes"] / 1e9 for row in rows],
            "held_gb": [row["held_bytes"] / 1e9 for row in rows],
            "f32": [{k: v for k, v in row["f32"].items() if k != "grads"}
                    for row in rows],
            "grad_err": [row["grad_err"] for row in rows],
            "setup_s": [row["setup_s"] for row in rows],
            "step_s": [row["step_s"] for row in rows],
            "f32_s": [row["f32_s"] for row in rows]}
    seen = set().union(*(r["seen"] for r in ranks))
    grad_held = {("flash", dt, b, sq, sk, h, kv, hd, kind, pad is not None)
                 for _, b, sq, sk, h, kv, hd, dt, kind, _, pad
                 in FLASH_GRAD_CASES}
    missed = sorted(seen - held_shapes()) + sorted(seen - grad_held)
    if missed:
        fail(f"phase 17 launched flash at shapes phases 5 and 12 (a) did "
             f"not hold: {missed}")
    log(f"    phase 17 trained at {len(seen)} flash shapes, forward and "
        f"backward held in phases 5 and 12 (a); launches {launched}")
    out["launches"] = launched
    out["one"] = {k: one[k] for k in ("loss", "ce", "aux", "kept")}
    out["one_s"] = max(r["one_s"] for r in ranks)
    log(f"    the one-rank float32 gradient on rank 0, the others waiting: "
        f"{out['one_s']:.1f} s")
    out["s"] = in_world + time.perf_counter() - t_phase
    log(f"    phase 17: {out['s']:.1f} s of its {TMOE_BUDGET_S:.0f} s budget "
        f"({in_world:.1f} s of it in phase 15's world)"
        + ("" if out["s"] <= TMOE_BUDGET_S else " (OVER)"))
    return out


# -- phase 18: seq_shard training; the KV cache's sequence over "model" ----

SQ_STEPS = 2                          # (a): bf16 steps, step 1 timed
SQ_ROWS, SQ_SEQ = 2, 512              # (a): a rank's rows of each batch
SQ_NORMS = ("norm1", "norm2", "final_norm", "q_norm", "k_norm")
KV_NEW = 16                           # (b): new tokens a request
KV_S_MAX = 1160                       # (b): the dense caches, 580 a rank
SQ_BUDGET_S = 120.0                   # the phase's share of the smoke's limit


def sq_f32_case(torch, mesh) -> dict:
    """(a): one float32 step of qwen3 at TM_F32_LAYERS layers from the same
    weights and batch (B2 S128) on one rank and on the mesh under
    ``seq_shard`` (each rank's block of a row: 64 positions).  The
    rank's worst moment errors over each leaf's max, those of the norm
    scales by name (their gradients are summed over "model" from the
    ranks' blocks), and the next batch's loss both ways."""
    from repro_torch import _tree, shardctx
    from repro_torch.data.pipeline import for_arch
    from repro_torch.launch import sharding, train
    from repro_torch.models import steps, transformer

    cfg = tm_f32_configs()[0][1]
    opts = sharding.ShardingOptions(seq_shard=True, fsdp_override=False)
    stream = for_arch(cfg, batch=2, seq=TM_F32_SEQ, seed=3)
    b0 = _tree.to_device(stream.get_batch(0), "cuda")
    b1 = _tree.to_device(stream.get_batch(1), "cuda")
    out: dict = {}
    params = transformer.init_params(SEED_KINDS, cfg, "cuda")
    local, view = sharding.place_params(mesh, cfg, params, opts)
    init, step = steps.make_train_step(cfg, lr=1e-3)
    new, opt, _ = step(params, init(params), b0)
    out["loss_after_one"] = float(steps.loss_fn(new, cfg, b1)[0])
    ref = {k: _tree.to_device(sharding.place_params(mesh, cfg, tree,
                                                    opts)[0], "cpu")
           for k, tree in (("mu", opt.mu), ("nu", opt.nu))}
    scale = {k: [float(t.abs().max()) for t in _tree.leaves(tree)]
             for k, tree in (("mu", opt.mu), ("nu", opt.nu))}
    del params, new, opt
    torch.cuda.empty_cache()
    init, step = train.make_mesh_train_step(mesh, view, lr=1e-3, opts=opts)
    new, opt, metrics = step(local, init(local), b0)
    with shardctx.activation_sharding(mesh):
        out["loss_after_mesh"] = float(steps.loss_fn(new, view, b1)[0])
    out["loss"] = float(metrics["loss"])
    paths: list = []
    sharding.map_with_paths(lambda path, t: paths.append(path), opt.mu)
    norms: dict = {}
    for k in ("mu", "nu"):
        errs = [float((got.float() - want.to(got.device)).abs().max())
                / max(sc, 1e-30)
                for got, want, sc in zip(_tree.leaves(getattr(opt, k)),
                                         _tree.leaves(ref[k]), scale[k])]
        out[f"{k}_rel"] = max(errs)
        for path, err in zip(paths, errs):
            name = path.rsplit("/", 1)[-1]
            if k == "mu" and name in SQ_NORMS:
                norms[name] = max(norms.get(name, 0.0), err)
    out["norms_mu_rel"] = norms
    del local, new, opt, ref
    torch.cuda.empty_cache()
    return out


def kv_requests(cfg):
    """(b)'s wave: KV_PROMPTS tokens drawn from seed 18, KV_NEW new tokens
    each."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(18)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new=KV_NEW) for i, n in enumerate(KV_PROMPTS)]


def kv_engine(torch, cfg, params, mesh=None) -> dict:
    """(b): the sync engine (4 slots, KV_S_MAX) on ``kv_requests``: each
    request's tokens, the launches, the engine's counters, and the bytes
    of the wave's cache."""
    from repro_torch import _tree
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, slots=4, s_max=KV_S_MAX,
                        sync_batching=True, mesh=mesh)
    reqs = kv_requests(cfg)
    for r in reqs:
        eng.submit(r)
    zero_counts()
    from repro_torch.kernels import decode_attention
    decode_attention.decode_attention_cuda.ml_launches = 0
    t0 = time.perf_counter()
    eng.step()                                   # the wave's prefill
    cache = eng.cache
    types = sorted({type(c).__name__ for c in
                    [*cache["units"].values(), *cache["tail"]]})
    nbytes = sum(t.numel() * t.element_size() for t in _tree.leaves(
        {"units": cache["units"], "tail": cache["tail"]}))
    run = _run_layout_bytes(eng.cfg, cache)
    del cache
    eng.run_until_idle()
    torch.cuda.synchronize()
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "launches": read_counts(),
            "ml_launches": decode_attention.decode_attention_cuda.ml_launches,
            "decode_steps": eng.decode_steps,
            "prefill_steps": eng.prefill_steps,
            "s": time.perf_counter() - t0, "types": types,
            "cache_bytes": nbytes, "run_layout_bytes": run}


def _run_layout_bytes(view, cache) -> int:
    """The bytes ``cache`` would hold in the layout before the sequence
    split: every sequence-split leaf at the whole length, the rank's run
    of kv heads."""
    from repro_torch import _tree
    from repro_torch.models import attention
    total = 0
    for c in [*cache["units"].values(), *cache["tail"]]:
        for t in _tree.leaves(c):
            n = t.numel() * t.element_size()
            if attention.is_seq_split(c):
                n *= view.model_size
                if t.dim() >= 4:
                    n = n * view.n_kv // t.shape[-2]
            total += n
    return total


def seq_rank(torch, mesh) -> dict:
    """A rank of phase 18, in phase 15's world after phase 17.  (a)
    qwen3-0.6b at full width and TM_LAYERS layers under ``seq_shard``
    (each rank's SQ_ROWS rows of SQ_SEQ tokens, its residual stream a
    block of 256 positions): SQ_STEPS bf16 steps of
    ``make_mesh_train_step`` (launches counted, shapes recorded,
    collectives timed and counted by kind), and ``sq_f32_case``.  (b)
    gemma3-1b at full width and depth in float32: rank 0 serves
    ``kv_requests`` through a one-rank sync engine while the others wait;
    then every rank serves them through the sync engine on the mesh (the
    data rows replicas, each a "model" pair whose dense and ring caches
    hold their blocks of the sequence)."""
    import torch.distributed as dist
    from repro_torch import _tree, shardctx
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import for_arch
    from repro_torch.launch import sharding, train
    from repro_torch.models import transformer

    t_rank = time.perf_counter()
    out: dict = {"coords": (mesh.get_local_rank("data"),
                            mesh.get_local_rank("model"))}
    seen: set = set()                   # (a)'s shapes: trained
    served: set = set()                 # (b)'s: served
    torch.cuda.empty_cache()
    # (a) seq_shard training, bf16
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=TM_LAYERS)
    opts = sharding.ShardingOptions(seq_shard=True, microbatches=1)
    batch = _tree.to_device(for_arch(cfg, batch=SQ_ROWS * TM_DATA,
                                     seq=SQ_SEQ, seed=7).get_batch(0),
                            "cuda")
    whole = transformer.init_params(SEED_KINDS, cfg, "cuda")
    local, view = sharding.place_params(mesh, cfg, whole, opts)
    del whole
    torch.cuda.empty_cache()
    init, step = train.make_mesh_train_step(mesh, view, lr=3e-4,
                                            microbatches=1, opts=opts)
    opt = init(local)
    a: dict = {"setup_s": time.perf_counter() - t0}
    spent: dict = {}
    step_s, losses = [], []
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    with recorded_launches(seen), timed_collectives(spent), \
            shardctx.collective_ledger() as ledger:
        for _ in range(SQ_STEPS):
            dist.barrier()
            t0 = time.perf_counter()
            local, opt, metrics = step(local, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
    kinds: dict = {}
    for kind, nbytes, _ in ledger:
        n, b = kinds.get(kind, (0, 0))
        kinds[kind] = (n + 1, b + nbytes)
    a.update(launches=read_counts(), step_s=step_s, losses=losses,
             collectives=spent, kinds=kinds,
             peak_bytes=torch.cuda.max_memory_allocated())
    del local, opt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with recorded_launches(seen):
        a["f32"] = sq_f32_case(torch, mesh)
    a["f32_s"] = time.perf_counter() - t0
    out["a"] = a
    dist.barrier()
    # (b) gemma3-1b served with sequence-split caches
    f32 = dataclasses.replace(get_config("gemma3-1b"), param_dtype="float32",
                              compute_dtype="float32")
    b: dict = {}
    t0 = time.perf_counter()
    if dist.get_rank() == 0:
        params = transformer.init_params(SEED_KINDS, f32, "cuda")
        with recorded_launches(served):
            b["one"] = kv_engine(torch, f32, params)
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    b["one_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = transformer.init_params(SEED_KINDS, f32, "cuda")
    with recorded_launches(served):
        b["mesh"] = kv_engine(torch, f32, params, mesh)
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    b["mesh_s"] = time.perf_counter() - t0
    out["b"] = b
    out["seen"], out["served"] = seen, served
    out["s"] = time.perf_counter() - t_rank
    return out


def seq_phase(torch, ranks: list) -> dict:
    """Phase 18: (a) and (b) of ``seq_rank``, on phase 15's world."""
    t_phase = time.perf_counter()
    in_world = max(r["s"] for r in ranks)
    out: dict = {"in_world_s": in_world}
    log(f"[18] (a) qwen3-0.6b at full width ({TM_LAYERS} of 28 layers) under "
        f"seq_shard on phase 15's (data {TM_DATA}, model {TM_MODEL}) world: "
        f"B{SQ_ROWS} S{SQ_SEQ} a rank, the residual stream a rank's block "
        f"of {SQ_SEQ // TM_MODEL} positions; {SQ_STEPS} bf16 steps and a "
        f"float32 step against one rank's.  (b) gemma3-1b at full width "
        f"and depth in float32, the sync engine on {len(KV_PROMPTS)} "
        f"prompts of {KV_PROMPTS} tokens and {KV_NEW} new each: one rank, "
        f"then the mesh with sequence-split caches")
    # (a)
    want = launches_of(flash_attention=2 * TM_LAYERS * SQ_STEPS,
                       flash_attention_backward=TM_LAYERS * SQ_STEPS)
    launched = {k: 0 for k in ("flash_attention", "flash_attention_backward",
                               "decode_attention")}
    tokens = SQ_ROWS * TM_DATA * SQ_SEQ
    p50s, shares = [], []
    for r in ranks:
        a = r["a"]
        where = f"(a) rank {r['coords']}"
        if a["launches"] != want:
            fail(f"{where}: launches {a['launches']}, expected {want}")
        if not all(x == x and abs(x) < 1e30 for x in a["losses"]):
            fail(f"{where}: a loss is not finite: {a['losses']}")
        if a["losses"] != ranks[0]["a"]["losses"]:
            fail("(a) the ranks report different losses")
        if "reduce-scatter" not in a["kinds"]:
            fail(f"{where}: no reduce-scatter over the sequence: "
                 f"{a['kinds']}")
        for k in ("flash_attention", "flash_attention_backward"):
            launched[k] += a["launches"][k]
        c = a["f32"]
        rel = abs(c["loss_after_mesh"] - c["loss_after_one"]) / abs(
            c["loss_after_one"])
        bad_norms = {k: v for k, v in c["norms_mu_rel"].items() if v > 1e-4}
        if (c["mu_rel"] > 1e-4 or c["nu_rel"] > 2e-4 or rel > LOSS_RTOL
                or bad_norms or set(c["norms_mu_rel"]) != set(SQ_NORMS)):
            fail(f"{where}: float32 moments {c['mu_rel']:.2e} / "
                 f"{c['nu_rel']:.2e} of their max, the norm scales' "
                 f"{c['norms_mu_rel']}, next loss {rel:.2e} relative, past "
                 f"1e-4 / 2e-4 / {LOSS_RTOL:g}")
        steps_s = a["step_s"][1:]                 # step 0 warms
        p50 = sorted(steps_s)[len(steps_s) // 2]
        share = sum(x for _, x in a["collectives"].values()) / sum(
            a["step_s"])
        p50s.append(p50)
        shares.append(share)
        log(f"    (a) rank {r['coords']}: step p50 {p50 * 1e3:.1f} ms "
            f"({tokens / p50:,.0f} tokens/s over the world), collectives "
            f"{share:.3f} of the steps' time ("
            + ", ".join(f"{k} x{n} {x:.2f} s" for k, (n, x)
                        in sorted(a["collectives"].items()))
            + "); by kind "
            + ", ".join(f"{k} x{n} {b / 1e6:.1f} MB" for k, (n, b)
                        in sorted(a["kinds"].items()))
            + f"; peak {a['peak_bytes'] / 1e9:.2f} GB; float32 moments "
            f"within {c['mu_rel']:.2e} / {c['nu_rel']:.2e} of their max, "
            f"the norm scales' first moments "
            + ", ".join(f"{k} {v:.1e}" for k, v
                        in sorted(c["norms_mu_rel"].items()))
            + f", next batch's loss {c['loss_after_mesh']:.6f} vs one rank "
            f"{c['loss_after_one']:.6f} ({rel:.2e})")
    out["a"] = {"losses": ranks[0]["a"]["losses"],
                "step_p50_ms": [x * 1e3 for x in p50s],
                "tokens_per_s": tokens / max(p50s),
                "collective_share": shares,
                "kinds": ranks[0]["a"]["kinds"],
                "peak_gb": [r["a"]["peak_bytes"] / 1e9 for r in ranks],
                "f32": [r["a"]["f32"] for r in ranks],
                "setup_s": max(r["a"]["setup_s"] for r in ranks),
                "f32_s": max(r["a"]["f32_s"] for r in ranks)}
    # (b)
    one = next(r["b"]["one"] for r in ranks if "one" in r["b"])
    layers = 26
    for label, run in [("one rank", one)] + [
            (f"rank {r['coords']}", r["b"]["mesh"]) for r in ranks]:
        want = launches_of(flash_attention=layers * run["prefill_steps"],
                           decode_attention=layers * run["decode_steps"])
        if run["launches"] != want or run["prefill_steps"] != 1:
            fail(f"(b) {label}: launches {run['launches']} over "
                 f"{run['prefill_steps']} prefill and {run['decode_steps']} "
                 f"decode steps, expected {want}")
        partial = run["decode_steps"] * layers if run is not one else 0
        if run["ml_launches"] != partial:
            fail(f"(b) {label}: {run['ml_launches']} launches of the "
                 f"partial entry, expected {partial}")
        if run is not one:
            if run["types"] != ["SeqKVCache", "SeqRingCache"]:
                fail(f"(b) {label}: caches {run['types']}, expected the "
                     f"sequence-split ones")
            if run["tokens"] != one["tokens"]:
                fail(f"(b) {label}: tokens {run['tokens']} part from one "
                     f"rank's {one['tokens']}")
        for k in ("flash_attention", "decode_attention"):
            launched[k] += run["launches"][k]
        log(f"    (b) {label}: {run['decode_steps']} decode ticks, "
            f"launches {run['launches']} ({run['ml_launches']} of the "
            f"partial entry), cache {run['cache_bytes'] / 1e6:.1f} MB "
            f"({', '.join(run['types'])}) against "
            f"{run['run_layout_bytes'] / 1e6:.1f} MB in the layout before "
            f"the split, {run['s']:.1f} s; tokens "
            + ("" if run is one else "= one rank's: ")
            + f"{run['tokens'][0][:6]}...")
    out["b"] = {"tokens": one["tokens"],
                "cache_bytes": [r["b"]["mesh"]["cache_bytes"] for r in ranks],
                "run_layout_bytes": [r["b"]["mesh"]["run_layout_bytes"]
                                     for r in ranks],
                "one_cache_bytes": one["cache_bytes"],
                "one_s": max(r["b"]["one_s"] for r in ranks),
                "mesh_s": max(r["b"]["mesh_s"] for r in ranks)}
    seen = set().union(*(r["seen"] for r in ranks))
    served = set().union(*(r["served"] for r in ranks))
    grad_held = {("flash", dt, b, sq, sk, h, kv, hd, kind, pad is not None)
                 for _, b, sq, sk, h, kv, hd, dt, kind, _, pad
                 in FLASH_GRAD_CASES}
    missed = (sorted((seen | served) - held_shapes())
              + sorted(seen - grad_held))
    if missed:
        fail(f"phase 18 launched at shapes phases 5 and 12 (a) did not "
             f"hold: {missed}")
    log(f"    phase 18 trained at {len(seen)} flash shapes (forward and "
        f"backward held in phases 5 and 12 (a)) and served at "
        f"{len(served)} flash and decode shapes (held in phase 5); "
        f"launches {launched}")
    out["launches"] = launched
    out["s"] = in_world + time.perf_counter() - t_phase
    log(f"    phase 18: {out['s']:.1f} s of its {SQ_BUDGET_S:.0f} s budget "
        f"({in_world:.1f} s of it in phase 15's world)"
        + ("" if out["s"] <= SQ_BUDGET_S else " (OVER)"))
    return out


# -- phase 19: the analysis layers' probes on the card ---------------------------

AN_BUDGET_S = 30.0                    # the phase's share of the smoke's limit
AN_LAYERS = 2                         # reduced qwen3-0.6b's (the probes' engines)
AN_ROLLOUT_ORACLE_SLOTS = 3 * 4       # (b): three rollouts of 4 Oracle slots


def analysis_phase(torch) -> dict:
    """Phase 19: ``repro_torch.analysis``'s probes on the card.  (a) The
    retrace probes' serving and chunked engines (reduced qwen3-0.6b,
    float32) pass their bounds, and every wave's greedy tokens equal the
    same probe's on the CPU; (b) three Oracle rollouts build nothing and
    load no library again; (c) the donation probe: every pool leaf keeps
    its storage over a tick and both commits, and the tick's peak memory
    grows by less than one pool; (d) ``python -m repro_torch.analysis
    --lint --json`` exits 0 here, where no JAX is installed.  The kernels'
    launches over (a)-(c) are counted exactly; each shape they launch at
    is one phase 5 held."""
    import contextlib
    import io
    from repro_torch.analysis import retrace, shardcheck
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    log("[19] the analysis layers on the card: (a) the retrace probes' "
        "serving and chunked engines (reduced qwen3-0.6b, float32, waves "
        f"{retrace.SERVING_WAVES} and {retrace.CHUNKED_WAVES}) against the "
        "same probes on the CPU; (b) three Oracle rollouts of a 3-cell "
        "fixed_rate grid; (c) the donation probe; (d) --lint --json")
    out: dict = {}
    seen: set = set()
    zero_all_counts()
    with recorded_launches(seen):
        t0 = time.perf_counter()
        card = [retrace.serving_probe(device="cuda"),
                retrace.chunked_probe(device="cuda")]
        torch.cuda.synchronize()
        probes_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rollout = retrace.rollout_probe(device="cuda")
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
        fails, figures = shardcheck.donation_probe("cuda")
    launched = {**read_counts(), "partition_sweep": sweep_launches()}
    # (a)
    prefills = decode_ticks = 0
    for probe in card:
        cpu = getattr(retrace, f"{probe.name}_probe")(
            device="cpu", head_dim=min(ops.HEAD_DIMS))
        if probe.failures or cpu.failures:
            fail(f"(a) {probe.name} probe: "
                 f"{[f.render() for f in probe.failures + cpu.failures]}")
        if probe.prefill_compiles != cpu.prefill_compiles:
            fail(f"(a) {probe.name}: prefill signatures {probe.prefill_compiles}"
                 f" on the card, {cpu.prefill_compiles} on the CPU")
        if probe.tokens != cpu.tokens:
            parted = sorted(r for r in cpu.tokens
                            if probe.tokens.get(r) != cpu.tokens[r])
            fail(f"(a) {probe.name}: greedy tokens of requests {parted} part "
                 f"from the CPU's")
        prefills += probe.steps["prefill_steps"] - probe.steps["chunk_steps"]
        decode_ticks += probe.steps["decode_steps"]
        log(f"    (a) {probe.name}: prefill signatures after each wave "
            f"{probe.prefill_compiles}"
            + (f", prefill_chunk input signatures "
               f"{len(probe.chunk_signatures)}" if probe.name == "chunked"
               else "")
            + f"; {len(probe.tokens)} requests' greedy tokens = the CPU's; "
            f"engine {probe.steps}")
        out[probe.name] = {"prefill_compiles": probe.prefill_compiles,
                           "steps": probe.steps}
    # (b)
    if rollout.failures:
        fail(f"(b) {[f.render() for f in rollout.failures]}")
    for name, c in rollout.libraries.items():
        if c["builds"] or c["loads"] or c["total_loads"] > 1:
            fail(f"(b) library {name}: {c} over the rollouts (nothing is "
                 f"built or loaded again, once a process at most)")
    log(f"    (b) 3 rollouts in {rollout_s:.1f} s; libraries built / "
        f"loaded during them: "
        + ", ".join(f"{n} {c['builds']}/{c['loads']} ({c['total_loads']} "
                    f"loads in the process)"
                    for n, c in rollout.libraries.items()))
    out["rollout"] = {"libraries": rollout.libraries, "s": rollout_s}
    # (c)
    if fails:
        fail(f"(c) donation probe: {[f.render() for f in fails]}")
    log(f"    (c) pool leaves keep their storage over two ticks, "
        f"commit_prefill and commit_chunk; the second tick's peak memory grew "
        f"{figures['tick_peak_growth_bytes']} B against a pool of "
        f"{figures['pool_bytes']} B")
    out["donation"] = figures
    # the launches of (a)-(c), exactly: a flash forward a layer per solo
    # prefill or first chunk, a paged decode a layer per tick (the
    # donation probe's one-layer engine: one prefill, two ticks), a sweep
    # an Oracle slot
    want = {**launches_of(flash_attention=AN_LAYERS * prefills + 1,
                          decode_attention=AN_LAYERS * decode_ticks + 2),
            "partition_sweep": AN_ROLLOUT_ORACLE_SLOTS}
    if launched != want:
        fail(f"phase 19 launches {launched}, expected {want}")
    log(f"    launches over (a)-(c): {launched}")
    out["launches"] = launched
    missed = sorted(seen - held_shapes(), key=str)
    if missed:
        fail(f"phase 19 launched kernels at shapes phase 5 did not hold: "
             f"{missed}")
    log(f"    (a)-(c) launched the attention kernels at {len(seen)} shapes, "
        f"each held in phase 5")
    # (d)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--lint", "--json"])
    lint = json.loads(buf.getvalue())["lint"]
    if rc != 0 or lint["new"]:
        fail(f"(d) --lint --json exited {rc}: {lint}")
    log(f"    (d) --lint --json: exit 0, {len(lint['new'])} findings, "
        f"{len(lint['baselined'])} baselined ({time.perf_counter() - t0:.1f} s)")
    out["probes_s"] = probes_s
    out["s"] = time.perf_counter() - t_phase
    log(f"    phase 19: {out['s']:.1f} s of its {AN_BUDGET_S:.0f} s budget"
        + ("" if out["s"] <= AN_BUDGET_S else " (OVER)"))
    return out


# -- phase 20: training the "s" and "r" kinds --------------------------------

SG_BUDGET_S = 75.0                    # the phase's share of the smoke's limit
SSD_GRAD_CHUNK = 64                   # the plain version's chunk, S padded
SSD_GRAD_NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")
# (a): (label, b, s, h, p, g, n, dtype, resets, the final state's cotangent:
# None (the state not differentiated, as in training), "zero" or "random");
# mamba2's H 64, P 64, N 128 at the training shape (a microbatch of B8 S512
# in 2), and its P and N at the one-kernel path (S <= 64) and the chunk
# edges; S 333 with resets at step 0, on the boundary of chunk 2 and twice
# inside it; G 2 over 4 heads; N and P multiples of 4 but not of 16, which
# the bf16 kernel pads to its tensor-core tiles
SSD_GRAD_CASES = [
    ("train", 4, 512, 64, 64, 1, 128, "bf16", None, None),
    ("train", 4, 512, 64, 64, 1, 128, "f32", None, None),
    ("S1", 2, 1, 8, 64, 1, 128, "f32", ((1, 0),), "random"),
    ("S1", 2, 1, 8, 64, 1, 128, "bf16", None, "random"),
    ("S63", 2, 63, 8, 64, 1, 128, "f32", ((0, 0),), "random"),
    ("S63", 2, 63, 8, 64, 1, 128, "bf16", ((0, 0),), "random"),
    ("S64", 2, 64, 8, 64, 1, 128, "f32", ((1, 10), (1, 40)), "random"),
    ("S65", 2, 65, 8, 64, 1, 128, "f32", ((0, 64), (1, 0)), "random"),
    ("S65", 2, 65, 8, 64, 1, 128, "bf16", ((0, 64), (1, 0)), "random"),
    ("S333", 1, 333, 8, 64, 1, 128, "f32",
     ((0, 0), (0, 128), (0, 140), (0, 150)), "random"),
    ("S333", 1, 333, 8, 64, 1, 128, "bf16",
     ((0, 0), (0, 128), (0, 140), (0, 150)), "random"),
    ("G2 H4", 2, 197, 4, 32, 2, 16, "f32", ((0, 64), (1, 70), (1, 100)),
     "random"),
    ("G2 H4", 2, 197, 4, 32, 2, 16, "bf16", ((0, 64), (1, 70), (1, 100)),
     "random"),
    ("final state's cotangent 0", 2, 130, 8, 64, 1, 128, "f32", ((0, 64),),
     "zero"),
    ("N12 P20", 2, 97, 4, 20, 2, 12, "bf16", ((0, 64),), "random"),
]
# (label, b, s, r, dtype, resets): recurrentgemma's R 2,560 at the training
# shape; S 1; an odd S (plan: segments of 8 steps, tiles of 128) with
# resets on a segment's first (8) and last (15) step and on a tile boundary
# (128); R not a multiple of the 16-channel tile
RGLRU_GRAD_CASES = [
    ("train", 4, 512, 2560, "f32", None),
    ("train", 4, 512, 2560, "bf16", None),
    ("S1", 2, 1, 16, "f32", ((1, 0),)),
    ("odd S", 2, 197, 37, "f32",
     ((0, 8), (0, 15), (0, 128), (1, 127), (1, 130), (1, 133))),
    ("odd S", 2, 197, 37, "bf16",
     ((0, 8), (0, 15), (0, 128), (1, 127), (1, 130), (1, 133))),
    ("R 40", 1, 300, 40, "f32", ((0, 0), (0, 256), (0, 299))),
]
# (c)'s "l" layers: the flash backward at recurrentgemma's training shape
RG_FLASH_GRAD = ("recurrentgemma local", 4, 512, 512, 10, 1, 256, "bf16",
                 "local", 2048, None)
SSD_BWD_SHAPE = (4, 512, 64, 64, 1, 128)        # timed: (b)'s microbatch
RGLRU_BWD_SHAPE = (4, 512, 2560)                # timed: (c)'s microbatch
# (b) and (c): B8 S512 in 2 microbatches (recommended_options), bf16, remat,
# lr 3e-4 as phase 12 (b)
SG_STEPS = 5
MAMBA_TRAIN_ARGS = ["--arch", "mamba2-1.3b", "--batch", "8", "--seq", "512",
                    "--steps", str(SG_STEPS), "--lr", "3e-4"]
RG_TRAIN_ARGS = ["--arch", "recurrentgemma-2b", "--batch", "8", "--seq",
                 "512", "--steps", str(SG_STEPS), "--lr", "3e-4"]
RG_TRAIN_LAYERS = 5          # (c): one (r, r, l) unit and the (r, r) tail
SG_MICRO = 2
# per step: each unit's layers run forward twice a microbatch (once more
# when the backward recomputes the unit), a tail layer's once, each
# layer's backward once
MAMBA_LAUNCHES = {"ssd_scan": 2 * 48 * SG_MICRO * SG_STEPS,
                  "ssd_scan_backward": 48 * SG_MICRO * SG_STEPS}
RG_LAUNCHES = {"rglru_scan": (2 * 2 + 2) * SG_MICRO * SG_STEPS,
               "rglru_scan_backward": 4 * SG_MICRO * SG_STEPS,
               "flash_attention": 2 * SG_MICRO * SG_STEPS,
               "flash_attention_backward": SG_MICRO * SG_STEPS}
# (d): one float32 step at 4 layers, one microbatch: mamba2 (4 "s" units),
# recurrentgemma as (r, r, l) + an (r,) tail
SG_F32_LAUNCHES = {
    "mamba2-1.3b": {"ssd_scan": 8, "ssd_scan_backward": 4},
    "recurrentgemma-2b": {"rglru_scan": 5, "rglru_scan_backward": 3,
                          "flash_attention": 2,
                          "flash_attention_backward": 1}}


def check_grads(torch, label: str, names, got, want) -> tuple:
    """Each kernel gradient finite and within GRAD_TOL_F32 (GRAD_TOL_BF16
    where it comes out in bf16) of max(1, max |plain gradient|); returns
    the largest absolute error and the largest error over its bound."""
    err = over = 0.0
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape:
            fail(f"{label}: {name} of shape {tuple(g.shape)}, the plain "
                 f"version's {tuple(w.shape)}")
        if not bool(torch.isfinite(g.float()).all()):
            fail(f"{label}: non-finite {name}")
        tol = GRAD_TOL_BF16 if g.dtype == torch.bfloat16 else GRAD_TOL_F32
        e = float((g.float() - w.float()).abs().max())
        bound = tol * max(1.0, float(w.abs().max()))
        if e > bound:
            fail(f"{label}: {name} max abs err {e:.3e} above {bound:.3e}")
        err, over = max(err, e), max(over, e / bound)
    return err, over


def grads_of(torch, outs, leaves, cots) -> list:
    """``torch.autograd.grad``, with zeros for a leaf the outputs do not
    use (the plain RG-LRU at S = 1 never reads a)."""
    got = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, leaves)]


def same_bits(torch, label: str, got, again) -> None:
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{label}: two calls on the same inputs differ")


def check_ssd_grad(torch, gen, case) -> tuple:
    """The SSD backward (through ``ops.ssd_scan`` with a gradient wanted)
    against autograd through the float32 plain version, and a second call
    equal to the first bit for bit."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as ssd
    label, b, s, h, p, g, n, dt, at, final = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    inputs = ssd_inputs(torch, gen, b, s, h, p, g, n, dtype)
    reset = resets_tensor(torch, b, s, at)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dstate = (None if final is None else
              torch.zeros(b, h, n, p, device="cuda") if final == "zero" else
              torch.randn(b, h, n, p, generator=gen, device="cuda"))

    def grads(fn, values, cot):
        leaves = [t.detach().requires_grad_(True) for t in values]
        y, state = fn(*leaves)
        if dstate is None:
            return grads_of(torch, y, leaves, cot)
        return grads_of(torch, [y, state], leaves, [cot, dstate])

    def kernel(*leaves):
        return ops.ssd_scan(*leaves, chunk=SSD_GRAD_CHUNK, reset=reset)

    before = ssd.ssd_scan_backward_cuda.launches
    got, again = grads(kernel, inputs, dy), grads(kernel, inputs, dy)
    torch.cuda.synchronize()
    if ssd.ssd_scan_backward_cuda.launches != before + 2:
        fail(f"ssd backward {label} {dt}: two gradients launched the "
             f"backward {ssd.ssd_scan_backward_cuda.launches - before} times")
    want = grads(lambda *v: ref.ssd_scan_padded(*v, SSD_GRAD_CHUNK,
                                                reset=reset),
                 [t.float() for t in inputs], dy.float())
    where = f"ssd backward {label} {dt}"
    err, over = check_grads(torch, where, SSD_GRAD_NAMES, got, want)
    same_bits(torch, where, got, again)
    log(f"  ssd bwd   {dt:4s} B{b} S{s} H{h} P{p} G{g} N{n} resets={at} "
        f"final state's cotangent {final}: ok, max abs err {err:.3e} "
        f"({over:.3f} of its bound), repeat bit-equal ({label})")
    return err, over


def check_rglru_grad(torch, gen, case) -> tuple:
    """The RG-LRU backward (through ``ops.rglru_scan`` with a gradient
    wanted) against autograd through the float32 plain version, and a
    second call equal to the first bit for bit."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as rg
    label, b, s, r, dt, at = case
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    x, a = rglru_inputs(torch, gen, b, s, r, dtype)
    reset = resets_tensor(torch, b, s, at)
    dh = torch.randn(b, s, r, generator=gen, device="cuda").to(dtype)

    def grads(fn, values, cot):
        leaves = [t.detach().requires_grad_(True) for t in values]
        return grads_of(torch, fn(*leaves, reset), leaves, cot)

    before = rg.rglru_scan_backward_cuda.launches
    got, again = (grads(ops.rglru_scan, (x, a), dh),
                  grads(ops.rglru_scan, (x, a), dh))
    torch.cuda.synchronize()
    if rg.rglru_scan_backward_cuda.launches != before + 2:
        fail(f"rglru backward {label} {dt}: two gradients launched the "
             f"backward {rg.rglru_scan_backward_cuda.launches - before} "
             f"times")
    want = grads(ref.rglru_scan_ref, (x.float(), a.float()), dh.float())
    where = f"rglru backward {label} {dt}"
    err, over = check_grads(torch, where, ("dx", "da"), got, want)
    same_bits(torch, where, got, again)
    log(f"  rglru bwd {dt:4s} B{b} S{s} R{r} resets={at}: ok, max abs err "
        f"{err:.3e} ({over:.3f} of its bound), repeat bit-equal ({label}; "
        f"plan {rg.plan(b, s, r)})")
    return err, over


def time_ssd_bwd(torch, gen, b, s, h, p, g, n) -> dict:
    """The bf16 SSD backward alone (``ssd_scan_backward_cuda``, y's
    cotangent only, as in training) beside the plain version's autograd
    from a saved graph; its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as ssd
    args = ssd_inputs(torch, gen, b, s, h, p, g, n, torch.bfloat16)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(
        torch.bfloat16)
    leaves = [t.detach().requires_grad_(True) for t in args]
    y_plain, _ = ref.ssd_scan_padded(*leaves, SSD_GRAD_CHUNK)
    t = time_kernel(
        torch, lambda: ssd.ssd_scan_backward_cuda(*args, dy),
        lambda: torch.autograd.grad(y_plain, leaves, dy, retain_graph=True),
        None, ssd.backward_op_count(b, s, h, p, n),
        ssd.backward_byte_count(b, s, h, p, g, n, 2, False), PEAK_BF16_S)
    t["shape"] = (f"B{b} S{s} H{h} P{p} G{g} N{n} bf16, backward (ops over "
                  f"the bf16 peak)")
    t["plan"] = ssd_plan(ssd, b, s, h, p)
    return t


def time_rglru_bwd(torch, gen, b, s, r) -> dict:
    """The float32 RG-LRU backward alone (the training gates are float32)
    beside the plain version's autograd from a saved graph; its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    x, a = rglru_inputs(torch, gen, b, s, r, torch.float32)
    h = rg.rglru_scan_cuda(x, a)
    dh = torch.randn(b, s, r, generator=gen, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (x, a)]
    h_plain = ref.rglru_scan_ref(*leaves)
    t = time_kernel(
        torch, lambda: rg.rglru_scan_backward_cuda(dh, a, h),
        lambda: torch.autograd.grad(h_plain, leaves, dh, retain_graph=True),
        None, rg.backward_op_count(b, s, r),
        rg.backward_byte_count(b, s, r, 4, False), PEAK_F32_S)
    t["shape"] = f"B{b} S{s} R{r} float32, backward"
    t["plan"] = rg.plan(b, s, r)
    return t


def check_refusals(torch) -> list:
    """The kernels without a backward -- decode attention, dense and paged,
    and the partition sweep -- raise NotImplementedError on the card where
    a gradient is wanted through them, and run under no_grad.  Returns the
    messages."""
    import numpy as np
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(21)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    q = rnd(2, 1, 4, 32).requires_grad_(True)
    k, v = rnd(2, 16, 2, 32), rnd(2, 16, 2, 32)
    valid = torch.ones(2, 16, dtype=torch.bool, device="cuda")
    pools = rnd(4, 8, 2, 32), rnd(4, 8, 2, 32)
    table = torch.arange(4, dtype=torch.int32, device="cuda").reshape(2, 2)
    lens = torch.tensor([5, 11], dtype=torch.int32, device="cuda")
    sweep = list(random_sweep_args(torch, np, 2, 3, 5, seed=21))
    sweep[0] = sweep[0].requires_grad_(True)
    calls = {
        "decode_attention": lambda: ops.decode_attention(q, k, v, valid),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q, *pools, table, lens),
        "partition_sweep": lambda: ops.partition_sweep_batched(*sweep)}
    messages = []
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            messages.append(str(e))
        else:
            fail(f"(a) {name} on the card took a gradient it has no "
                 f"backward for")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    return messages


def scan_grad_phase(torch) -> dict:
    """Phase 20 (a): both backward kernels at every listed case, flash's
    backward at recurrentgemma's training shape, the kernels without a
    backward refusing a gradient (``check_refusals``), and both backwards
    timed alone at their training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    log(f"[20] (a) the SSD and RG-LRU backward kernels vs autograd through "
        f"the float32 plain versions ({GRAD_TOL_F32} of max(1, max |g|) in "
        f"float32, {GRAD_TOL_BF16} for a gradient that comes out in bf16), "
        f"each case twice, bit for bit")
    out = {}
    for key, check, cases in (("ssd", check_ssd_grad, SSD_GRAD_CASES),
                              ("rglru", check_rglru_grad, RGLRU_GRAD_CASES)):
        errs, overs = zip(*(check(torch, gen, c) for c in cases))
        out[f"{key}_max_err"], out[f"{key}_err_over_tol"] = (max(errs),
                                                             max(overs))
    out["rg_flash_max_err"] = check_flash_grad(torch, gen, RG_FLASH_GRAD)
    out["refusals"] = check_refusals(torch)
    for msg in out["refusals"]:
        log(f"    refused on the card: {msg}")
    out["ssd_bwd"] = time_ssd_bwd(torch, gen, *SSD_BWD_SHAPE)
    out["rglru_bwd"] = time_rglru_bwd(torch, gen, *RGLRU_BWD_SHAPE)
    log_timed("ssd bwd", out["ssd_bwd"])
    log_timed("rglru bwd", out["rglru_bwd"])
    log(f"    ssd bwd plan (the forward's, for the recompute): "
        f"{out['ssd_bwd']['plan']}; rglru bwd plan {out['rglru_bwd']['plan']}")
    return out


def scan_training_phase(torch, smi: str) -> dict:
    """Phase 20: (a) ``scan_grad_phase``; (b) mamba2-1.3b and (c)
    recurrentgemma-2b (at RG_TRAIN_LAYERS) trained through
    ``launch.train.main`` with exact launches, a falling loss, their
    numbers and a profile; (d) one float32 step of each at 4 layers, card
    against CPU (``train_card_vs_cpu``), with exact launches."""
    from repro_torch.configs.base import get_config
    t_phase = t_part = time.perf_counter()
    out: dict = {"part_s": {}}

    def part_done(name: str) -> None:
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        log(f"    ({name}) took {now - t_part:.1f} s")
        t_part = now

    out["grad"] = scan_grad_phase(torch)
    part_done("a")
    log(f"[20] (b) python -m repro_torch.launch.train "
        f"{' '.join(MAMBA_TRAIN_ARGS)} (full width, 48 layers, bf16, remat)")
    _, out["mamba2"] = train_run(torch, MAMBA_TRAIN_ARGS, smi, MAMBA_LAUNCHES)
    out["mamba2"]["profile"] = train_profile(torch, MAMBA_TRAIN_ARGS)
    part_done("b")
    log(f"[20] (c) python -m repro_torch.launch.train "
        f"{' '.join(RG_TRAIN_ARGS)} (full width at {RG_TRAIN_LAYERS} of 26 "
        f"layers: one (r, r, l) unit and the (r, r) tail; bf16, remat)")
    _, out["recurrentgemma"] = train_run(torch, RG_TRAIN_ARGS, smi,
                                         RG_LAUNCHES, RG_TRAIN_LAYERS)
    out["recurrentgemma"]["profile"] = train_profile(torch, RG_TRAIN_ARGS,
                                                     RG_TRAIN_LAYERS)
    part_done("c")
    log("[20] (d) float32 training steps, card vs CPU (4 layers, full width)")
    f32 = dict(param_dtype="float32", compute_dtype="float32",
               opt_state_dtype="float32")
    out["card_vs_cpu"], f32_launches = {}, {}
    for name, cfg in (
            ("mamba2-1.3b", dataclasses.replace(get_config("mamba2-1.3b"),
                                                n_layers=4, **f32)),
            ("recurrentgemma-2b", dataclasses.replace(
                get_config("recurrentgemma-2b"), n_layers=4,
                tail_pattern=("r",), **f32))):
        zero_all_counts()
        out["card_vs_cpu"][name] = train_card_vs_cpu(
            torch, f"{name} {''.join(cfg.block_pattern + cfg.tail_pattern)}",
            cfg, False, part="d")
        got = read_counts()
        want = {k: SG_F32_LAUNCHES[name].get(k, 0) for k in got}
        if got != want:
            fail(f"(d) {name}: launches {got}, expected {want}")
        f32_launches[name] = got
    part_done("d")
    runs = [out["mamba2"]["launches"], out["recurrentgemma"]["launches"],
            *f32_launches.values()]
    out["launches"] = {k: sum(r.get(k, 0) for r in runs)
                       for k in ("ssd_scan", "ssd_scan_backward", "rglru_scan",
                                 "rglru_scan_backward", "flash_attention",
                                 "flash_attention_backward")}
    out["s"] = time.perf_counter() - t_phase
    log(f"    phase 20: {out['s']:.1f} s of its {SG_BUDGET_S:.0f} s budget"
        + ("" if out["s"] <= SG_BUDGET_S else " (OVER)"))
    return out


def gm_part(torch, held: dict, phase3: dict, cuts: int, ready: str,
            out: dict) -> int:
    """Phase 15 (a): the grid's model axis on GM_RANKS ranks, held to phase
    3's unsharded results (``held``); its numbers go into ``out``.  Returns
    the sweep's launches."""
    from repro_torch.launch.mesh import run_world
    # (a) the grid's model axis
    log(f"[15] (a) {GRID_CELLS}x{GRID_UES} grid on make_cells_mesh(model="
        f"{GM_RANKS}), {GM_RANKS} ranks on one card (gloo), {GM_COLS} UEs "
        f"of each cell a rank, {GM_SLOTS} slots of "
        + " and ".join(MESH_POLICIES) + ", against phase 3")
    t0 = time.perf_counter()
    ranks = run_world(gm_rank, GM_RANKS, args=(GM_SLOTS, ready),
                      backend="gloo",
                      device="cuda:0", deadline_s=TM_DEADLINE_S)
    sweep_calls = 0
    for r in ranks:
        want_cols = (r["rank"] * GM_COLS, (r["rank"] + 1) * GM_COLS)
        if r["cols"] != want_cols or r["device"] != 0:
            fail(f"(a) rank {r['rank']} held UEs {r['cols']} on cuda:"
                 f"{r['device']}, expected {want_cols} on cuda:0")
        for policy in MESH_POLICIES:
            got = r[policy]
            n = GM_SLOTS if policy == "oracle" else 0
            if got["launches"] != n or got["calls"] != [
                    (GRID_CELLS, GM_COLS, cuts, GRID_UES)] * n:
                fail(f"(a) rank {r['rank']} {policy}: {got['launches']} sweep "
                     f"launches at {got['calls']}, expected {n} at "
                     f"{(GRID_CELLS, GM_COLS, cuts, GRID_UES)}")
            sweep_calls += got["launches"]
            want = {k: v[:GM_SLOTS] for k, v in held[policy].items()
                    if k.startswith("results.")}
            bad = mesh_mismatch(torch, got["results"], want)
            if bad:
                fail(f"(a) rank {r['rank']} {policy} parts from phase 3's "
                     f"first {GM_SLOTS} slots: {bad}")
        log(f"    rank {r['rank']} (UEs {r['cols'][0]}-{r['cols'][1] - 1}): "
            f"grid built in {r['build_s']:.1f} s beside (b)'s start; "
            + "; ".join(f"{p} {r[p]['slot_ms']:.1f} ms/slot (phase 3 "
                        f"{phase3[p]['slot_ms']:.1f}), "
                        f"{r[p]['collectives_per_slot']:.0f} collectives "
                        f"{r[p]['collective_ms_per_slot']:.2f} ms a slot"
                        for p in MESH_POLICIES))
    log(f"    every rank's gathered results equal phase 3's first {GM_SLOTS} "
        f"slots (cuts identical, rtol {MESH_RTOL:g}, atol {MESH_ATOL:g}); "
        f"one sweep launch a rank per Oracle slot over {GRID_CELLS}x{GM_COLS} "
        f"rows with the even split over {GRID_UES}")
    out["grid"] = [{"rank": r["rank"], "build_s": r["build_s"],
                    **{f"{p}_{k}": r[p][k] for p in MESH_POLICIES
                       for k in ("slot_ms", "collectives_per_slot",
                                 "collective_ms_per_slot")}}
                   for r in ranks]
    out["phase3_slot_ms"] = {p: phase3[p]["slot_ms"] for p in MESH_POLICIES}
    out["a_s"] = time.perf_counter() - t0
    log(f"    (a) took {out['a_s']:.1f} s")
    return sweep_calls


def mesh_train_phase(torch, held: dict, phase3: dict, cuts: int) -> dict:
    """Phase 15: (a) the grid's model axis on GM_RANKS ranks, held to phase
    3's unsharded results (``held``); (b) ``launch.train`` over a (data 2,
    model 2) mesh of TM_RANKS ranks at full width; (c) float32 steps of
    the mesh against one rank's, and the compressed gradient sync on the
    card against the CPU."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import run_world

    t_phase = time.perf_counter()
    out: dict = {}

    # the two worlds start together; (a)'s timed work waits for (b)'s
    # ranks to be up, and (b) for (a) to end (go_file).  The ranks'
    # allocators grow their segments, so that four processes' freed
    # blocks do not strand the card's memory
    go_file = ROOT / "build" / "phase15_go"
    ready = ROOT / "build" / "phase15_ready"
    shutil.rmtree(ready, ignore_errors=True)
    ready.mkdir(parents=True)
    go_file.unlink(missing_ok=True)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    pool = ThreadPoolExecutor(1)
    world = pool.submit(run_world, tm_rank, TM_RANKS,
                        args=(str(go_file), str(ready)), backend="gloo",
                        device="cuda:0", deadline_s=TM_DEADLINE_S)
    try:
        grid_part = gm_part(torch, held, phase3, cuts, str(ready), out)
    finally:
        go_file.touch()
        pool.shutdown(wait=False)
    t0 = time.perf_counter()
    log(f"[15] (b) python -m repro_torch.launch.train {' '.join(TM_ARGS)} on "
        f"a (data {TM_DATA}, model {TM_MODEL}) mesh, {TM_RANKS} ranks on one "
        f"card (gloo), full width at {TM_LAYERS} of 28 layers; (c) float32 "
        f"steps against one rank's and the compressed gradient sync, card "
        f"against CPU")
    try:
        ranks = world.result()
    finally:
        go_file.unlink(missing_ok=True)
        shutil.rmtree(ready, ignore_errors=True)
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    out["sweep_launches"] = grid_part
    want = launches_of(flash_attention=TM_FLASH_FWD * TM_STEPS,
                       flash_attention_backward=TM_FLASH_BWD * TM_STEPS)
    launched = {"flash_attention": 0, "flash_attention_backward": 0}
    tokens = 8 * 512
    for r in ranks:
        if r["shape"] != (TM_DATA, TM_MODEL):
            fail(f"(b) rank {r['rank']} on a {r['shape']} mesh")
        if r["launches"] != want:
            fail(f"(b) rank {r['rank']}: launches {r['launches']}, expected "
                 f"{want}")
        if r["microbatches"] != TM_MICRO:
            fail(f"(b) rank {r['rank']}: {r['microbatches']} microbatches")
        if not all(x == x and abs(x) < 1e30 for x in r["losses"]):
            fail(f"(b) rank {r['rank']}: a loss is not finite: {r['losses']}")
        if r["losses"] != ranks[0]["losses"]:
            fail(f"(b) the ranks report different losses")
        for k in launched:
            launched[k] += r["launches"][k]
        steps_s = r["step_s"][1:]              # step 0 builds and warms
        p50 = sorted(steps_s)[len(steps_s) // 2]
        coll_s = sum(s for _, s in r["collectives"].values())
        share = coll_s / sum(r["step_s"])
        r["p50_s"], r["share"] = p50, share
        log(f"    rank {r['rank']} (data {r['coords'][0]}, model "
            f"{r['coords'][1]}): run {r['train_s']:.1f} s (set-up "
            f"{r['train_s'] - sum(r['step_s']):.1f} s, step 0 "
            f"{r['step_s'][0]:.1f} s), step p50 "
            f"{p50 * 1e3:.1f} ms ({tokens / p50:,.0f} tokens/s over the "
            f"world), collectives {share:.3f} of the steps' time ("
            + ", ".join(f"{k} x{c} {s:.2f} s" for k, (c, s)
                        in sorted(r["collectives"].items()))
            + f"), peak memory {r['peak_bytes'] / 1e9:.2f} GB")
    log(f"    losses {['%.4f' % x for x in ranks[0]['losses']]}; launches a "
        f"rank {ranks[0]['launches']}")
    train_seen = set().union(*(r["train_seen"] for r in ranks))
    want_seen = {("flash", "bf16", TM_ROWS, 512, 512, 16 // TM_MODEL,
                  8 // TM_MODEL, 128, "causal", False)}
    if train_seen != want_seen:
        fail(f"(b) flash launched at {sorted(train_seen)}, expected "
             f"{sorted(want_seen)}")
    p50s = [r["p50_s"] for r in ranks]
    out["train"] = {
        "ranks": [{k: r[k] for k in ("p50_s", "share", "peak_bytes")}
                  for r in ranks],
        "args": TM_ARGS, "losses": ranks[0]["losses"],
        "launches_per_rank": ranks[0]["launches"],
        "step_p50_ms": [x * 1e3 for x in p50s],
        "tokens_per_s": tokens / max(p50s),
        "collective_share": [r["share"] for r in ranks],
        "collectives": [r["collectives"] for r in ranks],
        "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks]}

    # (c) float32 steps, and the compressed sync
    for label, *_ in tm_f32_configs():
        cases = [r["f32"][label] for r in ranks]
        for r, c in zip(ranks, cases):
            if c["loss"] != cases[0]["loss"]:
                fail(f"(c) {label}: the ranks report different losses")
            if r["coords"][0] == 1:
                twin = next(x for x, y in zip(cases, ranks)
                            if y["coords"] == (0, r["coords"][1]))
                if c["digest"] != twin["digest"]:
                    fail(f"(c) {label}: data ranks hold different moments")
                continue
            rel = abs(c["loss_after_mesh"] - c["loss_after_one"]) / abs(
                c["loss_after_one"])
            if c["mu_rel"] > 1e-4 or c["nu_rel"] > 2e-4 or rel > LOSS_RTOL:
                fail(f"(c) {label}: rank {r['rank']} moments "
                     f"{c['mu_rel']:.2e} / {c['nu_rel']:.2e} of their max, "
                     f"next loss {rel:.2e} relative, past 1e-4 / 2e-4 / "
                     f"{LOSS_RTOL:g}")
            log(f"    (c) {label}, model rank {r['coords'][1]}: moments "
                f"within {c['mu_rel']:.2e} and {c['nu_rel']:.2e} of their "
                f"max, next batch's loss {c['loss_after_mesh']:.6f} vs one "
                f"rank {c['loss_after_one']:.6f} ({rel:.2e}); weights and "
                f"the one-rank step {c['one_s']:.1f} s, mesh step "
                f"{c['step_s']:.1f} s, checks {c['check_s']:.1f} s")
    for r in ranks:
        for mode, same in r["sync"].items():
            if not same:
                fail(f"(c) make_grad_sync {mode}: rank {r['rank']}'s card "
                     f"result parts from the CPU's")
    log(f"    (c) make_grad_sync over data in modes "
        + " and ".join(TM_SYNC_MODES) + ": card == CPU, bit for bit, on "
        f"every rank; (b)+(c) world {time.perf_counter() - t0:.1f} s, (c) "
        f"{max(r['f32_s'] for r in ranks):.1f} s a rank")
    out["f32"] = {label: [r["f32"][label] for r in ranks]
                  for label, *_ in tm_f32_configs()}
    # every shape a rank launched flash at must be one phases 5 and 12
    # held, forward and backward
    seen = set().union(*(r["seen"] for r in ranks))
    grad_held = {("flash", dt, b, sq, sk, h, kv, hd, kind, pad is not None)
                 for _, b, sq, sk, h, kv, hd, dt, kind, _, pad
                 in FLASH_GRAD_CASES}
    missed = sorted(seen - held_shapes()) + sorted(seen - grad_held)
    log(f"    phase 15 trained at {len(seen)} flash shapes, forward and "
        f"backward held in phases 5 and 12 (a)")
    if missed:
        fail(f"phase 15 launched flash at shapes phases 5 and 12 (a) did "
             f"not hold: {missed}")
    out["launches"] = launched
    # phases 16, 17 and 18's ranks ran in this world after (c): their
    # seconds are theirs
    out["zero_ranks"] = [r["zero"] for r in ranks]
    out["zero_s"] = max(r["zero"]["s"] for r in ranks)
    out["moe_ranks"] = [r["moe"] for r in ranks]
    out["moe_s"] = max(r["moe"]["s"] for r in ranks)
    out["seq_ranks"] = [r["seq"] for r in ranks]
    out["seq_s"] = max(r["seq"]["s"] for r in ranks)
    out["bc_s"] = (time.perf_counter() - t0 - out["zero_s"]
                   - out["moe_s"] - out["seq_s"])
    log(f"    (b) and (c) took {out['bc_s']:.1f} s after (a); the world had "
        f"started beside (a), its ranks waiting "
        f"{min(r['waited_s'] for r in ranks):.1f} s for it")
    out["s"] = (time.perf_counter() - t_phase - out["zero_s"]
                - out["moe_s"] - out["seq_s"])
    log(f"    phase 15: {out['s']:.1f} s of its {MM_BUDGET_S:.0f} s budget"
        + ("" if out["s"] <= MM_BUDGET_S else " (OVER)"))
    return out


def no_drop(cfg):
    """``cfg`` at the smallest integer capacity factor, ceil(E / k), at
    which an expert can take its whole group: cap = ceil(g k / E) x factor
    >= g, so no token drops whatever the routing and a token's output does
    not depend on the rest of its group.  (8, which the reference's own
    no-drop test uses for the reduced configs' 8 experts, leaves
    moonshot's 64 at 0.75 of a group: a bucketed prefill's identical pad
    tokens, first in token order, then take the slots of real tokens.)"""
    return dataclasses.replace(
        cfg, capacity_factor=float(-(-cfg.n_experts // cfg.top_k)))


def reduced_for_card(cfg):
    """The reduced config of ``cfg`` in bf16 with the attention kernels'
    smallest head dim (its own 16 is below it), as the CLIs build it on
    CUDA."""
    from repro_torch.configs.base import reduced
    from repro_torch.launch.serve import kernel_head_dim
    return reduced(cfg, param_dtype="bfloat16", compute_dtype="bfloat16",
                   **kernel_head_dim("cuda"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import scenarios
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import partition_sweep as ps
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd

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
    libs = _build.all_libraries()
    _build.build_all(libs)
    build_s = time.perf_counter() - t0
    for lib in libs:
        log(f"    built {lib.path().relative_to(ROOT)}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    log(f"    {len(libs)} kernels built in {build_s:.1f} s")
    report.update(card=kind, count=count, nvidia_smi=smi, build_s=build_s)
    # phase 16 (c)'s dry run, off the card, beside the phases before it
    import atexit
    dry = DryRun()
    atexit.register(dry.stop)

    phase_s = report["phase_s"] = {}
    clock = [2, time.perf_counter()]

    def phase_done(moved: float = 0.0) -> None:
        """Log and keep the seconds the phase that just ended took, less
        ``moved`` seconds of the next phase's work that it ran."""
        now = time.perf_counter()
        phase_s[clock[0]] = now - clock[1] - moved
        log(f"    phase {clock[0]} took {now - clock[1] - moved:.1f} s")
        clock[:] = [clock[0] + 1, now - moved]

    # -- 2. kernel vs plain on the card --------------------------------------
    log("[2] partition_sweep: CUDA kernel vs plain PyTorch")
    t0 = time.perf_counter()
    grid = scenarios.ScenarioGrid(
        scenarios.multicell_grid(cells=GRID_CELLS, ues=GRID_UES))
    log(f"    grid {GRID_CELLS}x{GRID_UES} built in "
        f"{time.perf_counter() - t0:.1f} s (C={grid.num_cuts})")

    rng = np.random.default_rng(0)     # (b)'s draws, then phase 3's
    cases = sweep_cases(torch, grid, rng)
    main_args = cases[0][1]
    main_plain = ref.partition_sweep_batched_ref(*main_args)
    errs = []
    for i, (label, args) in enumerate(cases):
        one = args[0].dim() == 2
        got = (ops.partition_sweep if one else ops.partition_sweep_batched)(*args)
        want = main_plain if i == 0 else (
            ref.partition_sweep_ref if one else ref.partition_sweep_batched_ref)(*args)
        errs.append(check_sweep(torch, got, want, label))

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

    phase_done()

    # -- 3. main path ----------------------------------------------------------
    log(f"[3] main path: ScenarioGrid {GRID_CELLS}x{GRID_UES}, "
        f"{MAIN_SLOTS} slots per policy")
    L_grid = grid.params.L
    policies, held = {}, {}
    ps.partition_sweep_cuda.launches = 0
    for policy in ("oracle", "local", "edge", "random"):
        t0 = time.perf_counter()
        states, res, summary = grid.make_rollout(policy, MAIN_SLOTS)(0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if policy in MESH_POLICIES:          # phase 13 (b) holds the mesh to it
            held[policy] = rollout_on_host(states, res, summary)
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
    grids = (scenarios.ScenarioGrid(cells),
             scenarios.ScenarioGrid(cells, device="cpu"))
    draws = grid_draws(np, grids[1], SMALL_SLOTS, rng)
    for policy in ("oracle", "local", "edge"):
        same_cut, worst = compare_rollouts(torch, grids, policy, SMALL_SLOTS,
                                           draws)
        log(f"      {policy:7s} same cuts {same_cut:.3f}, worst summary rel "
            f"diff {worst:.2e}")
        if same_cut < SAME_CUT_MIN or worst > SUMMARY_RTOL:
            fail(f"{policy}: card and CPU paths disagree")

    prof = profile_grid(torch, grid, PROFILE_SLOTS)
    report["profile"] = prof
    log(f"    profiler over {PROFILE_SLOTS} oracle slots: wall "
        f"{prof['wall_s']:.3f} s, device busy "
        f"{prof['device_busy_share']:.3f}, "
        f"{prof['device_ops_per_slot']:.0f} device ops/slot, "
        f"partition_sweep {prof['sweep_device_ms']} ms per launch")
    for row in prof["top"]:
        log(f"      {row['device_ms']:9.3f} ms  x{row['count']:<7d} "
            f"{row['name']}")

    phase_done()

    # -- 4. the learning loop ------------------------------------------------
    learning = learning_phase(torch, smi)
    report["learning"] = learning
    report["single_cell"] = learning["quickstart"]["baselines"]

    phase_done()
    att = attention_phase(torch, fa, da, ref)
    phase_done()
    report["attention"] = att
    serving = serving_phase(torch)
    phase_done()
    report["serving"] = serving
    scans = scan_phase(torch, ssd, rg, fa, da, ref)
    phase_done()
    report["scans"] = scans
    report["mamba2"] = mamba2_phase(torch)
    phase_done()
    report["recurrentgemma"] = recurrentgemma_phase(torch)
    phase_done()
    report["engines"] = engines_phase(torch, report, smi)
    phase_done()
    report["kinds"] = kinds = kinds_phase(torch)
    phase_done()
    report["training"] = training = training_phase(torch, smi)
    phase_done()
    report["mesh"] = mesh = mesh_phase(torch, held, policies,
                                       report["engines"]["train_compare"])
    phase_done()
    report["model_axis"] = tp = model_phase(torch, serving)
    phase_done()
    report["mesh_train"] = mm = mesh_train_phase(torch, held, policies,
                                                 grid.num_cuts)
    phase_done(moved=mm["zero_s"] + mm["moe_s"] + mm["seq_s"])
    report["zero"] = zr = zero_phase(torch, mm.pop("zero_ranks"), mm, dry)
    phase_done(moved=mm["moe_s"] + mm["seq_s"])
    report["moe"] = mo = moe_phase(torch, mm.pop("moe_ranks"))
    phase_done(moved=mm["seq_s"])
    report["seq"] = sq = seq_phase(torch, mm.pop("seq_ranks"))
    phase_done()
    report["analysis"] = an = analysis_phase(torch)
    phase_done()
    report["scan_training"] = sg = scan_training_phase(torch, smi)
    phase_done()
    # every kernel library this process launched was loaded once
    loads = {lib.name: lib.loads for lib in libs}
    if any(n != 1 for n in loads.values()):
        fail(f"kernel libraries loaded {loads} times in this process, "
             f"expected once each")
    log(f"    loads of each kernel library in this process: {loads}")
    report["library_loads"] = loads

    kernels = [{
        "name": "partition_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/partition_sweep.cu",
        "replaces": "src/repro/kernels/partition_sweep.py:175",
        "launches": (launches + mesh["sweep_launches"] + mm["sweep_launches"]
                     + an["launches"]["partition_sweep"]),
        "max_abs_err": max(errs), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    for name, key, err_key, source, replaces in (
            ("flash_attention", "flash", "flash_max_abs_err",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:163"),
            ("decode_attention", "decode", "decode_max_abs_err",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:84")):
        t = att[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (serving["launches"][name] + kinds["launches"][name]
                         + training["train"]["launches"][name]
                         + tp["launches"][name]
                         + mm["launches"].get(name, 0)
                         + zr["launches"].get(name, 0)
                         + mo["launches"].get(name, 0)
                         + sq["launches"].get(name, 0)
                         + an["launches"][name]
                         + sg["launches"].get(name, 0)),
            "max_abs_err": att[err_key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for name, key, source, replaces, launches in (
            ("ssd_scan", "ssd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan.py:135",
             report["mamba2"]["launches"]["ssd_scan"]
             + tp["launches"]["ssd_scan"] + sg["launches"]["ssd_scan"]),
            ("rglru_scan", "rglru",
             "src/repro_torch/kernels/csrc/rglru_scan.cu",
             "src/repro/kernels/rglru_scan.py:97",
             report["recurrentgemma"]["launches"]["rglru_scan"]
             + tp["launches"]["rglru_scan"] + sg["launches"]["rglru_scan"])):
        t = scans[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": scans[f"{key}_max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # the backward alone at the training shape, beside the plain version's
    # and SDPA's backward; no Pallas kernel has a backward, so it stands in
    # for the reference's differentiated non-Pallas arm
    t = training["flash_grad"]["timed"]["backward"]
    kernels.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/ops.py:61-74",
        "launches": (training["train"]["launches"]["flash_attention_backward"]
                     + mm["launches"]["flash_attention_backward"]
                     + zr["launches"]["flash_attention_backward"]
                     + mo["launches"]["flash_attention_backward"]
                     + sq["launches"]["flash_attention_backward"]
                     + sg["launches"]["flash_attention_backward"]),
        "max_abs_err": max(training["flash_grad"]["max_err"],
                           sg["grad"]["rg_flash_max_err"]), "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # the scans' backwards alone at their training shapes, beside the plain
    # versions' autograd; no single PyTorch call computes either, and no
    # Pallas kernel has a backward, so each stands in for the reference's
    # differentiated non-Pallas arm
    for name, key, source, replaces in (
            ("ssd_scan_backward", "ssd",
             "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "src/repro/kernels/ops.py:108-133"),
            ("rglru_scan_backward", "rglru",
             "src/repro_torch/kernels/csrc/rglru_scan.cu",
             "src/repro/kernels/ops.py:136-143")):
        t = sg["grad"][f"{key}_bwd"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sg["launches"][name],
            "max_abs_err": sg["grad"][f"{key}_max_err"],
            "max_err_over_tol": sg["grad"][f"{key}_err_over_tol"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
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
