#!/usr/bin/env python3
"""The scan kernels and the partition sweep beside their earlier versions, on one GPU.

    python3 scripts/scan_sweep_turns.py --parent DIR

``DIR`` is an unpacked tree of the commit whose kernels to compare with
(``mkdir -p build/parent && git archive <commit> | tar -x -C build/parent``).
Its ``ssd_scan.cu``, ``rglru_scan.cu`` and ``partition_sweep.cu`` are built
beside the committed ones into ``build/``, and every pair is timed in turns
(earlier, committed, committed, earlier) within this one process, so they
share a card.  Device time per call is torch.profiler's kernel time, mean of
50 calls, as ``chip_smoke.device_ms`` takes it.

* The partition sweep on phase 2's 4096 x 8 x 11 grid and on its first
  quarter and half of the cells (does the time follow the rows, or one
  wave's latency?); the registers and spills of every build (ptxas); per
  kernel, the SASS instruction count, its MUFU, and the loops (backward
  branches) with their lengths (cuobjdump); whether ``ncu`` is installed.
  Then variants of the committed kernel, each held to every check of
  ``chip_smoke.py`` phase 2 before it is timed: the search's one division
  per objective evaluation IEEE in place of approximate (``__fdividef``),
  two IEEE divisions (the plain version's form), and the build without
  ``-fmad=false``.
* The SSD scan in bf16 at mamba2's split check (B2 S512 H64 P64 N128) and
  solo prefill (B1 S32, a left pad of 3), the committed call's device
  kernels each with its time, and the count of tensor-core (HMMA)
  instructions in the committed library's SASS.
* The RG-LRU scan in float32 at recurrentgemma's solo prefill (B1 S32
  R2560, a left pad of 3) and split shape (B2 S512 R2560), earlier and
  committed in turns, and at the split shape with the L2 flushed before
  each call; the registers of both builds.
* The harness comparison: the committed SSD at B2 S512 bf16 and the
  RG-LRU, earlier and committed, at both shapes, on the same input tensors,
  through ``chip_smoke.time_kernel`` (phase 7's path) and ``in_turns``,
  then through ``chip_smoke.device_ms`` with one thing varied at a time:
  each call's outputs freed before the next, after a second of idling,
  after BUSY_S of bf16 matrix products, after 100 warm-up calls in place
  of one, on a second input draw, from a library built from a copy of the
  source at another path, after an 8 GB block is allocated and freed, and
  after ``torch.cuda.empty_cache()``.  ``nvidia-smi`` samples the SM
  clock every 20 ms meanwhile; each timing is logged with the median clock
  of its window.  Then ``chip_smoke.scan_phase`` itself, and last a
  profile of BIG_PROFILE small kernels (what ``chip_smoke.py`` profiles in
  its phase 3) followed by a profile of each case: how many kernel
  records it keeps, their sum over the calls and ``chip_smoke.per_call_ms``.

SASS listings go to ``--sass-dir`` (default ``build/sass``).  Needs CUDA
and nvcc; exits nonzero without them.

    ncu --section SpeedOfLight --section WarpStateStats -k regex:partition_sweep \
        python3 scripts/scan_sweep_turns.py --once sweep

runs one call of the committed sweep on the 4096 x 8 x 11 grid (``--once
ssd``: the SSD at B2 S512) and nothing else, for a profiler to wrap.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

COMMITTED_DIVISION = ("  return energy + v * __fdividef(d_ue * denom + q_coef * f, f * denom);\n")
IEEE_DIVISION = (COMMITTED_DIVISION,
                 "  return energy + v * ((d_ue * denom + q_coef * f) / (f * denom));\n")
TWO_DIVISIONS = (COMMITTED_DIVISION,
                 "  const float proc = d_ue / f;\n"
                 "  const float queue = q_coef / denom;\n"
                 "  return energy + v * (proc + queue);\n")

# Ablations of the committed SSD kernel, for diagnosis only (their outputs
# are wrong by design and not checked): each drops one part of a pass.
SSD_ABLATIONS = {
    "no entering state (scan pass)": (
        "  const bool has_prev = kMode == kScan && ch > 0;",
        "  const bool has_prev = false;"),
    "no decay mask (scan pass)": (
        "      sc[j][e] = keep ? sc[j][e] * expf(static_cast<float>(cum[q] - cum[r])) * dts[r] : 0.f;",
        "      sc[j][e] = keep ? sc[j][e] : 0.f;"),
    "no C.B^T (scan pass)": (
        "  for (int kd = 0; kd < up16(n); kd += 16) {",
        "  for (int kd = 0; kd < 0; kd += 16) {"),
    "no state product (chunk pass)": (
        "      tc::state_product(L, ",
        "      if (false) tc::state_product(L, "),
}


BUSY_S = 0.5     # seconds of bf16 matrix products before a "busy" timing
BIG_PROFILE = 100_000    # kernels in one profile, as chip_smoke's phase 3


def log(msg: str) -> None:
    print(msg, flush=True)


class ClockSampler:
    """``nvidia-smi`` printing the SM clock (MHz) every 20 ms while it runs; ``window(t0, t1)`` gives the median clock of
    the samples between two ``time.time()`` stamps."""

    def __enter__(self):
        import datetime
        import threading
        self.samples: list = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, text=True)

        def read():
            # stamped by nvidia-smi itself: its output may reach the pipe
            # in bursts
            for line in self.proc.stdout:
                try:
                    stamp, mhz = (v.strip() for v in line.split(","))
                    t = datetime.datetime.strptime(
                        stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                    self.samples.append((t, float(mhz)))
                except ValueError:
                    continue
        self.thread = threading.Thread(target=read, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        self.proc.wait(timeout=10)
        self.thread.join(timeout=10)

    def window(self, t0: float, t1: float) -> str:
        got = sorted(m for t, m in self.samples if t0 <= t <= t1)
        if not got:
            return "no clock sample"
        return (f"SM clock median {got[len(got) // 2]:.0f} MHz "
                f"({len(got)} samples, {got[0]:.0f}-{got[-1]:.0f})")


def busy(torch, seconds: float) -> None:
    """Keep the card busy with bf16 matrix products for ``seconds``."""
    import time
    m = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        for _ in range(10):
            m @ m
        torch.cuda.synchronize()


def variant(lib, name: str, old: str, new: str):
    """A Library built from ``lib``'s source with ``old`` -> ``new``."""
    from repro_torch.kernels import _build
    src = lib.source.read_text()
    if src.count(old) != 1:
        raise SystemExit(f"{lib.source.name}: expected one {old!r}")
    path = _build.BUILD_DIR / "variants" / name / lib.source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(old, new))
    return _build.Library(lib.name, path, lib._bind,
                          extra_flags=lib.flags[len(_build.BASE_FLAGS):])


def sass(lib, out_dir: pathlib.Path, tag: str) -> str:
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.sass").write_text(text)
    return text


def sass_summary(text: str) -> list[dict]:
    """Per kernel function: instructions, MUFU, and each backward branch's
    loop length in instructions."""
    out = []
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        instr = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)
        addr = [int(a, 16) for a, _ in instr]
        loops = []
        for i, (a, op) in enumerate(instr):
            tgt = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if tgt:
                t = int(tgt.group(1), 16)
                if t <= addr[i]:
                    body = [o for b, (_, o) in zip(addr, instr) if t <= b <= addr[i]]
                    loops.append({"length": len(body),
                                  "mufu": sum("MUFU" in o for o in body),
                                  "fchk": sum("FCHK" in o for o in body)})
        out.append({"name": name[:90], "instructions": len(instr),
                    "mufu": sum("MUFU" in o for _, o in instr),
                    "loops": sorted(loops, key=lambda d: -d["length"])[:4]})
    return out


def in_turns(torch, label: str, runs: dict, cases: dict) -> dict:
    """Device ms of each case under each run, in the order a, b, ..., b, a."""
    import chip_smoke as cs
    order = list(runs) + list(runs)[::-1]
    got: dict = {name: {} for name in runs}
    for name in order:
        for case, make in cases.items():
            fn = make(runs[name])
            got[name].setdefault(case, []).append(round(cs.device_ms(torch, fn, 50), 4))
        log(f"  {label} {name:24s} " + "  ".join(
            f"{case} {got[name][case][-1]:.4f}" for case in cases))
    return got


def parent_ssd(lib):
    """A call of the earlier SSD kernel (its C interface: no scratch)."""
    import torch

    def call(x, dt, a_log, b, c, d_skip, reset=None):
        bsz, s, h, p = x.shape
        g, n = b.shape[2], b.shape[3]
        y = torch.empty_like(x)
        st = torch.empty(bsz, h, n, p, dtype=torch.float32, device=x.device)
        err = lib.load().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(),
            None if reset is None else reset.data_ptr(), y.data_ptr(),
            st.data_ptr(), bsz, s, h, g, n, p,
            1 if x.dtype == torch.bfloat16 else 0, x.device.index or 0,
            torch.cuda.current_stream().cuda_stream)
        lib.check(err)
        return y, st
    return call


def bind_parent_sweep(source: pathlib.Path):
    """The binder of an earlier tree's sweep library: before the split
    count had an argument of its own (``cell_rows``), ``n_total`` was both
    the rows of a cell and the split, so the call drops ``cell_rows``."""
    from repro_torch.kernels import partition_sweep as ps
    if "int cell_rows" in source.read_text():
        return ps._bind

    def bind(lib) -> None:
        fn = lib.partition_sweep_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.partition_sweep_launch = lambda *a: fn(*a[:13], *a[14:])
    return bind


def bind_parent_ssd(lib) -> None:
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--once", choices=("sweep", "ssd"))
    ap.add_argument("--sass-dir", type=pathlib.Path,
                    default=ROOT / "build" / "sass")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import scenarios
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import partition_sweep as ps
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd
    if args.once == "sweep":
        import numpy as np
        grid = scenarios.ScenarioGrid(scenarios.multicell_grid(
            cells=cs.GRID_CELLS, ues=cs.GRID_UES))
        a = cs.sweep_cases(torch, grid, np.random.default_rng(0))[0][1]
        ops.partition_sweep_batched(*a)
        torch.cuda.synchronize()
        return 0
    if args.once == "ssd":
        gen = torch.Generator(device="cuda").manual_seed(7)
        a = cs.ssd_inputs(torch, gen, 2, 512, 64, 64, 1, 128, torch.bfloat16)
        ssd.ssd_scan_cuda(*a)
        torch.cuda.synchronize()
        return 0
    if args.parent is None:
        ap.error("--parent is required")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    csrc = args.parent / "src" / "repro_torch" / "kernels" / "csrc"
    sweep_libs = {
        "earlier": _build.Library(
            "partition_sweep", csrc / "partition_sweep.cu",
            bind_parent_sweep(csrc / "partition_sweep.cu"),
            extra_flags=("-fmad=false",)),
        "committed": ps.LIBRARY,
        "IEEE division": variant(ps.LIBRARY, "ieee_division", *IEEE_DIVISION),
        "two IEEE divisions": variant(ps.LIBRARY, "two_divisions",
                                      *TWO_DIVISIONS),
        "no -fmad=false": _build.Library("partition_sweep", ps.LIBRARY.source,
                                         ps._bind),
    }
    ssd_libs = {"earlier": _build.Library("ssd_scan", csrc / "ssd_scan.cu",
                                          bind_parent_ssd),
                "committed": ssd.LIBRARY}
    ablations = {name: variant(ssd.LIBRARY, f"ssd_ablation_{i}", *sub)
                 for i, (name, sub) in enumerate(SSD_ABLATIONS.items())}
    # the same sources at another path, built apart (a comment added, so
    # another hash): does the build matter?
    copies = {}
    for lib in (ssd.LIBRARY, rg.LIBRARY):
        path = _build.BUILD_DIR / "variants" / "copy" / lib.source.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(lib.source.read_text() + "\n// a copy\n")
        copies[lib.name] = _build.Library(lib.name, path, lib._bind)
    rg_libs = {"earlier": _build.Library("rglru_scan", csrc / "rglru_scan.cu",
                                         rg._bind),
               "committed": rg.LIBRARY}
    libs = (list(sweep_libs.values()) + list(ssd_libs.values())
            + list(ablations.values()) + list(copies.values())
            + list(rg_libs.values()))
    _build.build_all(libs)
    for group in (sweep_libs, ssd_libs, rg_libs):
        for name, lib in group.items():
            for line in lib.build_log.splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log(f"  ptxas {lib.name} {name}: {line.strip()}")
    ncu = shutil.which("ncu") or next(
        (str(p) for p in pathlib.Path(_build.nvcc()).parent.glob("ncu*")), None)
    log(f"ncu: {ncu or 'not installed'}")

    out_dir = args.sass_dir
    for name in ("earlier", "committed"):
        for row in sass_summary(sass(sweep_libs[name], out_dir,
                                     f"partition_sweep_{name}")):
            log(f"  sass sweep {name}: {row}")
    text = sass(ssd_libs["committed"], out_dir, "ssd_scan_committed")
    hmma = [line.strip() for line in text.splitlines() if "HMMA" in line]
    log(f"  sass ssd committed: {len(hmma)} HMMA instructions, e.g. "
        f"{hmma[0] if hmma else 'none'}")
    for row in sass_summary(text):
        log(f"  sass ssd committed: {row['name']} {row['instructions']} "
            f"instructions")

    if sweep_part(torch, cs, scenarios, ops, ref, ps, sweep_libs):
        return 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = {"B2 S512": (2, 512, None), "B1 S32 pad 3": (1, 32, cs.PAD3)}
    inputs = {}
    for key, (b, s, at) in shapes.items():
        inputs[key] = (cs.ssd_inputs(torch, gen, b, s, 64, 64, 1, 128,
                                     torch.bfloat16),
                       cs.resets_tensor(torch, b, s, at))
    rg_inputs = {key: (*cs.rglru_inputs(torch, gen, b, s, 2560, torch.float32),
                       cs.resets_tensor(torch, b, s, at))
                 for key, (b, s, at) in shapes.items()}
    ssd_part(torch, cs, ssd, ssd_libs, ablations, inputs, gen)
    rglru_part(torch, cs, rg, ref, rg_libs, rg_inputs)
    harness_part(torch, cs, ssd, rg, ref, rg_libs, copies, inputs, rg_inputs)
    return 0


def sweep_part(torch, cs, scenarios, ops, ref, ps, sweep_libs) -> bool:
    """The sweep in turns and its variants; True where the committed or
    the earlier kernel fails phase 2's checks."""
    grid = scenarios.ScenarioGrid(scenarios.multicell_grid(
        cells=cs.GRID_CELLS, ues=cs.GRID_UES))
    import numpy as np
    cases = cs.sweep_cases(torch, grid, np.random.default_rng(0))
    for name, lib in list(sweep_libs.items()):
        ps.LIBRARY = lib
        log(f"sweep {name}: phase 2's checks")
        try:
            for label, a in cases:
                cs.check_sweep(torch, ops.partition_sweep_batched(*a),
                               ref.partition_sweep_batched_ref(*a), label)
        except SystemExit as exc:
            log(f"  sweep {name} fails phase 2: {exc}")
            if name in ("earlier", "committed"):
                return True
            del sweep_libs[name]
    main_args = cases[0][1]

    def rows_case(cells):
        sub = tuple(t[:cells] for t in main_args)

        def make(lib):
            ps.LIBRARY = lib
            return lambda: ops.partition_sweep_batched(*sub)
        return make
    sweep_cases = {f"{c}x{cs.GRID_UES}x11": rows_case(c)
                   for c in (cs.GRID_CELLS // 4, cs.GRID_CELLS // 2,
                             cs.GRID_CELLS)}
    in_turns(torch, "sweep", {k: sweep_libs[k] for k in ("earlier", "committed")},
             sweep_cases)
    others = [k for k in sweep_libs if k not in ("earlier", "committed")]
    for name in others:
        in_turns(torch, "sweep", {"committed": sweep_libs["committed"],
                                  name: sweep_libs[name]}, sweep_cases)
    ps.LIBRARY = sweep_libs["committed"]
    return False


def ssd_part(torch, cs, ssd, ssd_libs, ablations, inputs, gen) -> None:
    """The SSD against the parent's where the parent's source differs (it
    must have the one-block-per-head kernel's C interface,
    ``bind_parent_ssd``: a parent from before the chunk-parallel SSD), the
    committed call's kernels one by one, and its ablations."""
    if ssd_libs["earlier"].source.read_bytes() != ssd.LIBRARY.source.read_bytes():
        ssd_against_parent(torch, cs, ssd, ssd_libs, inputs, gen)
    else:
        log("  ssd: the parent's source is the committed one")

    # the device kernels one committed call issues, each one's time
    def per_kernel(label, key):
        a, reset = inputs[key]
        fn = lambda: ssd.ssd_scan_cuda(*a, reset=reset)
        fn()
        torch.cuda.synchronize()
        rows, _ = cs.profiled(torch, lambda: [fn() for _ in range(20)])
        for e in sorted(rows, key=lambda e: -e.device_time_total):
            log(f"  ssd {key} {label} per kernel: "
                f"{cs.per_call_ms([e], 20):.4f} ms a call, "
                f"{-(-e.count // 20)} a call, {e.key[:90]}")
    for key in inputs:
        per_kernel("committed", key)
    # diagnosis: the split check with P cut into 2 and 4 column groups
    # (2,048 and 4,096 blocks a chunk pass), and the ablations
    plan = ssd.plan
    for groups in (2, 4):
        ssd.plan = lambda b, s, h, p, g=groups: (-(-s // ssd.CHUNK), g)
        per_kernel(f"{groups} column groups", "B2 S512")
    ssd.plan = plan
    for name, lib in ablations.items():
        ssd.LIBRARY = lib
        per_kernel(f"ablation: {name}", "B2 S512")
    ssd.LIBRARY = ssd_libs["committed"]


def ssd_against_parent(torch, cs, ssd, ssd_libs, inputs, gen) -> None:
    for key, (a, reset) in inputs.items():   # the earlier kernel agrees
        y0, s0 = parent_ssd(ssd_libs["earlier"])(*a, reset=reset)
        y1, s1 = ssd.ssd_scan_cuda(*a, reset=reset)
        log(f"  ssd {key}: committed vs earlier, max abs diff y "
            f"{float((y0.float() - y1.float()).abs().max()):.3e}, state "
            f"{float((s0 - s1).abs().max()):.3e}; plan {ssd.plan(*a[0].shape[:3], 64)}")

    def ssd_case(key):
        a, reset = inputs[key]

        def make(which):
            if which == "earlier":
                fn = parent_ssd(ssd_libs["earlier"])
                return lambda: fn(*a, reset=reset)
            return lambda: ssd.ssd_scan_cuda(*a, reset=reset)
        return make
    in_turns(torch, "ssd", {"earlier": "earlier", "committed": "committed"},
             {key: ssd_case(key) for key in inputs})
    # the earlier kernel on a second draw of the same shape
    a2 = cs.ssd_inputs(torch, gen, 2, 512, 64, 64, 1, 128, torch.bfloat16)
    fn = parent_ssd(ssd_libs["earlier"])
    log(f"  ssd earlier, B2 S512, second draw: "
        f"{cs.device_ms(torch, lambda: fn(*a2), 50):.4f} ms")


def rglru_part(torch, cs, rg, ref, rg_libs, rg_inputs) -> None:
    """The RG-LRU scan, earlier and committed, in turns, and with the L2
    flushed before each call."""
    for key, (x, a, reset) in rg_inputs.items():
        outs = {}
        for name, lib in rg_libs.items():
            rg.LIBRARY = lib
            outs[name] = rg.rglru_scan_cuda(x, a, reset=reset)
        rg.LIBRARY = rg_libs["committed"]
        want = ref.rglru_scan_ref(x, a, reset)
        log(f"  rglru {key}: max abs diff committed vs earlier "
            f"{float((outs['committed'] - outs['earlier']).abs().max()):.3e}, "
            f"committed vs plain "
            f"{float((outs['committed'] - want).abs().max()):.3e}; plan "
            f"{rg.plan(*x.shape)}, {rg.blocks(*x.shape)} blocks")

    def case(key):
        x, a, reset = rg_inputs[key]

        def make(lib):
            rg.LIBRARY = lib
            return lambda: rg.rglru_scan_cuda(x, a, reset=reset)
        return make
    cases = {key: case(key) for key in rg_inputs}
    in_turns(torch, "rglru", rg_libs, cases)
    x, a, _ = rg_inputs["B2 S512"]
    for name in ("earlier", "committed", "committed", "earlier"):
        rg.LIBRARY = rg_libs[name]
        ms = cs.flushed_device_ms(torch, lambda: rg.rglru_scan_cuda(x, a), 50,
                                  "rglru")
        log(f"  rglru {name:24s} B2 S512, L2 flushed before each call: "
            f"{ms:.4f}")
    rg.LIBRARY = rg_libs["committed"]


def harness_part(torch, cs, ssd, rg, ref, rg_libs, copies, inputs,
                 rg_inputs) -> None:
    """The same kernels on the same tensors through both harnesses, then
    through ``device_ms`` with one thing varied at a time; then
    ``chip_smoke.scan_phase`` itself in this process (with the committed
    and with the earlier RG-LRU kernel), and ``device_ms`` once more
    after it."""
    import time
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    ssd_args, _ = inputs["B2 S512"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    ssd_args2 = cs.ssd_inputs(torch, gen, 2, 512, 64, 64, 1, 128,
                              torch.bfloat16)
    rg2 = {key: cs.rglru_inputs(torch, gen, *x.shape, torch.float32)
           for key, (x, _, _) in rg_inputs.items()}

    def swapped(module, lib, fn):
        def call():
            keep, module.LIBRARY = module.LIBRARY, lib
            try:
                return fn()
            finally:
                module.LIBRARY = keep
        return call

    def rg_call(key, lib, draw=None):
        x, a, reset = rg_inputs[key]
        if draw is not None:
            x, a = draw[key]
        return swapped(rg, lib, lambda: rg.rglru_scan_cuda(x, a, reset=reset))
    # (the call, on a second draw, from a second build of the source)
    cases = {"ssd committed B2 S512 bf16": (
        lambda: ssd.ssd_scan_cuda(*ssd_args),
        lambda: ssd.ssd_scan_cuda(*ssd_args2),
        swapped(ssd, copies["ssd_scan"], lambda: ssd.ssd_scan_cuda(*ssd_args)))}
    for name in ("earlier", "committed"):
        for key in rg_inputs:
            lib = rg_libs[name]
            cases[f"rglru {name} {key}"] = (
                rg_call(key, lib), rg_call(key, lib, rg2),
                rg_call(key, copies["rglru_scan"]) if name == "committed"
                else None)

    def dropped_ms(fn, iters=50):
        """device_ms with each call's outputs freed before the next call
        (``device_ms`` keeps all ``iters`` outputs alive)."""
        fn()
        torch.cuda.synchronize()

        def run():
            for _ in range(iters):
                fn()
        rows, _ = cs.profiled(torch, run)
        return sum(e.device_time_total for e in rows) / 1e3 / iters

    with ClockSampler() as clock:
        def timed(label, case, run):
            t0 = time.time()
            ms = run()
            log(f"  harness {case:30s} {label:40s} {ms:.4f} ms; "
                f"{clock.window(t0, time.time())}")
        for case, (fn, fn_draw2, fn_copy) in cases.items():
            timed("chip_smoke.time_kernel", case, lambda: cs.time_kernel(
                torch, fn, fn, None, 1, 1, 1)["ms"])
            timed("in_turns (one run)", case, lambda: in_turns(
                torch, "harness", {"x": None}, {case: lambda _: fn}
            )["x"][case][0])
            timed("device_ms", case, lambda: cs.device_ms(torch, fn, 50))
            timed("device_ms, outputs freed each call", case,
                  lambda: dropped_ms(fn))

            def after_idle():
                time.sleep(1.0)
                return cs.device_ms(torch, fn, 50)
            timed("device_ms after 1 s idle", case, after_idle)

            def after_busy():
                busy(torch, BUSY_S)
                return cs.device_ms(torch, fn, 50)
            timed(f"device_ms after {BUSY_S} s busy", case, after_busy)

            def warm_100():
                for _ in range(99):
                    fn()
                return cs.device_ms(torch, fn, 50)
            timed("device_ms after 100 warm-up calls", case, warm_100)
            timed("device_ms, second input draw", case,
                  lambda: cs.device_ms(torch, fn_draw2, 50))
            if fn_copy is not None:
                timed("device_ms, build of a copy", case,
                      lambda: cs.device_ms(torch, fn_copy, 50))

            def after_pool():
                block = torch.empty(8 << 30, dtype=torch.uint8, device="cuda")
                del block
                return cs.device_ms(torch, fn, 50)
            timed("device_ms after 8 GB allocated, freed", case, after_pool)

            def after_empty_cache():
                torch.cuda.empty_cache()
                return cs.device_ms(torch, fn, 50)
            timed("device_ms after empty_cache()", case, after_empty_cache)

        for name in ("committed", "earlier"):
            rg.LIBRARY = rg_libs[name]
            t0 = time.time()
            out = cs.scan_phase(torch, ssd, rg, fa, da, ref)
            log(f"  harness chip_smoke.scan_phase, {name} RG-LRU: rglru B2 "
                f"S512 {out['rglru']['ms']:.4f} ms (flushed "
                f"{out['rglru']['l2_flushed_ms']:.4f}), B1 S32 pad 3 "
                f"{out['rglru_engine']['ms']:.4f}; ssd B2 S512 "
                f"{out['ssd']['ms']:.4f}, B1 S32 pad 3 "
                f"{out['ssd_engine']['ms']:.4f}; "
                f"{clock.window(t0, time.time())}")
        rg.LIBRARY = rg_libs["committed"]
        for case, (fn, _, _) in cases.items():
            timed("device_ms after scan_phase", case,
                  lambda: cs.device_ms(torch, fn, 50))

    # chip_smoke.py profiles ~100,000 kernels in phase 3 before it times
    # any scan: do the same, then count the records later profiles keep
    from torch.profiler import ProfilerActivity, profile
    t = torch.zeros(16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(BIG_PROFILE):
            t.add_(1.0)
        torch.cuda.synchronize()
    for case, (fn, _, _) in cases.items():
        fn()
        torch.cuda.synchronize()
        rows, _ = cs.profiled(torch, lambda: [fn() for _ in range(50)])
        kept = sum(e.count for e in rows)
        launched = sum(-(-e.count // 50) * 50 for e in rows)
        log(f"  harness {case:30s} after a profile of {BIG_PROFILE:,} kernels: "
            f"{kept} of {launched} kernel records kept; records' sum / 50 "
            f"{sum(e.device_time_total for e in rows) / 1e3 / 50:.4f} ms, "
            f"chip_smoke.per_call_ms {cs.per_call_ms(rows, 50):.4f} ms")


if __name__ == "__main__":
    sys.exit(main())
