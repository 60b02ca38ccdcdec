#!/usr/bin/env python3
"""The bf16 SSD-scan backward beside an earlier build of it, on one GPU.

    python3 scripts/ssd_backward_turns.py --parent DIR [--variants] [--sass-dir DIR]

``DIR`` is an unpacked tree of the commit whose kernel to compare with
(``mkdir -p build/ssd_parent && git archive <commit> src/repro_torch/kernels/csrc
| tar -x -C build/ssd_parent``).  Its ``ssd_scan.cu`` is built beside the
committed one into ``build/`` (both export ``ssd_scan_backward_launch``
with one C signature, so ``ssd_scan_backward_cuda`` serves both) and the
two backwards are timed in turns (earlier, committed, committed, earlier)
within this one process, so they share a card.  Device time per call is
torch.profiler's kernel time, mean of 50 calls (``chip_smoke.device_ms``).

Shape: mamba2-1.3b's training microbatch, B4 S512 H64 P64 G1 N128 bf16,
y's cotangent only (as a training step gives it).  Printed: the card's name
and power limit; for both builds the registers, spills and shared memory
``ptxas`` reports for the backward's kernels and the HMMA instructions of
each kernel in the SASS (saved under ``--sass-dir``, default
``build/sass``); the committed kernel's blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); the committed
backward through ``chip_smoke.time_ssd_bwd`` (beside the plain version's
autograd and the bound); the largest difference between the two builds'
gradients; each device kernel's time per build; and the turns.
``--variants`` adds the builds of ``VARIANTS`` (ablations of the committed
source) to the turns.  The report lands in ``build/ssd_backward_turns.json``.
Needs CUDA and nvcc; exits nonzero without them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPE = (4, 512, 64, 64, 1, 128)       # b, s, h, p, g, n
TURNS = 2        # rounds of (earlier, committed, committed, earlier)
# ``--variants``: the committed source with one change each (every
# occurrence of the first string replaced by the second), built and timed in
# turns beside it.  An ablation drops one part of the bf16 chunk-gradient
# kernel (chunk_backward_tc): its gradients are wrong by design, and its time
# says what that part costs.
VARIANTS = {
    "ablation: dX without B D": [
        ("      if (dm != nullptr) {\n        // B D:",
         "      if (false) {\n        // B D:")],
    "ablation: dB and dC without the state products": [
        ("      state_row_products(adb, adc, xs, dys, L.ldx, dm, mp, dmdot, n0 + g, n, p);",
         "")],
    "ablation: no products over the causal tiles": [
        ("for (int qt = mt; qt < 4; ++qt) {", "for (int qt = 4; qt < 4; ++qt) {"),
        ("for (int rt = 0; rt <= mt; ++rt) {", "for (int rt = 0; rt < 0; ++rt) {")],
    "ablation: no S and dS products": [
        ("      tc::mma(sc[k][0], a0, a1, a2, a3, b0, b1);\n"
         "      tc::mma(sc[k][1], a0, a1, a2, a3, b2, b3);", ""),
        ("      tc::mma(ds[k][0], a0, a1, a2, a3, b0, b1);\n"
         "      tc::mma(ds[k][1], a0, a1, a2, a3, b2, b3);", "")],
}
# the backward's kernels, by a piece of their mangled names
BACKWARD_KERNELS = ("chunk_backward", "chunk_adjoint", "chunk_kernel",
                    "adjoint_pass", "state_pass", "grad_reduce")


def log(msg: str) -> None:
    print(msg, flush=True)


def short(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled name."""
    m = re.search(r"\d+(chunk_\w+?|adjoint_pass|state_pass|grad_reduce)"
                  r"(?=[IEN]|$)", mangled)
    if not m:
        return mangled
    rest, args = mangled[m.end():], []
    if rest.startswith("I"):
        for tok in re.finditer(r"13__nv_bfloat16|f|Li(\d+)E|Lb([01])E|E",
                               rest[1:]):
            if tok.group(0) == "E":
                break
            args.append(tok.group(1) or {"0": "false", "1": "true"}.get(
                tok.group(2)) or {"f": "float"}.get(tok.group(0), "bf16"))
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_lines(log_text: str) -> list[str]:
    """ptxas's lines for the backward's kernels: the function, then its
    spill line and its register and shared memory line."""
    out, keep = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            keep = any(k in name for k in BACKWARD_KERNELS)
            if keep:
                out.append(short(name))
        elif keep and ("registers" in line or "spill" in line):
            out.append("    " + line.strip())
    return out


def hmma_counts(lib, out_dir: pathlib.Path, label: str) -> dict:
    """HMMA instructions of each backward kernel in ``lib``'s SASS
    (cuobjdump; the listing is saved under ``out_dir``)."""
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"ssd_scan_{label}.sass").write_text(text)
    counts = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if any(k in name for k in BACKWARD_KERNELS):
            counts[short(name)] = len(re.findall(r"\bHMMA\b", block))
    return counts


def variant(lib, name: str, subs):
    """A Library built from ``lib``'s source with each (old, new) of
    ``subs`` applied to every occurrence of old."""
    from repro_torch.kernels import _build
    src = lib.source.read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{lib.source.name}: no {old!r}")
        src = src.replace(old, new)
    src += f"\n// {name}\n"        # another hash: built anew
    path = _build.BUILD_DIR / "variants" / re.sub(r"\W+", "_", name) / \
        lib.source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return _build.Library(lib.name, path, lib._bind)


def per_kernel_ms(torch, cs, fn) -> dict:
    """Device ms per call of each device kernel ``fn`` launches, by its
    name and template arguments."""
    fn()
    torch.cuda.synchronize()
    rows, _ = cs.profiled(torch, lambda: [fn() for _ in range(50)])
    named = lambda key: "".join(re.search(r"(\w+)(<[^()]*>)?\(", key).groups(""))
    return {named(r.key): round(cs.per_call_ms([r], 50), 4) for r in rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, required=True)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sass-dir", type=pathlib.Path,
                    default=ROOT / "build" / "sass")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ssd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    source = (args.parent / "src" / "repro_torch" / "kernels" / "csrc"
              / "ssd_scan.cu")
    libs = {"earlier": _build.Library("ssd_scan", source, ssd._bind),
            "committed": ssd.LIBRARY}
    # both sources once more under a marker comment, so that ptxas reports
    # on them here even where an earlier run built them
    copies = {}
    for name, lib in libs.items():
        path = _build.BUILD_DIR / "ptxas_report" / name / "ssd_scan.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(lib.source.read_text() + f"\n// {name}, for ptxas\n")
        copies[name] = _build.Library("ssd_scan", path, ssd._bind)
    builds = dict(libs)
    if args.variants:
        builds.update({name: variant(ssd.LIBRARY, name, subs)
                       for name, subs in VARIANTS.items()})
    _build.build_all(list(builds.values()) + list(copies.values()))
    report = {"card": smi, "ptxas": {}, "hmma": {}}
    for name, lib in libs.items():
        lib.load()
        report["ptxas"][name] = ptxas_lines(copies[name].build_log)
        for line in report["ptxas"][name]:
            log(f"  ptxas {name}: {line}")
        report["hmma"][name] = hmma_counts(lib, args.sass_dir, name)
        log(f"  HMMA {name}: {report['hmma'][name]}")
    b, s, h, p, g, n = SHAPE
    report["blocks_per_sm"] = {
        dt: ssd.backward_blocks_per_sm(n, p, dtype)
        for dt, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32))}
    log(f"  committed chunk_backward blocks per SM at N{n} P{p}: "
        f"{report['blocks_per_sm']} ({ssd.backward_shared_bytes(n, p, 2)} B "
        f"bf16, {ssd.backward_shared_bytes(n, p)} B float32)")

    gen = torch.Generator(device="cuda").manual_seed(30)
    t = cs.time_ssd_bwd(torch, gen, *SHAPE)
    cs.log_timed("committed", t)
    report["timed"] = t
    inputs = cs.ssd_inputs(torch, gen, b, s, h, p, g, n, torch.bfloat16)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(
        torch.bfloat16)

    def call(lib):
        def run():
            saved, ssd.LIBRARY = ssd.LIBRARY, lib
            try:
                return ssd.ssd_scan_backward_cuda(*inputs, dy)
            finally:
                ssd.LIBRARY = saved
        return run

    got = {name: call(lib)() for name, lib in libs.items()}
    torch.cuda.synchronize()
    report["max_abs_diff"] = {
        k: float((a.float() - c.float()).abs().max())
        for k, a, c in zip(cs.SSD_GRAD_NAMES, got["earlier"], got["committed"])}
    log(f"  earlier vs committed, largest |difference| per gradient: "
        f"{report['max_abs_diff']}")
    report["per_kernel_ms"] = {}
    for name, lib in libs.items():
        report["per_kernel_ms"][name] = per_kernel_ms(torch, cs, call(lib))
        log(f"  {name}, per device kernel: {report['per_kernel_ms'][name]}")
    order = list(builds) + list(builds)[::-1]
    turns: dict = {name: [] for name in builds}
    for _ in range(TURNS):
        for name in order:
            ms = cs.device_ms(torch, call(builds[name]), 50)
            turns[name].append(round(ms, 4))
            log(f"  {name}: {ms:.4f} ms")
    report["turns"] = turns
    ratio = min(turns["earlier"]) / max(turns["committed"])
    log(f"  B{b} S{s} H{h} P{p} G{g} N{n} bf16 backward: " + ", ".join(
        f"{name} {min(v):.4f}-{max(v):.4f} ms" for name, v in turns.items())
        + f" ({ratio:.2f}x or more), bound {t['bound_ms']:.5f} ms "
        f"({t['bound_by']}); {smi}")
    out = ROOT / "build" / "ssd_backward_turns.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    log(f"report: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
