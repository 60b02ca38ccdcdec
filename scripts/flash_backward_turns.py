#!/usr/bin/env python3
"""The bf16 flash-attention backward beside an earlier build of it, on one GPU.

    python3 scripts/flash_backward_turns.py --parent DIR [--variants] [--sass-dir DIR]

``DIR`` is an unpacked tree of the commit whose kernel to compare with
(``mkdir -p build/parent && git archive <commit> | tar -x -C build/parent``).
Its ``flash_attention.cu`` is built beside the committed one into ``build/``
(both export the same C interface, so one ``_bind`` serves both) and the two
backwards are timed in turns (earlier, committed, committed, earlier) within
this one process, so they share a card.  Device time per call is
torch.profiler's kernel time, mean of 50 calls, as ``chip_smoke.device_ms``
takes it (``chip_smoke.per_call_ms``: every device kernel of a call).

Shapes: qwen3-0.6b's training shape, B4 S512 H16/8 hd128 causal, and
gemma3-1b's local layers, B1 S1100 H4/1 hd256 window 1,024 (the inputs and
calls of ``chip_smoke.flash_bwd_calls``).  At each: the committed backward
through ``chip_smoke.time_kernel`` (beside the plain version's backward,
SDPA's backward and the bound), the largest difference between the two
builds' dq, dk and dv, each device kernel's time, and the turns.  Before
them: the card's name and power limit, the registers and spills ``ptxas``
reports for every backward kernel of both builds, and the committed bf16
kernels' SASS instruction mix (saved under ``--sass-dir``, default
``build/sass``).  ``--variants`` adds the builds of ``VARIANTS`` (design
alternatives and ablations of the committed source) to the turns.  The
report lands in ``build/flash_backward_turns.json``.  Needs CUDA and nvcc;
exits nonzero without them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPES = {"train B4 S512 hd128 causal": (4, 512, 16, 8, 128, "causal", 0),
          "gemma3 B1 S1100 hd256 local": (1, 1100, 4, 1, 256, "local", 1024)}
TURNS = 2        # rounds of (earlier, committed, committed, earlier)
# ``--variants``: the committed source with one change each (every
# occurrence of the first string replaced by the second), built, held to the
# committed build's dq, dk, dv and timed in turns beside it.  An ablation
# drops one part of a pass: its gradients are wrong by design, and its time
# says what that part costs.
DQ_PRODUCTS = ("    for (int kd = 0; kd < kKd; ++kd) {\n"
               "      uint32_t a0, a1, a2, a3, e0, e1, e2, e3;\n"
               "      const int at")
DKV_PRODUCTS = ("    for (int kd = 0; kd < kKd; ++kd) {\n"
                "      uint32_t a0, a1, a2, a3, e0, e1, e2, e3;\n"
                "      if constexpr (kRegs)")
VARIANTS = {
    "dK/dV ring of 2 stages": [
        ("constexpr int dkv_stages() { return HD <= 128 ? 3 : 2; }",
         "constexpr int dkv_stages() { return 2; }")],
    "dK/dV K and V fragments from shared memory": [
        ("constexpr bool kRegs = HD <= 128;", "constexpr bool kRegs = false;")],
    "exp2f for ex2.approx.ftz": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = exp2f(x);")],
    "ablation: dQ phase 1 without products": [
        (DQ_PRODUCTS, DQ_PRODUCTS.replace("kd < kKd", "kd < 0"))],
    "ablation: dQ without phase 2": [
        ("for (int kk = 0; kk < kKeysQ / 16; ++kk) {",
         "for (int kk = 0; kk < 0; ++kk) {")],
    "ablation: dK/dV phase 1 without products": [
        (DKV_PRODUCTS, DKV_PRODUCTS.replace("kd < kKd", "kd < 0"))],
    "ablation: dK/dV without phase 2": [
        ("for (int kk = 0; kk < kQueries / 16; ++kk) {",
         "for (int kk = 0; kk < 0; ++kk) {")],
    "ablation: dQ and dK/dV without the exponentials": [
        ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
         "y = x;")],
    "ablation: no barrier between the phases": [
        ("    __syncthreads();   // dS of the whole step is stored\n", ""),
        ("    __syncthreads();   // P^T and dS^T of the whole step are stored\n",
         "")],
    "ablation: no masks": [("        if (edge) {", "        if (false) {")],
    "ablation: dQ loads its first key tile only": [
        ("if (i + 1 < n_mine) load_tile(", "if (false) load_tile(")],
    "ablation: dK/dV loads its first steps only": [
        ("if (i + kStages - 1 < n_mine) load_step(", "if (false) load_step(")],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_lines(log_text: str) -> list[str]:
    """ptxas's lines for the backward kernels: the function line (its
    mangled name holds dq_kernel / dkv_kernel / delta_kernel) and the
    register and spill lines after it."""
    out, keep = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            keep = any(n in line for n in ("dq_kernel", "dkv_kernel",
                                           "delta_kernel"))
            if "Compiling" in line and keep:
                out.append(line.strip())
        elif keep and ("registers" in line or "spill" in line):
            out.append("    " + line.strip())
    return out


def variant(lib, name: str, subs):
    """A Library built from ``lib``'s source with each (old, new) of
    ``subs`` applied to every occurrence of old."""
    from repro_torch.kernels import _build
    src = lib.source.read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{lib.source.name}: no {old!r}")
        src = src.replace(old, new)
    src += f"\n// {name}\n"        # another hash: built anew, with its log
    path = _build.BUILD_DIR / "variants" / name.replace(" ", "_").replace(
        ",", "") / lib.source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return _build.Library(lib.name, path, lib._bind)


def sass_mix(lib, out_dir: pathlib.Path) -> list[str]:
    """The committed backward kernels' SASS (cuobjdump, saved under
    ``out_dir``): per bf16 dq/dkv kernel, its instructions and, in its
    longest loop (a step), the count of each kind that matters here."""
    import re
    from repro_torch.kernels import _build
    tool = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True).stdout
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_attention.sass").write_text(text)
    kinds = ("HMMA", "LDSM", "LDGSTS", "MUFU", "STS", "LDS", "BAR", "SHFL")
    lines = []
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "2tc" not in name or not re.search(r"(dq|dkv)_kernel", name):
            continue
        instr = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)
        addr = [int(a, 16) for a, _ in instr]
        longest: list = []
        for i, (_, op) in enumerate(instr):
            tgt = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if tgt and int(tgt.group(1), 16) <= addr[i]:
                body = [o for b, (_, o) in zip(addr, instr)
                        if int(tgt.group(1), 16) <= b <= addr[i]]
                longest = max(longest, body, key=len)
        opcodes = [o.split()[1] if o.startswith("@") else o.split()[0]
                   for o in longest]
        mix = {k: sum(op.split(".")[0] == k for op in opcodes) for k in kinds}
        short = re.search(r"(dq|dkv)_kernelILi(\d+)", name)
        lines.append(f"{short.group(1)}_kernel<{short.group(2)}>: {len(instr)} "
                     f"instructions; longest loop {len(longest)}: {mix}")
    return lines


def per_kernel_ms(torch, cs, fn) -> dict:
    """Device ms per call of each device kernel ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    rows, _ = cs.profiled(torch, lambda: [fn() for _ in range(50)])
    return {r.key[:60]: round(cs.per_call_ms([r], 50), 4) for r in rows}


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
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    source = (args.parent / "src" / "repro_torch" / "kernels" / "csrc"
              / "flash_attention.cu")
    libs = {"earlier": _build.Library("flash_attention", source, fa._bind),
            "committed": fa.LIBRARY}
    if args.variants:
        libs.update({name: variant(fa.LIBRARY, name, subs)
                     for name, subs in VARIANTS.items()})
    # the committed source once more under another name, so that ptxas
    # reports on it here even where an earlier run built it
    report_copy = variant(fa.LIBRARY, "committed copy", [])
    _build.build_all(list(libs.values()) + [report_copy])
    logs = {name: lib.build_log for name, lib in libs.items()}
    logs["committed"] = report_copy.build_log
    for name, lib in libs.items():
        lib.load()
        for line in ptxas_lines(logs[name]):
            log(f"  ptxas {name}: {line}")

    for line in sass_mix(report_copy, args.sass_dir):
        log(f"  sass committed: {line}")

    gen = torch.Generator(device="cuda").manual_seed(21)
    report = {"card": smi}
    for label, shape in SHAPES.items():
        calls, n_flops, n_bytes, desc = cs.flash_bwd_calls(torch, gen, *shape)
        got = {name: calls["kernel"](lib)() for name, lib in libs.items()}
        torch.cuda.synchronize()
        diffs = {name: max(float((a.float() - c.float()).abs().max())
                           for a, c in zip(got[name], got["committed"]))
                 for name in libs if name != "committed"}
        t = cs.time_kernel(torch, calls["kernel"](libs["committed"]),
                           calls["plain"], calls["library"], n_flops, n_bytes,
                           cs.PEAK_BF16_S)
        t["shape"] = desc
        cs.log_timed(f"committed ({label})", t)
        for name, d in diffs.items():
            log(f"    {name} vs committed: largest |difference| of dq, dk, "
                f"dv {d:.3e}")
        for name in libs:
            log(f"    {name}, per device kernel: "
                f"{per_kernel_ms(torch, cs, calls['kernel'](libs[name]))}")
        order = list(libs) + list(libs)[::-1]
        turns: dict = {name: [] for name in libs}
        for _ in range(TURNS):
            for name in order:
                ms = cs.device_ms(torch, calls["kernel"](libs[name]), 50)
                turns[name].append(round(ms, 4))
                log(f"  {label}: {name:9s} {ms:.4f} ms")
        sdpa = [round(cs.device_ms(torch, calls["library"], 50), 4)
                for _ in range(2)]
        log(f"  {label}: " + ", ".join(
            f"{name} {min(v):.4f}-{max(v):.4f} ms" for name, v in turns.items())
            + f", SDPA backward {min(sdpa):.4f}-{max(sdpa):.4f} ms, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']}); {smi}")
        report[label] = {"turns": turns, "sdpa_ms": sdpa, "timed": t,
                         "max_abs_diff": diffs}
    out = ROOT / "build" / "flash_backward_turns.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    log(f"report: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
