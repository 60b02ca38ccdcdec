#!/usr/bin/env python3
"""Two design choices of the port's attention kernels, measured on one GPU.

    python3 scripts/attention_variants.py

Each variant is the committed kernel source with one substitution, built
beside it into ``build/variants/``; both are timed in turns (committed,
variant, variant, committed) within this one process, so they share a card:

* flash attention with P rounded to a single bf16 in P V (the committed
  kernel splits P into hi + lo bf16 parts): device time at qwen3-0.6b's
  B2 S512 and recurrentgemma-2b's B2 S512 prefill shapes, and the share of
  the 2e-2 band that qwen3-0.6b's two-layer bf16 prefill logits use around
  the CPU's (``chip_smoke.card_vs_cpu``);
* decode attention with 8 KB K/V stages (the committed kernel: 16 KB):
  device time at qwen3's decode tick (dense and paged) and at
  recurrentgemma's 2048-slot ring.

It also counts the tensor-core instructions (HMMA) in the committed flash
library's SASS.  Needs CUDA and nvcc; exits nonzero without them.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FLASH_LO = ("        mma(o[d], c0, c1, c2, c3, b0, b1);\n"
            "        mma(o[d + 1], c0, c1, c2, c3, b2, b3);\n")
DECODE_STAGE = "16384 / (HD * static_cast<int>(sizeof(T)))"


def variant(lib_module, name: str, old: str, new: str, count: int):
    """A Library built from the committed source with ``old`` -> ``new``."""
    from repro_torch.kernels import _build
    src = lib_module.LIBRARY.source.read_text()
    if src.count(old) != count:
        raise SystemExit(f"{lib_module.LIBRARY.source.name}: expected {count} "
                         f"of {old!r}")
    path = _build.BUILD_DIR / "variants" / name / lib_module.LIBRARY.source.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(old, new))
    return _build.Library(lib_module.LIBRARY.name, path, lib_module._bind)


def in_turns(label, module, libs, cases):
    """Device ms of each case under each library, in the order a, b, b, a."""
    import torch
    import chip_smoke as cs
    order = list(libs) + list(libs)[::-1]
    for name in order:
        module.LIBRARY = libs[name]
        row = {case: round(cs.device_ms(torch, fn, 50), 4)
               for case, fn in cases.items()}
        print(f"{label} {name:18s} {row}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import serve_partitioned as sp
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    flash = {"hi + lo (committed)": fa.LIBRARY,
             "one bf16": variant(fa, "flash_one_bf16", FLASH_LO, "", 1)}
    decode = {"16 KB stages (committed)": da.LIBRARY,
              "8 KB stages": variant(da, "decode_8kb", DECODE_STAGE,
                                     DECODE_STAGE.replace("16384", "8192"), 3)}
    _build.build_all(list(flash.values()) + list(decode.values()))
    sass = subprocess.run(
        [str(pathlib.Path(_build.nvcc()).parent / "cuobjdump"), "-sass",
         str(fa.LIBRARY.path())], capture_output=True, text=True,
        check=True).stdout
    hmma = [line.split(";")[0].strip() for line in sass.splitlines()
            if "HMMA" in line]
    print(f"flash SASS: {len(hmma)} HMMA instructions, e.g. {hmma[0]}")

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {}
    for key, (b, s, h, kv, hd, w) in {
            "qwen3 B2 S512": (2, 512, 16, 8, 128, 0),
            "recurrentgemma B2 S512": (2, 512, 10, 1, 256, 2048)}.items():
        q, k, v = cs.attention_inputs(torch, gen, b, s, s, h, kv, hd,
                                      torch.bfloat16)
        kind = "local" if w else "causal"
        cases[key] = (lambda q=q, k=k, v=v, kind=kind, w=w:
                      fa.flash_attention_cuda(q, k, v, kind=kind, window=w))
    in_turns("flash", fa, flash, cases)
    for name, lib in flash.items():
        fa.LIBRARY = lib
        try:      # logs the share of the band its worst logit uses
            cs.card_vs_cpu(torch, sp.model_config(layers=2))
            print(f"flash {name}: within the band", flush=True)
        except SystemExit as failed:
            print(f"flash {name}: {failed}", flush=True)
    fa.LIBRARY = flash["hi + lo (committed)"]

    b, s, h, kv, hd = 8, 512, 16, 8, 128
    q, k, v = cs.attention_inputs(torch, gen, b, 1, s, h, kv, hd,
                                  torch.bfloat16)
    lens = torch.randint(8, 333, (b,), generator=gen, device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    pq, kp, vp, table = cs.paged_inputs(torch, gen, b, 32, 16, h, kv, hd,
                                        torch.bfloat16)
    seq_lens = (lens - 1).to(torch.int32)
    rq, rk, rv, rvalid = cs.ring_decode_inputs(torch, gen)
    in_turns("decode", da, decode, {
        "qwen3 tick dense": lambda: da.decode_attention_cuda(q, k, v, valid),
        "qwen3 tick paged": lambda: da.decode_attention_paged_cuda(
            pq, kp, vp, table, seq_lens),
        "ring": lambda: da.decode_attention_cuda(rq, rk, rv, rvalid)})
    for lib in decode.values():      # both right before either is kept
        da.LIBRARY = lib
        cs.check_ring_decode(torch, da, ref, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
