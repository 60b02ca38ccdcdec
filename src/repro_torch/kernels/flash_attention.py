"""CUDA flash attention for prefill (GQA; causal, local or full; per-row
left pad).

The Hopper kernel is ``csrc/flash_attention.cu``; it replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.  bf16 inputs
run on the tensor cores (``mma.sync``), float32 inputs on the CUDA cores in
full float32.  It is built on first use through ``kernels._build`` and
launched on PyTorch's current stream.  The plain version is
``kernels.ref.flash_attention_ref``.

``flash_attention_cuda.launches`` counts launches: it rises by one each time
the wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KINDS = {"causal": 0, "local": 1, "full": 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP = 64          # query heads per kv head: the rows of one block


def _bind(lib) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("flash_attention", _build.CSRC / "flash_attention.cu",
                         _bind)


def check_qkv(q, k, v) -> None:
    """Raise unless q (B, Sq, H, hd) and k, v (B, Sk, KV, hd) are what the
    attention kernels take: one supported dtype and head dim, KV dividing
    H, non-empty, contiguous and 16-byte aligned on one CUDA device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Sk, KV, {hd}) for q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    kv = k.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads over {kv} kv heads: need a "
                         f"multiple")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k, v must be contiguous and 16-byte aligned")


def flash_attention_cuda(q, k, v, *, kind: str = "causal", window: int = 0,
                         pad=None):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    ``pad`` (B,) int32 on the same device: row b's keys below ``pad[b]`` are
    masked (left-padded prompts).  A query row that sees no key comes out
    as zeros.  Sq and Sk may differ and need not be multiples of anything.
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    check_qkv(q, k, v)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if pad is not None:
        if (pad.shape != (b,) or pad.dtype != torch.int32
                or pad.device != q.device or not pad.is_contiguous()):
            raise ValueError(f"pad must be a contiguous ({b},) int32 tensor "
                             f"on {q.device}")
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    device = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if pad is None else pad.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kv, hd, DTYPES[q.dtype], KINDS[kind], int(window),
        1.0 / (hd ** 0.5), device, torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def live_pairs(batch: int, sq: int, sk: int, kind: str, window: int = 0,
               pad=None) -> int:
    """(query position, key) pairs the function needs, summed over the
    batch: the keys each query of each row may see (``pad``: the rows'
    left-pad counts).  Multiply by 4 * H * hd for its flops."""
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(sk)[None, :]
    seen = torch.ones(sq, sk, dtype=torch.bool)
    if kind != "full":
        seen = kj <= qi
        if kind == "local":
            seen = seen & (kj > qi - window)
    if pad is None:
        return batch * int(seen.sum())
    return sum(int((seen & (kj >= int(p))).sum()) for p in pad)
