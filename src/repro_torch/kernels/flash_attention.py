"""CUDA flash attention for prefill and training (GQA; causal, local or
full; per-row left pad), forward and backward.

The Hopper kernels are ``csrc/flash_attention.cu``; the forward replaces the
TPU kernel ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The backward has no TPU counterpart (the reference differentiates only its
non-Pallas arm): it gives the gradients of plain attention, from the
forward's output and its rows' log-sum-exp.  bf16 inputs run on the tensor
cores (``mma.sync``), float32 inputs on the CUDA cores in full float32.
They are built on first use through ``kernels._build`` and launched on
PyTorch's current stream.  The plain version is
``kernels.ref.flash_attention_ref`` (autograd through it for the backward).

The bf16 backward is two launches: a dQ pass that also forms D =
rowsum(dO * O), then a dK/dV pass.  Each block streams its tiles through a
cp.async ring and splits every step into two phases: S and dP computed once
and shared through shared memory, then the outputs accumulated.  Blocks go
heaviest first, and a cluster of blocks splits the work where one block a
tile would leave the card idle (gemma3's hd 256 local layers).  What bounds
it on an H100 is the latency of its ``mma.sync`` products, fragment loads and
softmax, not the bytes (``scripts/flash_backward_turns.py`` times it, its
earlier build and each part).  No atomics: every element of dq, dk and dv
has one writer, so two calls on the same inputs agree bit for bit.

``flash_attention_cuda.launches`` and ``flash_attention_backward_cuda.
launches`` count launches: each rises by one each time its wrapper
launches its kernel, and nowhere else.  ``FlashAttention`` is the
``torch.autograd.Function`` that pairs them.
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
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
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


def _check_call(q, k, v, kind, pad) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    check_qkv(q, k, v)
    b, h, kv = q.shape[0], q.shape[2], k.shape[2]
    if h // kv > MAX_GROUP:
        raise ValueError(f"{h // kv} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if pad is not None:
        if (pad.shape != (b,) or pad.dtype != torch.int32
                or pad.device != q.device or not pad.is_contiguous()):
            raise ValueError(f"pad must be a contiguous ({b},) int32 tensor "
                             f"on {q.device}")


def _device_stream(t):
    device = t.device.index if t.device.index is not None \
        else torch.cuda.current_device()
    return device, torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_cuda(q, k, v, *, kind: str = "causal", window: int = 0,
                         pad=None, with_lse: bool = False):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's dtype.

    ``pad`` (B,) int32 on the same device: row b's keys below ``pad[b]`` are
    masked (left-padded prompts).  A query row that sees no key comes out
    as zeros.  Sq and Sk may differ and need not be multiples of anything.
    ``with_lse`` also returns the rows' log-sum-exp of the scaled scores,
    (B, H, Sq) float32, +inf on a row that sees no key: what the backward
    needs.
    """
    _check_call(q, k, v, kind, pad)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    device, stream = _device_stream(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if pad is None else pad.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, sq, sk, h, kv, hd, DTYPES[q.dtype], KINDS[kind], int(window),
        1.0 / (hd ** 0.5), device, stream)
    LIBRARY.check(err)
    flash_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def flash_attention_backward_cuda(q, k, v, out, lse, dout, *,
                                  kind: str = "causal", window: int = 0,
                                  pad=None):
    """(dq, dk, dv), shaped and typed as (q, k, v): the gradients of plain
    attention (``ref.flash_attention_ref``) at dout, from the forward's
    ``out`` and ``lse`` (``flash_attention_cuda(..., with_lse=True)``).
    A query row that sees no key gets dq = 0 and gives nothing to dk, dv.
    Deterministic: no atomics."""
    _check_call(q, k, v, kind, pad)
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and like q")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {sq}) float32 "
                         f"tensor on {q.device}")
    lib = LIBRARY.load()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    device, stream = _device_stream(q)
    err = lib.flash_attention_backward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if pad is None else pad.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, h, kv, hd, DTYPES[q.dtype], KINDS[kind], int(window),
        1.0 / (hd ** 0.5), device, stream)
    LIBRARY.check(err)
    flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """The flash kernel with the backward kernel as its gradient.  The
    forward saves q, k, v, out and lse; the pad is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kind, window, pad):
        out, lse = flash_attention_cuda(q, k, v, kind=kind, window=window,
                                        pad=pad, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, pad)
        ctx.kind, ctx.window = kind, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, pad = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_cuda(
            q, k, v, out, lse, dout.contiguous(), kind=ctx.kind,
            window=ctx.window, pad=pad)
        return dq, dk, dv, None, None, None


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
