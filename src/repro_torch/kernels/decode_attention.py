"""CUDA decode attention: one query token's GQA attention against a cache
under a (B, S) validity mask.

The Hopper kernel is ``csrc/decode_attention.cu``; it replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas``.  It is built
on first use through ``kernels._build`` and launched on PyTorch's current
stream.  The plain version is ``kernels.ref.decode_attention_ref``.

``decode_attention_cuda.launches`` counts launches: it rises by one each
time the wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPES, check_qkv


def _bind(lib) -> None:
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("decode_attention",
                         _build.CSRC / "decode_attention.cu", _bind)


def decode_attention_cuda(q, k, v, valid_mask):
    """q (B, 1, H, hd), k/v (B, S, KV, hd), valid_mask (B, S) bool ->
    (B, 1, H, hd) in q's dtype.  A row with no valid key gets the uniform
    average of its S values (the reference's semantics)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    check_qkv(q, k, v)
    b, _, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    if (valid_mask.shape != (b, s) or valid_mask.dtype != torch.bool
            or valid_mask.device != q.device
            or not valid_mask.is_contiguous()):
        raise ValueError(f"valid_mask must be a contiguous ({b}, {s}) bool "
                         f"tensor on {q.device}")
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    device = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_mask.data_ptr(),
        out.data_ptr(), b, s, h, kv, hd, DTYPES[q.dtype], 1.0 / (hd ** 0.5),
        device, torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
