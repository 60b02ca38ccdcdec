"""CUDA RG-LRU scan: h_t = a_t h_{t-1} + x_t over (B, S, R).

The Hopper kernel is ``csrc/rglru_scan.cu``; it replaces the TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan_pallas``.  It is built on first
use through ``kernels._build`` and launched on PyTorch's current stream.
The plain version is ``kernels.ref.rglru_scan_ref``.  One thread walks one
(batch row, channel) in order; any S is taken as it is.

``rglru_scan_cuda.launches`` counts launches: it rises by one each time the
wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def op_count(batch: int, s: int, width: int) -> int:
    """One multiply and one add a step per channel."""
    return 2 * batch * s * width


def byte_count(batch: int, s: int, width: int, itemsize: int,
               reset: bool) -> int:
    """x and a read, h written, in the input type; the reset row."""
    return 3 * batch * s * width * itemsize + (batch * s if reset else 0)


def _bind(lib) -> None:
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("rglru_scan", _build.CSRC / "rglru_scan.cu", _bind)


def rglru_scan_cuda(x, a, *, reset=None):
    """x, a (B, S, R) of one dtype, ``reset`` (B, S) bool -> h (B, S, R) in
    x's dtype, float32 inside."""
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"x and a must be one (B, S, R) shape, got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    if x.dtype not in DTYPES or a.dtype != x.dtype:
        raise ValueError(f"x and a must share one of {list(DTYPES)}, got "
                         f"{x.dtype} and {a.dtype}")
    bsz, s, r = x.shape
    if x.numel() == 0:
        raise ValueError("empty input")
    tensors = [x, a]
    if reset is not None:
        if reset.shape != (bsz, s) or reset.dtype != torch.bool:
            raise ValueError(f"reset must be a ({bsz}, {s}) bool tensor")
        tensors.append(reset)
    for t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("every input must lie on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("every input must be contiguous")
    lib = LIBRARY.load()
    out = torch.empty_like(x)
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    err = lib.rglru_scan_launch(
        x.data_ptr(), a.data_ptr(),
        None if reset is None else reset.data_ptr(), out.data_ptr(), bsz, s,
        r, DTYPES[x.dtype], device,
        torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err)
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0
