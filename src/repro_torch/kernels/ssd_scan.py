"""CUDA Mamba2 SSD chunked scan.

The Hopper kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_pallas``.  It is built on first use
through ``kernels._build`` and launched on PyTorch's current stream.  The
plain version is ``kernels.ref.ssd_scan_ref``.  One block walks one
(head, batch row) in tiles of ``TILE`` steps with the state in shared
memory; the tile is a tiling choice and any S is taken as it is.

``ssd_scan_cuda.launches`` counts launches: it rises by one each time the
wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                      # steps a block takes at a time (csrc kTile)
MAX_SHARED = 232_448           # bytes of shared memory a Hopper block may use


def shared_bytes(n: int, p: int) -> int:
    """Dynamic shared memory of one block: the state, the tile's x, B, C
    (rows padded by 4) and decay weights, and the per-step rows (the
    float64 prefix sums count twice)."""
    return 4 * (n * p + TILE * p + 2 * TILE * (n + 4) + TILE * (TILE + 4)
                + 6 * TILE)


def op_count(batch: int, s: int, heads: int, p: int, n: int,
             tile: int = TILE) -> int:
    """Float operations of the chunked form at ``tile`` steps, causal
    triangle only: per tile of L steps, C.B^T and W.x over L(L+1)/2 pairs,
    C.M and the state update over L x N x P, and the D skip."""
    total = 0
    for t0 in range(0, s, tile):
        L = min(tile, s - t0)
        pairs = L * (L + 1) // 2
        total += 2 * pairs * (n + p) + 4 * L * n * p + 2 * L * p
    return batch * heads * total


def byte_count(batch: int, s: int, heads: int, p: int, groups: int, n: int,
               itemsize: int, reset: bool) -> int:
    """Bytes the scan must move: x, B, C read and y written in the input
    type, dt read and the state written in float32, a_log and d_skip, and
    the reset row."""
    return (2 * batch * s * heads * p * itemsize
            + 2 * batch * s * groups * n * itemsize
            + batch * s * heads * 4 + 2 * heads * 4
            + batch * heads * n * p * 4 + (batch * s if reset else 0))


def _bind(lib) -> None:
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("ssd_scan", _build.CSRC / "ssd_scan.cu", _bind)


def ssd_scan_cuda(x, dt, a_log, b, c, d_skip, *, reset=None):
    """x (B, S, H, P), dt (B, S, H) float32, a_log and d_skip (H,) float32,
    b and c (B, S, G, N) of x's dtype, ``reset`` (B, S) bool -> (y (B, S, H,
    P) in x's dtype, final state (B, H, N, P) float32).  Semantics of
    ``ref.ssd_scan_ref`` at any chunk; S need not be a multiple of
    anything."""
    if x.dim() != 4 or b.dim() != 4 or c.shape != b.shape:
        raise ValueError(f"x must be (B, S, H, P) and b, c (B, S, G, N); got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, s) or g == 0 or h % g:
        raise ValueError(f"b {tuple(b.shape)} does not fit x {tuple(x.shape)}"
                         f": need (B, S, G, N) with G dividing H")
    if dt.shape != (bsz, s, h) or a_log.shape != (h,) or d_skip.shape != (h,):
        raise ValueError("dt must be (B, S, H) and a_log, d_skip (H,)")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"x, b, c must share one of {list(DTYPES)}, got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a_log, d_skip)):
        raise ValueError("dt, a_log and d_skip must be float32")
    if n % 4 or p % 4 or s == 0:
        raise ValueError(f"N {n} and P {p} must be multiples of 4, S > 0")
    if shared_bytes(n, p) > MAX_SHARED:
        raise ValueError(f"N {n} x P {p} needs {shared_bytes(n, p)} bytes of "
                         f"shared memory; a block has {MAX_SHARED}")
    tensors = [x, dt, a_log, b, c, d_skip]
    if reset is not None:
        if reset.shape != (bsz, s) or reset.dtype != torch.bool:
            raise ValueError(f"reset must be a ({bsz}, {s}) bool tensor")
        tensors.append(reset)
    for t in tensors:      # read element by element: no wider alignment
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("every input must lie on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("every input must be contiguous")
    lib = LIBRARY.load()
    y = torch.empty_like(x)
    state = torch.empty(bsz, h, n, p, dtype=torch.float32, device=x.device)
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(),
        None if reset is None else reset.data_ptr(), y.data_ptr(),
        state.data_ptr(), bsz, s, h, g, n, p, DTYPES[x.dtype], device,
        torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err)
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
