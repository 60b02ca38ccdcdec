"""CUDA RG-LRU scan: h_t = a_t h_{t-1} + x_t over (B, S, R).

The Hopper kernel is ``csrc/rglru_scan.cu``; it replaces the TPU kernel
``repro/kernels/rglru_scan.py::rglru_scan_pallas``.  It is built on first
use through ``kernels._build`` and launched on PyTorch's current stream.
The plain version is ``kernels.ref.rglru_scan_ref``.

One device kernel a call at any S.  A block owns a tile of channels and
splits S over its threads: a tile of ``segments`` x ``steps`` steps, each
thread one segment of ``steps`` steps of one channel (``plan``).  Each
thread reduces its segment to a composite pair (A = prod a, X = the
segment's scan from 0), the block scans the pairs over the segments to get
the h entering each one, and each thread replays its steps from that h.
Longer S is walked tile by tile, h carried across.  ``rglru_scan_segmented``
is a plain-torch mirror of those composites, carries and tiles, used by no
path: the CPU tests hold it against the reference.

``rglru_scan_cuda.launches`` counts launches: it rises by one each time the
wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 256              # threads a block at most (csrc kMaxThreads)
SMS = 132                      # an H100's SMs


def plan(batch: int, s: int, width: int) -> tuple[int, int, int]:
    """(channels, segments, steps) of a block: the kernel launches
    ceil(R / channels) x B blocks of channels x segments threads, each
    thread taking ``steps`` steps of a tile of segments x steps.  16
    channels a block (a warp's loads: two rows of 64 contiguous bytes in
    float32) unless that would give more than two blocks an SM anyway;
    4 steps a thread where one tile of them covers S, else 8; as many
    segments as S needs, up to MAX_THREADS threads.  A recurrentgemma solo
    prefill, B1 S32 R2560: 160 blocks of 16 x 8 threads, one tile; B2
    S512: 320 blocks of 16 x 16, four tiles of 128 steps.  csrc
    ``make_plan`` computes the same; keep the two in step."""
    channels = 32 if batch * -(-width // 32) >= 2 * SMS else 16
    steps = 4 if s <= 4 * (MAX_THREADS // channels) else 8
    segments = min(MAX_THREADS // channels, -(-s // steps))
    return channels, segments, steps


def blocks(batch: int, s: int, width: int) -> int:
    """Blocks one launch takes."""
    return -(-width // plan(batch, s, width)[0]) * batch


def rglru_scan_segmented(x, a, reset=None, *, segments: int, steps: int):
    """Plain torch mirror of the kernel's algebra at ``segments`` x
    ``steps`` steps a tile, any S (steps past S are x = 0, a = 1, which
    leave h as it is).  Per tile: (1) each segment's composite, A = prod
    a_t and X = its scan from h = 0, with a_t = 0 at a reset, so that no
    history crosses one; (2) serially over the segments, the h entering
    each, h <- X + A h from the h the last tile left; (3) each segment's
    steps replayed from its entering h.  Returns h in x's dtype."""
    bsz, s, r = x.shape
    a32, x32 = a.float(), x.float()
    if reset is not None:
        a32 = torch.where(reset[:, :, None], 0.0, a32)
    tile = segments * steps
    n_tiles = -(-s // tile)
    pad = n_tiles * tile - s
    x32 = torch.cat([x32, x32.new_zeros(bsz, pad, r)], 1)
    a32 = torch.cat([a32, a32.new_ones(bsz, pad, r)], 1)
    xs = x32.reshape(bsz, n_tiles, segments, steps, r)
    as_ = a32.reshape(bsz, n_tiles, segments, steps, r)
    out = torch.empty_like(xs)
    carry = x32.new_zeros(bsz, r)
    for k in range(n_tiles):
        xt, at = xs[:, k], as_[:, k]                       # (B, W, T, R)
        # (1) the composites of the tile's segments
        comp_a = x32.new_ones(bsz, segments, r)
        comp_x = x32.new_zeros(bsz, segments, r)
        for u in range(steps):
            comp_x = at[:, :, u] * comp_x + xt[:, :, u]
            comp_a = at[:, :, u] * comp_a
        # (2) the h entering each segment
        h, entering = carry, []
        for j in range(segments):
            entering.append(h)
            h = comp_a[:, j] * h + comp_x[:, j]
        carry = h
        # (3) the replay
        h = torch.stack(entering, 1)
        for u in range(steps):
            h = at[:, :, u] * h + xt[:, :, u]
            out[:, k, :, u] = h
    return out.reshape(bsz, n_tiles * tile, r)[:, :s].to(x.dtype)


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
