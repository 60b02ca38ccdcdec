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

The backward (``rglru_scan_backward_cuda``, the same source and kernel run
from the end of the sequence) gives dx and da from dh and the forward's h:
the reverse scan g_t = dh_t + a_{t+1} g_{t+1}, no carry into t where a
reset fires at t + 1, with dx = g and da_t = g_t h_{t-1} fused into the
replay.  ``RglruScan`` is the autograd Function ``ops.rglru_scan`` runs on
CUDA where a gradient is wanted; it saves h rather than recomputing it.
``rglru_scan_backward_segmented`` mirrors the reverse composites in plain
torch, used by no path.  ``rglru_scan_backward_cuda.launches`` counts its
launches.
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


def _segmented(x32, a32, segments: int, steps: int):
    """The kernel's algebra over float32 x, a (B, S, R), a = 0 where a
    reset fires, at ``segments`` x ``steps`` steps a tile (steps past S are
    x = 0, a = 1, which leave h as it is).  Per tile: (1) each segment's
    composite, A = prod a_t and X = its scan from h = 0; (2) serially over
    the segments, the h entering each, h <- X + A h from the h the last
    tile left; (3) each segment's steps replayed from its entering h."""
    bsz, s, r = x32.shape
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
    return out.reshape(bsz, n_tiles * tile, r)[:, :s]


def rglru_scan_segmented(x, a, reset=None, *, segments: int, steps: int):
    """Plain torch mirror of the kernel's algebra at ``segments`` x
    ``steps`` steps a tile, any S: the composites, the carry over segments
    and tiles and the replay (``_segmented``), with a_t = 0 at a reset, so
    that no history crosses one.  Returns h in x's dtype."""
    a32 = a.float()
    if reset is not None:
        a32 = torch.where(reset[:, :, None], 0.0, a32)
    return _segmented(x.float(), a32, segments, steps).to(x.dtype)


def rglru_scan_backward_segmented(dh, a, h, reset=None, *, segments: int,
                                  steps: int):
    """Plain torch mirror of the backward kernel: the reverse scan g_t =
    dh_t + a_{t+1} g_{t+1}, with a_{t+1} = 0 where a reset fires at t + 1
    (nothing of step t + 1's gradient reaches t across it), run from the
    end of the sequence with the forward's composites, carries and replay
    (``_segmented`` on the reversed sequence).  Returns (dx, da) in the
    input dtypes: dx_t = g_t and da_t = g_t h_{t-1}, 0 at a reset and at
    t = 0; ``h`` is the forward's output."""
    bsz, s, r = dh.shape
    a32 = a.float()
    nxt = torch.cat([a32[:, 1:], a32.new_zeros(bsz, 1, r)], 1)
    prev = torch.cat([h.float().new_zeros(bsz, 1, r), h.float()[:, :-1]], 1)
    if reset is not None:
        cut = torch.cat([reset[:, 1:], reset.new_zeros(bsz, 1)], 1)
        nxt = torch.where(cut[:, :, None], 0.0, nxt)
        prev = torch.where(reset[:, :, None], 0.0, prev)
    g = _segmented(dh.float().flip(1), nxt.flip(1), segments, steps).flip(1)
    return g.to(dh.dtype), (g * prev).to(a.dtype)


def op_count(batch: int, s: int, width: int) -> int:
    """One multiply and one add a step per channel."""
    return 2 * batch * s * width


def byte_count(batch: int, s: int, width: int, itemsize: int,
               reset: bool) -> int:
    """x and a read, h written, in the input type; the reset row."""
    return 3 * batch * s * width * itemsize + (batch * s if reset else 0)


def backward_op_count(batch: int, s: int, width: int) -> int:
    """One multiply and one add a step per channel for g, one multiply for
    da."""
    return 3 * batch * s * width


def backward_byte_count(batch: int, s: int, width: int, itemsize: int,
                        reset: bool) -> int:
    """dh, a and h read, dx and da written, in the input type; the reset
    row."""
    return 5 * batch * s * width * itemsize + (batch * s if reset else 0)


def _bind(lib) -> None:
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.rglru_scan_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("rglru_scan", _build.CSRC / "rglru_scan.cu", _bind)


def _check(tensors, reset) -> tuple:
    """Every tensor of the first's (B, S, R) shape and dtype on its CUDA
    device, contiguous; ``reset`` (B, S) bool or None.  Returns (B, S,
    R)."""
    x = tensors[0]
    if x.dim() != 3 or any(t.shape != x.shape for t in tensors):
        raise ValueError(f"x and a must be one (B, S, R) shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"x and a must share one of {list(DTYPES)}, got "
                         f"{[t.dtype for t in tensors]}")
    if x.numel() == 0:
        raise ValueError("empty input")
    bsz, s, r = x.shape
    if reset is not None:
        if reset.shape != (bsz, s) or reset.dtype != torch.bool:
            raise ValueError(f"reset must be a ({bsz}, {s}) bool tensor")
        tensors = [*tensors, reset]
    for t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("every input must lie on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("every input must be contiguous")
    return bsz, s, r


def _launch_args(x):
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return (DTYPES[x.dtype], device,
            torch.cuda.current_stream(x.device).cuda_stream)


def rglru_scan_cuda(x, a, *, reset=None):
    """x, a (B, S, R) of one dtype, ``reset`` (B, S) bool -> h (B, S, R) in
    x's dtype, float32 inside."""
    bsz, s, r = _check([x, a], reset)
    lib = LIBRARY.load()
    out = torch.empty_like(x)
    err = lib.rglru_scan_launch(
        x.data_ptr(), a.data_ptr(),
        None if reset is None else reset.data_ptr(), out.data_ptr(), bsz, s,
        r, *_launch_args(x))
    LIBRARY.check(err)
    rglru_scan_cuda.launches += 1
    return out


rglru_scan_cuda.launches = 0


def rglru_scan_backward_cuda(dh, a, h, *, reset=None):
    """dh, a and the forward's h (B, S, R) of one dtype, ``reset`` (B, S)
    bool -> (dx, da) of the same shape and dtype, float32 inside."""
    bsz, s, r = _check([dh, a, h], reset)
    lib = LIBRARY.load()
    dx, da = torch.empty_like(dh), torch.empty_like(dh)
    err = lib.rglru_scan_backward_launch(
        dh.data_ptr(), a.data_ptr(), h.data_ptr(),
        None if reset is None else reset.data_ptr(), dx.data_ptr(),
        da.data_ptr(), bsz, s, r, *_launch_args(dh))
    LIBRARY.check(err)
    rglru_scan_backward_cuda.launches += 1
    return dx, da


rglru_scan_backward_cuda.launches = 0


class RglruScan(torch.autograd.Function):
    """The RG-LRU kernel with the backward kernel as its gradient.  The
    forward saves a, its output h and the reset, which is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, a, reset):
        h = rglru_scan_cuda(x, a, reset=reset)
        ctx.save_for_backward(a, h, reset)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, reset = ctx.saved_tensors
        dx, da = rglru_scan_backward_cuda(dh.contiguous(), a, h, reset=reset)
        return dx, da, None
