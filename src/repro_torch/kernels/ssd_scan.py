"""CUDA Mamba2 SSD chunked scan.

The Hopper kernel is ``csrc/ssd_scan.cu``; it replaces the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan_pallas``.  It is built on first use
through ``kernels._build`` and launched on PyTorch's current stream.  The
plain version is ``kernels.ref.ssd_scan_ref``.

The sequence is split over blocks in chunks of ``CHUNK`` steps (the SSD
dual decomposition; ``plan`` gives the chunks and the column groups of P).
A call issues one device kernel where S <= CHUNK (y and the final state of
one chunk, over (column group, head, batch row) blocks) and three
otherwise: the chunks' own states and carry factors into float32 scratch,
the serial pass over the chunks that turns them into the states entering
each chunk (for bf16 x already split into the hi and lo bf16 parts the
tensor cores take), and y.  The scratch is allocated per call with
``torch.empty`` (PyTorch's caching allocator, current stream).
``ssd_scan_chunked`` is a plain-torch mirror of those three passes, used by
no path: the CPU tests hold it against the reference to check the algebra
the state pass relies on.  Any S and any chunk: the chunk is a tiling
choice, not part of the result.

``ssd_scan_cuda.launches`` counts calls: it rises by one each time the
wrapper launches the call's kernels, however many device kernels that is,
and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64                     # steps a block takes (csrc kT)
TARGET_BLOCKS = 256            # about two blocks per SM of 132
MAX_SHARED = 232_448           # bytes of shared memory a Hopper block may use
MODES = ("one", "state", "scan")


def plan(batch: int, s: int, heads: int, p: int) -> tuple[int, int]:
    """(chunks, column groups of P) of a call.  P is split in halves while
    the chunk blocks number fewer than TARGET_BLOCKS and each group keeps a
    multiple of 16 columns (a tensor-core tile): 4 groups (256 blocks) at
    a mamba2 solo prefill, B 1 x H 64, where one group would leave half the
    SMs idle; 1 at B 2, S 512 (1,024 blocks)."""
    chunks = -(-s // CHUNK)
    groups = 1
    while (chunks * heads * batch * groups < TARGET_BLOCKS
           and p % (2 * groups) == 0 and (p // (2 * groups)) % 16 == 0):
        groups *= 2
    return chunks, groups


def kernels_per_call(s: int) -> int:
    """Device kernels one call issues: one chunk pass where S <= CHUNK,
    else the state pass, the serial pass over chunks and the output pass."""
    return 1 if s <= CHUNK else 3


def _up16(v: int) -> int:
    return (v + 15) // 16 * 16


def _after(at: int, nbytes: int) -> int:
    """The 16-byte-aligned offset after a region of nbytes at ``at``."""
    return (at + nbytes + 15) // 16 * 16


def shared_bytes(n: int, p: int, itemsize: int = 4, mode: str | None = None) -> int:
    """Dynamic shared memory of one chunk block (csrc ``layout``) for a
    column group of ``p`` columns, in the given mode, or the largest of the
    three modes: the per-step rows (float64 prefix sums, dt, the inter and
    coef factors, segment ids), the x, B and C tiles, and per mode the hi +
    lo parts of coef x or of the entering state, which the scan mode copies
    over B's tile once C.B^T is done (bf16, tiles padded to 16 and rows by
    8), or the decay weights and the entering state (float32, B/C rows
    padded by 4)."""
    if mode is None:
        return max(shared_bytes(n, p, itemsize, m) for m in MODES)
    at = 0
    for nbytes in (CHUNK * 8, CHUNK * 4, CHUNK * 4, CHUNK * 4, CHUNK * 4):
        at = _after(at, nbytes)
    if itemsize == 2:
        np_, pp = _up16(n), _up16(p)
        ldx, ldb = pp + 8, np_ + 8
        # the scan mode copies the entering state over B's tile
        sizes = [CHUNK * ldx * 2,
                 max(CHUNK * ldb * 2, 2 * np_ * ldx * 2) if mode == "scan"
                 else CHUNK * ldb * 2]
        if mode != "state":
            sizes += [CHUNK * ldb * 2]
        if mode != "scan":
            sizes += [CHUNK * ldx * 2, CHUNK * ldx * 2]
    else:
        ldb = n + 4
        sizes = [CHUNK * p * 4, CHUNK * ldb * 4]
        if mode != "state":
            sizes += [CHUNK * ldb * 4, CHUNK * (CHUNK + 4) * 4]
        if mode == "scan":
            sizes += [n * p * 4]
    for nbytes in sizes:
        at = _after(at, nbytes)
    return at


def op_count(batch: int, s: int, heads: int, p: int, n: int,
             tile: int = CHUNK) -> int:
    """Float operations of the chunked form at ``tile`` steps, causal
    triangle only: per tile of L steps, C.B^T and W.x over L(L+1)/2 pairs,
    C.M and the state update over L x N x P, and the D skip.  The work of
    the function, whatever passes implement it."""
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
    the reset row.  The chunk states' round trip through scratch is the
    design's cost, not the function's."""
    return (2 * batch * s * heads * p * itemsize
            + 2 * batch * s * groups * n * itemsize
            + batch * s * heads * 4 + 2 * heads * 4
            + batch * heads * n * p * 4 + (batch * s if reset else 0))


def ssd_scan_chunked(x, dt, a_log, b, c, d_skip, *, reset=None,
                     chunk: int = CHUNK):
    """Plain torch mirror of the kernel's three passes, any S (the last
    chunk is padded with dt = 0 rows, which add nothing).  Pass (a), per
    chunk: prefix sums ``cum`` of A dt (float64) and segment ids ``seg``
    (in-chunk resets so far), the chunk's own state S_c = sum_r [seg_r =
    seg_end] exp(total - cum_r) dt_r b_r x_r^T, its carry [no reset in the
    chunk] exp(total) and inter_q = [seg_q = 0] exp(cum_q).  Pass (b),
    serial over chunks: M_c = carry_c M_{c-1} + S_c.  Pass (c): y = W x +
    inter (C M_{c-1}) + D x with W = (C B^T) exp(cum_q - cum_r) dt_r on
    r <= q, same segment.  Returns (y in x's dtype, final state float32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def chunks(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bsz, pad) + tuple(t.shape[2:]))], 1)
        return t.reshape((bsz, nc, chunk) + tuple(t.shape[2:]))

    xc, dtc = chunks(x), chunks(dt)                          # (B,C,Q,H,P)
    bc = chunks(b).repeat_interleave(h // g, dim=3)          # (B,C,Q,H,N)
    cc = chunks(c).repeat_interleave(h // g, dim=3)
    rc = (torch.zeros(bsz, nc, chunk, dtype=torch.int64, device=x.device)
          if reset is None else chunks(reset).long())
    a = -torch.exp(a_log.float())
    cum = torch.cumsum((a * dtc).double(), dim=2)            # (B,C,Q,H)
    seg = torch.cumsum(rc, dim=2)                            # (B,C,Q)
    total, seg_end = cum[:, :, -1], seg[:, :, -1]

    # (a) the chunk's own state, carry and inter factors
    coef = (torch.exp(total[:, :, None] - cum).float() * dtc
            * (seg == seg_end[..., None])[..., None])        # (B,C,Q,H)
    s_c = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", coef, bc, xc)
    carry = torch.exp(total).float() * (seg_end == 0)[..., None]   # (B,C,H)
    inter = torch.exp(cum).float() * (seg == 0)[..., None]   # (B,C,Q,H)

    # (b) the states entering each chunk, serial over chunks
    m = torch.zeros(bsz, h, n, p, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(m)
        m = carry[:, i, :, None, None] * m + s_c[:, i]
    m_prev = torch.stack(entering, 1)                        # (B,C,H,N,P)

    # (c) y from the chunk's own term and the entering state
    q_idx = torch.arange(chunk, device=x.device)
    keep = ((q_idx[None, :] <= q_idx[:, None])[None, None]
            & (seg[..., :, None] == seg[..., None, :]))      # (B,C,Q,R)
    ldecay = cum.permute(0, 1, 3, 2)[..., :, None] - cum.permute(0, 1, 3, 2)[..., None, :]
    decay = torch.where(keep[:, :, None], ldecay, -torch.inf).exp().float()
    w = torch.einsum("bcqhn,bcrhn->bchqr", cc, bc) * decay
    y = (torch.einsum("bchqr,bcrh,bcrhp->bcqhp", w, dtc, xc)
         + inter[..., None] * torch.einsum("bcqhn,bchnp->bcqhp", cc, m_prev)
         + d_skip.float()[None, None, None, :, None] * xc)
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), m


def _bind(lib) -> None:
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("ssd_scan", _build.CSRC / "ssd_scan.cu", _bind)


def ssd_scan_cuda(x, dt, a_log, b, c, d_skip, *, reset=None):
    """x (B, S, H, P), dt (B, S, H) float32, a_log and d_skip (H,) float32,
    b and c (B, S, G, N) of x's dtype, ``reset`` (B, S) bool -> (y (B, S, H,
    P) in x's dtype, final state (B, H, N, P) float32).  Semantics of
    ``ref.ssd_scan_ref`` at any chunk; S need not be a multiple of
    anything, and inputs may start at any element offset."""
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
    if shared_bytes(n, p, x.element_size()) > MAX_SHARED:
        raise ValueError(f"N {n} x P {p} needs "
                         f"{shared_bytes(n, p, x.element_size())} bytes of "
                         f"shared memory; a block has {MAX_SHARED}")
    tensors = [x, dt, a_log, b, c, d_skip]
    if reset is not None:
        if reset.shape != (bsz, s) or reset.dtype != torch.bool:
            raise ValueError(f"reset must be a ({bsz}, {s}) bool tensor")
        tensors.append(reset)
    for t in tensors:      # any element offset: the kernel tests alignment
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("every input must lie on x's CUDA device")
        if not t.is_contiguous():
            raise ValueError("every input must be contiguous")
    lib = LIBRARY.load()
    chunks, col_groups = plan(bsz, s, h, p)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty(bsz, h, n, p, dtype=torch.float32, device=x.device)
    chunk_states = entering = carry = None
    if chunks > 1:
        chunk_states = torch.empty(bsz, h, chunks, n, p, dtype=torch.float32,
                                   device=x.device)
        carry = torch.empty(bsz, h, chunks, dtype=torch.float32,
                            device=x.device)
        if x.dtype == torch.bfloat16:
            entering = torch.empty(bsz, h, chunks, 2, n, p,
                                   dtype=torch.bfloat16, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), ptr(reset), y.data_ptr(),
        state.data_ptr(), ptr(chunk_states), ptr(entering), ptr(carry), bsz,
        s, h, g, n, p,
        col_groups, DTYPES[x.dtype], device,
        torch.cuda.current_stream(x.device).cuda_stream)
    LIBRARY.check(err)
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0
