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

The backward (``ssd_scan_backward_cuda``, the same source) gives the
gradients of (y, final state) with respect to x, dt, a_log, b, c and d_skip
at any S, through ``SsdScan``, the autograd Function ``ops.ssd_scan`` runs
on CUDA where a gradient is wanted.  Where S > CHUNK it recomputes the
states entering each chunk with the forward's state and serial passes,
forms each chunk's U = sum_q inter_q c_q dy_q^T (the forward's state pass
again, with C, inter and dy in place of B, coef and x), and walks the
chunks backward (the adjoint pass) for D_c, the gradient reaching the state
that leaves chunk c: seeded with the final state's gradient, carried by
each chunk's carry factor, so zero across a chunk that holds a reset.  One
block per (chunk, head, batch row) then forms the chunk's dx, ddt and its
head's shares of db and dc from those and the chunk's C B^T and dY X^T: for
bf16 on the tensor cores, the float32 operands (W, dCB, D, M, inter dy) as
hi + lo bf16 parts, two blocks an SM; for float32 in FMA loops.  A last
pass sums db and dc over each group's heads and dA and dD over (B, S) in a
fixed order, so two calls give the same bits.  The gradient of the float64
prefix sums of A dt is reverse-summed in float64.
``ssd_scan_backward_chunked`` mirrors those passes in plain torch, used by
no path (``split=True`` rounds as the bf16 kernel does).
``ssd_scan_backward_cuda.launches`` counts its calls.
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


BWD_WARPS = 8                  # warps of a backward block (csrc kBThreads)
BWD_TILES = 10                 # causal 16 x 16 tiles of a chunk (csrc kTiles)


def backward_shared_bytes(n: int, p: int, itemsize: int = 4) -> int:
    """Dynamic shared memory of one chunk-gradient block: the per-step rows
    (one float64, six 4-byte), then for float32 x (csrc ``bwd_layout``)
    four arrays of 16 lanes' partial sums a step, 32 float64 of warp sums,
    the C, dY, X and B tiles (rows padded by 4), the entering state and the
    leaving adjoint (N x P each) and W and dCB (CHUNK x (CHUNK + 4)); for
    bf16 x (csrc ``bwd_tc_layout``) a partial sum of G's rows and of its
    columns per (tile, row), of dcoef and dinter per (warp, step), a
    float64 per warp and the chunk's end (16 bytes), then the bf16 tiles C,
    B (CHUNK x (N + 8), N padded to 16), X, dY (CHUNK x (P + 8)), and W and
    dCB as hi and lo parts (CHUNK x (CHUNK + 8) each)."""
    sizes = [CHUNK * 8] + [CHUNK * 4] * 6
    if itemsize == 2:
        ldn, ldx, ldw = _up16(n) + 8, _up16(p) + 8, CHUNK + 8
        sizes += ([BWD_TILES * 16 * 4] * 2 + [BWD_WARPS * CHUNK * 4] * 2
                  + [BWD_WARPS * 8, 16] + [CHUNK * ldn * 2] * 2
                  + [CHUNK * ldx * 2] * 2 + [CHUNK * ldw * 2] * 4)
    else:
        sizes += ([CHUNK * 16 * 4] * 4
                  + [32 * 8, CHUNK * (n + 4) * 4, CHUNK * (p + 4) * 4,
                     CHUNK * (p + 4) * 4, CHUNK * (n + 4) * 4, n * p * 4,
                     n * p * 4, CHUNK * (CHUNK + 4) * 4,
                     CHUNK * (CHUNK + 4) * 4])
    at = 0
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


def backward_op_count(batch: int, s: int, heads: int, p: int, n: int) -> int:
    """Float operations of the chunked backward at ``CHUNK`` steps (the
    kernel's kT), causal triangle only, with no final-state cotangent (a
    training step discards the final state): per chunk of L steps, C B^T
    and dY X^T over the L(L+1)/2 pairs, W^T dY, dCB^T C and dCB B over
    them; the products with the leaving adjoint D (B D for dx, D X for db)
    for every chunk but the last; the products with the entering state M
    (M dY for dc) and U = C^T dY for every chunk after the first; and,
    where S > CHUNK, the recompute of each chunk's own state.  The work of
    the function, whatever passes implement it."""
    total = 0
    chunks = list(range(0, s, CHUNK))
    for k, t0 in enumerate(chunks):
        L = min(CHUNK, s - t0)
        pairs = L * (L + 1) // 2
        total += 2 * pairs * (n + p) + 2 * pairs * (p + 2 * n)
        if k + 1 < len(chunks):
            total += 2 * 2 * L * n * p
        if k > 0:
            total += 2 * 2 * L * n * p
        if len(chunks) > 1:
            total += 2 * L * n * p
    return batch * heads * total


def backward_byte_count(batch: int, s: int, heads: int, p: int, groups: int,
                        n: int, itemsize: int, reset: bool) -> int:
    """Bytes the backward must move, with no final-state cotangent: x, dy,
    b and c read and dx, db and dc written in the input type; dt read and
    ddt written in float32; a_log, d_skip and their gradients; the reset
    row."""
    return (3 * batch * s * heads * p * itemsize
            + 4 * batch * s * groups * n * itemsize
            + 2 * batch * s * heads * 4 + 4 * heads * 4
            + (batch * s if reset else 0))


def _in_chunks(t, nc: int, chunk: int):
    """(B, S, ...) -> (B, nc, chunk, ...) float32, zero rows past S."""
    t = t.float()
    pad = nc * chunk - t.shape[1]
    if pad:
        t = torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))],
                      1)
    return t.reshape((t.shape[0], nc, chunk) + tuple(t.shape[2:]))


def _hi_lo(t):
    """t as the bf16 kernels enter a float32 operand: hi = bf16(t) plus lo =
    bf16(t - hi), about 16 significant bits."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def _chunk_terms(x, dt, a_log, b, c, reset, chunk: int,
                 split: bool = False) -> dict:
    """Passes (a) and (b) of the kernel, shared by both mirrors: the
    chunked inputs, the prefix sums ``cum`` of A dt (float64) and segment
    ids ``seg``, the factors coef, carry and inter, and the states entering
    each chunk (``m_prev``, (B, C, H, N, P)) and leaving the last
    (``final``).  ``split``: coef x enters the chunk states as hi + lo
    parts (``_hi_lo``), as the bf16 kernel's tensor cores take it."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // chunk)
    xc, dtc = _in_chunks(x, nc, chunk), _in_chunks(dt, nc, chunk)
    bc = _in_chunks(b, nc, chunk).repeat_interleave(h // g, dim=3)
    cc = _in_chunks(c, nc, chunk).repeat_interleave(h // g, dim=3)
    rc = (torch.zeros(bsz, nc, chunk, dtype=torch.int64, device=x.device)
          if reset is None else _in_chunks(reset, nc, chunk).long())
    a = -torch.exp(a_log.float())
    cum = torch.cumsum((a * dtc).double(), dim=2)            # (B,C,Q,H)
    seg = torch.cumsum(rc, dim=2)                            # (B,C,Q)
    total, seg_end = cum[:, :, -1], seg[:, :, -1]

    # (a) the chunk's own state, carry and inter factors
    to_end = (torch.exp(total[:, :, None] - cum).float()
              * (seg == seg_end[..., None])[..., None])      # (B,C,Q,H)
    coef = to_end * dtc
    cx = coef[..., None] * xc
    s_c = torch.einsum("bcqhn,bcqhp->bchnp", bc, _hi_lo(cx) if split else cx)
    carry = torch.exp(total).float() * (seg_end == 0)[..., None]   # (B,C,H)
    inter = torch.exp(cum).float() * (seg == 0)[..., None]   # (B,C,Q,H)

    # (b) the states entering each chunk, serial over chunks
    m = torch.zeros(bsz, h, n, p, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(m)
        m = carry[:, i, :, None, None] * m + s_c[:, i]
    return dict(nc=nc, a=a, xc=xc, dtc=dtc, bc=bc, cc=cc, cum=cum, seg=seg,
                to_end=to_end, coef=coef, carry=carry, inter=inter,
                m_prev=torch.stack(entering, 1), final=m)


def _decay(t: dict, chunk: int, device):
    """E[q][r] = exp(cum_q - cum_r) on r <= q in one segment, else 0,
    (B, C, H, Q, R): the mask is applied to the log decay before the exp."""
    q_idx = torch.arange(chunk, device=device)
    seg, cum = t["seg"], t["cum"]
    keep = ((q_idx[None, :] <= q_idx[:, None])[None, None]
            & (seg[..., :, None] == seg[..., None, :]))      # (B,C,Q,R)
    cum_h = cum.permute(0, 1, 3, 2)
    ldecay = cum_h[..., :, None] - cum_h[..., None, :]
    return torch.where(keep[:, :, None], ldecay, -torch.inf).exp().float()


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
    t = _chunk_terms(x, dt, a_log, b, c, reset, chunk)
    xc, cc = t["xc"], t["cc"]

    # (c) y from the chunk's own term and the entering state
    w = torch.einsum("bcqhn,bcrhn->bchqr", cc, t["bc"]) * _decay(t, chunk,
                                                                 x.device)
    y = (torch.einsum("bchqr,bcrh,bcrhp->bcqhp", w, t["dtc"], xc)
         + t["inter"][..., None] * torch.einsum("bcqhn,bchnp->bcqhp", cc,
                                                t["m_prev"])
         + d_skip.float()[None, None, None, :, None] * xc)
    y = y.reshape(bsz, t["nc"] * chunk, h, p)[:, :s]
    return y.to(x.dtype), t["final"]


def ssd_scan_backward_chunked(x, dt, a_log, b, c, d_skip, dy, dstate=None,
                              *, reset=None, chunk: int = CHUNK,
                              split: bool = False):
    """Plain torch mirror of the backward kernel's passes, any S: the
    gradients (dx, ddt, da_log, db, dc, dd_skip) of ``ssd_scan``'s (y,
    final state) under the cotangents ``dy`` and ``dstate`` (None: 0).
    Passes (a) and (b) recompute the entering states M; (u) U_c = sum_q
    inter_q c_q dy_q^T; (v) serially backward over the chunks, D_c, the
    gradient reaching the state that leaves chunk c: D_last = dstate,
    D_{c-1} = carry_c D_c + U_c; (w) per chunk, with S = C B^T, dS = dY
    X^T, E the masked decay and V = dS E: W = S E dt_r, dCB = V dt_r, G =
    V S dt_r, and

        dx_r = sum_q W_qr dy_q + coef_r (b_r D) + D_h dy_r
        db_r = sum_q dCB_qr c_q + coef_r (D x_r)      (summed over a group)
        dc_q = sum_r dCB_qr b_r + inter_q (M dy_q)    (summed over a group)

    and the gradient of the prefix sums, dcum_q = sum_{r<q} G_qr -
    sum_{r>q} G_rq + inter_q dinter_q - coef_q dcoef_q, plus at the last
    step sum_r coef_r dcoef_r + carry <D, M>, reverse-summed in float64
    into dl_t, the gradient of A dt_t: ddt gets A dl, da_log A sum dt dl.
    dx, db, dc come back in the inputs' dtypes, the rest float32.
    ``split`` rounds the float32 operands of the products as the bf16
    kernel enters them into its tensor cores, hi + lo bf16 parts
    (``_hi_lo``): coef x, inter dy, W, dCB, D and M; <D, M> and the
    products of two bf16 inputs stay as they are."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    t = _chunk_terms(x, dt, a_log, b, c, reset, chunk, split)
    rnd = _hi_lo if split else (lambda v: v)
    nc = t["nc"]
    xc, dtc, bc, cc = t["xc"], t["dtc"], t["bc"], t["cc"]
    coef, inter, carry, m_prev = t["coef"], t["inter"], t["carry"], t["m_prev"]
    dyc = _in_chunks(dy, nc, chunk)

    # (u) what each chunk's y sends back to its entering state
    u = torch.einsum("bcqhn,bcqhp->bchnp", cc, rnd(inter[..., None] * dyc))
    # (v) the adjoint pass
    m = (torch.zeros(bsz, h, n, p, device=x.device) if dstate is None
         else dstate.float())
    leaving = [None] * nc
    for i in reversed(range(nc)):
        leaving[i] = m
        m = carry[:, i, :, None, None] * m + u[:, i]
    d_c = torch.stack(leaving, 1)                            # (B,C,H,N,P)

    # (w) each chunk's gradients
    e = _decay(t, chunk, x.device)                           # (B,C,H,Q,R)
    sc = torch.einsum("bcqhn,bcrhn->bchqr", cc, bc)
    v = torch.einsum("bcqhp,bcrhp->bchqr", dyc, xc) * e
    dt_r = dtc.permute(0, 1, 3, 2)[..., None, :]             # (B,C,H,1,R)
    w, dcb, gt = sc * e * dt_r, v * dt_r, v * sc
    q_idx = torch.arange(chunk, device=x.device)
    strict = q_idx[:, None] > q_idx[None, :]                 # q > r
    rowsum = (gt * dt_r * strict).sum(-1).permute(0, 1, 3, 2)   # (B,C,Q,H)
    colsum = (gt * strict).sum(-2).permute(0, 1, 3, 2)
    diag = torch.diagonal(gt, dim1=-2, dim2=-1).permute(0, 1, 3, 2)
    w, dcb = rnd(w), rnd(dcb)
    bd = torch.einsum("bcrhn,bchnp->bcrhp", bc, rnd(d_c))
    dx = (torch.einsum("bchqr,bcqhp->bcrhp", w, dyc) + coef[..., None] * bd
          + d_skip.float()[None, None, None, :, None] * dyc)
    dxm = torch.einsum("bchnp,bcrhp->bcrhn", rnd(d_c), xc)
    mdy = torch.einsum("bchnp,bcqhp->bcqhn", rnd(m_prev), dyc)
    db = torch.einsum("bchqr,bcqhn->bcrhn", dcb, cc) + coef[..., None] * dxm
    dc = torch.einsum("bchqr,bcrhn->bcqhn", dcb, bc) + inter[..., None] * mdy
    dcoef, dinter = (bd * xc).sum(-1), (cc * mdy).sum(-1)    # (B,C,Q,H)
    kq = dcoef * coef
    dcum = (rowsum.double() - (dtc * colsum).double()
            + (inter * dinter).double() - kq.double())
    dcum[:, :, -1] += kq.double().sum(2) + (carry * (d_c * m_prev).sum(
        (-1, -2))).double()
    dl = dcum.flip(2).cumsum(2).flip(2)                      # reverse, float64
    a = t["a"]
    ddt = (colsum + diag + dcoef * t["to_end"] + (a.double() * dl).float())
    da_log = (a.double() * (dtc.double() * dl).sum((0, 1, 2))).float()
    dd_skip = (dyc * xc).sum((0, 1, 2, 4))

    def out(v, like, heads=True):
        v = v.reshape((bsz, nc * chunk) + tuple(v.shape[3:]))[:, :s]
        if heads:      # each head's share, summed over its group
            v = v.reshape(bsz, s, g, h // g, n).sum(3)
        return v.to(like.dtype)

    return (out(dx, x, False), out(ddt, dt.float(), False), da_log,
            out(db, b), out(dc, c), dd_skip)


def _bind(lib) -> None:
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.ssd_scan_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    if hasattr(lib, "ssd_scan_backward_blocks_per_sm"):   # not in older builds
        fn = lib.ssd_scan_backward_blocks_per_sm
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int


LIBRARY = _build.Library("ssd_scan", _build.CSRC / "ssd_scan.cu", _bind)


def _check(x, dt, a_log, b, c, d_skip, reset, smem_of) -> None:
    """Raise on what the kernels do not take; ``smem_of(n, p)`` is the
    shared memory the call's blocks need."""
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
    smem = smem_of(n, p)
    if smem > MAX_SHARED:
        raise ValueError(f"N {n} x P {p} needs {smem} bytes of shared memory; "
                         f"a block has {MAX_SHARED}")
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_args(x):
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return device, torch.cuda.current_stream(x.device).cuda_stream


def ssd_scan_cuda(x, dt, a_log, b, c, d_skip, *, reset=None):
    """x (B, S, H, P), dt (B, S, H) float32, a_log and d_skip (H,) float32,
    b and c (B, S, G, N) of x's dtype, ``reset`` (B, S) bool -> (y (B, S, H,
    P) in x's dtype, final state (B, H, N, P) float32).  Semantics of
    ``ref.ssd_scan_ref`` at any chunk; S need not be a multiple of
    anything, and inputs may start at any element offset."""
    _check(x, dt, a_log, b, c, d_skip, reset,
           lambda n, p: shared_bytes(n, p, x.element_size()))
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
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
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), _ptr(reset), y.data_ptr(),
        state.data_ptr(), _ptr(chunk_states), _ptr(entering), _ptr(carry),
        bsz, s, h, g, n, p, col_groups, DTYPES[x.dtype], *_launch_args(x))
    LIBRARY.check(err)
    ssd_scan_cuda.launches += 1
    return y, state


ssd_scan_cuda.launches = 0


def ssd_scan_backward_cuda(x, dt, a_log, b, c, d_skip, dy, dstate=None, *,
                           reset=None):
    """The gradients (dx, ddt, da_log, db, dc, dd_skip) of ``ssd_scan_cuda``'s
    (y, final state) under the cotangents ``dy`` (y's shape and dtype) and
    ``dstate`` ((B, H, N, P), or None for none): dx, db and dc in x's
    dtype, the rest float32.  The inputs as ``ssd_scan_cuda`` takes them;
    outputs and float32 scratch are allocated here (``torch.empty``)."""
    # the chunk gradients' blocks, and the forward's state pass they rerun
    # (also in its U mode)
    _check(x, dt, a_log, b, c, d_skip, reset, lambda n, p: max(
        backward_shared_bytes(n, p, x.element_size()),
        shared_bytes(n, p, x.element_size(), "state")))
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"dy must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} tensor on x's device")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if dstate is not None:
        if dstate.shape != (bsz, h, n, p) or dstate.device != x.device:
            raise ValueError(f"dstate must be ({bsz}, {h}, {n}, {p}) on x's "
                             f"device")
        dstate = dstate.float().contiguous()
        if dstate.data_ptr() % 16:          # read four floats at a time
            dstate = dstate.clone()
    lib = LIBRARY.load()
    chunks, col_groups = plan(bsz, s, h, p)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, db, dc = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (x, b, c))
    ddt = torch.empty(bsz, s, h, **f32)
    da_log, dd_skip = torch.empty(h, **f32), torch.empty(h, **f32)
    db_part, dc_part = (torch.empty(bsz, s, h, n, **f32) for _ in range(2))
    head_part = torch.empty(2, bsz, chunks, h, **f32)
    chunk_states = carry = adj = None
    if chunks > 1:
        chunk_states = torch.empty(bsz, h, chunks, n, p, **f32)
        adj = torch.empty(bsz, h, chunks, n, p, **f32)
        carry = torch.empty(bsz, h, chunks, **f32)
    err = lib.ssd_scan_backward_launch(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), d_skip.data_ptr(), _ptr(reset), dy.data_ptr(),
        _ptr(dstate), dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
        db.data_ptr(), dc.data_ptr(), dd_skip.data_ptr(), _ptr(chunk_states),
        _ptr(carry), _ptr(adj), db_part.data_ptr(), dc_part.data_ptr(),
        head_part.data_ptr(), bsz, s, h, g, n, p, col_groups,
        DTYPES[x.dtype], *_launch_args(x))
    LIBRARY.check(err)
    ssd_scan_backward_cuda.launches += 1
    return dx, ddt, da_log, db, dc, dd_skip


ssd_scan_backward_cuda.launches = 0


def backward_blocks_per_sm(n: int, p: int, dtype=torch.bfloat16) -> int:
    """Chunk-gradient blocks one SM of the current card holds at N x P
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = LIBRARY.load()
    got = lib.ssd_scan_backward_blocks_per_sm(n, p, DTYPES[dtype],
                                              torch.cuda.current_device())
    if got < 0:
        LIBRARY.check(-got)
    return got


class SsdScan(torch.autograd.Function):
    """The SSD kernel with the backward kernel as its gradient.  The
    forward saves its inputs (the backward recomputes the chunk states);
    the reset is not differentiable.  A final state nobody differentiates
    (training drops it) reaches the backward as None, not a zero tensor."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, reset):
        ctx.set_materialize_grads(False)
        y, state = ssd_scan_cuda(x, dt, a_log, b, c, d_skip, reset=reset)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, reset)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a_log, b, c, d_skip, reset = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_backward_cuda(x, dt, a_log, b, c, d_skip, dy, dstate,
                                       reset=reset)
        return (*grads, None)
