"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, ``kernels.ops`` runs them only for tensors on the
CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
Port of ``repro/kernels/ref.py`` (the attention, scan and partition-sweep
parts).
"""
from __future__ import annotations

from typing import Mapping

import torch

_NEG = -1e30


def _scale(hd: int) -> torch.Tensor:
    """1 / sqrt(hd) in float32, rounded as the reference rounds it."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))


def attention_ref(q, k, v, mask=None, *, with_ml: bool = False):
    """GQA attention with dense scores.

    q (B, Sq, H, hd); k, v (B, Sk, KV, hd); ``mask`` (Sq, Sk), shared across
    the batch, or (B, Sq, Sk).  Softmax in float32; a fully masked row gets
    the uniform average.  Returns (B, Sq, H, hd) in q's dtype; with
    ``with_ml`` also each row's float32 softmax max and sum (masked keys
    score -1e30), (B, Sq, H) each, as ``merge_partials`` takes them.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) \
        * _scale(hd).to(q.device)
    if mask is not None:
        m = mask[:, None, None] if mask.dim() == 3 else mask[None, None, None]
        scores = torch.where(m, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    out = out.reshape(b, sq, h, hd).to(q.dtype)
    if not with_ml:
        return out
    return (out, *(t.permute(0, 3, 1, 2).reshape(b, sq, h)
                   for t in _max_sum(scores)))


def _max_sum(scores):
    """The softmax max and sum over the last axis of float32 scores."""
    top = torch.amax(scores, dim=-1)
    return top, torch.sum(torch.exp(scores - top[..., None]), dim=-1)


def merge_partials(out, m, l):
    """Attention over a sequence from its blocks' partials, as the decode
    kernel's merge combines its splits: ``out`` (n, ..., hd) each block's
    normalised output, ``m`` and ``l`` (n, ...) its softmax max and sum
    (``with_ml``).  Each block weighs exp(m - max m) times its sum, so a
    wholly masked block (m = -1e30) weighs nothing beside a block with a
    valid key, and where no block has one the result is the uniform
    average over every key.  Returns (..., hd) in float32."""
    top = torch.amax(m, dim=0).clamp(min=_NEG)
    w = torch.exp(m - top) * l
    acc = torch.sum(w[..., None] * out.float(), dim=0)
    return acc / torch.clamp(torch.sum(w, dim=0), min=1e-20)[..., None]


def build_mask(kind: str, sq: int, sk: int, window: int = 0, device=None):
    """Dense (Sq, Sk) mask of ``kind`` (causal | local | full -> None)."""
    if kind == "full":
        return None
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    if kind == "causal":
        return kj <= qi
    if kind == "local":
        return (kj <= qi) & (kj > qi - window)
    raise ValueError(kind)


def attention_blocked(q, k, v, *, kind: str, window: int = 0,
                      q_block: int = 0):
    """Attention over query blocks: scores exist only as
    (B, KV, G, Qb, Sk') tiles.  "local" slices a (window + Qb)-wide K/V band
    per block.  Same semantics as ``attention_ref`` under ``build_mask``.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = _scale(hd).to(q.device)
    if not q_block:
        q_block = 512 if k.shape[1] < 16384 else 128
    qb = min(q_block, s)
    sk = k.shape[1]
    k32, v32 = k.float(), v.float()
    use_band = kind == "local" and window > 0 and window + qb < sk
    band = min(window + qb, sk) if use_band else sk
    tiles = []
    for i in range(-(-s // qb)):
        qt = q[:, i * qb:(i + 1) * qb]
        rows = qt.shape[1]
        if rows < qb:
            qt = torch.cat([qt, qt.new_zeros((b, qb - rows, h, hd))], dim=1)
        q_pos = i * qb + torch.arange(qb, device=q.device)
        if use_band:
            start = min(max(i * qb - window, 0), sk - band)
            kt, vt = k32[:, start:start + band], v32[:, start:start + band]
            k_pos = start + torch.arange(band, device=q.device)
        else:
            kt, vt = k32, v32
            k_pos = torch.arange(sk, device=q.device)
        qg = qt.reshape(b, qb, kvh, g, hd)
        scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), kt) * scale
        m = None
        if kind == "causal":
            m = k_pos[None, :] <= q_pos[:, None]
        elif kind == "local":
            m = ((k_pos[None, :] <= q_pos[:, None])
                 & (k_pos[None, :] > q_pos[:, None] - window))
        if m is not None:
            scores = torch.where(m[None, None, None], scores, _NEG)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskh->bqkgh", probs, vt)
        tiles.append(out.reshape(b, qb, h, hd)[:, :rows].to(q.dtype))
    return torch.cat(tiles, dim=1)


def flash_attention_ref(q, k, v, *, kind: str = "causal", window: int = 0,
                        pad=None):
    """Plain version of the flash kernel: dense attention under the kind's
    mask and, with ``pad`` (B,), the left-pad mask ``k_pos >= pad[b]``.
    It agrees with the kernel on every query row that sees a key; a row
    that sees none gets the uniform average here and zeros from the kernel
    (such rows are the pad rows of a left-padded prompt, which nothing
    reads)."""
    sq, sk = q.shape[1], k.shape[1]
    mask = build_mask(kind, sq, sk, window, device=q.device)
    if pad is not None:
        keep = (torch.arange(sk, device=q.device)[None, :]
                >= pad.to(q.device)[:, None])
        keep = keep[:, None, :].expand(q.shape[0], sq, sk)
        mask = keep if mask is None else keep & mask[None]
    return attention_ref(q, k, v, mask=mask)


def decode_attention_ref(q, k, v, valid_mask, *, with_ml: bool = False):
    """One query token's GQA attention against a cache.

    q (B, 1, H, hd); k, v (B, S, KV, hd); valid_mask (B, S) bool.  A row with
    no valid key gets the uniform average of its S values.  ``with_ml``:
    (out, m, l), the float32 softmax max and sum of each (row, head),
    (B, H) each, as the kernel's partial entry gives them.
    """
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k.float()) \
        * _scale(hd).to(q.device)
    scores = torch.where(valid_mask[:, None, None, :], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v.float())
    out = out.reshape(b, 1, h, hd).to(q.dtype)
    if not with_ml:
        return out
    return (out, *(t.reshape(b, h) for t in _max_sum(scores)))


def ssd_scan_ref(x, dt, a_log, b, c, d_skip, chunk: int, reset=None):
    """Mamba2 SSD (state-space dual) scan in chunked form.

    x (B, S, H, P); dt (B, S, H) step sizes (> 0); a_log (H,) with
    A = -exp(a_log); b, c (B, S, G, N), group g serving heads
    g * H/G .. (g + 1) * H/G - 1; d_skip (H,); ``reset`` (B, S) bool zeroes
    the state entering step t (t's own contribution survives).  S must be a
    multiple of ``chunk``.  Returns (y (B, S, H, P) in x's dtype, final
    state (B, H, N, P) float32, or float64 for float64 x).  Per head, with state M (N x P):

        M_t = [reset_t ? 0 : exp(A dt_t) M_{t-1}] + dt_t b_t x_t^T
        y_t = c_t M_t + D x_t

    Resets stay in the linear domain (segment-id masks), and the causal and
    same-segment mask is applied to the log decay before the exp: for
    r > q the exponent is positive and would overflow.  Arithmetic is
    float32 (float64 for float64 inputs), but the prefix sums of A dt
    within a chunk, and their differences, are float64: at mamba2's decays
    (A dt down to about -13 a step) they reach -3,000 over a 256-step
    chunk, where the float32 ulp is 2.4e-4, and a decay factor would carry
    that relative error.  The CUDA kernel does the same.
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    reps = h // g
    bh = torch.repeat_interleave(b, reps, dim=2)
    ch = torch.repeat_interleave(c, reps, dim=2)
    a = -torch.exp(a_log.to(f))
    dt32 = dt.to(f)
    la = a[None, None, :] * dt32

    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p).to(f)
    bc = bh.reshape(bsz, nc, chunk, h, n).to(f)
    cc = ch.reshape(bsz, nc, chunk, h, n).to(f)
    dtc = dt32.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(la.reshape(bsz, nc, chunk, h).double(),
                       dim=2)                                  # (B,C,Q,H)
    total = cum[:, :, -1]                                      # (B,C,H)

    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, None, None]
    if reset is not None:
        seg = torch.cumsum(reset.reshape(bsz, nc, chunk).to(torch.int32),
                           dim=2)                               # (B,C,Q)
        keep = keep & (seg[:, :, :, None] == seg[:, :, None, :])[:, :, None]

    # intra-chunk term: y[q] = sum_{r<=q} exp(cum_q - cum_r) (c_q.b_r) dt_r x_r
    scores = torch.einsum("bcqhn,bcrhn->bchqr", cc, bc)
    cum_h = cum.permute(0, 1, 3, 2)                            # (B,C,H,Q)
    ldecay = cum_h[..., :, None] - cum_h[..., None, :]
    ldecay = torch.where(keep, ldecay, -torch.inf)
    w = scores * torch.exp(ldecay).to(f)
    y_intra = torch.einsum("bchqr,bcrh,bcrhp->bcqhp", w, dtc, xc)

    # chunk-boundary states: sum_r exp(total - cum_r) dt_r b_r x_r^T
    decay_to_end = torch.exp(total[:, :, None, :] - cum).to(f)
    gate = torch.ones(bsz, nc, dtype=f, device=x.device)
    inter_decay = torch.exp(cum).to(f)
    if reset is not None:
        decay_to_end = decay_to_end * (seg == seg[:, :, -1:])[..., None]
        gate = (seg[:, :, -1] == 0).to(f)
        inter_decay = inter_decay * (seg == 0)[..., None]
    contrib = torch.einsum("bcqh,bcqh,bcqhn,bcqhp->bchnp", decay_to_end, dtc,
                           bc, xc)

    m = torch.zeros(bsz, h, n, p, dtype=f, device=x.device)
    starts = []
    for i in range(nc):
        starts.append(m)
        m = (m * torch.exp(total[:, i]).to(f)[..., None, None]
             * gate[:, i, None, None, None] + contrib[:, i])
    m_starts = torch.stack(starts, dim=1)                      # (B,C,H,N,P)

    y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", inter_decay, cc,
                           m_starts)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + d_skip.to(f)[None, None, :, None] * x.to(f)
    return y.to(x.dtype), m


def ssd_scan_padded(x, dt, a_log, b, c, d_skip, chunk: int, reset=None):
    """``ssd_scan_ref`` at any S: S right-padded to a ``chunk`` multiple
    with dt = 0 steps (decay exp(0) = 1, contribution dt b x = 0, so the
    final state is untouched) and the padded rows of y cut off."""
    s = x.shape[1]
    tail = (-s) % chunk
    if not tail:
        return ssd_scan_ref(x, dt, a_log, b, c, d_skip, chunk=chunk,
                            reset=reset)

    def pad(t):
        return torch.cat([t, t.new_zeros((t.shape[0], tail)
                                         + tuple(t.shape[2:]))], dim=1)

    y, state = ssd_scan_ref(pad(x), pad(dt), a_log, pad(b), pad(c), d_skip,
                            chunk=chunk,
                            reset=None if reset is None else pad(reset))
    return y[:, :s], state


def ssd_step_ref(state, x_t, dt_t, a_log, b_t, c_t, d_skip):
    """One decode step of the SSD recurrence.  state (B, H, N, P) float32;
    x_t (B, H, P); dt_t (B, H); b_t, c_t (B, G, N).  Returns (y_t (B, H, P)
    in x_t's dtype, new state)."""
    reps = x_t.shape[1] // b_t.shape[1]
    bh = torch.repeat_interleave(b_t, reps, dim=1).float()
    ch = torch.repeat_interleave(c_t, reps, dim=1).float()
    a = -torch.exp(a_log.float())
    dt32 = dt_t.float()
    decay = torch.exp(a[None, :] * dt32)
    x32 = x_t.float()
    new_state = (state * decay[..., None, None]
                 + torch.einsum("bh,bhn,bhp->bhnp", dt32, bh, x32))
    y = torch.einsum("bhnp,bhn->bhp", new_state, ch)
    y = y + d_skip.float()[None, :, None] * x32
    return y.to(x_t.dtype), new_state


def rglru_scan_ref(x, a, reset=None):
    """Linear recurrence h_t = a_t h_{t-1} + x_t over (B, S, R), h_0 = 0.

    ``reset`` (B, S) bool zeroes the state entering step t, written as
    a_t = 0 so the combine stays exact.  A log2(S) doubling scan of the
    pairs (A, X): (A_t, X_t) <- (A_t A_{t-k}, X_t + A_t X_{t-k}), float32.
    Returns h in x's dtype.
    """
    a32, x32 = a.float(), x.float()
    if reset is not None:
        a32 = torch.where(reset[:, :, None], 0.0, a32)
    s = x.shape[1]
    shift = 1
    while shift < s:
        a_prev = torch.cat([torch.ones_like(a32[:, :shift]), a32[:, :-shift]],
                           dim=1)
        x_prev = torch.cat([torch.zeros_like(x32[:, :shift]),
                            x32[:, :-shift]], dim=1)
        x32 = x32 + a32 * x_prev
        a32 = a32 * a_prev
        shift *= 2
    return x32.to(x.dtype)

# The MEC constants of the partition sweep, in the order of a scalar row.
SCALAR_NAMES = ("rho", "kappa", "p_tx", "w_hz", "n0", "f_max_ue", "f_max_es",
                "v", "gamma_ue", "gamma_es", "stability_margin")


def pack_scalars(scalars: Mapping[str, float], device=None) -> torch.Tensor:
    """One (11,) float32 scalar row from a dict of the MEC constants."""
    return torch.tensor([float(scalars[k]) for k in SCALAR_NAMES],
                        dtype=torch.float32, device=device)


def partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain, q_energy,
                        q_memory, scalars, n_total: int | None = None):
    """Plain partition sweep: builds the per-cut tables from RAW per-layer
    arrays, then delegates to ``repro_torch.core.sweep``.

    Tables are (..., N, C), vectors (..., N), ``scalars`` the (..., 11)
    float32 rows of ``SCALAR_NAMES``, one per cell (a single (11,) row
    serves every cell); the even split is over ``n_total`` UEs, by default
    the per-cell N (``macs.shape[-2]``).
    """
    from ..core import sweep

    prefix_macs = torch.cumsum(macs, dim=-1)
    prefix_params = torch.cumsum(params_b, dim=-1)
    suffix_macs = prefix_macs[..., -1:] - prefix_macs
    suffix_params = prefix_params[..., -1:] - prefix_params
    c = macs.shape[-1]
    idx = torch.arange(c, device=macs.device)
    acts_m = torch.where((idx >= 1) & (idx <= L[..., None]), acts, 0.0)
    prefix_act_max = torch.cummax(acts_m, dim=-1).values
    suffix_inc = torch.flip(torch.cummax(torch.flip(acts_m, (-1,)), dim=-1).values,
                            (-1,))
    suffix_act_max = torch.cat(
        [suffix_inc[..., 1:], torch.zeros_like(suffix_inc[..., :1])], dim=-1)
    consts = {k: scalars[..., i, None, None] for i, k in enumerate(SCALAR_NAMES)}
    return sweep.objective_table(
        prefix_macs=prefix_macs, suffix_macs=suffix_macs, psi=psi,
        prefix_params=prefix_params, suffix_params=suffix_params,
        prefix_act_max=prefix_act_max, suffix_act_max=suffix_act_max,
        L=L, lam=lam, gain=gain, q_energy=q_energy, q_memory=q_memory,
        n_total=n_total, **consts)


def partition_sweep_batched_ref(macs, params_b, acts, psi, L, lam, gain,
                                q_energy, q_memory, scalars,
                                n_total: int | None = None):
    """Batched plain sweep: tables (B, N, C), vectors (B, N), scalars
    (B, 11) or one (11,) row.  The per-cell even split is
    ``partition_sweep_ref``'s own, over ``n_total`` (default N) UEs."""
    if macs.dim() != 3:
        raise ValueError(f"expected (B, N, C) tables, got {tuple(macs.shape)}")
    return partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain,
                               q_energy, q_memory, scalars, n_total)
