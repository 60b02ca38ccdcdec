"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, ``kernels.ops`` runs them only for tensors on the
CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
Port of ``repro/kernels/ref.py`` (the attention and partition-sweep parts).
"""
from __future__ import annotations

from typing import Mapping

import torch

_NEG = -1e30


def _scale(hd: int) -> torch.Tensor:
    """1 / sqrt(hd) in float32, rounded as the reference rounds it."""
    return 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))


def attention_ref(q, k, v, mask=None):
    """GQA attention with dense scores.

    q (B, Sq, H, hd); k, v (B, Sk, KV, hd); ``mask`` (Sq, Sk), shared across
    the batch, or (B, Sq, Sk).  Softmax in float32; a fully masked row gets
    the uniform average.  Returns (B, Sq, H, hd) in q's dtype.
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
    return out.reshape(b, sq, h, hd).to(q.dtype)


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


def decode_attention_ref(q, k, v, valid_mask):
    """One query token's GQA attention against a cache.

    q (B, 1, H, hd); k, v (B, S, KV, hd); valid_mask (B, S) bool.  A row with
    no valid key gets the uniform average of its S values.
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
    return out.reshape(b, 1, h, hd).to(q.dtype)

# The MEC constants of the partition sweep, in the order of a scalar row.
SCALAR_NAMES = ("rho", "kappa", "p_tx", "w_hz", "n0", "f_max_ue", "f_max_es",
                "v", "gamma_ue", "gamma_es", "stability_margin")


def pack_scalars(scalars: Mapping[str, float], device=None) -> torch.Tensor:
    """One (11,) float32 scalar row from a dict of the MEC constants."""
    return torch.tensor([float(scalars[k]) for k in SCALAR_NAMES],
                        dtype=torch.float32, device=device)


def partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain, q_energy,
                        q_memory, scalars):
    """Plain partition sweep: builds the per-cut tables from RAW per-layer
    arrays, then delegates to ``repro_torch.core.sweep``.

    Tables are (..., N, C), vectors (..., N), ``scalars`` the (..., 11)
    float32 rows of ``SCALAR_NAMES``, one per cell (a single (11,) row
    serves every cell); the even split uses the per-cell N
    (``macs.shape[-2]``).
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
        **consts)


def partition_sweep_batched_ref(macs, params_b, acts, psi, L, lam, gain,
                                q_energy, q_memory, scalars):
    """Batched plain sweep: tables (B, N, C), vectors (B, N), scalars
    (B, 11) or one (11,) row.  The per-cell even split is
    ``partition_sweep_ref``'s own, over the N axis."""
    if macs.dim() != 3:
        raise ValueError(f"expected (B, N, C) tables, got {tuple(macs.shape)}")
    return partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain,
                               q_energy, q_memory, scalars)
