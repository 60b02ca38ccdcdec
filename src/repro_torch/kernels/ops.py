"""Kernel entry points of the port.

Dispatch is by device alone: a CUDA tensor launches the CUDA kernel and a
CPU tensor runs the plain version in ``kernels.ref``.  There is no other
switch and no fallback: a kernel that fails to build or launch raises.

Gradients.  The CPU arms are plain torch, differentiable as they stand.  On
CUDA a gradient is wanted where ``torch.is_grad_enabled()`` and a tensor
input ``requires_grad``; flash attention, the SSD scan and the RG-LRU scan
then run through ``flash_attention.FlashAttention``, ``ssd_scan.SsdScan``
and ``rglru_scan.RglruScan``, whose backwards are kernels too.  Decode
attention (dense and paged) and the partition sweep have no backward and
raise ``NotImplementedError`` there (``NO_BACKWARD`` names the ROADMAP
item that would give each one): their outputs would otherwise be tensors
autograd does not see.
"""
from __future__ import annotations

import torch

from . import ref
# names that callers outside kernels/ need of the kernel modules and the
# build, re-exported here so that nothing else imports those directly (the
# kernel-wrapper lint rule, ``analysis.rules``)
from ._build import all_libraries as all_libraries
from .flash_attention import HEAD_DIMS as HEAD_DIMS
from .partition_sweep import check_scalar_rows as check_scalar_rows

# kernel -> the ROADMAP item that will give it a backward
NO_BACKWARD = {
    "decode_attention": "ROADMAP queue 2, item B5 (serving kernels; no "
                        "training path differentiates them)",
    "decode_attention_paged": "ROADMAP queue 2, item B5 (serving kernels; "
                              "no training path differentiates them)",
    "partition_sweep": "ROADMAP queue 2, item B5 (the controller never "
                       "differentiates the sweep)",
}


def grad_wanted(*tensors) -> bool:
    """True where autograd records and some tensor input requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise for a CUDA kernel without a backward when a gradient is
    wanted through it."""
    if grad_wanted(*tensors):
        raise NotImplementedError(
            f"{name} on CUDA has no backward kernel, and a gradient is "
            f"wanted through it; it comes with {NO_BACKWARD[name]}")


# Above this many score elements per (batch x head) the CPU path switches to
# the blocked formulation, as the reference's non-Pallas arm does.
_BLOCKED_THRESHOLD = 2048 * 2048


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    pad_mask=None):
    """GQA attention.  q (B, Sq, H, hd), k/v (B, Sk, KV, hd); kind "causal",
    "local" (sliding window) or "full".

    ``pad_mask`` (B, Sk) bool marks VALID keys per row; False is left-pad
    filler, contiguous from position 0.  On CUDA the flash kernel runs at
    every size, with the mask as a per-row pad count.  On the CPU this is
    the reference's non-Pallas arm: dense attention under the kind's mask
    and that pad (``ref.flash_attention_ref``), or, without a pad mask, dense up to ``_BLOCKED_THRESHOLD`` score
    elements and blocked above.
    """
    pad = None
    if pad_mask is not None:
        pad = (~pad_mask).sum(dim=1, dtype=torch.int32)
    if q.is_cuda:
        from .flash_attention import FlashAttention, flash_attention_cuda
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if grad_wanted(q, k, v):
            return FlashAttention.apply(q, k, v, kind, window, pad)
        return flash_attention_cuda(q, k, v, kind=kind, window=window,
                                    pad=pad)
    if pad is not None:
        return ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                       pad=pad)
    sq, sk = q.shape[1], k.shape[1]
    if sq * sk <= _BLOCKED_THRESHOLD:
        return ref.attention_ref(q, k, v, mask=ref.build_mask(
            kind, sq, sk, window, device=q.device))
    return ref.attention_blocked(q, k, v, kind=kind, window=window)


def decode_attention(q, k, v, valid_mask, *, with_ml: bool = False):
    """Single-token GQA attention.  q (B, 1, H, hd), k/v (B, S, KV, hd),
    valid_mask (B, S) bool.  ``with_ml``: (out, m, l), the float32 softmax
    max and sum of each (row, head), (B, H) each: a block's partial of a
    sequence held in blocks (``ref.merge_partials``)."""
    if q.is_cuda:
        from .decode_attention import decode_attention_cuda
        refuse_grad("decode_attention", q, k, v)
        return decode_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), valid_mask.contiguous(),
                                     with_ml=with_ml)
    return ref.decode_attention_ref(q, k, v, valid_mask, with_ml=with_ml)


def decode_attention_paged(q, k_pool, v_pool, block_table, seq_lens):
    """Single-token GQA attention against a paged pool.  q (B, 1, H, hd);
    pools (n_blocks, bs, KV, hd); block_table (B, M) maps row b's logical
    blocks to pool blocks; row b sees keys j <= seq_lens[b] of its
    (B, M * bs) view.  On CUDA the kernel reads the pool through the table
    (the index tensors go to int32 first); on the CPU the rows are gathered
    and the plain version runs, as the reference does."""
    if q.is_cuda:
        from .decode_attention import decode_attention_paged_cuda
        refuse_grad("decode_attention_paged", q, k_pool, v_pool)
        return decode_attention_paged_cuda(
            q.contiguous(), k_pool.contiguous(), v_pool.contiguous(),
            block_table.to(torch.int32).contiguous(),
            seq_lens.to(torch.int32).contiguous())
    b, m = block_table.shape
    bs = k_pool.shape[1]
    kvh, hd = k_pool.shape[-2:]
    k_rows = k_pool[block_table].reshape(b, m * bs, kvh, hd)
    v_rows = v_pool[block_table].reshape(b, m * bs, kvh, hd)
    valid = (torch.arange(m * bs, device=q.device)[None, :]
             <= seq_lens[:, None])
    return ref.decode_attention_ref(q, k_rows, v_rows, valid)


def chunk_attention(q, k, v, *, start: int, first: int = 0,
                    with_ml: bool = False):
    """Chunked-prefill GQA attention: q (B, C, H, hd) holds the tokens at
    positions ``start .. start + C - 1``; k/v (B, S, KV, hd) are dense
    scratch caches, or the block of one from position ``first`` on.
    Query row i sees key j iff first + j <= start + i.  ``with_ml`` also
    returns each row's softmax max and sum, (B, C, H) each (a block's
    partial).  Plain torch on every device: the reference has no kernel
    for it either."""
    sq, sk = q.shape[1], k.shape[1]
    mask = (first + torch.arange(sk, device=q.device)[None, :]
            <= (start + torch.arange(sq, device=q.device))[:, None])
    return ref.attention_ref(q, k, v, mask=mask, with_ml=with_ml)


def ssd_scan(x, dt, a_log, b, c, d_skip, chunk: int, reset=None):
    """Mamba2 SSD.  x (B, S, H, P), dt (B, S, H), a_log (H,), b/c
    (B, S, G, N), d_skip (H,); ``reset`` (B, S) bool zeroes the carried
    state entering flagged steps.  Returns (y (B, S, H, P), final state
    (B, H, N, P) float32).

    On CUDA the SSD kernel runs at any S (its tile is its own; ``chunk``
    is a tiling choice that does not change the result).  On the CPU the
    plain chunked scan runs at ``chunk``, as the reference does, S padded
    to a chunk multiple (``ref.ssd_scan_padded``).
    """
    if x.is_cuda:
        from .ssd_scan import SsdScan, ssd_scan_cuda
        # the casts stay outside the Function: autograd carries each
        # gradient back to its parameter's own dtype
        args = (x.contiguous(), dt.float().contiguous(),
                a_log.float().contiguous(), b.contiguous(), c.contiguous(),
                d_skip.float().contiguous(),
                None if reset is None else reset.contiguous())
        if grad_wanted(*args):
            return SsdScan.apply(*args)
        return ssd_scan_cuda(*args[:-1], reset=args[-1])
    return ref.ssd_scan_padded(x, dt, a_log, b, c, d_skip, chunk,
                               reset=reset)


def rglru_scan(x, a, reset=None):
    """Gated linear recurrence h_t = a_t h_{t-1} + x_t over (B, S, R), any
    S; ``reset`` (B, S) bool zeroes the state entering flagged steps."""
    if x.is_cuda:
        from .rglru_scan import RglruScan, rglru_scan_cuda
        x, a = x.contiguous(), a.contiguous()
        reset = None if reset is None else reset.contiguous()
        if grad_wanted(x, a):
            return RglruScan.apply(x, a, reset)
        return rglru_scan_cuda(x, a, reset=reset)
    return ref.rglru_scan_ref(x, a, reset=reset)


def partition_sweep(macs, params_b, acts, psi, L, lam, gain, q_energy,
                    q_memory, scalars, n_total: int | None = None):
    """Per-(UE, cut) drift-plus-penalty table (paper eq. 11) of one cell:
    tables (N, C), vectors (N,), ``scalars`` the cell's (11,) float32 row of
    ``ref.SCALAR_NAMES`` (``ref.pack_scalars`` makes it from a dict).
    ``n_total`` is the UE count of the even split (default N), as the
    reference's ``partition_sweep_pallas`` takes it."""
    if macs.is_cuda:
        from .partition_sweep import partition_sweep_cuda
        refuse_grad("partition_sweep", macs, params_b, acts, psi, L, lam,
                    gain, q_energy, q_memory, scalars)
        return partition_sweep_cuda(macs, params_b, acts, psi, L, lam, gain,
                                    q_energy, q_memory,
                                    scalars.reshape(1, -1).contiguous(),
                                    cell_rows=macs.shape[0], n_total=n_total)
    return ref.partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain,
                                   q_energy, q_memory, scalars, n_total)


def partition_sweep_batched(macs, params_b, acts, psi, L, lam, gain,
                            q_energy, q_memory, scalars,
                            n_total: int | None = None):
    """(B, N, C) sweep over every cell of a grid in one kernel launch.

    The B*N rows are flattened onto the kernel's rows, N of them a cell.
    ``n_total`` is the UE count of each cell's even split: N by default;
    on a grid whose UE axis is split over "model", the rank holds N of a
    cell's ``n_total`` UEs.  ``scalars`` is (B, 11), one row per cell, or
    one (11,) row for every cell.
    """
    if macs.is_cuda:
        from .partition_sweep import partition_sweep_cuda
        refuse_grad("partition_sweep", macs, params_b, acts, psi, L, lam,
                    gain, q_energy, q_memory, scalars)
        b, n, c = macs.shape
        flat = lambda t: t.reshape((b * n,) + tuple(t.shape[2:])).contiguous()
        rows = torch.broadcast_to(scalars, (b, scalars.shape[-1])).contiguous()
        out = partition_sweep_cuda(
            flat(macs), flat(params_b), flat(acts), flat(psi), flat(L),
            flat(lam), flat(gain), flat(q_energy), flat(q_memory), rows,
            cell_rows=n, n_total=n_total)
        return out.reshape(b, n, c)
    return ref.partition_sweep_batched_ref(macs, params_b, acts, psi, L, lam,
                                           gain, q_energy, q_memory, scalars,
                                           n_total)
