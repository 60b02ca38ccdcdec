"""GQA attention: init, projections, the prefill / decode / chunk / paged
paths, the global KV cache and the sliding-window ring cache.

Port of ``repro/models/attention.py``: self-attention of the kinds "g"
(global), "l" (sliding window) and "e" (the encoder's, over every key), and
cross-attention against a context's K/V (no RoPE, no qk-norm) for the "x"
and "d" kinds.  The attention itself goes through
``kernels.ops``: on CUDA tensors the flash and decode kernels, on the CPU
their plain versions.  Where the reference returns an updated cache, the
port writes into the cache it was given and returns that same cache: a
caller that needs the old state clones it first.

Under tensor parallelism (``cfg`` a ``shardctx.RankConfig`` that splits
"attn") the rank projects its own query heads and the kv heads they read
(its own share where the kv heads divide the "model" axis; where they do
not, the run of kv heads its query heads' groups cover, and its cache
holds just those).  Uneven groups are gathered per query head
(``_kv_for_q``).  The output projection is row-parallel: its partial sum
is all-reduced over "model".  In training, the replicated inputs enter the
split block through ``shardctx.enter`` (their gradient summed over
"model").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import shardctx
from ..kernels import ops
from .common import dense_init, dtype_of, head_rms_norm, rope

class KVCache(NamedTuple):
    """Global-attention cache: full-length K and V."""
    k: torch.Tensor   # (B, S_max, KV, hd), or a pool (n_blocks, block, KV, hd)
    v: torch.Tensor


class RingCache(NamedTuple):
    """Sliding-window cache: ``window`` slots and each slot's absolute
    position (-1 where empty)."""
    k: torch.Tensor     # (B, W, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor   # (B, W) int32


def init_attention(gen, cfg, *, cross: bool = False, device=None) -> dict:
    """Parameters of one attention sub-block."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv
    dt = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (d, h * hd), dt, device=device),
        "wk": dense_init(gen, (d, kv * hd), dt, device=device),
        "wv": dense_init(gen, (d, kv * hd), dt, device=device),
        "wo": dense_init(gen, (h * hd, d), dt, scale=(h * hd) ** -0.5,
                         device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dt, device=device)
        p["bk"] = torch.zeros(kv * hd, dtype=dt, device=device)
        p["bv"] = torch.zeros(kv * hd, dtype=dt, device=device)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros(hd, dtype=dt, device=device)
        p["k_norm"] = torch.zeros(hd, dtype=dt, device=device)
    return p


def _project_q(p, cfg, x):
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(*x.shape[:-1], h, hd)
    if "q_norm" in p:
        q = head_rms_norm(q, p["q_norm"])
    return q


def _project_kv(p, cfg, x):
    kv, hd = cfg.n_kv, cfg.resolved_head_dim
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(*x.shape[:-1], kv, hd)
    v = v.reshape(*x.shape[:-1], kv, hd)
    if "k_norm" in p:
        k = head_rms_norm(k, p["k_norm"])
    return k, v


def _kv_for_q(cfg, k, v):
    """k, v (..., KV, hd) as the rank's query heads read them.  The rank
    holds the run of kv heads its query heads read; where that run serves
    its kv heads unevenly (``cfg.q_kv``, each local query head's kv head),
    they are gathered one a query head, so no group size is assumed.
    Otherwise GQA's own mapping holds and k, v pass as they are."""
    idx = cfg.q_kv if shardctx.split(cfg, "attn") else ()
    if not idx:
        return k, v
    at = torch.tensor(idx, device=k.device)
    return k.index_select(-2, at), v.index_select(-2, at)


def _out(p, cfg, out, x):
    """The attention output (..., H, hd) through ``wo``: row-parallel where
    the heads are split, so its partial sum is all-reduced over "model"."""
    out = out.reshape(*x.shape[:-1], -1)
    return shardctx.reduce(cfg, "attn", out @ p["wo"])


def self_attention(p, cfg, x, positions, *, kind: str, pad_mask=None):
    """Full-sequence self-attention (train / prefill).  kind: g | l | e.

    ``positions`` is (S,) or per-row (B, S); ``pad_mask`` (B, S) marks the
    valid (non-left-pad) positions.  Returns (out, (k, v)).
    """
    x = shardctx.enter(cfg, "attn", x)
    q = _project_q(p, cfg, x)
    k, v = _project_kv(p, cfg, x)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    akind = {"l": "local", "e": "full"}.get(kind, "causal")
    out = ops.flash_attention(q, *_kv_for_q(cfg, k, v), kind=akind,
                              window=cfg.window, pad_mask=pad_mask)
    return _out(p, cfg, out, x), (k, v)


def cross_attention(p, cfg, x, context_kv):
    """Cross-attention of x (B, S, D) against precomputed context K/V
    (B, Sk, KV, hd): every query sees every context key, no RoPE."""
    x = shardctx.enter(cfg, "attn", x)
    q = _project_q(p, cfg, x)
    k, v = _kv_for_q(cfg, *context_kv)
    out = ops.flash_attention(q, k, v, kind="full")
    return _out(p, cfg, out, x)


def context_kv(p, cfg, context):
    """The cross-attention K/V of context embeddings (B, Sk, D), once per
    prefill: a ``KVCache`` (k, v), each (B, Sk, KV, hd)."""
    return KVCache(*_project_kv(p, cfg, shardctx.enter(cfg, "attn",
                                                       context)))


def decode_cross_attention(p, cfg, x, context_cache):
    """One token's cross-attention against the prefill's context K/V, every
    key valid."""
    q = _project_q(p, cfg, x)
    k, v = _kv_for_q(cfg, *context_cache)
    valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    out = ops.decode_attention(q, k, v, valid)
    return _out(p, cfg, out, x)


def init_kv_cache(cfg, batch: int, s_max: int, dtype, device=None) -> KVCache:
    kv, hd = cfg.n_kv, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros(batch, s_max, kv, hd, dtype=dtype, device=device),
        v=torch.zeros(batch, s_max, kv, hd, dtype=dtype, device=device))


def init_ring_cache(cfg, batch, dtype, device=None) -> RingCache:
    """Empty ring; ``batch`` is the row count or a tuple of leading dims
    (units, rows)."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    shape = (*lead, cfg.window, cfg.n_kv, cfg.resolved_head_dim)
    return RingCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((*lead, cfg.window), -1, dtype=torch.int32,
                       device=device))


def prefill_into_ring(cache: RingCache, k, v, length: int) -> RingCache:
    """Store the last ``window`` entries of a prefilled sequence (in place)
    at their ring slots, slot = position % window, so that decode writes
    continue from there."""
    w = cache.k.shape[1]
    s = k.shape[1]
    take = min(w, s)
    pos = torch.arange(s - take, s, device=k.device)
    slots = pos % w
    cache.k[:, slots] = k[:, s - take:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, s - take:].to(cache.v.dtype)
    cache.pos[:, slots] = pos.to(torch.int32)
    return cache


def prefill_into_kv(cache: KVCache, k, v) -> KVCache:
    """Write a prefilled sequence at positions 0.. of the cache (in place)."""
    s = k.shape[1]
    cache.k[:, :s] = k
    cache.v[:, :s] = v
    return cache


def decode_self_attention(p, cfg, x, cache, pos: int, *, kind: str,
                          pad=None):
    """Single-token decode: x (B, 1, D) against a dense ``KVCache`` (kind
    "g") or a ``RingCache`` (kind "l").

    ``pos`` is the shared write position; ``pad`` (B,) the rows' left-pad
    counts (RoPE at ``pos - pad``, cache entries below ``pad`` masked).
    Writes the token's K/V into ``cache`` at ``pos`` (a ring: at slot
    ``pos % window``, and only the last ``window`` positions stay valid).
    Returns (out, cache).
    """
    q = _project_q(p, cfg, x)               # (B, 1, H, hd)
    k_new, v_new = _project_kv(p, cfg, x)   # (B, 1, KV, hd)
    if cfg.rope_theta:
        if pad is None:
            pvec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        else:
            pvec = (pos - pad)[:, None]
        q = rope(q, pvec, cfg.rope_theta)
        k_new = rope(k_new, pvec, cfg.rope_theta)
    b, s = cache.k.shape[:2]
    at = pos % s if kind == "l" else pos
    cache.k[:, at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, at] = v_new[:, 0].to(cache.v.dtype)
    if kind == "l":
        cache.pos[:, at] = pos
        valid = (cache.pos >= 0) & (cache.pos >= pos - s + 1)
        if pad is not None:
            valid = valid & (cache.pos >= pad[:, None])
    else:
        slots = torch.arange(s, device=x.device)
        valid = (slots <= pos)[None, :].expand(b, s)
        if pad is not None:
            valid = valid & (slots[None, :] >= pad[:, None])
    out = ops.decode_attention(q, *_kv_for_q(cfg, cache.k, cache.v), valid)
    return _out(p, cfg, out, x), cache


def chunk_self_attention(p, cfg, x, cache: KVCache, start: int, positions):
    """Resumable chunked prefill: x (B, C, D) holds the chunk's tokens at
    ``positions = start + arange(C)``; ``cache`` is a dense (B, S_max, KV,
    hd) scratch holding the first ``start`` tokens.  Writes the chunk's K/V
    at ``start`` (in place; rows past the scratch's end are dropped) and
    attends with the prefix-causal mask.  Returns (out, cache)."""
    q = _project_q(p, cfg, x)
    k_new, v_new = _project_kv(p, cfg, x)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k_new = rope(k_new, positions, cfg.rope_theta)
    # the reference's dynamic_update_slice clamps the start so the chunk
    # fits; a chunk never crosses s_max on the engine's path
    s_max, c = cache.k.shape[1], x.shape[1]
    at = min(start, s_max - c)
    cache.k[:, at:at + c] = k_new.to(cache.k.dtype)
    cache.v[:, at:at + c] = v_new.to(cache.v.dtype)
    out = ops.chunk_attention(q, *_kv_for_q(cfg, cache.k, cache.v),
                              start=start)
    return _out(p, cfg, out, x), cache


def decode_self_attention_paged(p, cfg, x, cache, *, kind: str,
                                block_table, seq_lens):
    """Single-token decode against per-slot caches (continuous batching):
    row i writes position ``seq_lens[i]`` (in place).

    * kind "g": ``cache`` is a pool ``KVCache`` (n_blocks, block_size, KV,
      hd); ``block_table`` (B, M) maps row i's logical blocks to pool
      blocks.  The new K/V goes into block ``block_table[i, seq_lens[i] //
      bs]`` at offset ``seq_lens[i] % bs``; attention reads each row's
      blocks through the table as a (B, M * bs) view with positions past
      ``seq_lens[i]`` masked (``ops.decode_attention_paged``).  Idle rows
      (seq_lens 0, table all zeros) write into the reserved dummy block 0.
    * kind "l": ``cache`` is a per-slot ``RingCache`` (B, W, KV, hd); row i
      writes ring slot ``seq_lens[i] % W`` (positions are semantic: the
      commit re-slots prefill entries).
    """
    q = _project_q(p, cfg, x)
    k_new, v_new = _project_kv(p, cfg, x)
    if cfg.rope_theta:
        pvec = seq_lens[:, None]
        q = rope(q, pvec, cfg.rope_theta)
        k_new = rope(k_new, pvec, cfg.rope_theta)
    b = x.shape[0]
    if kind == "l":
        w = cache.k.shape[1]
        rows = torch.arange(b, device=x.device)
        slot = seq_lens % w
        cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
        cache.pos[rows, slot] = seq_lens.to(torch.int32)
        valid = ((cache.pos >= 0)
                 & (cache.pos >= (seq_lens - w + 1)[:, None]))
        out = ops.decode_attention(q, *_kv_for_q(cfg, cache.k, cache.v),
                                   valid)
        return _out(p, cfg, out, x), cache
    bs = cache.k.shape[1]
    rows = torch.arange(b, device=x.device)
    blk = block_table[rows, seq_lens // bs]
    off = seq_lens % bs
    cache.k[blk, off] = k_new[:, 0].to(cache.k.dtype)
    cache.v[blk, off] = v_new[:, 0].to(cache.v.dtype)
    out = ops.decode_attention_paged(q, *_kv_for_q(cfg, cache.k, cache.v),
                                     block_table, seq_lens)
    return _out(p, cfg, out, x), cache
