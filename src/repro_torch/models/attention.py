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
not, the run of kv heads its query heads' groups cover).  Uneven groups
are gathered per query head (``_kv_for_q``).  Where the kv heads do not
divide the axis, the dense and ring caches are split over "model" along
the sequence (``SeqKVCache``, ``SeqRingCache``; ROADMAP 7d): a rank holds
every kv head of its block of positions, the new tokens' query and kv
heads are all-gathered, each rank attends every query head against its
block, and the blocks' partials (max, sum, output) are merged for the
rank's own heads.  The output projection is row-parallel: its partial sum
is all-reduced over "model".  In training, the replicated inputs enter the
split block through ``shardctx.enter`` (their gradient summed over
"model").
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import shardctx
from ..kernels import ops, ref
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


class SeqKVCache(KVCache):
    """A ``KVCache`` whose sequence is split over "model" (ROADMAP 7d): rank
    r holds every kv head of positions [r L, (r + 1) L), L its own length
    (``shardctx.seq_caches``)."""
    __slots__ = ()


class SeqRingCache(RingCache):
    """A ``RingCache`` split so: rank r holds every kv head of ring slots
    [r L, (r + 1) L), and their positions, of a ring of M L slots."""
    __slots__ = ()


def is_seq_split(cache) -> bool:
    """Whether ``cache`` is a rank's block of a sequence-split cache."""
    return isinstance(cache, (SeqKVCache, SeqRingCache))


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
    prefill: a ``KVCache`` (k, v), each (B, Sk, KV, hd).  The context is
    no residual stream: under sequence parallelism it is whole on every
    rank, and its gradient was summed over "model" where it entered the
    stack (``transformer._sequence_parallel``)."""
    if not shardctx.seq_block(cfg):
        context = shardctx.enter(cfg, "attn", context)
    return KVCache(*_project_kv(p, cfg, context))


def decode_cross_attention(p, cfg, x, context_cache):
    """One token's cross-attention against the prefill's context K/V, every
    key valid."""
    q = _project_q(p, cfg, x)
    k, v = _kv_for_q(cfg, *context_cache)
    valid = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    out = ops.decode_attention(q, k, v, valid)
    return _out(p, cfg, out, x)


def _seq_parts(cfg, length: int, seq: bool) -> int:
    """The ranks a cache of ``length`` positions or slots is split over
    along its sequence: "model" where ``cfg`` keeps sequence-split caches
    and the axis divides the length (the policy's ``cache_spec``), else
    1."""
    if seq and shardctx.seq_caches(cfg) and length % cfg.model_size == 0:
        return cfg.model_size
    return 1


def init_kv_cache(cfg, batch, s_max: int, dtype, device=None, *,
                  seq: bool = True) -> KVCache:
    """A zeroed dense cache of ``s_max`` positions; ``batch`` is the row
    count or a tuple of leading dims (units, rows).  Where ``cfg`` keeps
    sequence-split caches (and ``seq``), the rank's ``SeqKVCache``."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    parts = _seq_parts(cfg, s_max, seq)
    kv = cfg.whole.n_kv if parts > 1 else cfg.n_kv
    shape = (*lead, s_max // parts, kv, cfg.resolved_head_dim)
    return (SeqKVCache if parts > 1 else KVCache)(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))


def init_ring_cache(cfg, batch, dtype, device=None, *,
                    seq: bool = True) -> RingCache:
    """Empty ring; ``batch`` is the row count or a tuple of leading dims
    (units, rows).  Where ``cfg`` keeps sequence-split caches (and
    ``seq``), the rank's ``SeqRingCache``."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    parts = _seq_parts(cfg, cfg.window, seq)
    kv = cfg.whole.n_kv if parts > 1 else cfg.n_kv
    w = cfg.window // parts
    shape = (*lead, w, kv, cfg.resolved_head_dim)
    return (SeqRingCache if parts > 1 else RingCache)(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((*lead, w), -1, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=64)
def _kv_sources(n_heads: int, n_kv: int, m: int) -> tuple:
    """(run width, (rank, index in its run) of each kv head): where in the
    ranks' gathered kv-head runs (each padded to the widest) every kv head
    is, from the lowest rank that holds it."""
    runs = [shardctx.kv_run(n_heads, n_kv, m, r) for r in range(m)]
    width = max(run[-1] + 1 - run[0] for run in runs)
    src = []
    for j in range(n_kv):
        r = next(r for r, run in enumerate(runs) if run[0] <= j <= run[-1])
        src.append((r, j - runs[r][0]))
    return width, tuple(src)


def whole_heads(cfg, q, k, v):
    """Every rank's query heads and every kv head of the same positions:
    q (B, C, H / M, hd) or None, k and v (B, C, n_kv, hd) the rank's
    run -> (q (B, C, H, hd) or None, k, v (B, C, KV, hd)), in one
    all-gather over "model" (outside autograd: a serving path)."""
    whole = cfg.whole
    width, src = _kv_sources(whole.n_heads, whole.n_kv, cfg.model_size)
    b, c, n, hd = k.shape
    pad = lambda t: torch.cat([t, t.new_zeros((b, c, width - n, hd))], 2) \
        if n < width else t
    parts = [pad(k).reshape(b, c, -1), pad(v).reshape(b, c, -1)]
    if q is not None:
        parts.insert(0, q.reshape(b, c, -1))
    rows = shardctx.model_gather_rows(torch.cat(parts, -1))
    m = rows.shape[0]
    at = 0
    if q is not None:
        h = q.shape[2]
        q = rows[..., :h * hd].reshape(m, b, c, h, hd).permute(1, 2, 0, 3, 4)
        q = q.reshape(b, c, m * h, hd)
        at = h * hd
    ranks = torch.tensor([r for r, _ in src], device=k.device)
    index = torch.tensor([i for _, i in src], device=k.device)

    def heads(flat):
        t = flat.reshape(m, b, c, width, hd)[ranks, :, :, index]
        return t.permute(1, 2, 0, 3).contiguous()       # (B, C, KV, hd)

    k = heads(rows[..., at:at + width * hd])
    v = heads(rows[..., at + width * hd:])
    return q, k, v


def _merge(cfg, out, m, l):
    """The rank's query heads (B, C, H / M, hd) of attention whose ranks
    each attended every query head against their block of the sequence:
    ``out`` (B, C, H, hd), ``m``, ``l`` (B, C, H) are this rank's partials,
    all-gathered over "model" (one collective) and merged as the decode
    kernel merges its splits (``ref.merge_partials``)."""
    b, c, h, hd = out.shape
    part = torch.cat([out.float(), m[..., None], l[..., None]], -1)
    rows = shardctx.model_gather_rows(part)              # (M, B, C, H, hd + 2)
    mine = h // cfg.model_size
    rows = rows[:, :, :, cfg.model_rank * mine:(cfg.model_rank + 1) * mine]
    merged = ref.merge_partials(rows[..., :hd], rows[..., hd],
                                rows[..., hd + 1])
    return merged.to(out.dtype)


def prefill_into_ring(cache: RingCache, k, v, length: int, *,
                      parts: int = 1, block: int = 0) -> RingCache:
    """Store the last ``window`` entries of a prefilled sequence (in place)
    at their ring slots, slot = position % window, so that decode writes
    continue from there.  ``cache`` may be block ``block`` of a ring split
    into ``parts`` blocks of slots (a ``SeqRingCache``; k and v then hold
    every kv head): it takes the entries whose slots it holds."""
    wl = cache.k.shape[1]
    w = wl * parts
    s = k.shape[1]
    # the last window's positions whose slots the block holds (host ints:
    # no shape that depends on a tensor's values, as on the meta device)
    held = [p for p in range(max(s - w, 0), s)
            if block * wl <= p % w < (block + 1) * wl]
    pos = torch.tensor(held, dtype=torch.long, device=k.device)
    slots = pos % w - block * wl
    cache.k[:, slots] = k[:, pos].to(cache.k.dtype)
    cache.v[:, slots] = v[:, pos].to(cache.v.dtype)
    cache.pos[:, slots] = pos.to(torch.int32)
    return cache


def prefill_into_kv(cache: KVCache, k, v, *, first: int = 0) -> KVCache:
    """Write a prefilled sequence at positions 0.. of the cache (in place);
    ``cache`` may be the block of a sequence-split cache whose first
    position is ``first`` (a ``SeqKVCache``; k and v then hold every kv
    head): it takes the positions it holds."""
    s = min(k.shape[1] - first, cache.k.shape[1])
    if s > 0:
        cache.k[:, :s] = k[:, first:first + s]
        cache.v[:, :s] = v[:, first:first + s]
    return cache


def fill_prefill(cfg, cache, k, v):
    """``prefill_into_kv`` or ``prefill_into_ring`` of the rank's run of kv
    heads k, v (B, S, n_kv, hd) over a whole prompt: where ``cache`` is
    split over the sequence, every kv head is gathered first
    (``whole_heads``) and the rank writes its block."""
    ring = isinstance(cache, RingCache)
    if not is_seq_split(cache):
        if ring:
            return prefill_into_ring(cache, k, v, k.shape[1])
        return prefill_into_kv(cache, k, v)
    _, k, v = whole_heads(cfg, None, k, v)
    if ring:
        return prefill_into_ring(cache, k, v, k.shape[1],
                                 parts=cfg.model_size, block=cfg.model_rank)
    return prefill_into_kv(cache, k, v,
                           first=cfg.model_rank * cache.k.shape[1])


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
    if is_seq_split(cache):
        return _decode_seq(p, cfg, x, cache, pos, kind, pad, q, k_new, v_new)
    s = cache.k.shape[1]
    at = pos % s if kind == "l" else pos
    cache.k[:, at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, at] = v_new[:, 0].to(cache.v.dtype)
    if kind == "l":
        cache.pos[:, at] = pos
    valid = _valid(cache, pos, pad, 0, s)
    out = ops.decode_attention(q, *_kv_for_q(cfg, cache.k, cache.v), valid)
    return _out(p, cfg, out, x), cache


def _valid(cache, pos: int, pad, first: int, window: int):
    """(B, L) validity of the cache's entries for the token at ``pos``:
    a ring's slots of the last ``window`` positions, a dense cache's
    positions up to ``pos`` (its first at ``first``), both at or past
    each row's left pad."""
    b, s = cache.k.shape[:2]
    if isinstance(cache, RingCache):
        valid = (cache.pos >= 0) & (cache.pos >= pos - window + 1)
        return valid if pad is None else valid & (cache.pos >= pad[:, None])
    slots = first + torch.arange(s, device=cache.k.device)
    valid = (slots <= pos)[None, :].expand(b, s)
    return valid if pad is None else valid & (slots[None, :] >= pad[:, None])


def _decode_seq(p, cfg, x, cache, pos: int, kind: str, pad, q, k_new,
                v_new):
    """``decode_self_attention`` against the rank's block of a
    sequence-split cache (ROADMAP 7d): the token's query heads and kv heads
    are all-gathered over "model"; the rank that holds the token's
    position (or ring slot) writes its K/V; each rank attends every query
    head against its block (the decode kernel's partial entry), and the
    blocks' partials are merged for the rank's own heads, which go through
    the row-parallel ``wo``."""
    q, k_new, v_new = whole_heads(cfg, q, k_new, v_new)
    lb = cache.k.shape[1]
    at = (pos % (lb * cfg.model_size) if kind == "l" else pos) \
        - cfg.model_rank * lb
    if 0 <= at < lb:
        cache.k[:, at] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, at] = v_new[:, 0].to(cache.v.dtype)
        if kind == "l":
            cache.pos[:, at] = pos
    valid = _valid(cache, pos, pad, cfg.model_rank * lb,
                   lb * cfg.model_size)
    out, m, l = ops.decode_attention(q, cache.k, cache.v, valid,
                                     with_ml=True)
    out = _merge(cfg, out, m[:, None], l[:, None])
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
    if not is_seq_split(cache):
        at = min(start, s_max - c)
        cache.k[:, at:at + c] = k_new.to(cache.k.dtype)
        cache.v[:, at:at + c] = v_new.to(cache.v.dtype)
        out = ops.chunk_attention(q, *_kv_for_q(cfg, cache.k, cache.v),
                                  start=start)
        return _out(p, cfg, out, x), cache
    # the rank's block of a sequence-split scratch: as _decode_seq does,
    # for the chunk's C tokens at once
    q, k_new, v_new = whole_heads(cfg, q, k_new, v_new)
    first = cfg.model_rank * s_max
    at = min(start, s_max * cfg.model_size - c) - first
    lo, hi = max(at, 0), min(at + c, s_max)
    if lo < hi:
        cache.k[:, lo:hi] = k_new[:, lo - at:hi - at].to(cache.k.dtype)
        cache.v[:, lo:hi] = v_new[:, lo - at:hi - at].to(cache.v.dtype)
    out, m, l = ops.chunk_attention(q, cache.k, cache.v, start=start,
                                    first=first, with_ml=True)
    return _out(p, cfg, _merge(cfg, out, m, l), x), cache


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
