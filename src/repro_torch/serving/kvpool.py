"""Paged KV-cache pool for continuous-batching serving.

Port of ``repro/serving/kvpool.py``.  The KV cache of every unit-stacked
"g" or "m" layer lives in a block pool
``(U, n_blocks, block_size, KV, hd)``; a host-side :class:`BlockAllocator`
hands out blocks, and block 0 is a reserved dummy that idle decode rows
write into.  Each slot's block table maps its logical blocks to pool
blocks; the paged decode gathers them back into a contiguous view for the
decode-attention kernel.

Sliding-window rings ("l") hold a fixed ``window`` of slots and recurrent
state ("r", "s") is O(1) per request, so those live as plain per-slot rows
(batch axis = decode slots), as in the reference.

Where the reference returns a new pool, the port writes into the pool it
was given (``commit_prefill``, ``commit_chunk``).

Under a "model" mesh the pool's kv-head dim shards M ways where the kv
heads divide M (``_pool_leaf_spec``, the reference's policy), and holds
the kv heads the rank's query heads read where they do not; the block tables, ``seq_lens`` and the
allocator stay on the host, replicated, so every rank makes the same
decisions.  The policy replicates recurrent state; the rank-local layout
(``launch.sharding``) keeps the RG-LRU's and the SSD's state of its own
channels and heads.  The engine builds its rank's pool directly from its
``RankConfig`` (``init_decode_state``), which is the pool
``place_decode_state`` cuts from the whole one.
"""
from __future__ import annotations

from collections import deque

import torch

from ..models import transformer
from ..models.attention import KVCache, RingCache
from ..models.common import dtype_of


class BlockAllocator:
    """Host-side free-list over the KV block pool.

    Block 0 is reserved as the dummy block (idle decode rows write there);
    ``capacity`` is therefore ``n_blocks - 1``.  Every block is either in
    the free list or handed out: ``free()`` of a block never handed out
    raises, both paths validate their whole argument before changing
    anything, and ``alloc()`` rolls back if it finds the free list corrupt.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved dummy), "
                             f"got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free: deque[int] = deque(range(1, n_blocks))
        self._handed: set[int] = set()

    @property
    def capacity(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def handed_out(self) -> frozenset[int]:
        return frozenset(self._handed)

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` blocks, or None (and no side effect) if unavailable."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        got: list[int] = []
        for _ in range(n):
            b = self._free.popleft()
            if b in self._handed:            # corrupted free list: roll back
                self._free.extendleft(reversed(got + [b]))
                raise ValueError(f"free list corrupted: block {b} is both "
                                 f"free and handed out")
            got.append(b)
        self._handed.update(got)
        return got

    def free(self, blocks) -> None:
        """Return blocks to the free list; a bad batch raises with the
        allocator unchanged."""
        blocks = list(blocks)
        seen: set[int] = set()
        for b in blocks:
            if not 1 <= b < self.n_blocks:
                raise ValueError(f"block {b} outside pool (dummy block 0 is "
                                 f"never allocated)")
            if b in seen:
                raise ValueError(f"double free of block {b} (duplicated "
                                 f"within one free() batch)")
            if b not in self._handed:
                if b in self._free:
                    raise ValueError(f"double free of block {b}")
                raise ValueError(f"free of block {b} that was never handed "
                                 f"out")
            seen.add(b)
        for b in blocks:
            self._handed.discard(b)
            self._free.append(b)


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV entries (at least one)."""
    return max(1, -(-tokens // block_size))


def pool_stats(allocator: BlockAllocator, seq_lens, owned) -> dict:
    """Host-side pool gauges: free blocks, utilization (allocated /
    capacity) and internal fragmentation (wasted token slots inside
    allocated blocks / allocated token capacity)."""
    cap = allocator.capacity
    allocated = sum(len(blocks) for blocks in owned)
    used_tokens = sum(int(seq_lens[i]) for i in range(len(owned))
                      if owned[i])
    alloc_tokens = allocated * allocator.block_size
    return {
        "n_free": allocator.n_free,
        "capacity": cap,
        "allocated": allocated,
        "utilization": allocated / cap if cap else 0.0,
        "fragmentation": (1.0 - used_tokens / alloc_tokens
                          if alloc_tokens else 0.0),
    }


SERVED = ("g", "l", "m", "r", "s")


def check_pattern(cfg, sync: bool = False) -> None:
    """Raise a ``ValueError`` unless ``cfg`` is a plain decoder stack of
    the kinds the engine serves (g/l/m/r/s): the cross-attention kinds need
    a context that token requests do not carry, and an encoder needs source
    frames.  The continuous engine's message is the reference's; the sync
    engine, which the reference lets fail at its first prefill, says why."""
    bad = set("xde") & (set(cfg.block_pattern) | set(cfg.tail_pattern or ()))
    if bad or cfg.enc_layers:
        hint = ("the sync engine passes tokens only, no image or source "
                "embeddings" if sync else
                "use ServingEngine(sync_batching=True)")
        raise ValueError(
            f"continuous batching serves plain decoder stacks (g/l/m/r/s); "
            f"{cfg.name} has {sorted(bad) or 'encoder layers'} -- {hint}")


def init_decode_state(cfg, params, slots: int, n_blocks: int,
                      block_size: int) -> dict:
    """The zeroed continuous-decode state on the parameters' device, with
    the structure of a ``transformer.prefill`` cache (no ``pos``/``pad``):
    each "g" and "m" layer's KV as a block pool ``(U, n_blocks,
    block_size, KV, hd)`` (tail layers without the U axis), and each ring
    ("l") and recurrent ("r", "s") cache with one row per decode slot."""
    check_pattern(cfg)
    device = params["embed"].device
    dt = dtype_of(cfg.compute_dtype)

    def build(kind, lead):
        if kind not in ("g", "m"):
            return transformer.new_cache(cfg, kind, (*lead, slots), 0, device,
                                         seq=False)
        shape = (*lead, n_blocks, block_size, cfg.n_kv,
                 cfg.resolved_head_dim)
        return KVCache(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device))

    return {"units": {f"slot{i}": build(kind, (cfg.n_units,))
                      for i, kind in enumerate(cfg.block_pattern)},
            "tail": [build(kind, ()) for kind in cfg.tail_pattern]}


def _pairs(state, solo):
    """(decode-state cache, solo cache) of every layer, each with a leading
    layer axis (a tail cache gets a view with one)."""
    for name, pool in state["units"].items():
        yield pool, solo["units"][name]
    lead = lambda c: type(c)(*[t.unsqueeze(0) for t in c])
    for pool, one in zip(state["tail"], solo["tail"]):
        yield lead(pool), lead(one)


def _copy_rows(pool, one, slot: int) -> None:
    """A ring or recurrent cache of the batch-1 solo run into decode row
    ``slot``, whole."""
    for dst, src in zip(pool, one):
        dst[:, slot] = src[:, 0]


def commit_prefill(state, solo, pad: int, slot: int, block_ids, *,
                   block_size: int):
    """Write one solo-prefilled request into the decode state, in place.

    ``solo`` is the {"units", "tail"} cache of a batch-1 bucketed prefill
    and ``pad`` its left-pad count.  Global KV: ``block_ids`` (nb,) are the
    pool blocks for the bucket width (entries past the owned count are the
    dummy block 0, which absorbs the rolled-out pad); the token axis is
    rolled by -pad so the real tokens sit at positions 0.., then cut or
    zero-padded to ``nb * block_size`` and written block by block.  Rings:
    prefill stored entries at their padded positions, so the ring rolls by
    -pad to semantic slots and pad entries get position -1.  Recurrent
    state is copied whole.  Rings and recurrent state land in row
    ``slot``.
    """
    nb = block_ids.shape[0]
    want = nb * block_size
    pad = int(pad)
    for pool, one in _pairs(state, solo):
        if isinstance(pool, KVCache):
            for dst, leaf in ((pool.k, one.k), (pool.v, one.v)):
                x = torch.roll(leaf[:, 0], -pad, dims=1)   # (U, s_max, KV, hd)
                tok = x.shape[1]
                if want < tok:
                    x = x[:, :want]
                elif want > tok:
                    x = torch.cat([x, x.new_zeros((x.shape[0], want - tok)
                                                  + tuple(x.shape[2:]))],
                                  dim=1)
                dst[:, block_ids] = x.reshape(x.shape[0], nb, block_size,
                                              *x.shape[2:])
        elif isinstance(pool, RingCache):
            pos = torch.roll(one.pos[:, 0], -pad, dims=1)
            pool.k[:, slot] = torch.roll(one.k[:, 0], -pad, dims=1)
            pool.v[:, slot] = torch.roll(one.v[:, 0], -pad, dims=1)
            pool.pos[:, slot] = torch.where(pos >= pad, pos - pad, -1)
        else:
            _copy_rows(pool, one, slot)
    return state


def commit_chunk(state, solo, chunk_start: int, n_new: int, slot: int,
                 block_ids, *, block_size: int):
    """Write ONE prefill chunk of a streaming request into the decode state,
    in place.  Global KV: solo-scratch positions ``chunk_start ..
    chunk_start + n_new - 1`` go to their blocks in ``block_ids`` (the
    slot's full table row); the reference also routes the chunk's junk
    lanes into the dummy block 0, the port writes only the real positions,
    so every block but 0 ends up the same.  Rings and recurrent state are
    copied whole into row ``slot`` after every chunk (a chunk stream has no
    pad, so ring positions are already semantic): that overwrites what the
    decode ticks stepped into the streaming slot's rows meanwhile."""
    pos = chunk_start + torch.arange(n_new, device=block_ids.device)
    blk = block_ids[pos // block_size]
    off = pos % block_size
    for pool, one in _pairs(state, solo):
        if isinstance(pool, KVCache):
            for dst, leaf in ((pool.k, one.k), (pool.v, one.v)):
                dst[:, blk, off] = leaf[:, 0, chunk_start:chunk_start + n_new]
        else:
            _copy_rows(pool, one, slot)
    return state


def _pool_leaf_spec(mesh, path, leaf):
    """Placement policy for one decode-state leaf: pool/ring kv-head dims
    shard over "model" when divisible, everything else (block-shaped axes,
    ring positions, recurrent state) replicates."""
    from ..launch.sharding import P, _path_str
    from ..shardctx import mesh_axes

    axes = mesh_axes(mesh)
    if "model" not in axes:
        return P()
    m = axes["model"]
    name = _path_str(path).rsplit("/", 1)[-1]
    if name in ("k", "v") and leaf.ndim >= 4 and leaf.shape[-2] % m == 0:
        return P(*([None] * (leaf.ndim - 2)), "model", None)
    return P()


def decode_state_specs(mesh, state) -> list[tuple]:
    """``[(path_str, shape, spec)]`` for every decode-state leaf: the
    policy's (``state``'s leaves need only ``shape`` and ``ndim``; ``mesh``
    may be a shape-only stand-in).  ``place_decode_state`` applies it to
    the kv heads and the rank-local layout to the recurrent state."""
    from ..launch.sharding import map_with_paths
    out = []
    map_with_paths(lambda path, leaf: out.append(
        (path, tuple(leaf.shape), _pool_leaf_spec(mesh, path, leaf))), state)
    return out


def place_decode_state(mesh, state, cfg):
    """This rank's shard of a whole decode state of ``cfg`` under
    ``mesh``, by the rank-local layout (``launch.sharding.rank_config``):
    the pools' and rings' kv heads the rank's query heads read (its share
    where ``_pool_leaf_spec`` shards them, the run its query heads cover
    where the policy replicates them), the RG-LRU's conv tail and state by
    channel and the SSD's conv tail (x by head, B and C whole) and state
    by head where the layer is split; everything else whole.  It equals
    ``init_decode_state`` of the rank's ``RankConfig``."""
    from ..launch.sharding import (_kv_heads, _part, _ssm_columns,
                                   map_with_paths, rank_config)

    view = rank_config(mesh, cfg)
    m, r = view.model_size, view.model_rank

    def kind_of(path):
        parts = path.split("/")
        if parts[0] == "units":
            return cfg.block_pattern[int(parts[1].removeprefix("slot"))]
        return cfg.tail_pattern[int(parts[1])]

    def cut(path, leaf):
        kind, name = kind_of(path), path.rsplit("/", 1)[-1]
        if kind == "r" and "rglru" in view.split and name in ("conv", "h"):
            return _part(leaf, -1, r, m)
        if kind == "s" and "ssm" in view.split:
            if name == "conv":
                cols = torch.tensor(_ssm_columns(cfg, r, m, True),
                                    device=leaf.device)
                return leaf.index_select(-1, cols)
            if name == "state":
                return _part(leaf, -3, r, m)
        if name in ("k", "v") and "attn" in view.split:
            return _kv_heads(view, leaf, -2)
        return leaf

    return map_with_paths(cut, state)
