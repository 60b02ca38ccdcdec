"""CUDA decode attention: one query token's GQA attention against a cache,
dense under a (B, S) validity mask or paged through a block table.

The Hopper kernel is ``csrc/decode_attention.cu``; it replaces the TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas``.  It is built
on first use through ``kernels._build`` and launched on PyTorch's current
stream.  It splits S over blocks (``decode_splits``) and merges the splits
in a second, small kernel.  The plain version is
``kernels.ref.decode_attention_ref`` (the paged entry: the gather of
``ops.decode_attention_paged`` on the CPU, then that).

Both wrappers take ``with_ml``: the partial entry, which also returns each
(row, head)'s float32 softmax max and sum (``kernels.ref.merge_partials``
merges such partials of one sequence's blocks).

``decode_attention_cuda.launches`` counts launches: it rises by one each
time either wrapper launches the kernel, and nowhere else;
``decode_attention_cuda.ml_launches`` counts the partial entry's among
them.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import DTYPES, HEAD_DIMS, check_qkv

SMS = 132                  # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS
SPLIT_KEYS = 64            # a split is a multiple of this many keys
MAX_ROWS = 16              # query heads of a block; more make head groups


def _bind(lib) -> None:
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("decode_attention",
                         _build.CSRC / "decode_attention.cu", _bind)


def head_groups(group: int) -> int:
    """Blocks that share one kv head's ``group`` query heads."""
    return -(-group // MAX_ROWS)


def decode_splits(batch: int, kv_heads: int, s: int) -> tuple[int, int]:
    """(splits, keys per split) for ``batch`` rows x ``kv_heads`` (x head
    groups) blocks over S keys: the fewest splits of whole SPLIT_KEYS tiles
    that give about TARGET_BLOCKS blocks, or one tile a split where S is too
    short for that.  Every split holds at least one key."""
    tiles = -(-s // SPLIT_KEYS)
    want = -(-TARGET_BLOCKS // (batch * kv_heads))
    per = max(1, tiles // want)
    return -(-tiles // per), per * SPLIT_KEYS


def _launch(q, k, v, mask, table, seq_lens, s: int, table_width: int,
            block_size: int, with_ml: bool = False):
    b, _, h, hd = q.shape
    kv = k.shape[2]
    splits, chunk = decode_splits(b, kv * head_groups(h // kv), s)
    lib = LIBRARY.load()
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(b * h * splits * hd, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(b * h * splits * 2, dtype=torch.float32,
                              device=q.device)
    ml = (torch.empty((2, b, h), dtype=torch.float32, device=q.device)
          if with_ml else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    device = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    err = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), ptr(table),
        ptr(seq_lens), out.data_ptr(), ptr(part_acc), ptr(part_ml), ptr(ml),
        b, s, h,
        kv, hd, DTYPES[q.dtype], table_width, block_size, chunk, splits,
        1.0 / (hd ** 0.5), device,
        torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err)
    decode_attention_cuda.launches += 1
    if not with_ml:
        return out
    decode_attention_cuda.ml_launches += 1
    return out, ml[0], ml[1]


def decode_attention_cuda(q, k, v, valid_mask, *, with_ml: bool = False):
    """q (B, 1, H, hd), k/v (B, S, KV, hd), valid_mask (B, S) bool ->
    (B, 1, H, hd) in q's dtype.  A row with no valid key gets the uniform
    average of its S values (the reference's semantics).  ``with_ml``:
    (out, m, l), m and l the float32 softmax max and sum of each (row,
    head), (B, H) each (masked keys score -1e30)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    check_qkv(q, k, v)
    b, s = q.shape[0], k.shape[1]
    if (valid_mask.shape != (b, s) or valid_mask.dtype != torch.bool
            or valid_mask.device != q.device
            or not valid_mask.is_contiguous()):
        raise ValueError(f"valid_mask must be a contiguous ({b}, {s}) bool "
                         f"tensor on {q.device}")
    return _launch(q, k, v, valid_mask, None, None, s, 0, 0, with_ml)


def decode_attention_paged_cuda(q, k_pool, v_pool, block_table, seq_lens, *,
                                with_ml: bool = False):
    """q (B, 1, H, hd); pools (n_blocks, bs, KV, hd); block_table (B, M)
    int32; seq_lens (B,) int32 -> (B, 1, H, hd) in q's dtype.

    The same result as gathering ``k_pool[block_table]`` into
    (B, M * bs, KV, hd) and calling ``decode_attention_cuda`` with the mask
    ``j <= seq_lens[b]``; the kernel reads the pool through the table and
    never reads a key past ``min(seq_lens[b] + 1, M * bs)``.  ``with_ml``
    as for ``decode_attention_cuda`` (the keys past that bound weigh
    nothing in l).
    """
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    if (k_pool.dim() != 4 or k_pool.shape != v_pool.shape
            or k_pool.shape[3] != hd):
        raise ValueError(f"k_pool {tuple(k_pool.shape)} and v_pool "
                         f"{tuple(v_pool.shape)} must be (n_blocks, bs, KV, "
                         f"{hd})")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q and the pools must share one of {list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    kv = k_pool.shape[2]
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads over {kv} kv heads: need a "
                         f"multiple")
    for name, t, dims in (("block_table", block_table, 2),
                          ("seq_lens", seq_lens, 1)):
        if (t.dtype != torch.int32 or t.dim() != dims or t.shape[0] != b
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dims}-d int32 "
                             f"tensor on {q.device} with {b} rows, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    m = block_table.shape[1]
    if m == 0 or k_pool.shape[1] == 0:
        raise ValueError("empty block table or block")
    for t in (q, k_pool, v_pool):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q and the pools must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q and the pools must be contiguous and 16-byte "
                             "aligned")
    bs = k_pool.shape[1]
    return _launch(q, k_pool, v_pool, None, block_table, seq_lens, m * bs, m,
                   bs, with_ml)


decode_attention_cuda.launches = 0
decode_attention_cuda.ml_launches = 0
