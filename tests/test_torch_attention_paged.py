"""Port parity: paged decode attention and the split-K plan.

``ops.decode_attention_paged`` reads a (n_blocks, bs, KV, hd) pool through a
(B, M) block table, row b seeing keys j <= seq_lens[b].  On the CPU it is the
gather the paged "g" decode always did, then the plain version; here it is
held against the reference's TPU kernel (``decode_attention_pallas`` in
interpret mode) on the gathered rows at the reference's attention tolerance,
2e-5 in float32 (tests/test_kernels.py), and against the port's dense
``ops.decode_attention`` bit for bit.  The CUDA kernel runs on the card only
(tests/test_torch_gpu.py); here its split plan and its wrapper's input checks
are tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import decode_attention as p_da
from repro_torch.kernels import ops as p_ops

TOL = dict(rtol=2e-5, atol=2e-5)


def paged_inputs(seed, b, m, bs, n_blocks, h, kv, hd, seq_lens):
    """q, pools and a scattered block table (each row's blocks drawn
    without repeats from the pool, block 0 included), numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k_pool = rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    v_pool = rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    table = np.stack([rng.permutation(n_blocks)[:m]
                      for _ in range(b)]).astype(np.int32)
    return q, k_pool, v_pool, table, np.asarray(seq_lens, np.int32)


def gathered(k_pool, v_pool, table, seq_lens):
    b, m = table.shape
    bs, kv, hd = k_pool.shape[1:]
    k = k_pool[table].reshape(b, m * bs, kv, hd)
    v = v_pool[table].reshape(b, m * bs, kv, hd)
    valid = np.arange(m * bs)[None, :] <= seq_lens[:, None]
    return k, v, valid


CASES = [
    # (b, m, bs, n_blocks, h, kv, hd, seq_lens): 0, a block boundary, the
    # table's last position M * bs - 1, and positions inside a block
    (4, 4, 16, 11, 4, 2, 32, [0, 15, 16, 63]),
    (3, 3, 8, 9, 6, 2, 16, [23, 7, 0]),
    (2, 5, 4, 12, 10, 1, 64, [19, 8]),
]


@pytest.mark.parametrize("b,m,bs,n_blocks,h,kv,hd,seq_lens", CASES)
def test_paged_matches_pallas_kernel_on_gathered_rows(b, m, bs, n_blocks, h,
                                                      kv, hd, seq_lens):
    q, k_pool, v_pool, table, lens = paged_inputs(
        sum(seq_lens), b, m, bs, n_blocks, h, kv, hd, seq_lens)
    k, v, valid = gathered(k_pool, v_pool, table, lens)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   valid_mask=jnp.asarray(valid), k_block=16,
                                   interpret=True)
    got = p_ops.decode_attention_paged(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(table).long(),
        torch.from_numpy(lens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,m,bs,n_blocks,h,kv,hd,seq_lens", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_equals_dense_entry_exactly(b, m, bs, n_blocks, h, kv, hd,
                                          seq_lens, dtype):
    """The paged entry is the dense entry on the gathered rows, bit for bit
    on the CPU, with int32 or int64 index tensors."""
    q, k_pool, v_pool, table, lens = paged_inputs(
        b + m, b, m, bs, n_blocks, h, kv, hd, seq_lens)
    k, v, valid = gathered(k_pool, v_pool, table, lens)
    t = lambda a: torch.from_numpy(a).to(dtype)
    want = p_ops.decode_attention(t(q), t(k), t(v), torch.from_numpy(valid))
    for index in (torch.int32, torch.int64):
        got = p_ops.decode_attention_paged(
            t(q), t(k_pool), t(v_pool), torch.from_numpy(table).to(index),
            torch.from_numpy(lens).to(index))
        assert got.dtype == dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("batch,kv_heads,s", [
    (8, 8, 512),          # qwen3-0.6b's decode tick
    (8, 1, 2048),         # recurrentgemma-2b's ring
    (1, 1, 5), (1, 1, 64), (1, 1, 65), (2, 4, 300), (1, 8, 32768),
    (64, 8, 512), (300, 1, 100), (3, 2, 1000)])
def test_decode_splits_cover_s_with_whole_tiles(batch, kv_heads, s):
    """Each split is whole 64-key tiles and holds a key; the splits cover S;
    the grid reaches 2 x 132 blocks wherever S has that many tiles."""
    splits, chunk = p_da.decode_splits(batch, kv_heads, s)
    assert splits >= 1 and chunk >= p_da.SPLIT_KEYS
    assert chunk % p_da.SPLIT_KEYS == 0
    assert (splits - 1) * chunk < s <= splits * chunk
    tiles = -(-s // p_da.SPLIT_KEYS)
    units = batch * kv_heads
    assert units * splits >= min(p_da.TARGET_BLOCKS, units * tiles)
    if units * tiles >= p_da.TARGET_BLOCKS:
        assert units * splits >= p_da.TARGET_BLOCKS


def test_decode_splits_at_the_served_shapes():
    """qwen3's tick gets one 64-key tile a split (8 x 8 x 8 = 512 blocks);
    recurrentgemma's ring at least 2 splits (32 of 64 keys: 256 blocks)."""
    assert p_da.decode_splits(8, 8, 512) == (8, 64)
    assert p_da.decode_splits(8, 1, 2048) == (32, 64)
    assert p_da.head_groups(10) == 1 and p_da.head_groups(40) == 3


def test_paged_wrapper_rejects_what_it_cannot_launch():
    q, k_pool, v_pool, table, lens = paged_inputs(0, 2, 3, 8, 7, 4, 2, 32,
                                                  [3, 9])
    q, k_pool, v_pool = (torch.from_numpy(a) for a in (q, k_pool, v_pool))
    table, lens = torch.from_numpy(table), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="CUDA"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table, lens)
    with pytest.raises(ValueError, match="int32"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table.long(),
                                         lens)
    with pytest.raises(ValueError, match="int32"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table,
                                         lens.long())
    with pytest.raises(ValueError, match="block_table"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table[:1], lens)
    with pytest.raises(ValueError, match="block_table"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table[:, 0], lens)
    with pytest.raises(ValueError, match="seq_lens"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table,
                                         lens[None])
    with pytest.raises(ValueError, match="k_pool"):
        p_da.decode_attention_paged_cuda(q, k_pool, v_pool[:, :4], table,
                                         lens)
    with pytest.raises(ValueError, match="share"):
        p_da.decode_attention_paged_cuda(q, k_pool.double(), v_pool, table,
                                         lens)
    with pytest.raises(ValueError, match=r"\(B, 1, H, hd\)"):
        p_da.decode_attention_paged_cuda(q[:, 0], k_pool, v_pool, table, lens)
