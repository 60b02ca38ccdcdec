"""The KV cache's sequence over "model" (ROADMAP 7d) against the
reference's unsharded decode.

Where the query heads are split over "model" and the kv heads do not
divide it, a rank's dense and ring caches hold every kv head of its block
of the sequence (``SeqKVCache``, ``SeqRingCache``), as the reference
policy's ``cache_spec`` splits them.

* Two gloo worlds (``launch.mesh.run_world``, rank bodies in
  ``tests/_kv_seq.py``) run reduced gemma3-1b (4 query heads over 1 kv
  head, "l" rings of 8 and a "g" layer) on a 2-way model axis and the
  g/r/s hybrid (4 over 2) on a 4-way one, from the reference's
  parameters: a left-padded batch's prefill and 14 greedy decode steps
  (the rings wrap), and a prompt prefilled in chunks then decoded.  The
  float32 tokens equal the reference's unsharded ``prefill`` /
  ``prefill_chunk`` / ``decode_step``.  ``transformer.pool_layout`` (the
  continuous engine's one all-gather an admission, before
  ``kvpool.commit_prefill``) gives the rank's kv heads of the one-rank
  cache.  The continuous engine's tokens after such commits are held by
  tests/test_torch_model_axis_recurrent.py, whose recurrentgemma (M 2)
  and hybrid (M 4) views split their caches so.
* The plain partial attention and its merge (``kernels.ref``): blocks of
  a sequence attended apart and merged equal the whole, for the decode
  and chunk forms, including a row with no valid key anywhere (the
  uniform average of every value) and a block with none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _kv_seq as kq
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.kernels import ref as r_ref
from repro.models import transformer as r_tf
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding

import _model_axis as ma


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


class _Jitted:
    """The reference's entry points, jitted (eager JAX dispatches each op
    through Python)."""
    prefill = jax.jit(r_tf.prefill, static_argnames=("cfg", "s_max"))
    decode_step = jax.jit(r_tf.decode_step, static_argnames=("cfg",))
    prefill_chunk = jax.jit(r_tf.prefill_chunk,
                            static_argnames=("cfg", "start", "n_valid"))


def _reference(name, params) -> dict:
    cfg = kq.config(name, r_get_config, r_reduced)
    argmax = lambda logits: np.asarray(jnp.argmax(logits, -1)).astype(
        np.int32)
    return {"greedy": kq.greedy(_Jitted, params, cfg, jnp.asarray, argmax),
            "chunked": kq.chunked(_Jitted, params, cfg, jnp.asarray, argmax)}


@pytest.fixture(scope="module")
def worlds():
    from concurrent.futures import ThreadPoolExecutor
    params = {name: r_tf.init_params(
        jax.random.PRNGKey(0), kq.config(name, r_get_config, r_reduced))
        for name in kq.NAMES}
    with ThreadPoolExecutor(len(kq.NAMES)) as pool:
        runs = {name: pool.submit(
            pmesh.run_world, kq.world, m,
            args=(name, jax.tree.map(np.asarray, params[name])),
            deadline_s=300) for name, m in kq.NAMES.items()}
        want = {name: _reference(name, params[name]) for name in kq.NAMES}
        return {name: (want[name], run.result())
                for name, run in runs.items()}


@pytest.mark.parametrize("path", ["greedy", "chunked"])
@pytest.mark.parametrize("name", sorted(kq.NAMES))
def test_tokens_equal_the_unsharded_reference(worlds, name, path):
    want, ranks = worlds[name]
    assert max(kq.LENGTHS) + kq.NEW > 8         # the rings wrap
    for r, out in enumerate(ranks):
        assert out[path] == want[path], f"rank {r}"


@pytest.mark.parametrize("name", sorted(kq.NAMES))
def test_caches_hold_every_kv_head_of_a_block(worlds, name):
    """The split caches' shapes: the layers' dense K/V (units, rows,
    S_MAX / M, every kv head, hd), a ring's W / M slots."""
    _, ranks = worlds[name]
    m = kq.NAMES[name]
    cfg = kq.config(name, get_config, reduced)
    hd = cfg.resolved_head_dim
    for out in ranks:
        assert out["seq_caches"] and "attn" in out["split"]
        assert "SeqKVCache" in out["types"]
        assert ("SeqRingCache" in out["types"]) == ("l" in cfg.block_pattern)
        for path, shape in out["shapes"].items():
            leaf = path.rsplit("/", 1)[-1]
            slot = path.split("/")[1]
            kind = (cfg.block_pattern[int(slot.removeprefix("slot"))]
                    if path.startswith("units") else
                    cfg.tail_pattern[int(slot)])
            if kind not in ("g", "l") or leaf not in ("k", "v", "pos"):
                continue
            length = (kq.S_MAX if kind == "g" else cfg.window) // m
            if leaf == "pos":
                assert shape[-1] == length, path
            else:
                assert shape[-3:] == (length, cfg.n_kv, hd), path


@pytest.mark.parametrize("name", sorted(kq.NAMES))
def test_pool_layout_gathers_the_rank_run(worlds, name):
    _, ranks = worlds[name]
    for out in ranks:
        assert not [t for t in out["pool_types"] if t.startswith("Seq")]
        assert out["pool_err"]
        for path, err in out["pool_err"].items():
            assert err <= 1e-5, (path, err)


def test_engine_stacks_split_their_caches():
    """tests/test_torch_model_axis_recurrent.py's continuous and sync
    engines run through split caches and ``pool_layout``: recurrentgemma
    (4 query heads over 1) on 2 ranks, the hybrid (4 over 2) on 4."""
    from repro_torch import shardctx
    for name, m in (("recurrentgemma", 2), ("hybrid-grs", 4)):
        cfg = ma.port_cfg(name)
        for r in range(m):
            assert shardctx.seq_caches(sharding.rank_view(cfg, m, r)), name
    assert not shardctx.seq_caches(
        sharding.rank_view(ma.port_cfg("qwen3"), 2, 0))


# -- the plain partial attention and its merge -------------------------------

def _inputs(b, s, h, kv, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)
    return rnd(b, 1, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd)


def _valid(b, s):
    """Row 0 every key, row 1 the second half alone, row 2 none, row 3
    every other key."""
    valid = torch.ones(b, s, dtype=torch.bool)
    valid[1, : s // 2] = False
    valid[2] = False
    valid[3, ::2] = False
    return valid


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("h,kv", [(4, 1), (4, 2), (8, 8)])
def test_decode_blocks_merge_to_the_whole(blocks, h, kv):
    b, s, hd = 4, 32, 16
    q, k, v = _inputs(b, s, h, kv, hd)
    valid = _valid(b, s)
    whole = ops.decode_attention(q, k, v, valid)
    r_whole = r_ref.decode_attention_ref(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, valid)))
    np.testing.assert_allclose(whole.numpy(), np.asarray(r_whole),
                               rtol=2e-5, atol=2e-5)
    # the partial entry's output is the plain one's
    out, m, l = ops.decode_attention(q, k, v, valid, with_ml=True)
    assert torch.equal(out, whole) and m.shape == l.shape == (b, h)
    # row 2 has no valid key: max -1e30, its sum the key count
    assert torch.all(m[2] == -1e30) and torch.all(l[2] == s)
    parts = [ops.decode_attention(q, kc, vc, mc, with_ml=True)
             for kc, vc, mc in zip(k.chunk(blocks, 1), v.chunk(blocks, 1),
                                   valid.chunk(blocks, 1))]
    merged = ref.merge_partials(*(torch.stack(t) for t in zip(
        *((o[:, 0], mb, lb) for o, mb, lb in parts))))
    torch.testing.assert_close(merged, whole[:, 0], rtol=2e-5, atol=2e-5)
    # the row with no valid key is the uniform average of every value
    uniform = v[2].mean(0).repeat_interleave(h // kv, 0)
    torch.testing.assert_close(merged[2], uniform, rtol=2e-5, atol=2e-5)
    # row 1's first block has no valid key and weighs nothing
    assert torch.all(parts[0][1][1] == -1e30)


@pytest.mark.parametrize("blocks", [2, 4])
def test_chunk_blocks_merge_to_the_whole(blocks):
    b, c, s, h, kv, hd, start = 2, 5, 32, 4, 2, 16, 9
    g = torch.Generator().manual_seed(3)
    q = torch.randn(b, c, h, hd, generator=g)
    k, v = (torch.randn(b, s, kv, hd, generator=g) for _ in range(2))
    whole = ops.chunk_attention(q, k, v, start=start)
    lb = s // blocks
    parts = [ops.chunk_attention(q, k[:, i * lb:(i + 1) * lb],
                                 v[:, i * lb:(i + 1) * lb], start=start,
                                 first=i * lb, with_ml=True)
             for i in range(blocks)]
    merged = ref.merge_partials(*(torch.stack(t) for t in zip(*parts)))
    torch.testing.assert_close(merged, whole, rtol=2e-5, atol=2e-5)
    # the blocks past the chunk's last position hold no valid key
    assert torch.all(parts[-1][1] == -1e30)
