"""Port parity: the decoder entry points on the ring and recurrent stacks.

``forward_train``, ``prefill`` (with left pads), ``decode_step``,
``prefill_chunk`` and ``decode_step_paged`` (with the pool commits of
``serving.kvpool``) against the reference's, on three reduced stacks in
float32: recurrentgemma-2b ("r", "r", "l" units and an "r", "r" tail),
mamba2-1.3b (all "s") and the reference's mixed ``hybrid-grs`` stack of
``tests/test_ragged.py`` ("g", "r", "s").  The reference's parameters are
carried across with ``params_from_reference``; inputs are drawn with
numpy.  Logits are held to 1e-4 and greedy tokens must be identical; ring
and recurrent cache rows to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.serving import kvpool as r_kvpool
from repro_torch.configs import base as p_base
from repro_torch.models import attention as p_attn
from repro_torch.models import transformer as p_tf
from repro_torch.serving import kvpool as p_kvpool

TOL = dict(rtol=1e-4, atol=1e-4)


def hybrid_grs(get_config, reduced):
    """tests/test_ragged.py's mixed stack: attention, RG-LRU and SSD in one
    unit."""
    return dataclasses.replace(
        reduced(get_config("mamba2-1.3b")), name="hybrid-grs-smoke",
        block_pattern=("g", "r", "s"), n_layers=6, n_heads=4, n_kv=2,
        head_dim=16, d_ff=128, rnn_width=32)


STACKS = {
    "recurrentgemma": lambda g, r: r(g("recurrentgemma-2b")),
    "mamba2": lambda g, r: r(g("mamba2-1.3b")),
    "hybrid-grs": hybrid_grs,
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cores(tree):
    """Every cache leaf as numpy, in tree order."""
    return [_np(x) for x in jax.tree_util.tree_leaves(
        {"units": tree["units"], "tail": tree["tail"]})]


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    """(reference cfg, port cfg, reference params, port params, the
    reference's entry points compiled once per shape)."""
    make = STACKS[request.param]
    r_cfg = make(r_get_config, r_reduced)
    p_cfg = make(p_base.get_config, p_base.reduced)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    jit = dict(
        prefill=jax.jit(lambda p, t, pad: r_tf.prefill(p, r_cfg, {"tokens": t},
                                                       s_max=48, pad=pad)),
        decode=jax.jit(lambda p, c, t: r_tf.decode_step(p, r_cfg, c, t)),
        chunk=jax.jit(lambda p, c, t, s, n: r_tf.prefill_chunk(p, r_cfg, c, t,
                                                               s, n)),
        paged=jax.jit(lambda p, c, t, bt, sl: r_tf.decode_step_paged(
            p, r_cfg, c, t, bt, sl)))
    return r_cfg, p_cfg, r_params, p_params, jit


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                shape).astype(np.int32)


def test_forward_train_and_tail_match_reference(stack):
    r_cfg, p_cfg, r_params, p_params, _ = stack
    toks = _tokens(p_cfg, (2, 11), 1)
    r_lg, _ = r_tf.forward_train(r_params, r_cfg, {"tokens": jnp.asarray(toks)})
    p_lg, aux = p_tf.forward_train(p_params, p_cfg,
                                   {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    assert float(aux) == 0.0
    assert len(p_params.get("tail", [])) == len(p_cfg.tail_pattern)
    assert p_tf.param_count(p_params) == sum(
        int(x.size) for x in jax.tree.leaves(r_params))


def test_padded_prefill_and_decode_match_reference(stack):
    """A ragged batch (left pads 0 and 5) through prefill, then 4 decode
    steps past the reduced window of 8: logits, tokens and every cache
    leaf (KV, ring K/V/positions, conv and recurrent state)."""
    r_cfg, p_cfg, r_params, p_params, jit = stack
    toks = _tokens(p_cfg, (2, 16), 2)
    pad = np.array([0, 5], np.int32)
    r_lg, r_c = jit["prefill"](r_params, jnp.asarray(toks), jnp.asarray(pad))
    p_lg, p_c = p_tf.prefill(p_params, p_cfg, {"tokens": torch.from_numpy(toks)},
                             s_max=48, pad=torch.from_numpy(pad))
    np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    for got, want in zip(_cores(p_c), _cores(r_c)):
        np.testing.assert_allclose(got, want, **TOL)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(r_lg, -1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(p_lg, -1).numpy(), nxt)
        r_lg, r_c = jit["decode"](r_params, r_c, jnp.asarray(nxt))
        p_lg, p_c = p_tf.decode_step(p_params, p_cfg, p_c,
                                     torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    assert p_c["pos"] == 20 and p_c["pad"].tolist() == [0, 5]
    for got, want in zip(_cores(p_c), _cores(r_c)):
        np.testing.assert_allclose(got, want, **TOL)


def test_chunked_prefill_matches_reference_and_whole_prompt(stack):
    """A 21-token prompt in chunks of 8 (the last one 5 real tokens and 3
    of right pad): each chunk's logits and the stream's cache match the
    reference's, and the last chunk's logits are the whole prompt's."""
    r_cfg, p_cfg, r_params, p_params, jit = stack
    prompt = _tokens(p_cfg, (21,), 3)
    c = 8
    r_lg, r_c = jit["prefill"](r_params, jnp.asarray(prompt[None, :c]), None)
    p_lg, p_c = p_tf.prefill(p_params, p_cfg,
                             {"tokens": torch.from_numpy(prompt[None, :c])},
                             s_max=48)
    r_c = {"units": r_c["units"], "tail": r_c["tail"]}
    p_c = {"units": p_c["units"], "tail": p_c["tail"]}
    for start in (8, 16):
        n_valid = min(c, 21 - start)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :n_valid] = prompt[start:start + n_valid]
        r_lg, r_c = jit["chunk"](r_params, r_c, jnp.asarray(chunk),
                                 jnp.int32(start), jnp.int32(n_valid))
        p_lg, p_c = p_tf.prefill_chunk(p_params, p_cfg, p_c,
                                       torch.from_numpy(chunk), start, n_valid)
        np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    whole, w_c = p_tf.prefill(p_params, p_cfg,
                              {"tokens": torch.from_numpy(prompt[None])},
                              s_max=48)
    np.testing.assert_allclose(_np(p_lg), _np(whole), **TOL)
    # the right-pad steps of the last chunk moved no ring or recurrent state
    for kind, name in zip(p_cfg.block_pattern, p_c["units"]):
        if kind != "g":
            for got, want in zip(p_c["units"][name], w_c["units"][name]):
                np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_paged_decode_after_commits_matches_reference(stack):
    """The pool of ``init_decode_state`` (3 slots): a left-padded solo
    prefill committed into slot 2, a 2-chunk stream into slot 0, slot 1
    idle; then 3 paged decode ticks.  Logits of the live slots, every
    ring and recurrent row of the live slots and every pool block but
    the dummy block 0 match the reference's."""
    r_cfg, p_cfg, r_params, p_params, jit = stack
    slots, n_blocks, bs = 3, 13, 4
    r_state = r_kvpool.init_decode_state(r_cfg, r_params, slots, n_blocks, bs)
    p_state = p_kvpool.init_decode_state(p_cfg, p_params, slots, n_blocks, bs)
    assert [x.shape for x in jax.tree_util.tree_leaves(r_state)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(p_state)]

    # slot 2: a 9-token prompt in the 16 bucket (pad 7), blocks 1-3 (+ dummy)
    prompt = _tokens(p_cfg, (9,), 4)
    toks = np.pad(prompt, (7, 0))[None]
    ids = np.array([1, 2, 3, 0], np.int32)
    r_lg2, r_solo = jit["prefill"](r_params, jnp.asarray(toks),
                                   jnp.asarray([7], jnp.int32))
    p_lg2, p_solo = p_tf.prefill(p_params, p_cfg,
                                 {"tokens": torch.from_numpy(toks)}, s_max=48,
                                 pad=torch.tensor([7], dtype=torch.int32))
    r_state = r_kvpool.commit_prefill(
        r_state, {"units": r_solo["units"], "tail": r_solo["tail"]},
        jnp.int32(7), jnp.int32(2), jnp.asarray(ids), block_size=bs)
    p_kvpool.commit_prefill(p_state, {"units": p_solo["units"],
                                      "tail": p_solo["tail"]}, 7, 2,
                            torch.from_numpy(ids).long(), block_size=bs)

    # slot 0: a 13-token stream in chunks of 8, blocks 4-7
    stream = _tokens(p_cfg, (13,), 5)
    row = np.array([4, 5, 6, 7] + [0] * 8, np.int32)
    r_lg0, r_sc = jit["prefill"](r_params, jnp.asarray(stream[None, :8]), None)
    p_lg0, p_sc = p_tf.prefill(p_params, p_cfg,
                               {"tokens": torch.from_numpy(stream[None, :8])},
                               s_max=48)
    r_sc = {"units": r_sc["units"], "tail": r_sc["tail"]}
    p_sc = {"units": p_sc["units"], "tail": p_sc["tail"]}
    r_state = r_kvpool.commit_chunk(r_state, r_sc, jnp.int32(0), jnp.int32(8),
                                    jnp.int32(0), jnp.asarray(row),
                                    block_size=bs)
    p_kvpool.commit_chunk(p_state, p_sc, 0, 8, 0, torch.from_numpy(row).long(),
                          block_size=bs)
    chunk = np.zeros((1, 8), np.int32)
    chunk[0, :5] = stream[8:]
    r_lg0, r_sc = jit["chunk"](r_params, r_sc, jnp.asarray(chunk),
                               jnp.int32(8), jnp.int32(5))
    p_lg0, p_sc = p_tf.prefill_chunk(p_params, p_cfg, p_sc,
                                     torch.from_numpy(chunk), 8, 5)
    r_state = r_kvpool.commit_chunk(r_state, r_sc, jnp.int32(8), jnp.int32(5),
                                    jnp.int32(0), jnp.asarray(row),
                                    block_size=bs)
    p_kvpool.commit_chunk(p_state, p_sc, 8, 5, 0, torch.from_numpy(row).long(),
                          block_size=bs)

    table = np.zeros((slots, 12), np.int32)
    table[0, :4] = [4, 5, 6, 7]
    table[2, :3] = [1, 2, 3]
    seq_lens = np.array([13, 0, 9], np.int32)
    last = np.array([int(np.argmax(_np(r_lg0))), 0,
                     int(np.argmax(_np(r_lg2)))], np.int32)
    assert last[0] == int(torch.argmax(p_lg0)) and \
        last[2] == int(torch.argmax(p_lg2))
    for _ in range(3):
        r_lg, r_state = jit["paged"](r_params, r_state, jnp.asarray(last),
                                     jnp.asarray(table), jnp.asarray(seq_lens))
        p_lg, p_state = p_tf.decode_step_paged(
            p_params, p_cfg, p_state, torch.from_numpy(last).long(),
            torch.from_numpy(table).long(), torch.from_numpy(seq_lens).long())
        live = [0, 2]
        np.testing.assert_allclose(_np(p_lg)[live], _np(r_lg)[live], **TOL)
        nxt = torch.argmax(p_lg, -1).numpy()
        np.testing.assert_array_equal(nxt[live],
                                      np.asarray(jnp.argmax(r_lg, -1))[live])
        last[live] = nxt[live]
        seq_lens[live] += 1
    layers = [(p_state["units"][k], r_state["units"][k], 1)
              for k in p_state["units"]]
    layers += [(pc, rc, 0) for pc, rc in zip(p_state["tail"],
                                            r_state["tail"])]
    for p_cache, r_cache, ax in layers:
        for got, want in zip(p_cache, r_cache):
            got, want = _np(got), _np(want)
            if isinstance(p_cache, p_attn.KVCache):
                # a pool: every block but the dummy block 0
                got = np.take(got, range(1, n_blocks), axis=ax)
                want = np.take(want, range(1, n_blocks), axis=ax)
            else:
                # one row per slot: the live slots
                got, want = np.take(got, live, axis=ax), np.take(want, live,
                                                                 axis=ax)
            np.testing.assert_allclose(got, want, **TOL)


def test_ring_commit_reslots_to_semantic_positions():
    """A left-padded prompt longer than the window: the committed ring row
    holds each real entry at slot (position - pad) % window with that
    position, and the pad entries at -1."""
    cfg = p_base.reduced(p_base.get_config("recurrentgemma-2b"))
    w, pad, s = cfg.window, 3, 14
    ring = p_attn.init_ring_cache(cfg, (1, 1), torch.float32)
    k = torch.arange(s, dtype=torch.float32)[None, :, None, None].expand(
        1, s, 1, 16).contiguous()
    p_attn.prefill_into_ring(p_attn.RingCache(ring.k[0], ring.v[0],
                                              ring.pos[0]), k, k, s)
    state = {"units": {"slot0": p_attn.init_ring_cache(cfg, (1, 2),
                                                       torch.float32)},
             "tail": []}
    p_kvpool.commit_prefill(state, {"units": {"slot0": ring}, "tail": []},
                            pad, 1, torch.zeros(1, dtype=torch.long),
                            block_size=4)
    row = state["units"]["slot0"]
    pos = row.pos[0, 1].tolist()
    for slot, p in enumerate(pos):
        assert p >= 0                         # 14 > window + pad: no pads left
        assert slot == p % w
        assert float(row.k[0, 1, slot, 0, 0]) == p + pad
    assert row.pos[0, 0].tolist() == [-1] * w     # the other slot untouched
