"""Port parity: configs, LM profiles, model primitives and the transformer
entry points.

The reference's parameters (``repro.models.transformer.init_params``) are
carried into the port with ``params_from_reference``: the two packages draw
different random streams, so the same seed would give different weights.
Inputs are drawn with numpy.  Everything runs in float32 on
``reduced(get_config("qwen3-0.6b"), n_layers=4)``; logits are held to 1e-4
and greedy tokens must be identical.  Profiles and configs are pure data
and must agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import load_all as r_load_all
from repro.configs.base import reduced as r_reduced
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import ffn as r_ffn
from repro.models import transformer as r_tf
from repro.profiling.lmprofiles import all_lm_profiles as r_all_profiles
from repro.serving import kvpool as r_kvpool
from repro_torch.configs import base as p_base
from repro_torch.models import attention as p_attn
from repro_torch.models import common as p_common
from repro_torch.models import ffn as p_ffn
from repro_torch.models import transformer as p_tf
from repro_torch.profiling.lmprofiles import all_lm_profiles as p_all_profiles
from repro_torch.serving import kvpool as p_kvpool

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
PRIM_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    r_cfg = r_reduced(r_get_config("qwen3-0.6b"), n_layers=4)
    p_cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), n_layers=4)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and profiles
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    r_all, p_all = r_load_all(), p_base.load_all()
    assert sorted(r_all) == sorted(p_all) and len(p_all) == 10
    for name, r_cfg in r_all.items():
        p_cfg = p_all[name]
        assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg), name
        assert p_cfg.n_units == r_cfg.n_units
        assert dataclasses.asdict(p_base.reduced(p_cfg, n_layers=4 * len(
            p_cfg.block_pattern) + len(p_cfg.tail_pattern))) == \
            dataclasses.asdict(r_reduced(r_cfg, n_layers=4 * len(
                r_cfg.block_pattern) + len(r_cfg.tail_pattern)))
    assert p_base.get_config("qwen3-0.6b") is p_all["qwen3-0.6b"]
    for name in ("no-such-arch", "qwen3_0_6b"):     # "_" maps to "-" in both
        with pytest.raises(KeyError):
            r_get_config(name)
        with pytest.raises(KeyError):
            p_base.get_config(name)


@pytest.mark.parametrize("tokens", [64, 128])
def test_lm_profiles_match_reference(tokens):
    r_prof, p_prof = r_all_profiles(tokens), p_all_profiles(tokens)
    assert sorted(r_prof) == sorted(p_prof) and len(p_prof) == 10
    for name, r in r_prof.items():
        p = p_prof[name]
        assert p.layer_names == r.layer_names
        for field in ("macs", "param_bytes", "act_bytes"):
            np.testing.assert_array_equal(getattr(p, field),
                                          getattr(r, field), err_msg=name)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_norms_rope_and_masks_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    tx, ts = torch.from_numpy(x), torch.from_numpy(scale)
    np.testing.assert_allclose(_np(p_common.rms_norm(tx, ts)),
                               _np(r_common.rms_norm(x, scale)), **PRIM_TOL)
    np.testing.assert_allclose(_np(p_common.head_rms_norm(tx, ts)),
                               _np(r_common.head_rms_norm(x, scale)),
                               **PRIM_TOL)
    for pos in (np.arange(7), np.maximum(np.arange(7)[None] - np.array([[0], [3]]), 0)):
        np.testing.assert_allclose(
            _np(p_common.rope(tx, torch.from_numpy(pos), 1e6)),
            _np(r_common.rope(x, jnp.asarray(pos), 1e6)), rtol=1e-5, atol=1e-5)
    xb = x.astype(ml_dtypes.bfloat16)
    got = p_common.rms_norm(tx.to(torch.bfloat16), ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(r_common.rms_norm(xb, scale)),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_array_equal(p_common.causal_mask(5, 7, 2).numpy(),
                                  np.asarray(r_common.causal_mask(5, 7, 2)))
    np.testing.assert_array_equal(p_common.local_mask(5, 7, 3, 1).numpy(),
                                  np.asarray(r_common.local_mask(5, 7, 3, 1)))
    assert p_common.dtype_of("bfloat16") == torch.bfloat16


@pytest.mark.parametrize("gated,s", [(True, 12), (False, 12), (True, 8192)])
def test_ffn_matches_reference(gated, s):
    """Gated (silu) and plain (tanh gelu) FFNs; 8192 tokens take the
    chunked path."""
    cfg = r_reduced(r_get_config("qwen3-0.6b"), gated_ffn=gated)
    pcfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), gated_ffn=gated)
    p = r_ffn.init_ffn(jax.random.PRNGKey(1), cfg)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal((1, s, 64)).astype(np.float32)
    np.testing.assert_allclose(_np(p_ffn.apply_ffn(pp, pcfg, torch.from_numpy(x))),
                               _np(r_ffn.apply_ffn(p, cfg, x)),
                               rtol=1e-5, atol=1e-5)


def test_self_attention_matches_reference(model):
    r_cfg, p_cfg, r_params, p_params = model
    r_p = jax.tree.map(lambda a: a[0], r_params["units"]["slot0"]["attn"])
    p_p = {k: v[0] for k, v in p_params["units"]["slot0"]["attn"].items()}
    x = np.random.default_rng(2).standard_normal((2, 9, 64)).astype(np.float32)
    pad = np.array([0, 4])
    pos = np.maximum(np.arange(9)[None] - pad[:, None], 0)
    mask = np.arange(9)[None] >= pad[:, None]
    r_out, (r_k, r_v) = r_attn.self_attention(
        r_p, r_cfg, x, jnp.asarray(pos), kind="g", pad_mask=jnp.asarray(mask))
    p_out, (p_k, p_v) = p_attn.self_attention(
        p_p, p_cfg, torch.from_numpy(x), torch.from_numpy(pos), kind="g",
        pad_mask=torch.from_numpy(mask))
    for got, want in ((p_out, r_out), (p_k, r_k), (p_v, r_v)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# transformer entry points
# ---------------------------------------------------------------------------

def test_params_from_reference_keeps_structure_and_values(model):
    r_cfg, p_cfg, r_params, p_params = model
    r_leaves = jax.tree_util.tree_leaves_with_path(r_params)
    assert p_tf.param_count(p_params) == r_tf.param_count(r_params)
    for path, leaf in r_leaves:
        node = p_params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    assert p_params["units"]["slot0"]["attn"]["wq"].shape[0] == p_cfg.n_units
    # bf16 leaves (ml_dtypes) come across bit for bit
    tree = jax.tree.map(lambda a: np.asarray(a).astype(ml_dtypes.bfloat16),
                        jax.tree.map(np.asarray, r_params))
    bf = p_tf.params_from_reference(tree, p_cfg, "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].view(torch.int16).numpy(),
        tree["embed"].view(np.int16))
    wrong = dataclasses.replace(p_cfg, n_layers=2)
    with pytest.raises(ValueError, match="n_units"):
        p_tf.params_from_reference(jax.tree.map(np.asarray, r_params), wrong,
                                   "cpu")


def test_forward_train_logits_match_reference(model):
    r_cfg, p_cfg, r_params, p_params = model
    toks = _tokens(r_cfg, (2, 13), 3)
    want, _ = r_tf.forward_train(r_params, r_cfg, {"tokens": jnp.asarray(toks)})
    got, aux = p_tf.forward_train(p_params, p_cfg,
                                  {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_steps_match_reference(model, padded):
    """prefill (with a left pad) then five decode_steps: logits to 1e-4,
    identical greedy tokens, the same K/V in every real cache slot."""
    r_cfg, p_cfg, r_params, p_params = model
    toks = _tokens(r_cfg, (2, 11), 4)
    pad = np.array([0, 6], np.int32) if padded else None
    s_max = 24
    r_lg, r_c = r_tf.prefill(r_params, r_cfg, {"tokens": jnp.asarray(toks)},
                             s_max=s_max,
                             pad=None if pad is None else jnp.asarray(pad))
    p_lg, p_c = p_tf.prefill(p_params, p_cfg,
                             {"tokens": torch.from_numpy(toks).long()},
                             s_max=s_max,
                             pad=None if pad is None else torch.from_numpy(pad))
    np.testing.assert_allclose(_np(p_lg), _np(r_lg), **LOGIT_TOL)
    assert p_c["pos"] == int(r_c["pos"]) and ("pad" in p_c) == padded
    np.testing.assert_allclose(_np(p_c["units"]["slot0"].k),
                               _np(r_c["units"]["slot0"].k), rtol=1e-5,
                               atol=1e-5)
    r_tok = jnp.argmax(r_lg, -1)
    p_tok = torch.argmax(p_lg, -1)
    for _ in range(5):
        assert p_tok.tolist() == np.asarray(r_tok).tolist()
        r_lg, r_c = r_tf.decode_step(r_params, r_cfg, r_c, r_tok.astype(jnp.int32))
        p_lg, p_c = p_tf.decode_step(p_params, p_cfg, p_c, p_tok)
        np.testing.assert_allclose(_np(p_lg), _np(r_lg), **LOGIT_TOL)
        r_tok, p_tok = jnp.argmax(r_lg, -1), torch.argmax(p_lg, -1)
    assert p_c["pos"] == int(r_c["pos"]) == 16


def test_prefill_chunk_stream_matches_reference(model):
    """A 21-token prompt in chunks of 8 (chunk 1 a plain prefill, the last
    right-padded): every chunk's logits match, and the last equal the
    whole-prompt prefill's."""
    r_cfg, p_cfg, r_params, p_params = model
    prompt = _tokens(r_cfg, (21,), 5)
    c, s_max = 8, 32
    _, r_c = r_tf.prefill(r_params, r_cfg,
                          {"tokens": jnp.asarray(prompt[None, :c])}, s_max=s_max)
    _, p_c = p_tf.prefill(p_params, p_cfg,
                          {"tokens": torch.from_numpy(prompt[None, :c]).long()},
                          s_max=s_max)
    r_c = {"units": r_c["units"], "tail": r_c["tail"]}
    p_c = {"units": p_c["units"], "tail": p_c["tail"]}
    for start in (8, 16):
        n_valid = min(c, 21 - start)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, :n_valid] = prompt[start:start + n_valid]
        r_lg, r_c = r_tf.prefill_chunk(r_params, r_cfg, r_c, jnp.asarray(chunk),
                                       jnp.int32(start), jnp.int32(n_valid))
        p_lg, p_c = p_tf.prefill_chunk(p_params, p_cfg, p_c,
                                       torch.from_numpy(chunk).long(), start,
                                       n_valid)
        np.testing.assert_allclose(_np(p_lg), _np(r_lg), **LOGIT_TOL)
    whole, _ = p_tf.prefill(p_params, p_cfg,
                            {"tokens": torch.from_numpy(prompt[None]).long()},
                            s_max=s_max)
    np.testing.assert_allclose(_np(p_lg), _np(whole), **LOGIT_TOL)
    np.testing.assert_allclose(_np(p_c["units"]["slot0"].v[:, :, :21]),
                               _np(r_c["units"]["slot0"].v[:, :, :21]),
                               rtol=1e-5, atol=1e-5)


def test_decode_step_paged_matches_reference(model):
    """Three paged decode steps over a pool holding two committed prompts
    and an idle slot: logits to 1e-4, identical tokens, the same pool."""
    r_cfg, p_cfg, r_params, p_params = model
    bs, n_blocks, slots = 4, 12, 3
    r_state = r_kvpool.init_decode_state(r_cfg, r_params, slots, n_blocks, bs)
    p_state = p_kvpool.init_decode_state(p_cfg, p_params, slots, n_blocks, bs)
    table = np.zeros((slots, 4), np.int32)
    seq_lens = np.zeros(slots, np.int32)
    last = np.zeros(slots, np.int32)
    for slot, (n, blocks) in enumerate([(6, [3, 7]), (9, [1, 2, 5])]):
        prompt = _tokens(r_cfg, (n,), 6 + slot)
        width = 8 if n <= 8 else 16
        toks = np.pad(prompt, (width - n, 0))[None]
        pad = width - n
        ids = np.zeros(-(-width // bs), np.int32)
        ids[:len(blocks)] = blocks
        r_lg, r_solo = r_tf.prefill(r_params, r_cfg, {"tokens": jnp.asarray(toks)},
                                    s_max=16, pad=jnp.asarray([pad], jnp.int32))
        p_lg, p_solo = p_tf.prefill(p_params, p_cfg,
                                    {"tokens": torch.from_numpy(toks).long()},
                                    s_max=16, pad=torch.tensor([pad]))
        r_state = r_kvpool.commit_prefill(
            r_state, {"units": r_solo["units"], "tail": r_solo["tail"]},
            jnp.int32(pad), jnp.int32(slot), jnp.asarray(ids), block_size=bs)
        p_kvpool.commit_prefill(p_state, {"units": p_solo["units"], "tail": []},
                                pad, slot, torch.from_numpy(ids).long(),
                                block_size=bs)
        table[slot, :len(blocks)] = blocks
        seq_lens[slot] = n
        last[slot] = int(torch.argmax(p_lg[0]))
        assert last[slot] == int(jnp.argmax(r_lg[0]))
    for _ in range(3):
        r_lg, r_state = r_tf.decode_step_paged(
            r_params, r_cfg, r_state, jnp.asarray(last), jnp.asarray(table),
            jnp.asarray(seq_lens))
        p_lg, p_state = p_tf.decode_step_paged(
            p_params, p_cfg, p_state, torch.from_numpy(last).long(),
            torch.from_numpy(table).long(), torch.from_numpy(seq_lens).long())
        np.testing.assert_allclose(_np(p_lg)[:2], _np(r_lg)[:2], **LOGIT_TOL)
        nxt = torch.argmax(p_lg, -1).numpy()
        np.testing.assert_array_equal(nxt[:2], np.asarray(jnp.argmax(r_lg, -1))[:2])
        last[:2] = nxt[:2]
        seq_lens[:2] += 1
    # every block but the dummy block 0 holds the same K/V
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            _np(getattr(p_state["units"]["slot0"], leaf))[:, 1:],
            _np(getattr(r_state["units"]["slot0"], leaf))[:, 1:],
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,slice_word", [
    ("moonshot-v1-16b-a3b", "MoE"), ("llama4-maverick-400b-a17b", "MoE"),
    ("llama-3.2-vision-90b", "cross-attention"),
    ("seamless-m4t-large-v2", "cross-attention")])
def test_unported_layer_kinds_raise_naming_their_slice(arch, slice_word):
    """The kinds an earlier slice refused ("m"; "x", "e", "d") are ported:
    the port's own ``init_params`` gives the reference's structure and
    shapes (the encoder's units lead with ``enc_layers``), with the MoE
    block or the cross-attention block the slice named, and
    ``params_from_reference`` carries every leaf across unchanged."""
    cfg = p_base.reduced(p_base.get_config(arch))
    p = p_tf.init_params(0, cfg, "cpu")
    r = r_tf.init_params(jax.random.PRNGKey(0), cfg_r(cfg))
    shapes = lambda t: sorted((jax.tree_util.keystr(k), tuple(v.shape))
                              for k, v in jax.tree_util.tree_leaves_with_path(t))
    assert shapes(jax.tree.map(lambda t: np.zeros(t.shape), p)) == shapes(r)
    block = "moe" if slice_word == "MoE" else "xattn"
    assert any(block in layer for layer in p["units"].values())
    if cfg.enc_layers:
        assert {t.shape[0] for t in p_tf._leaves(p["encoder"]["units"])} \
            == {cfg.enc_layers}
    carried = p_tf.params_from_reference(jax.tree.map(np.asarray, r), cfg,
                                         "cpu")
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(r),
                                 jax.tree.leaves(jax.tree.map(
                                     lambda t: t.numpy(), carried))):
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b",
                                  "mamba2-1.3b"])
def test_ring_and_recurrent_stacks_are_servable(arch):
    """The "l", "r" and "s" kinds (and tail stacks) are served: the port's
    own init gives the reference's parameter structure and shapes."""
    cfg = p_base.reduced(p_base.get_config(arch))
    p_kvpool.check_pattern(cfg)
    p = p_tf.init_params(0, cfg, "cpu")
    r = jax.eval_shape(lambda k: r_tf.init_params(k, cfg_r(cfg)),
                       jax.random.PRNGKey(0))
    shapes = lambda t: sorted((jax.tree_util.keystr(k), tuple(v.shape))
                              for k, v in jax.tree_util.tree_leaves_with_path(t))
    assert shapes(jax.tree.map(lambda t: np.zeros(t.shape), p)) == shapes(r)
    assert len(p.get("tail", [])) == len(cfg.tail_pattern)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_init_params_fills_stacks_bit_identical_to_stacking(arch):
    """``init_params`` fills each unit-stacked leaf one layer at a time in
    the draw order of the earlier build, which drew every layer and then
    stacked them: the seeded weights are bit-identical."""
    from repro_torch import _tree
    from repro_torch.models.common import dense_init, dtype_of, embed_init
    cfg = p_base.reduced(p_base.get_config(arch), param_dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    dt = dtype_of(cfg.param_dtype)
    old = {"embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt),
           "units": {f"slot{i}": _tree.stack(
               [p_tf._init_layer(gen, cfg, kind, "cpu")
                for _ in range(cfg.n_units)])
               for i, kind in enumerate(cfg.block_pattern)},
           "final_norm": torch.zeros(cfg.d_model, dtype=dt)}
    if cfg.tail_pattern:
        old["tail"] = [p_tf._init_layer(gen, cfg, kind, "cpu")
                       for kind in cfg.tail_pattern]
    if not cfg.tie_embeddings:
        old["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    new = p_tf.init_params(5, cfg, "cpu")
    assert _tree.leaves(new) and len(_tree.leaves(new)) == len(
        _tree.leaves(old))
    for a, b in zip(_tree.leaves(new), _tree.leaves(old)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_init_params_shapes_dtypes_and_device_rule():
    cfg = p_base.reduced(p_base.get_config("starcoder2-7b"), n_layers=2,
                         param_dtype="bfloat16")
    p = p_tf.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    r = jax.eval_shape(lambda k: r_tf.init_params(k, cfg_r(cfg)),
                       jax.random.PRNGKey(0))
    assert p_tf.param_count(p) == sum(int(np.prod(x.shape))
                                      for x in jax.tree.leaves(r))
    assert p["units"]["slot0"]["attn"]["bq"].shape == (2, 64)
    assert p["embed"].dtype == torch.bfloat16
    w = p["units"]["slot0"]["ffn"]["w1"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(64) + 1e-6   # truncated at 2 sigma
    again = p_tf.init_params(3, cfg, "cpu")
    assert torch.equal(again["embed"], p["embed"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            p_tf.init_params(0, cfg)


def cfg_r(p_cfg):
    """The reference's ArchConfig with the port config's fields."""
    from repro.configs.base import ArchConfig
    return ArchConfig(**dataclasses.asdict(p_cfg))
