"""Port parity: the cross-attention kinds ("x", "d") and the encoder ("e")
of ``models/transformer.py`` and ``models/attention.py`` against the
reference.

Reduced llama-3.2-vision-90b (four "g" layers and one "x" layer a unit, two
units, 8 image embeddings) and reduced seamless-m4t-large-v2 (two "d"
layers over a two-layer "e" encoder, 20 source frames) run in float32 with
the reference's parameters carried across by ``params_from_reference``;
tokens and embeddings are drawn with numpy.  ``forward_train`` logits,
``prefill`` logits and every cache leaf (the context K/V included), with
and without a left pad, and three ``decode_step``s are held to 1e-4; the
port's decode equals its own teacher-forced logits at the reference's
2e-4.  The reference runs jitted on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import attention as r_attn
from repro.models import transformer as r_tf
from repro_torch.configs import base as p_base
from repro_torch.models import attention as p_attn
from repro_torch.models import transformer as p_tf

ARCHS = ("llama-3.2-vision-90b", "seamless-m4t-large-v2")
TOL = dict(rtol=1e-4, atol=1e-4)
TF_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_archs.py's
B, S, CTX = 2, 16, {"llama-3.2-vision-90b": 8, "seamless-m4t-large-v2": 20}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference cfg, port cfg, reference params, port params,
    numpy batch)."""
    arch = request.param
    r_cfg = r_reduced(r_get_config(arch))
    p_cfg = p_base.reduced(p_base.get_config(arch))
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(
        jax.tree.map(np.asarray, r_params), p_cfg, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, r_cfg.vocab, (B, S)).astype(np.int32)}
    key = "image_embeds" if r_cfg.frontend == "vision" else "src_embeds"
    batch[key] = rng.standard_normal((B, CTX[arch], r_cfg.d_model)
                                     ).astype(np.float32)
    return arch, r_cfg, p_cfg, r_params, p_params, batch


def _batches(batch, upto=None):
    cut = lambda a, k: a[:, :upto] if k == "tokens" and upto else a
    r = {k: jnp.asarray(cut(v, k)) for k, v in batch.items()}
    p = {k: torch.from_numpy(np.array(cut(v, k))) for k, v in batch.items()}
    p["tokens"] = p["tokens"].long()
    return r, p


def _flat(tree):
    """Leaves in a canonical order (dict keys sorted, sequences in order)
    for both packages' caches."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def test_forward_train_logits_match_reference(model):
    _, r_cfg, p_cfg, r_params, p_params, batch = model
    rb, pb = _batches(batch)
    r_lg, r_aux = jax.jit(lambda p, b: r_tf.forward_train(p, r_cfg, b))(
        r_params, rb)
    p_lg, p_aux = p_tf.forward_train(p_params, p_cfg, pb)
    assert p_lg.shape == (B, S, p_cfg.vocab) and p_lg.dtype == torch.float32
    np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    assert float(p_aux) == float(r_aux) == 0.0


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_caches_and_decode_steps_match_reference(model, padded):
    arch, r_cfg, p_cfg, r_params, p_params, batch = model
    half = S // 2
    rb, pb = _batches(batch, half)
    pad = np.array([0, 3], np.int32) if padded else None
    s_max = S + 4
    r_lg, r_cache = jax.jit(
        lambda p, b, pad: r_tf.prefill(p, r_cfg, b, s_max=s_max, pad=pad))(
        r_params, rb, None if pad is None else jnp.asarray(pad))
    p_lg, p_cache = p_tf.prefill(
        p_params, p_cfg, pb, s_max=s_max,
        pad=None if pad is None else torch.from_numpy(pad))
    np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    core = lambda c: {"units": c["units"], "tail": c["tail"]}
    r_leaves, p_leaves = _flat(core(r_cache)), _flat(core(p_cache))
    assert [tuple(x.shape) for x in p_leaves] == \
        [tuple(x.shape) for x in r_leaves]
    for got, want in zip(p_leaves, r_leaves):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    ctx_slot = r_cfg.block_pattern.index("x" if "x" in r_cfg.block_pattern
                                         else "d")
    ctx = p_cache["units"][f"slot{ctx_slot}"]["ctx_kv"]
    assert ctx.k.shape[:3] == (p_cfg.n_units, B, CTX[arch])

    r_step = jax.jit(lambda p, c, t: r_tf.decode_step(p, r_cfg, c, t))
    for t in range(half, half + 3):
        tok = batch["tokens"][:, t]
        r_lg, r_cache = r_step(r_params, r_cache, jnp.asarray(tok))
        p_lg, p_cache = p_tf.decode_step(p_params, p_cfg, p_cache,
                                         torch.from_numpy(tok).long())
        np.testing.assert_allclose(_np(p_lg), _np(r_lg), **TOL)
    assert p_cache["pos"] == half + 3


def test_decode_equals_teacher_forcing(model):
    """The reference's own serving invariant, on the port: a prefill of
    the first half and three decode steps on the next tokens give the
    teacher-forced logits."""
    _, _, p_cfg, _, p_params, batch = model
    _, pb = _batches(batch)
    full, _ = p_tf.forward_train(p_params, p_cfg, pb)
    half = S // 2
    _, pre = _batches(batch, half)
    lg, cache = p_tf.prefill(p_params, p_cfg, pre, s_max=S + 4)
    np.testing.assert_allclose(_np(lg), _np(full[:, half - 1]), **TF_TOL)
    for t in range(half, half + 3):
        lg, cache = p_tf.decode_step(p_params, p_cfg, cache,
                                     pb["tokens"][:, t])
        np.testing.assert_allclose(_np(lg), _np(full[:, t]), **TF_TOL)


def test_cross_attention_paths_match_reference(model):
    """``context_kv``, ``cross_attention`` (Sq != Sk, full) and
    ``decode_cross_attention`` of one "x"/"d" layer on the same inputs."""
    arch, r_cfg, p_cfg, r_params, p_params, batch = model
    slot = r_cfg.block_pattern.index("x" if "x" in r_cfg.block_pattern
                                     else "d")
    r_p = jax.tree.map(lambda a: a[0], r_params["units"][f"slot{slot}"])
    p_p = {k: v[0] for k, v in
           p_params["units"][f"slot{slot}"]["xattn"].items()}
    r_p = r_p["xattn"]
    assert "q_norm" not in p_p and sorted(p_p) == sorted(r_p)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 5, r_cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((B, CTX[arch], r_cfg.d_model)).astype(np.float32)
    r_kv = r_attn.context_kv(r_p, r_cfg, jnp.asarray(ctx))
    p_kv = p_attn.context_kv(p_p, p_cfg, torch.from_numpy(ctx))
    for got, want in zip(p_kv, r_kv):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(
        _np(p_attn.cross_attention(p_p, p_cfg, torch.from_numpy(x), p_kv)),
        _np(r_attn.cross_attention(r_p, r_cfg, jnp.asarray(x), r_kv)), **TOL)
    np.testing.assert_allclose(
        _np(p_attn.decode_cross_attention(p_p, p_cfg,
                                          torch.from_numpy(x[:, :1]), p_kv)),
        _np(r_attn.decode_cross_attention(r_p, r_cfg,
                                          jnp.asarray(x[:, :1]), r_kv)),
        **TOL)


def test_params_from_reference_checks_the_encoder_depth():
    cfg = p_base.reduced(p_base.get_config("seamless-m4t-large-v2"))
    r_cfg = r_reduced(r_get_config("seamless-m4t-large-v2"))
    tree = jax.tree.map(np.asarray,
                        r_tf.init_params(jax.random.PRNGKey(0), r_cfg))
    p = p_tf.params_from_reference(tree, cfg, "cpu")
    assert p["encoder"]["units"]["slot0"]["attn"]["wq"].shape[0] == \
        cfg.enc_layers
    tree["encoder"]["units"] = jax.tree.map(lambda a: a[:1],
                                            tree["encoder"]["units"])
    with pytest.raises(ValueError, match="enc_layers=2"):
        p_tf.params_from_reference(tree, cfg, "cpu")
