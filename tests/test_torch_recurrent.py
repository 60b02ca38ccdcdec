"""Port parity: the layers of slice 3, one by one.

The Mamba2 SSD block (``models/ssm.py``), the Griffin RG-LRU block
(``models/rglru.py``) and the sliding-window ring cache of
``models/attention.py`` (kind "l": prefill into the ring, the dense decode
with a pad vector, the per-slot paged decode) against the reference's, on
the reference's parameters carried across and inputs drawn with numpy, in
float32 on the reduced mamba2-1.3b and recurrentgemma-2b configs.
Outputs and caches are held to 1e-5 (float32 through one layer; the scans
inside to their own 1e-4).  The port steps its caches in place, the
reference returns new ones: both are compared after each step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import attention as r_attn
from repro.models import rglru as r_rglru
from repro.models import ssm as r_ssm
from repro_torch import _tree
from repro_torch.configs import base as p_base
from repro_torch.models import attention as p_attn
from repro_torch.models import rglru as p_rglru
from repro_torch.models import ssm as p_ssm

TOL = dict(rtol=1e-5, atol=1e-5)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _params(tree):
    """A reference parameter dict as the port's (float32 on the CPU)."""
    return _tree.from_numpy({k: np.asarray(v) for k, v in tree.items()},
                            "cpu")


def _configs(name):
    return (r_reduced(r_get_config(name)),
            p_base.reduced(p_base.get_config(name)))


def _x(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _pad_mask(b, s, pads):
    return np.arange(s)[None, :] >= np.asarray(pads)[:, None]


def _caches_close(p_cache, r_cache, tol=SCAN_TOL):
    for got, want in zip(p_cache, r_cache):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("s,pads", [(12, None), (12, [0, 5]), (2, None),
                                    (9, [3, 8])])
def test_apply_ssm_matches_reference(s, pads):
    """Full sequences, ragged rows (pad inputs zeroed, scan reset) and a
    sequence shorter than the conv window (a left-padded conv tail)."""
    r_cfg, p_cfg = _configs("mamba2-1.3b")
    r_p = r_ssm.init_ssm(jax.random.PRNGKey(1), r_cfg)
    p_p = _params(r_p)
    x = _x(r_cfg, 2, s, seed=s)
    mask = None if pads is None else _pad_mask(2, s, pads)
    r_out, r_cache = r_ssm.apply_ssm(
        r_p, r_cfg, jnp.asarray(x), want_cache=True,
        pad_mask=None if mask is None else jnp.asarray(mask))
    p_out, p_cache = p_ssm.apply_ssm(
        p_p, p_cfg, torch.from_numpy(x), want_cache=True,
        pad_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(p_out), _np(r_out), **SCAN_TOL)
    _caches_close(p_cache, r_cache)
    assert p_cache.conv.shape == (2, p_cfg.conv_width - 1,
                                  p_ssm._dims(p_cfg)[-1])
    np.testing.assert_allclose(
        _np(p_ssm.apply_ssm(p_p, p_cfg, torch.from_numpy(x), pad_mask=None
                            if mask is None else torch.from_numpy(mask))),
        _np(p_out), rtol=0, atol=0)


def test_ssm_decode_steps_match_reference_in_place():
    r_cfg, p_cfg = _configs("mamba2-1.3b")
    r_p = r_ssm.init_ssm(jax.random.PRNGKey(2), r_cfg)
    p_p = _params(r_p)
    x = _x(r_cfg, 2, 7, seed=3)
    _, r_cache = r_ssm.apply_ssm(r_p, r_cfg, jnp.asarray(x), want_cache=True)
    _, p_cache = p_ssm.apply_ssm(p_p, p_cfg, torch.from_numpy(x),
                                 want_cache=True)
    steps = _x(r_cfg, 2, 4, seed=4)
    for t in range(4):
        xt = steps[:, t:t + 1]
        r_y, r_cache = r_ssm.apply_ssm_decode(r_p, r_cfg, jnp.asarray(xt),
                                              r_cache)
        p_y, same = p_ssm.apply_ssm_decode(p_p, p_cfg, torch.from_numpy(xt),
                                           p_cache)
        assert same is p_cache
        np.testing.assert_allclose(_np(p_y), _np(r_y), **SCAN_TOL)
        _caches_close(p_cache, r_cache)
    fresh = p_ssm.init_ssm_cache(p_cfg, (3, 2), torch.float32)
    ref_fresh = r_ssm.init_ssm_cache(r_cfg, 2, jnp.float32)
    assert fresh.conv.shape == (3,) + ref_fresh.conv.shape
    assert fresh.state.shape == (3,) + ref_fresh.state.shape


@pytest.mark.parametrize("s,pads", [(12, None), (12, [0, 5]), (2, None)])
def test_apply_rglru_matches_reference(s, pads):
    r_cfg, p_cfg = _configs("recurrentgemma-2b")
    r_p = r_rglru.init_rglru(jax.random.PRNGKey(5), r_cfg)
    p_p = _params(r_p)
    x = _x(r_cfg, 2, s, seed=s + 10)
    mask = None if pads is None else _pad_mask(2, s, pads)
    r_out, r_cache = r_rglru.apply_rglru(
        r_p, r_cfg, jnp.asarray(x), want_cache=True,
        pad_mask=None if mask is None else jnp.asarray(mask))
    p_out, p_cache = p_rglru.apply_rglru(
        p_p, p_cfg, torch.from_numpy(x), want_cache=True,
        pad_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(p_out), _np(r_out), **SCAN_TOL)
    _caches_close(p_cache, r_cache)


def test_rglru_decode_steps_match_reference_in_place():
    r_cfg, p_cfg = _configs("recurrentgemma-2b")
    r_p = r_rglru.init_rglru(jax.random.PRNGKey(6), r_cfg)
    p_p = _params(r_p)
    r_cache = r_rglru.init_rglru_cache(r_cfg, 2, jnp.float32)
    p_cache = p_rglru.init_rglru_cache(p_cfg, 2, torch.float32)
    steps = _x(r_cfg, 2, 5, seed=7)
    for t in range(5):
        xt = steps[:, t:t + 1]
        r_y, r_cache = r_rglru.apply_rglru_decode(r_p, r_cfg, jnp.asarray(xt),
                                                  r_cache)
        p_y, same = p_rglru.apply_rglru_decode(p_p, p_cfg,
                                               torch.from_numpy(xt), p_cache)
        assert same is p_cache
        np.testing.assert_allclose(_np(p_y), _np(r_y), **TOL)
        _caches_close(p_cache, r_cache, TOL)


@pytest.fixture(scope="module")
def ring():
    """recurrentgemma's reduced attention (4 heads over 1 kv head, hd 16,
    window 8) with the reference's weights."""
    r_cfg, p_cfg = _configs("recurrentgemma-2b")
    r_p = r_attn.init_attention(jax.random.PRNGKey(8), r_cfg)
    return r_cfg, p_cfg, r_p, _params(r_p)


@pytest.mark.parametrize("s", [5, 12])
def test_ring_prefill_and_padded_decode_match_reference(ring, s):
    """A prompt shorter and longer than the window goes into the ring at
    slot pos % window; then the dense decode (shared position, a pad
    vector) steps past the window's wrap."""
    r_cfg, p_cfg, r_p, p_p = ring
    w = r_cfg.window
    rng = np.random.default_rng(s)
    kv = [rng.standard_normal((2, s, 1, 16)).astype(np.float32)
          for _ in range(2)]
    r_ring = r_attn.prefill_into_ring(
        r_attn.init_ring_cache(r_cfg, 2, jnp.float32), *map(jnp.asarray, kv),
        s)
    p_ring = p_attn.prefill_into_ring(
        p_attn.init_ring_cache(p_cfg, 2, torch.float32),
        *map(torch.from_numpy, kv), s)
    _caches_close(p_ring, r_ring, TOL)
    assert p_ring.pos.dtype == torch.int32
    assert int((p_ring.pos >= 0).sum()) == 2 * min(s, w)
    pad = np.array([0, 3], np.int32)
    steps = _x(r_cfg, 2, w + 3, seed=s + 1)
    for t in range(w + 3):
        xt = steps[:, t:t + 1]
        r_out, r_ring = r_attn.decode_self_attention(
            r_p, r_cfg, jnp.asarray(xt), r_ring, s + t, kind="l",
            pad=jnp.asarray(pad))
        p_out, _ = p_attn.decode_self_attention(
            p_p, p_cfg, torch.from_numpy(xt), p_ring, s + t, kind="l",
            pad=torch.from_numpy(pad))
        np.testing.assert_allclose(_np(p_out), _np(r_out), **TOL)
        _caches_close(p_ring, r_ring, TOL)


def test_paged_ring_decode_matches_reference(ring):
    """Per-slot rings: each row writes slot seq_len % window at its own
    semantic position; an idle row (seq_len 0) steps garbage."""
    r_cfg, p_cfg, r_p, p_p = ring
    rng = np.random.default_rng(9)
    w = r_cfg.window
    r_ring = r_attn.init_ring_cache(r_cfg, 3, jnp.float32)
    p_ring = p_attn.init_ring_cache(p_cfg, 3, torch.float32)
    seq_lens = np.array([0, 5, 11], np.int32)
    table = np.zeros((3, 1), np.int32)
    for t in range(w + 2):
        xt = rng.standard_normal((3, 1, r_cfg.d_model)).astype(np.float32)
        r_out, r_ring = r_attn.decode_self_attention_paged(
            r_p, r_cfg, jnp.asarray(xt), r_ring, kind="l",
            block_table=jnp.asarray(table), seq_lens=jnp.asarray(seq_lens))
        p_out, _ = p_attn.decode_self_attention_paged(
            p_p, p_cfg, torch.from_numpy(xt), p_ring, kind="l",
            block_table=torch.from_numpy(table),
            seq_lens=torch.from_numpy(seq_lens))
        np.testing.assert_allclose(_np(p_out)[1:], _np(r_out)[1:], **TOL)
        _caches_close(p_ring, r_ring, TOL)
        seq_lens[1:] += 1
