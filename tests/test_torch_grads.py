"""Port parity: gradients through the kernel entry points and the model.

The CPU arms of ``kernels.ops`` are plain torch and stay differentiable:
flash attention's gradients against ``jax.grad`` of the reference's
non-Pallas arm (1e-4 / 1e-5).  The CUDA arms of the kernels without a
backward (decode attention and the sweep) raise where a gradient is
wanted (``ops.refuse_grad``); the
rule's logic is held here, the raising on the card in
``test_torch_gpu.py``.  ``cross_entropy`` against the reference's;
``run_units``' one unbind per leaf leaves serving's prefill unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.models import steps as r_steps
from repro_torch import _tree
from repro_torch.configs import base as p_base
from repro_torch.kernels import ops as p_ops
from repro_torch.models import steps as p_steps
from repro_torch.models import transformer as p_tf


def _np(x):
    return x.detach().float().cpu().numpy()


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_reference(with_mask):
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if with_mask else None
    want = r_steps.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 None if mask is None else jnp.asarray(mask))
    got = p_steps.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(targets),
                                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if with_mask:   # an all-zero mask divides by 1, not 0
        zero = np.zeros_like(mask)
        np.testing.assert_allclose(
            float(p_steps.cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(targets),
                                        torch.from_numpy(zero))),
            float(r_steps.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(targets),
                                        jnp.asarray(zero))))




@pytest.mark.parametrize("kind,sq,sk,window,pad", [
    ("causal", 24, 24, 0, None), ("local", 24, 24, 6, None),
    ("full", 10, 30, 0, None), ("causal", 24, 24, 0, [0, 5, 24]),
    ("local", 24, 24, 6, [3, 0, 11])])
def test_flash_attention_gradients_match_reference(kind, sq, sk, window,
                                                   pad):
    """Autograd through the port's CPU arm against ``jax.grad`` of the
    reference's non-Pallas arm, GQA 6 heads over 2."""
    rng = np.random.default_rng(7)
    b = 3
    q = rng.normal(size=(b, sq, 6, 16)).astype(np.float32)
    k = rng.normal(size=(b, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(b, sk, 2, 16)).astype(np.float32)
    dout = rng.normal(size=(b, sq, 6, 16)).astype(np.float32)
    mask = None if pad is None else (np.arange(sk)[None, :]
                                     >= np.asarray(pad)[:, None])

    def r_loss(q, k, v):
        out = r_ops.flash_attention(q, k, v, kind=kind, window=window,
                                    pad_mask=None if mask is None
                                    else jnp.asarray(mask))
        return jnp.sum(out * dout)

    want = jax.jit(jax.grad(r_loss, argnums=(0, 1, 2)))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = p_ops.flash_attention(*leaves, kind=kind, window=window,
                                pad_mask=None if mask is None
                                else torch.from_numpy(mask))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_gradient_rule_refuses_kernels_without_a_backward():
    """``refuse_grad`` raises, naming the kernel and its ROADMAP item,
    exactly when autograd records and an input requires grad (the CUDA arms
    call it; the CPU arms stay differentiable)."""
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    for name in p_ops.NO_BACKWARD:
        with pytest.raises(NotImplementedError, match=name) as info:
            p_ops.refuse_grad(name, y, x)
        assert "ROADMAP" in str(info.value)
        p_ops.refuse_grad(name, y, y)                  # nothing wants a grad
        with torch.no_grad():
            p_ops.refuse_grad(name, x)
    # the scans have backward kernels since the SSD and RG-LRU Functions
    assert set(p_ops.NO_BACKWARD) == {"decode_attention",
                                      "decode_attention_paged",
                                      "partition_sweep"}
    assert p_ops.grad_wanted(y, x) and not p_ops.grad_wanted(y, None)


def test_unstacked_units_leave_prefill_unchanged(monkeypatch):
    """``run_units`` takes each unit from one ``torch.unbind`` per leaf;
    serving's prefill logits and caches equal those of indexing each unit
    out, bit for bit."""
    cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), n_layers=4)
    params = p_tf.init_params(0, cfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    logits, caches = p_tf.prefill(params, cfg, {"tokens": tokens}, s_max=24,
                                  pad=[0, 3])
    n = cfg.n_units
    monkeypatch.setattr(p_tf, "_unstack", lambda units: [
        _tree.index(units, u) for u in range(n)])
    logits2, caches2 = p_tf.prefill(params, cfg, {"tokens": tokens},
                                    s_max=24, pad=[0, 3])
    assert torch.equal(logits, logits2)
    for a, b in zip(_tree.leaves(caches["units"]),
                    _tree.leaves(caches2["units"])):
        assert torch.equal(a, b)
