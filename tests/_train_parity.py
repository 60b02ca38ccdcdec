"""Shared body of the LM-training parity tests (``models.steps``):
``test_torch_train.py``, ``test_torch_train_gemma3.py`` and
``test_torch_train_moe.py`` run it on reduced qwen3-0.6b, gemma3-1b and
moonshot-v1-16b-a3b, ``test_torch_train_scans.py`` on reduced mamba2-1.3b
and recurrentgemma-2b (XLA's compile of the reference's steps takes most
of each file's time, so each file stays under 40 s).

The reference's parameters are carried across with
``transformer.params_from_reference``; batches are drawn with numpy and fed
to both packages.  The reference's steps run jitted on the CPU through its
non-Pallas arm (the only arm it can differentiate).  Tolerances: each
step's loss within 1e-5 relative; each gradient leaf within 1e-4 of that
leaf's largest |g|; parameters after 3 steps within PARAM_TOL, measured:
the largest gap over the six cases is 3.78e-5 (moonshot, 2 microbatches;
the others 3.3e-6 to 3.64e-5), 1.3 % of the 3e-3 a parameter can move in
3 steps at lr 1e-3.  It comes from float32 sums taken in another order,
which Adam's m / sqrt(v) magnifies on leaves whose gradient is near zero;
the bound sits 2.6x above it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import steps as r_steps
from repro.models import transformer as r_tf
from repro_torch import _tree
from repro_torch.configs import base as p_base
from repro_torch.models import steps as p_steps
from repro_torch.models import transformer as p_tf

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # x the leaf's max |g|
PARAM_TOL = 1e-4
# each arch's reduced config; gemma3-1b's unit is cut from (l x 5, g) + (l,
# l) to (l, g) + (l,): its widths and flags, both attention kinds and a
# tail layer at a third of the layers (XLA's compile time grows with the
# unit's layers, and this file must stay under 40 s)
ARCHS = {"qwen3-0.6b": {},
         "gemma3-1b": dict(block_pattern=("l", "g"), tail_pattern=("l",),
                           n_layers=5),
         "moonshot-v1-16b-a3b": {},
         "mamba2-1.3b": {},
         "recurrentgemma-2b": {}}
B, S = 4, 16             # S above the reduced window (8): "l" masks bite


def _np(x):
    return x.detach().float().cpu().numpy()


def _batch(cfg, step):
    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def _to_port(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            batch.items()}


def make_arch(name):
    """(reference cfg, port cfg, reference params, port params)."""
    cut = ARCHS[name]
    r_cfg = r_reduced(r_get_config(name), **cut)
    p_cfg = p_base.reduced(p_base.get_config(name), **cut)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


def _assert_tree_close(p_tree, r_tree, cfg, tol_of, label):
    r_port = p_tf.params_from_reference(jax.tree.map(np.asarray, r_tree),
                                        cfg, "cpu")
    got, want = _tree.leaves(p_tree), _tree.leaves(r_port)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), _np(w)
        tol = tol_of(w)
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{label}: leaf {i} {w.shape} off by {err:.3e} > {tol:.3e}"


def check_gradients(arch):
    r_cfg, p_cfg, r_params, p_params = arch
    batch = _batch(r_cfg, 0)
    (r_loss, (r_ce, r_aux)), r_grads = jax.jit(
        jax.value_and_grad(r_steps.loss_fn, has_aux=True),
        static_argnums=1)(r_params, r_cfg, batch)
    (p_loss, (p_ce, p_aux)), p_grads = p_steps.value_and_grad(
        p_params, p_cfg, _to_port(batch))
    for r, p in ((r_loss, p_loss), (r_ce, p_ce), (r_aux, p_aux)):
        np.testing.assert_allclose(float(p), float(r), rtol=LOSS_RTOL,
                                   atol=1e-7)
    _assert_tree_close(p_grads, r_grads, p_cfg,
                       lambda w: GRAD_TOL * max(float(np.abs(w).max()), 1e-30),
                       "grad")


def check_train_step(arch, microbatches):
    r_cfg, p_cfg, r_params, p_params = arch
    r_init, r_step = r_steps.make_train_step(r_cfg, lr=1e-3,
                                             microbatches=microbatches)
    p_init, p_step = p_steps.make_train_step(p_cfg, lr=1e-3,
                                             microbatches=microbatches)
    r_step = jax.jit(r_step)
    r_opt, p_opt = r_init(r_params), p_init(p_params)
    before = [t.clone() for t in _tree.leaves(p_params)]
    for step in range(3):
        batch = _batch(r_cfg, step)
        r_params, r_opt, r_m = r_step(r_params, r_opt, batch)
        p_params, p_opt, p_m = p_step(p_params, p_opt, _to_port(batch))
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(p_m[key]), float(r_m[key]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {step} {key}")
    assert int(p_opt.step) == 3
    _assert_tree_close(p_params, r_params, p_cfg, lambda w: PARAM_TOL,
                       "params after 3 steps")
    # the step returned new trees and left its inputs as they were
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, _tree.leaves(p_params)))


def check_indivisible_batch(arch, batch=3, microbatches=2):
    """A batch whose rows ``microbatches`` does not divide: the reference's
    step raises (its reshape to (microbatches, b // microbatches, ...)),
    the port's raises ValueError naming both numbers before any gradient,
    and neither the parameters nor the optimizer state move."""
    r_cfg, p_cfg, r_params, p_params = arch
    tokens = np.random.default_rng(7).integers(
        0, r_cfg.vocab, (batch, S + 1)).astype(np.int32)
    data = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    r_init, r_step = r_steps.make_train_step(r_cfg, microbatches=microbatches)
    with pytest.raises(TypeError, match="reshape"):
        jax.jit(r_step)(r_params, r_init(r_params), data)
    p_init, p_step = p_steps.make_train_step(p_cfg, microbatches=microbatches)
    p_opt = p_init(p_params)
    before = [t.clone() for t in _tree.leaves(p_params)]
    with pytest.raises(ValueError, match=rf"\b{batch} rows.*"
                       rf"microbatches={microbatches}"):
        p_step(p_params, p_opt, _to_port(data))
    assert all(torch.equal(a, b) for a, b in
               zip(before, _tree.leaves(p_params)))
    assert int(p_opt.step) == 0


def check_accumulation(arch):
    """Two microbatches give the gradient of the whole batch (the mean of
    the shards' means, each shard equal in size), and the FSDP configs sum
    in bf16 as the reference does."""
    _, p_cfg, _, p_params = arch
    batch = _to_port(_batch(p_cfg, 0))
    _, whole = p_steps.value_and_grad(p_params, p_cfg, batch)
    grads = []
    for m in range(2):
        half = {k: v[m * B // 2:(m + 1) * B // 2] for k, v in batch.items()}
        grads.append(p_steps.value_and_grad(p_params, p_cfg, half)[1])
    mean = _tree.map_tensors(lambda a, b: (a + b) / 2, *grads)
    if not p_cfg.n_experts:       # MoE routing groups differ by batch
        for g, w in zip(_tree.leaves(mean), _tree.leaves(whole)):
            assert float((g - w).abs().max()) <= GRAD_TOL * max(
                float(w.abs().max()), 1e-30)
    assert p_steps.default_microbatches(p_cfg, 8) == 1


def check_remat(arch):
    """Per-unit remat changes no gradient, and checkpoints every unit."""
    _, p_cfg, _, p_params = arch
    batch = _to_port(_batch(p_cfg, 1))
    (l0, _), g0 = p_steps.value_and_grad(p_params, p_cfg, batch)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    torch.utils.checkpoint.checkpoint = counting
    try:
        (l1, _), g1 = p_steps.value_and_grad(
            p_params, dataclasses.replace(p_cfg, remat=True), batch)
    finally:
        torch.utils.checkpoint.checkpoint = real
    assert len(calls) == p_cfg.n_units          # one checkpoint a unit
    assert float(l1) == float(l0)
    for a, b in zip(_tree.leaves(g0), _tree.leaves(g1)):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1.0)
