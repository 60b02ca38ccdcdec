"""Port parity: the MoE mixer (``models/ffn.py``: ``init_moe``,
``apply_moe``) against ``repro.models.ffn``.

The reference's expert parameters are carried across as numpy; the tokens
are drawn with numpy.  Both run reduced moonshot-v1-16b-a3b (8 experts,
top-6, a shared expert) and reduced llama4-maverick-400b-a17b (8 experts,
top-1, a shared expert) at capacity factors 1.25 (tokens drop) and 8 (none
does), on 24 tokens (one group), 1024 (one full group) and 1280 (a second
group padded with zero tokens), in float32 and bf16.  The kept (token,
expert) pairs must be identical: the reference's dispatch tensor is read
through its one dispatch einsum, the port's through ``ffn.route``.  y is
held to 1e-5 in float32 and 2e-2 in bf16, the aux loss to 1e-6.  The
reference runs jitted on the CPU.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import ffn as r_ffn
from repro_torch import _tree
from repro_torch.configs import base as p_base
from repro_torch.models import ffn as p_ffn

ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
Y_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6


def _cfgs(arch, capacity, dtype):
    over = dict(capacity_factor=capacity, param_dtype=dtype,
                compute_dtype=dtype)
    return (r_reduced(r_get_config(arch), **over),
            p_base.reduced(p_base.get_config(arch), **over))


@pytest.fixture(scope="module")
def moe_params():
    """{(arch, dtype): (reference params, port params)}, made on demand."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            r_cfg, p_cfg = _cfgs(arch, 1.25, dtype)
            r_p = r_ffn.init_moe(jax.random.PRNGKey(3), r_cfg)
            cache[arch, dtype] = (r_p, _tree.from_numpy(
                jax.tree.map(np.asarray, r_p), "cpu"))
        return cache[arch, dtype]
    return get


def _reference(r_cfg, r_p, x):
    """(y, aux, dispatch) of the reference, jitted; the dispatch tensor is
    the first operand of its dispatch einsum."""
    def run(p, x):
        seen = []
        einsum = jnp.einsum

        def spy(spec, *operands, **kw):
            if spec == "gsec,gsd->egcd":
                seen.append(operands[0])
            return einsum(spec, *operands, **kw)
        jnp.einsum = spy
        try:
            y, aux = r_ffn.apply_moe(p, r_cfg, x)
        finally:
            jnp.einsum = einsum
        return y, aux, seen[0]
    return [np.asarray(a, np.float32) for a in jax.jit(run)(r_p, x)]


def _port(p_cfg, p_p, x, monkeypatch):
    seen = []
    route = p_ffn.route

    def spy(*a):
        out = route(*a)
        seen.append(out[0])
        return out
    monkeypatch.setattr(p_ffn, "route", spy)
    y, aux = p_ffn.apply_moe(p_p, p_cfg, x)
    return y.float().numpy(), float(aux), seen[0].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [24, 1024, 1280])
@pytest.mark.parametrize("capacity", [1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, capacity, tokens, dtype,
                                     moe_params, monkeypatch):
    r_cfg, p_cfg = _cfgs(arch, capacity, dtype)
    r_p, p_p = moe_params(arch, dtype)
    x32 = np.random.default_rng(tokens).standard_normal(
        (2, tokens // 2, r_cfg.d_model)).astype(np.float32)
    if dtype == "bfloat16":
        x_r = x32.astype(ml_dtypes.bfloat16)
        x_p = torch.from_numpy(x32).to(torch.bfloat16)
    else:
        x_r, x_p = x32, torch.from_numpy(x32)
    y_r, aux_r, disp_r = _reference(r_cfg, r_p, jnp.asarray(x_r))
    y_p, aux_p, disp_p = _port(p_cfg, p_p, x_p, monkeypatch)

    groups = -(-tokens // p_ffn.MOE_GROUP)
    gsize = min(p_ffn.MOE_GROUP, tokens)
    cap = p_ffn.moe_capacity(p_cfg, gsize)
    assert disp_p.shape == (groups, gsize, p_cfg.n_experts, cap)
    assert disp_r.shape == disp_p.shape
    kept_r, kept_p = disp_r.sum(-1) > 0, disp_p.sum(-1) > 0
    np.testing.assert_array_equal(kept_p, kept_r)
    np.testing.assert_array_equal(disp_p, disp_r)
    if capacity == 8.0:       # cap == group: every chosen expert keeps it
        assert kept_p.sum() == groups * gsize * p_cfg.top_k
    elif tokens == 1280:      # the padded group's zero tokens all route
        assert kept_p.sum() < groups * gsize * p_cfg.top_k    # alike: drops
    assert y_p.shape == x32.shape
    tol = Y_TOL[dtype]
    np.testing.assert_allclose(y_p, y_r, rtol=tol, atol=tol)
    np.testing.assert_allclose(aux_p, aux_r, rtol=AUX_TOL, atol=AUX_TOL)


def test_capacity_and_drops_at_decode_batches():
    """At 8 decode slots both full configs give each expert one token a
    step; 1.25 drops where 8.0 keeps all."""
    for arch in ARCHS:
        cfg = p_base.get_config(arch)
        assert p_ffn.moe_capacity(cfg, 8) == 1
        assert p_ffn.moe_capacity(cfg, p_ffn.MOE_GROUP) == min(
            p_ffn.MOE_GROUP,
            int(max(1, -(-p_ffn.MOE_GROUP * cfg.top_k // cfg.n_experts))
                * cfg.capacity_factor))
    cfg = p_base.get_config("moonshot-v1-16b-a3b")
    assert p_ffn.moe_capacity(cfg, 1024) == 120


def test_init_moe_structure_dtypes_and_sliced_draws():
    """The port's init has the reference's structure and shapes, a float32
    router in a bf16 model, and expert leaves drawn per expert (truncated
    at 2 sigma of fan-in D)."""
    r_cfg, p_cfg = _cfgs(ARCHS[0], 1.25, "bfloat16")
    p = p_ffn.init_moe(torch.Generator().manual_seed(0), p_cfg, "cpu")
    r = jax.eval_shape(lambda k: r_ffn.init_moe(k, r_cfg),
                       jax.random.PRNGKey(0))
    shapes = lambda t: sorted((jax.tree_util.keystr(k), tuple(v.shape))
                              for k, v in
                              jax.tree_util.tree_leaves_with_path(t))
    assert shapes(jax.tree.map(lambda t: np.zeros(t.shape), p)) == shapes(r)
    assert p["router"].dtype == torch.float32
    assert p["wi"].dtype == torch.bfloat16
    w = p["wi"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(p_cfg.d_model) + 1e-2
    assert not torch.equal(w[0], w[1])
