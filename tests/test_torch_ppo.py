"""Port parity: the MLP, the three policy heads, Adam, GAE and the PPO
update, each against its ``repro`` twin on the same numpy inputs.

The reference's parameters and optimizer state come across through
``ppo.train_state_from_reference(jax.tree.map(np.asarray, state), ...)``;
the reference's own action draws are replayed through ``sample``'s
``noise`` (the normal draw of ``k_act``, or the Gumbel draw whose argmax
``jax.random.categorical`` takes).

Tolerances, each beside the largest gap measured here (CPU, float32;
"beyond atol" is the smallest rtol that passes with the stated atol):

    what                                bound                  measured
    mlp_apply                           rtol 1e-5, atol 1e-7   2.8e-6 beyond atol
    heads: sample (replayed draws),     rtol 1e-5, atol 1e-6   1.6e-7 beyond atol
      logp, entropy, mean_action, split
    heads: categorical cuts, to_cut     equal                  equal
    Adam, 10 steps: params, moments     rtol 1e-6 + 1e-6 x     1.6e-9 absolute on
                                        the leaf's largest     leaves of size 1.2
                                        magnitude
      bf16 moments                      equal                  equal
    gae: advantages, returns            rtol 1e-5, atol 1e-7   8.1e-8 beyond atol
    update: last-epoch metrics          rtol 1e-4, atol 1e-6   2.2e-6 relative
    update: params and first moments    atol 1e-5 (rtol 1e-4)  6.3e-7 absolute
    update: second moments              atol 1e-9 (rtol 1e-4)  5.5e-12 absolute

``update`` runs 8 epochs of Adam on a 16-slot trajectory the reference's
Runner collected, for each head.  Adam divides each first moment by the
root of its second, so a parameter moves by about lr = 3e-4 a step
whatever its gradient's size, and the two packages' float32 reductions
(summed in another order) reach the parameters as absolute, not relative,
differences: the parameters are held at atol 1e-5, where small entries
sit far from their relative band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import env as r_env
from repro.core import lymdo as r_lymdo
from repro.core import networks as r_net
from repro.core import policies as r_pol
from repro.core import ppo as r_ppo
from repro.optim import adam as r_adam
from repro_torch import _tree
from repro_torch.core import networks as p_net
from repro_torch.core import policies as p_pol
from repro_torch.core import ppo as p_ppo
from repro_torch.optim import adam as p_adam

RTOL_NET = 1e-5
RTOL_ADAM = 1e-6
RTOL_GAE = 1e-5
RTOL_METRICS, ATOL_PARAMS = 1e-4, 1e-5
HEADS = ("gaussian", "categorical", "joint")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    a = np.asarray(a)
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a).to(dtype)


def assert_trees_close(got, want, rtol, atol=0.0, where="", atol_rel=0.0):
    """Leaf by leaf; ``atol_rel`` adds that share of the leaf's largest
    magnitude to ``atol``."""
    # jax.tree.leaves orders dict keys: walk both trees that way
    g, w = jax.tree.leaves(_as_np_tree(got)), jax.tree.leaves(want)
    assert len(g) == len(w), where
    for i, (a, b) in enumerate(zip(g, w)):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(
            np.asarray(a, np.float64), b, rtol=rtol,
            atol=atol + atol_rel * float(np.max(np.abs(b))),
            err_msg=f"{where} leaf {i}")


def _as_np_tree(tree):
    if isinstance(tree, dict):
        return {k: _as_np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_np_tree(v) for v in tree]
    return _np(tree.float() if tree.dtype == torch.bfloat16 else tree)


@pytest.fixture(scope="module")
def ref_env():
    return r_env.paper_env()


def make_heads(ref_env, head):
    L = np.array(ref_env.L)
    cfg = ref_env.cfg
    if head == "gaussian":
        return (r_pol.GaussianTanhPolicy(ref_env.obs_dim, L),
                p_pol.GaussianTanhPolicy(ref_env.obs_dim, torch.as_tensor(L)))
    if head == "categorical":
        return (r_pol.CategoricalPolicy(ref_env.obs_dim, L),
                p_pol.CategoricalPolicy(ref_env.obs_dim, torch.as_tensor(L)))
    return (r_pol.JointGaussianPolicy(ref_env.obs_dim, L, cfg.f_max_ue,
                                      cfg.f_max_es),
            p_pol.JointGaussianPolicy(ref_env.obs_dim, torch.as_tensor(L),
                                      cfg.f_max_ue, cfg.f_max_es))


def convert_params(tree):
    return _tree.from_numpy(jax.tree.map(np.asarray, tree), "cpu", torch.float32)


# ---------------------------------------------------------------------------
# Networks and heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("final_scale", [1.0, 0.1])
def test_mlp_apply_on_converted_params(final_scale):
    params = r_net.mlp_init(jax.random.PRNGKey(3), (20, 128, 64, 7))
    x = np.random.default_rng(0).normal(size=(6, 20)).astype(np.float32)
    want = r_net.mlp_apply(params, jnp.asarray(x), final_scale=final_scale)
    got = p_net.mlp_apply(convert_params(params), torch.as_tensor(x),
                          final_scale=final_scale)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL_NET,
                               atol=1e-7)


def test_mlp_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    params = p_net.mlp_init(gen, (20, 128, 64, 1), "cpu")
    assert [tuple(l["w"].shape) for l in params] == [(20, 128), (128, 64),
                                                     (64, 1)]
    assert all(not l["b"].any() for l in params)
    # normal * sqrt(2 / fan_in)
    assert abs(float(params[1]["w"].std()) - (2.0 / 128) ** 0.5) < 0.02


def _ref_noise(ref_pol, key, head):
    if head == "categorical":
        return jax.random.gumbel(key, (ref_pol.n_ue, ref_pol.num_cuts))
    return jax.random.normal(key, (ref_pol.act_dim,))


@pytest.mark.parametrize("head", HEADS)
def test_heads_match_reference(ref_env, head):
    ref_pol, pol = make_heads(ref_env, head)
    rp = ref_pol.init(jax.random.PRNGKey(1))
    pp = convert_params(rp)
    obs = np.random.default_rng(1).normal(size=(6, ref_env.obs_dim)).astype(np.float32)
    obs_t = torch.as_tensor(obs)
    close = lambda g, w: np.testing.assert_allclose(
        _np(g).astype(np.float64), np.asarray(w, np.float64),
        rtol=RTOL_NET, atol=1e-6)
    # sample, with the reference's own draw replayed, one obs at a time
    actions = []
    for i in range(obs.shape[0]):
        k = jax.random.PRNGKey(100 + i)
        a_ref, lp_ref = ref_pol.sample(rp, jnp.asarray(obs[i]), k)
        a, lp = pol.sample(pp, obs_t[i], noise=np.asarray(_ref_noise(ref_pol, k, head)))
        if head == "categorical":
            np.testing.assert_array_equal(_np(a), np.asarray(a_ref))
        else:
            close(a, a_ref)
        close(lp, lp_ref)
        actions.append(np.asarray(a_ref))
    actions = np.stack(actions)
    close(pol.logp(pp, obs_t, _t(actions)), ref_pol.logp(rp, jnp.asarray(obs), actions))
    close(pol.entropy(pp, obs_t), ref_pol.entropy(rp, jnp.asarray(obs)))
    m_ref = ref_pol.mean_action(rp, jnp.asarray(obs))
    m = pol.mean_action(pp, obs_t)
    if head == "categorical":
        np.testing.assert_array_equal(_np(m), np.asarray(m_ref))
    else:
        close(m, m_ref)
    if head == "joint":
        for g, w in zip(pol.split(_t(actions)), ref_pol.split(actions)):
            close(g, w)
    else:
        np.testing.assert_array_equal(_np(pol.to_cut(_t(actions))),
                                      np.asarray(ref_pol.to_cut(actions)))
    # the generator path draws actions in range
    a, _ = pol.sample(pp, obs_t, torch.Generator().manual_seed(0))
    cut = _np(pol.split(a)[0] if head == "joint" else pol.to_cut(a))
    assert ((cut >= 0) & (cut <= np.asarray(ref_env.L))).all()


@given(st.floats(-50, 50), st.integers(1, 40))
@settings(max_examples=60, deadline=None)
def test_map_cut_range(y, num_layers):
    """Eq. (13) extension: the cut lands in {0..L}, as the reference's."""
    cut = int(p_pol.map_cut(torch.tensor(y, dtype=torch.float32), num_layers))
    assert 0 <= cut <= num_layers
    assert cut == int(r_pol.map_cut(jnp.float32(y), jnp.int32(num_layers)))


def test_map_cut_extremes_and_monotone():
    assert int(p_pol.map_cut(torch.tensor(-50.0), 8)) == 0
    assert int(p_pol.map_cut(torch.tensor(50.0), 8)) == 8
    ys = np.linspace(-4, 4, 257, dtype=np.float32)
    got = _np(p_pol.map_cut(torch.as_tensor(ys), 8))
    assert (np.diff(got) >= 0).all()
    np.testing.assert_array_equal(got, np.asarray(r_pol.map_cut(jnp.asarray(ys), 8)))


def test_categorical_masks_infeasible_cuts(ref_env):
    _, pol = make_heads(ref_env, "categorical")
    pp = pol.init(torch.Generator().manual_seed(0))
    obs = torch.randn(32, ref_env.obs_dim, generator=torch.Generator().manual_seed(1))
    cut, _ = pol.sample(pp, obs, torch.Generator().manual_seed(2))
    assert (cut <= pol.num_layers).all()
    # the entropy counts only the cuts a UE has
    assert torch.isfinite(pol.entropy(pp, obs))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def _tree_np(rng, scale=1.0):
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"mlp": [{"w": f(6, 5), "b": f(5)}, {"w": f(5, 3), "b": f(3)}],
            "log_std": f(3)}


@pytest.mark.parametrize("clip,wd,dtype", [
    (0.5, 0.0, None),         # clip active: the grads' norm is about 10
    (None, 0.0, None),        # no clip
    (1e3, 0.01, None),        # clip inactive, decoupled weight decay
    (0.5, 0.0, "bfloat16"),   # moments kept in bf16
])
def test_adam_ten_steps_match_reference(clip, wd, dtype):
    rng = np.random.default_rng(0)
    params = _tree_np(rng)
    grads = [_tree_np(rng, 3.0) for _ in range(10)]
    r_init, r_upd = r_adam.adam(1e-2, weight_decay=wd, grad_clip=clip,
                                state_dtype=None if dtype is None
                                else getattr(jnp, dtype))
    p_init, p_upd = p_adam.adam(1e-2, weight_decay=wd, grad_clip=clip,
                                state_dtype=None if dtype is None
                                else getattr(torch, dtype))
    rp = jax.tree.map(jnp.asarray, params)
    pp = convert_params(params)
    rs, ps = r_init(rp), p_init(pp)
    for g in grads:
        if clip == 0.5:
            assert float(r_adam.global_norm(g)) > 2 * clip
        rp, rs = r_upd(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps = p_upd(convert_params(g), ps, pp)
    assert int(ps.step) == int(rs.step) == 10 and ps.step.dtype == torch.int32
    assert_trees_close(pp, rp, RTOL_ADAM, 0.0, "params", RTOL_ADAM)
    if dtype is None:
        assert_trees_close(ps.mu, rs.mu, RTOL_ADAM, 0.0, "mu", RTOL_ADAM)
        assert_trees_close(ps.nu, rs.nu, RTOL_ADAM, 0.0, "nu", RTOL_ADAM)
    else:
        assert all(x.dtype == torch.bfloat16 for x in _tree.leaves(ps.mu))
        assert_trees_close(ps.mu, rs.mu, 0.0, 0.0, "mu")
        assert_trees_close(ps.nu, rs.nu, 0.0, 0.0, "nu")
    np.testing.assert_allclose(float(p_adam.global_norm(pp)),
                               float(r_adam.global_norm(rp)), rtol=RTOL_ADAM)


def test_adam_leaves_its_inputs_alone():
    init, upd = p_adam.adam(0.1, grad_clip=0.5)
    params = convert_params(_tree_np(np.random.default_rng(1)))
    before = [x.clone() for x in _tree.leaves(params)]
    state = init(params)
    new, state2 = upd(params, state, params)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(params), before))
    assert int(state.step) == 0 and int(state2.step) == 1
    assert not torch.equal(new["log_std"], params["log_std"])


# ---------------------------------------------------------------------------
# GAE and the update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", [1.0, 0.95])
@pytest.mark.parametrize("bootstrap", [False, True])
def test_gae_matches_reference(ref_env, lam, bootstrap):
    cfg = dict(gae_lambda=lam, bootstrap_last=bootstrap)
    ref_pol, pol = make_heads(ref_env, "gaussian")
    ref = r_ppo.PPO(ref_pol, ref_env.obs_dim, r_ppo.PPOConfig(**cfg))
    port = p_ppo.PPO(pol, ref_env.obs_dim, p_ppo.PPOConfig(**cfg))
    rng = np.random.default_rng(2)
    k = 16
    arrs = dict(obs=np.zeros((k, 20), np.float32),
                action=np.zeros((k, 5), np.float32),
                logp=np.zeros(k, np.float32),
                reward=(rng.normal(size=k) * 30 - 20).astype(np.float32),
                value=rng.normal(size=k).astype(np.float32),
                last_value=np.float32(rng.normal()))
    adv_r, ret_r = ref.gae(r_ppo.Trajectory(**{n: jnp.asarray(a) for n, a in arrs.items()}))
    adv, ret = port.gae(p_ppo.Trajectory(**{n: _t(a) for n, a in arrs.items()}))
    np.testing.assert_allclose(_np(adv), np.asarray(adv_r), rtol=RTOL_GAE, atol=1e-7)
    np.testing.assert_allclose(_np(ret), np.asarray(ret_r), rtol=RTOL_GAE, atol=1e-7)


def convert_traj(traj):
    return p_ppo.Trajectory(*(_t(np.asarray(x)) for x in traj))


@pytest.fixture(scope="module")
def collected(ref_env):
    """Per head: the reference's agent, initial state and a 16-slot
    trajectory its Runner collected."""
    out = {}
    for head in HEADS:
        ref_pol, pol = make_heads(ref_env, head)
        agent = r_ppo.PPO(ref_pol, ref_env.obs_dim, r_ppo.PPOConfig())
        state = agent.init(jax.random.PRNGKey(7))
        runner = r_lymdo.Runner(ref_env, agent, steps=16,
                                mode="joint" if head == "joint" else "lymdo")
        traj, _, _ = jax.jit(runner._make_episode())(state.params,
                                                     jax.random.PRNGKey(8))
        out[head] = (agent, state, traj, pol)
    return out


@pytest.mark.parametrize("head", HEADS)
def test_update_on_a_reference_trajectory(collected, head):
    agent, state, traj, pol = collected[head]
    new_state, metrics = agent.update(state, traj)
    port = p_ppo.PPO(pol, agent.obs_dim, p_ppo.PPOConfig())
    ps = p_ppo.train_state_from_reference(jax.tree.map(np.asarray, state),
                                          pol, "cpu")
    got_state, got = port.update(ps, convert_traj(traj))
    for name in ("loss", "actor_loss", "critic_loss", "ratio_max"):
        np.testing.assert_allclose(_np(got[name]), np.asarray(metrics[name]),
                                   rtol=RTOL_METRICS, atol=1e-6, err_msg=name)
    assert int(got_state.opt_state.step) == int(new_state.opt_state.step) == 8
    assert_trees_close(got_state.params, new_state.params, RTOL_METRICS,
                       ATOL_PARAMS, "params")
    assert_trees_close(got_state.opt_state.mu, new_state.opt_state.mu,
                       RTOL_METRICS, ATOL_PARAMS, "mu")
    assert_trees_close(got_state.opt_state.nu, new_state.opt_state.nu,
                       RTOL_METRICS, 1e-9, "nu")


def test_train_state_converter(collected):
    agent, state, _, pol = collected["gaussian"]
    ps = p_ppo.train_state_from_reference(jax.tree.map(np.asarray, state),
                                          pol, "cpu")
    assert all(x.dtype == torch.float32 for x in _tree.leaves(ps.params))
    assert ps.opt_state.step.dtype == torch.int32
    assert_trees_close(ps.params, state.params, 0.0, 0.0, "params")
    _, _, _, cat = collected["categorical"]
    with pytest.raises(ValueError, match="CategoricalPolicy"):
        p_ppo.train_state_from_reference(jax.tree.map(np.asarray, state),
                                         cat, "cpu")


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_tree_from_numpy(dtype):
    """The converter all the port's weight carry-across shares: nesting kept
    (tuples as lists), values exact; bf16 leaves stay bf16 and integers keep
    their type unless a dtype is given; float64 becomes float32."""
    bf16 = jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)
    tree = {"a": [np.arange(6, dtype=np.float64).reshape(2, 3),
                  (np.asarray(bf16), np.int32(7))],
            "b": {"c": np.asarray([1, 2], np.int64)}}
    got = _tree.from_numpy(tree, "cpu", dtype)
    a0, (a1, a2) = got["a"][0], got["a"][1]
    assert isinstance(got["a"][1], list)
    assert a0.dtype == torch.float32
    assert a1.dtype == (torch.bfloat16 if dtype is None else dtype)
    assert a2.dtype == (torch.int32 if dtype is None else dtype)
    assert got["b"]["c"].dtype == (torch.int64 if dtype is None else dtype)
    np.testing.assert_array_equal(a0.numpy(), tree["a"][0])
    np.testing.assert_array_equal(a1.float().numpy(), [1.5, -2.25, 3.0])
    assert int(a2) == 7 and got["b"]["c"].tolist() == [1, 2]


def test_port_init_and_act(ref_env):
    _, pol = make_heads(ref_env, "categorical")
    agent = p_ppo.PPO(pol, ref_env.obs_dim)
    state = agent.init(torch.Generator().manual_seed(0))
    assert int(state.opt_state.step) == 0
    assert state.params["v"][-1]["w"].shape == (64, 1)
    obs = torch.zeros(ref_env.obs_dim)
    cut, logp, value = agent.act(state.params, obs,
                                 torch.Generator().manual_seed(1))
    assert cut.shape == (5,) and logp.shape == () and value.shape == ()
