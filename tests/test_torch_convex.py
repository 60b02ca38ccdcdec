"""Port parity: the per-slot convex allocators P3/P4/P5 against
``repro.core.convex`` on the cases of tests/test_convex.py, plus a batched
(B, N) case that would catch a sum pooled across cells.

Tolerance: rtol 1e-4 (the sweep's tolerance); both sides run the same
fixed-iteration searches in float32, so only libm and bisection decisions
made on near-equal values can differ.

P3's minimizer is the exception.  Eq. (19) is flat at its minimum to within
float32 rounding over a band of about 5e-4 of f, and XLA's fused evaluation
of the objective differs from eager evaluation in the last bit (the
reference's own jit and eager results already disagree there), so the
Fibonacci search lands anywhere in that band.  The objective VALUE at the
minimizer agrees to 1e-6; its location is held to P3_FLAT_RTOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convex as r_cx
from repro_torch.core import convex as p_cx

RTOL = 1e-4
P3_FLAT_RTOL = 2e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(_np(got).astype(np.float32),
                               _np(want).astype(np.float32), rtol=rtol, atol=atol)


def test_fibonacci_ratios_match_reference():
    np.testing.assert_array_equal(
        np.asarray(p_cx._FIB_RATIO_LO, np.float32),
        np.asarray(r_cx._FIB_RATIO_LO, np.float32))
    np.testing.assert_array_equal(
        np.asarray(p_cx._FIB_RATIO_HI, np.float32),
        np.asarray(r_cx._FIB_RATIO_HI, np.float32))


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,d,lam", [(0.0, 2e8, 2.0), (250.0, 1e8, 1.0),
                                     (500.0, 4e8, 0.5), (1e4, 2e8, 2.0),
                                     (120.0, 3.9e8, 2.4)])
def test_p3_matches_reference(q, d, lam):
    kappa, v, f_max = 1e-28, 10.0, 1.5e9
    want = r_cx.solve_p3(jnp.float32(q), kappa, jnp.float32(d),
                         jnp.float32(lam), v, f_max)
    got = p_cx.solve_p3(torch.tensor(q), kappa, torch.tensor(d),
                        torch.tensor(lam), v, f_max)
    _close(got, want, rtol=P3_FLAT_RTOL)
    _close(p_cx.p3_objective(got, q, kappa, d, lam, v),
           r_cx.p3_objective(want, q, kappa, d, lam, v), rtol=1e-6)
    # the objective agrees too, and beats a coarse grid (test_convex's guard)
    grid = np.linspace(d * lam * 1.001 + 1.0, f_max, 2_000).astype(np.float32)
    j_grid = float(np.min(_np(p_cx.p3_objective(torch.as_tensor(grid), q,
                                                kappa, d, lam, v))))
    j_star = float(p_cx.p3_objective(got, q, kappa, d, lam, v))
    assert j_star <= j_grid * (1 + 2e-3) + 1e-6
    _close(p_cx.p3_objective(torch.as_tensor(grid), q, kappa, d, lam, v),
           r_cx.p3_objective(jnp.asarray(grid), q, kappa, d, lam, v), rtol=1e-6)


def test_p3_zero_demand_and_batched_grid():
    assert (_np(p_cx.solve_p3(torch.zeros(3), 1e-28, torch.zeros(3),
                              torch.ones(3), 10.0, 1.5e9)) == 0).all()
    rng = np.random.default_rng(0)
    shape = (3, 5, 11)
    d = rng.uniform(0, 6e8, shape).astype(np.float32)
    d[..., 0] = 0.0
    lam = rng.uniform(0.2, 2.5, shape[:2] + (1,)).astype(np.float32)
    q = rng.uniform(0, 300, shape[:2] + (1,)).astype(np.float32)
    f_max = np.float32([1.5e9, 2.0e9, 1.0e9]).reshape(3, 1, 1)
    want = jax.vmap(lambda q_, d_, l_, f_: r_cx.solve_p3(q_, 1e-28, d_, l_, 10.0, f_))(
        jnp.asarray(q), jnp.asarray(d), jnp.asarray(lam),
        jnp.asarray(f_max[:, 0, 0]))
    got = p_cx.solve_p3(torch.as_tensor(q), 1e-28, torch.as_tensor(d),
                        torch.as_tensor(lam), 10.0, torch.as_tensor(f_max))
    _close(got, want, rtol=P3_FLAT_RTOL)
    want_obj = jax.vmap(lambda f_, q_, d_, l_: r_cx.p3_objective(
        f_, q_, 1e-28, d_, l_, 10.0))(want, jnp.asarray(q), jnp.asarray(d),
                                      jnp.asarray(lam))
    _close(p_cx.p3_objective(got, torch.as_tensor(q), 1e-28, torch.as_tensor(d),
                             torch.as_tensor(lam), 10.0), want_obj, rtol=1e-6)


# ---------------------------------------------------------------------------
# P4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ds", [[1e8, 4e8, 9e8], [0.0, 0.0], [0.0, 3e8, 0.0, 1e6],
                                [5e8] * 8])
def test_p4_matches_reference(ds):
    d = np.asarray(ds, np.float32)
    _close(p_cx.solve_p4(torch.as_tensor(d), 15e9),
           r_cx.solve_p4(jnp.asarray(d), 15e9), rtol=1e-6)


def test_p4_batched_is_per_cell():
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 1e9, (4, 6)).astype(np.float32)
    d[1] = 0.0                                    # one cell where nobody offloads
    got = p_cx.solve_p4(torch.as_tensor(d), 15e9)
    want = jax.vmap(lambda x: r_cx.solve_p4(x, 15e9))(jnp.asarray(d))
    _close(got, want, rtol=1e-6)
    sums = _np(got).sum(-1)
    np.testing.assert_allclose(sums[[0, 2, 3]], 15e9, rtol=1e-5)
    assert sums[1] == 0


# ---------------------------------------------------------------------------
# P5
# ---------------------------------------------------------------------------

def _p5_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    gain = (rng.exponential(1.0, n) * 1.58e-11).astype(np.float32)
    psi = rng.uniform(0.05e6, 1.0e6, n).astype(np.float32)
    lam = rng.uniform(0.5, 2.5, n).astype(np.float32)
    q = rng.uniform(0.0, 200.0, n).astype(np.float32)
    return q, 0.1, lam, 10.0, psi, 5e6, gain, 10 ** (-17.4) / 1000.0


def _p5_both(q, p, lam, v, psi, w, gain, n0):
    want = r_cx.solve_p5(jnp.asarray(q), p, jnp.asarray(lam), v,
                         jnp.asarray(psi), w, jnp.asarray(gain), n0)
    got = p_cx.solve_p5(torch.as_tensor(q), p, torch.as_tensor(lam), v,
                        torch.as_tensor(psi), w, torch.as_tensor(gain), n0)
    return got, want


@pytest.mark.parametrize("n,seed", [(2, 0), (3, 3), (5, 5), (8, 8)])
def test_p5_matches_reference(n, seed):
    got, want = _p5_both(*_p5_inputs(n, seed))
    _close(got, want)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-4)


def test_p5_beats_brute_force_n2():
    """test_convex's coarse n=2 line search must not beat the port either."""
    q, p, lam, v, psi, w, gain, n0 = _p5_inputs(2, seed=0)
    alpha, _ = _p5_both(q, p, lam, v, psi, w, gain, n0)
    args = (torch.as_tensor(q), p, torch.as_tensor(lam), v,
            torch.as_tensor(psi), w, torch.as_tensor(gain), n0)
    best = min(float(p_cx.p5_objective(torch.tensor([a0, 1 - a0]), *args))
               for a0 in np.linspace(1e-3, 1 - 1e-3, 401))
    ours = float(p_cx.p5_objective(alpha, *args))
    assert ours <= best * (1 + 1e-3)
    want = r_cx.p5_objective(jnp.asarray(_np(alpha)), jnp.asarray(q), p,
                             jnp.asarray(lam), v, jnp.asarray(psi), w,
                             jnp.asarray(gain), n0)
    _close(ours, want, rtol=1e-6)


@pytest.mark.parametrize("n", [3, 5, 8])
def test_p5_kkt_residual(n):
    """At the port's optimum the marginal value of bandwidth is equalized."""
    q, p, lam, v, psi, w, gain, n0 = _p5_inputs(n, seed=n)
    alpha, _ = _p5_both(q, p, lam, v, psi, w, gain, n0)
    s = torch.as_tensor(p * gain / (w * n0))
    coeff = torch.as_tensor((q * p * lam + v) * 8.0 * psi / w)
    log_m = _np(p_cx._log_marginal(alpha, s, torch.log(coeff)))
    assert log_m.max() - log_m.min() < 5e-3
    want = r_cx._log_marginal(jnp.asarray(_np(alpha)), jnp.asarray(_np(s)),
                              jnp.log(jnp.asarray(_np(coeff))))
    _close(log_m, want, rtol=1e-5)


def test_p5_inactive_single_and_idle():
    q, p, lam, v, psi, w, gain, n0 = _p5_inputs(4, seed=7)
    psi2 = psi.copy()
    psi2[[1, 3]] = 0.0
    got, want = _p5_both(q, p, lam, v, psi2, w, gain, n0)
    _close(got, want)
    assert _np(got)[1] == 0.0 and _np(got)[3] == 0.0
    psi1 = psi.copy()
    psi1[[0, 2, 3]] = 0.0
    got, _ = _p5_both(q, p, lam, v, psi1, w, gain, n0)
    assert _np(got).tolist() == [0.0, 1.0, 0.0, 0.0]
    got, _ = _p5_both(q, p, lam, v, np.zeros(4, np.float32), w, gain, n0)
    assert (_np(got) == 0).all()


def test_p5_batched_is_per_cell():
    """(B, N): each cell's bandwidth sums to 1 on its own.  A sum pooled
    over all cells would give every cell about 1/B."""
    rng = np.random.default_rng(2)
    b, n = 4, 5
    q = rng.uniform(0, 200, (b, n)).astype(np.float32)
    lam = rng.uniform(0.5, 2.5, (b, n)).astype(np.float32)
    psi = rng.uniform(0.05e6, 1e6, (b, n)).astype(np.float32)
    psi[2, 1:] = 0.0                              # one active UE
    psi[3] = 0.0                                  # idle cell
    gain = (rng.exponential(1.0, (b, n)) * 1.58e-11).astype(np.float32)
    v = np.float32([10.0, 5.0, 20.0, 10.0])
    w, n0, p = 5e6, 10 ** (-17.4) / 1000.0, 0.1
    want = jax.vmap(lambda q_, l_, v_, s_, g_: r_cx.solve_p5(
        q_, p, l_, v_, s_, w, g_, n0))(jnp.asarray(q), jnp.asarray(lam),
                                       jnp.asarray(v), jnp.asarray(psi),
                                       jnp.asarray(gain))
    got = p_cx.solve_p5(torch.as_tensor(q), p, torch.as_tensor(lam),
                        torch.as_tensor(v)[:, None], torch.as_tensor(psi), w,
                        torch.as_tensor(gain), n0)
    _close(got, want)
    np.testing.assert_allclose(_np(got).sum(-1), [1.0, 1.0, 1.0, 0.0], atol=1e-4)
    assert _np(got)[2].tolist() == [1.0, 0.0, 0.0, 0.0, 0.0]
