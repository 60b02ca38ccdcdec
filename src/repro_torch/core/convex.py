"""Per-slot convex resource allocation (paper Sec. IV-C).

Port of ``repro/core/convex.py``, with its iteration counts, clamps and
u-space P5 form unchanged:

* P3 (eq. 19)  local CPU frequency  f_ue  -- 40-step Fibonacci search per UE
* P4 (eq. 20)  edge CPU frequency   f_es  -- closed form (eq. 23)
* P5 (eq. 24)  uplink bandwidth     alpha -- 42 outer x 36 inner bisection

The solvers batch over any leading dims.  The UE axis is the LAST one, and
every sum over UEs is taken over it alone (``dim=-1, keepdim=True``): the
reference gets per-cell sums from ``vmap``, and a sum without a ``dim``
here would pool all cells of a grid into one budget.  Scalar constants are
Python floats or tensors that broadcast against ``(..., N)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12

# ---------------------------------------------------------------------------
# P3: local computational resource (Fibonacci search, eq. 19)
# ---------------------------------------------------------------------------

_FIB_N = 40
_FIB = np.ones(_FIB_N + 3, dtype=np.float64)
for _i in range(2, _FIB_N + 3):
    _FIB[_i] = _FIB[_i - 1] + _FIB[_i - 2]
# ratio[k] = F_{n-k} / F_{n-k+2}: fraction of the interval probed at step k,
# rounded to float32 as the reference uses it.
_FIB_RATIO_LO = [float(np.float32(_FIB[_FIB_N - k] / _FIB[_FIB_N - k + 2]))
                 for k in range(_FIB_N)]
_FIB_RATIO_HI = [float(np.float32(_FIB[_FIB_N - k + 1] / _FIB[_FIB_N - k + 2]))
                 for k in range(_FIB_N)]


def p3_objective(f, q_energy, kappa, d_ue, lam, v):
    """Eq. (19): Q*kappa*f^2*d*lam + V*(d/f + d^2 lam / (2 (f^2 - f d lam)))."""
    f = torch.clamp_min(torch.as_tensor(f), _EPS)
    energy = q_energy * kappa * (f * f) * d_ue * lam
    proc = d_ue / f
    denom = torch.clamp_min(f * f - f * d_ue * lam, _EPS)
    queue = (d_ue * d_ue) * lam / (2.0 * denom)
    return energy + v * (proc + queue)


def solve_p3(q_energy, kappa, d_ue, lam, v, f_max, *, stability_margin=1e-3):
    """Fibonacci-search minimizer of (19) per UE on (d*lam, f_max].

    Elementwise over broadcast args.  ``d_ue == 0`` (full offload) gives
    f_ue = 0.  Infeasible ``d*lam >= f_max`` clamps to f_max.
    """
    d_ue = torch.as_tensor(d_ue)
    lo = d_ue * lam * (1.0 + stability_margin) + 1.0
    hi = torch.zeros_like(lo) + f_max
    lo = torch.minimum(lo, hi)

    def obj(f):
        return p3_objective(f, q_energy, kappa, d_ue, lam, v)

    a, b = lo, hi
    for r_lo, r_hi in zip(_FIB_RATIO_LO, _FIB_RATIO_HI):
        span = b - a
        x1 = a + r_lo * span
        x2 = a + r_hi * span
        take_left = obj(x1) < obj(x2)
        a, b = torch.where(take_left, a, x1), torch.where(take_left, x2, b)
    f_star = 0.5 * (a + b)
    # Also consider the upper boundary (optimum can sit at f_max when Q ~ 0).
    f_star = torch.where(obj(hi) < obj(f_star), hi, f_star)
    return torch.where(d_ue > 0, f_star, 0.0)


# ---------------------------------------------------------------------------
# P4: edge computational resource (closed form, eq. 23)
# ---------------------------------------------------------------------------

def solve_p4(d_es, f_max_es):
    """f_es* = f_max * sqrt(d_n) / sum_m sqrt(d_m) per cell (eq. 23)."""
    root = torch.sqrt(torch.clamp_min(torch.as_tensor(d_es), 0.0))
    total = torch.sum(root, dim=-1, keepdim=True)
    safe_total = torch.where(total > 0, total, 1.0)
    return torch.where(total > 0, f_max_es * root / safe_total, 0.0)


# ---------------------------------------------------------------------------
# P5: communication resource (two-level KKT bisection, eq. 24)
# ---------------------------------------------------------------------------

_ALPHA_MIN = 1e-7
_INNER_ITERS = 36
_OUTER_ITERS = 42


def _log_rate_terms(alpha, s):
    """r(a) = a*log2(1+s/a); returns (log r, log r') computed stably."""
    a = torch.clamp_min(alpha, _ALPHA_MIN * 1e-3)
    l2 = torch.log2(1.0 + s / a)
    log_r = torch.log(a) + torch.log(torch.clamp_min(l2, _EPS))
    rp = l2 - s / (math.log(2.0) * (a + s))
    log_rp = torch.log(torch.clamp_min(rp, _EPS))
    return log_r, log_rp


def _log_marginal(alpha, s, log_c):
    """log of m(a) = c * r'(a) / r(a)^2 -- the (negated) objective slope."""
    log_r, log_rp = _log_rate_terms(alpha, s)
    return log_c + log_rp - 2.0 * log_r


def solve_p5(q_energy, p_tx, lam, v, psi_bytes, w_hz, gain, n0):
    """Minimize eq. (24) s.t. sum(alpha) <= 1 per cell, alpha >= 0.

    KKT: the marginal m_n(alpha_n) is equalized across UEs with psi > 0 and
    the bandwidth constraint is tight.  The inner bisection inverts m_n at a
    trial multiplier eta in u = ln(1 + s/alpha); the outer one drives each
    cell's sum(alpha(eta)) to 1, with one eta per cell.
    """
    bits = 8.0 * torch.as_tensor(psi_bytes)
    active = bits > 0
    n_active = torch.sum(active, dim=-1, keepdim=True)
    s = p_tx * gain / (w_hz * n0)                     # per-UE SNR coefficient
    coeff = (q_energy * p_tx * lam + v) * bits / w_hz  # c_n
    coeff_c = torch.clamp_min(coeff, _EPS)
    ln2 = math.log(2.0)
    u_lo0 = torch.log1p(s)                  # alpha = 1
    u_hi0 = torch.log1p(s / _ALPHA_MIN)     # alpha = ALPHA_MIN

    def a_of_u(u):
        em = -torch.expm1(-u)               # 1 - e^-u, stable for small u
        return s * (1.0 - em) / torch.clamp_min(em, _EPS), em

    def alpha_of_eta(log_eta):
        eta = torch.exp(log_eta)
        u_lo, u_hi = u_lo0, u_hi0
        for _ in range(_INNER_ITERS):
            mid = 0.5 * (u_lo + u_hi)
            a, em = a_of_u(mid)
            # c * r' > eta * r^2  <=>  c*ln2*(u - em) > eta * a^2 * u^2
            too_steep = (coeff_c * ln2 * torch.clamp_min(mid - em, _EPS)
                         > eta * a * a * mid * mid)
            u_lo, u_hi = (torch.where(too_steep, u_lo, mid),
                          torch.where(too_steep, mid, u_hi))
        alpha, _ = a_of_u(0.5 * (u_lo + u_hi))
        return torch.where(active, torch.clamp(alpha, _ALPHA_MIN, 1.0), 0.0)

    e_lo = torch.full(n_active.shape, -40.0, dtype=s.dtype, device=s.device)
    e_hi = torch.full(n_active.shape, 40.0, dtype=s.dtype, device=s.device)
    for _ in range(_OUTER_ITERS):
        mid = 0.5 * (e_lo + e_hi)
        total = torch.sum(alpha_of_eta(mid), dim=-1, keepdim=True)
        # sum(alpha) decreasing in eta: too much bandwidth -> raise eta.
        over = total > 1.0
        e_lo, e_hi = torch.where(over, mid, e_lo), torch.where(over, e_hi, mid)
    alpha = alpha_of_eta(0.5 * (e_lo + e_hi))
    # Exactness: single active UE -> alpha = 1; none -> zeros.
    alpha = torch.where(n_active == 1, active.to(alpha.dtype), alpha)
    # Normalize residual bisection slack onto active UEs.
    total = torch.sum(alpha, dim=-1, keepdim=True)
    return torch.where(n_active > 0, alpha / torch.clamp_min(total, _EPS), 0.0)


def p5_objective(alpha, q_energy, p_tx, lam, v, psi_bytes, w_hz, gain, n0):
    """Eq. (24) objective value per cell (for tests / oracle search)."""
    from .queueing import trans_delay

    t = trans_delay(psi_bytes, alpha, w_hz, p_tx, gain, n0)
    return torch.sum((q_energy * p_tx * lam + v) * t, dim=-1)
