"""Serial-queue E2E delay model (paper Sec. II-B, eqs. 1-4).

Port of ``repro/core/queueing.py``: elementwise over any leading dims.
Units: seconds, Hz (cycles/s), bytes (bits at the rate boundary), Watts.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def md1_sojourn(lam, mu):
    """Average M/D/1 sojourn time (eq. 2): T = 1/mu + lam / (2 mu (mu - lam))."""
    lam = torch.as_tensor(lam)
    mu = torch.as_tensor(mu)
    wait = lam / (2.0 * mu * torch.clamp_min(mu - lam, _EPS))
    return 1.0 / torch.clamp_min(mu, _EPS) + wait


def ue_sojourn(lam, f_ue, d_ue):
    """Local sojourn delay (eq. 2) with mu = f_ue / d_ue; zero for cut 0."""
    d_ue = torch.as_tensor(d_ue)
    mu = torch.where(d_ue > 0, f_ue / torch.clamp_min(d_ue, _EPS), torch.inf)
    return torch.where(d_ue > 0, md1_sojourn(lam, mu), 0.0)


def shannon_rate(alpha, w_hz, p_tx, gain, n0):
    """FDMA uplink rate: R = alpha W log2(1 + p h / (alpha W N0))."""
    alpha = torch.as_tensor(alpha)
    snr = p_tx * gain / (torch.clamp_min(alpha, _EPS) * w_hz * n0)
    rate = alpha * w_hz * torch.log2(1.0 + snr)
    return torch.where(alpha > 0, rate, 0.0)


def trans_delay(psi_bytes, alpha, w_hz, p_tx, gain, n0):
    """Transmission delay (eq. 3).  psi given in BYTES, rate in bits/s."""
    bits = 8.0 * torch.as_tensor(psi_bytes)
    rate = shannon_rate(alpha, w_hz, p_tx, gain, n0)
    return torch.where(bits > 0, bits / torch.clamp_min(rate, _EPS), 0.0)


def es_sojourn(f_es, d_es):
    """Edge sojourn (eq. 4): deterministic service, queuing neglected."""
    d_es = torch.as_tensor(d_es)
    return torch.where(d_es > 0, d_es / torch.clamp_min(f_es, _EPS), 0.0)


def es_sojourn_gd1(lam, f_es, d_es, rho_ue):
    """G/D/1-corrected edge sojourn (Kingman, deterministic service)."""
    d_es = torch.as_tensor(d_es)
    mu = torch.where(d_es > 0, f_es / torch.clamp_min(d_es, _EPS), torch.inf)
    rho_es = torch.clamp(lam / torch.clamp_min(mu, _EPS), 0.0, 1.0 - 1e-6)
    ca2 = 1.0 - torch.clamp(rho_ue, 0.0, 1.0) ** 2
    wait = (0.5 * ca2 * rho_es / torch.clamp_min(1.0 - rho_es, _EPS)
            / torch.clamp_min(mu, _EPS))
    return torch.where(d_es > 0, 1.0 / torch.clamp_min(mu, _EPS) + wait, 0.0)


def e2e_delay(lam, f_ue, f_es, d_ue, d_es, psi_bytes, alpha, w_hz, p_tx, gain, n0,
              edge_queueing: bool = False):
    """End-to-end delay (eq. 1): T_ue + T_trans + T_es, per UE."""
    t_ue = ue_sojourn(lam, f_ue, d_ue)
    t_tx = trans_delay(psi_bytes, alpha, w_hz, p_tx, gain, n0)
    if edge_queueing:
        mu_ue = torch.where(d_ue > 0, f_ue / torch.clamp_min(d_ue, _EPS),
                            torch.inf)
        rho_ue = torch.where(torch.isinf(mu_ue), 0.0,
                             lam / torch.clamp_min(mu_ue, _EPS))
        t_es = es_sojourn_gd1(lam, f_es, d_es, rho_ue)
    else:
        t_es = es_sojourn(f_es, d_es)
    return t_ue + t_tx + t_es, (t_ue, t_tx, t_es)
