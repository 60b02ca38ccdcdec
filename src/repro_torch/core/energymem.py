"""UE energy (eq. 5) and model-memory (eq. 6) models, in J and GB.

Port of ``repro/core/energymem.py``; elementwise over any leading dims.
"""
from __future__ import annotations

GB = 1e9


def compute_energy(f_ue, d_ue, lam, kappa):
    """Local computation power E^comp = kappa * f^2 * d * lam   [J/s]."""
    return kappa * (f_ue * f_ue) * d_ue * lam


def trans_energy(p_tx, t_trans, lam):
    """Offloading transmission power E^trans = p * T_trans * lam   [J/s]."""
    return p_tx * t_trans * lam


def ue_energy(f_ue, d_ue, lam, kappa, p_tx, t_trans):
    """Total UE power draw for the slot (eq. 5)."""
    return compute_energy(f_ue, d_ue, lam, kappa) + trans_energy(p_tx, t_trans, lam)


def memory_cost(prefix_params, suffix_params, prefix_act_max, suffix_act_max,
                gamma_ue, gamma_es):
    """Deployment memory cost (eq. 6), in GB, from bytes gathered at the cut."""
    local = gamma_ue * prefix_params + prefix_act_max
    edge = gamma_es * suffix_params + suffix_act_max
    return (local + edge) / GB
