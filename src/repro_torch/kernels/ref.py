"""Plain PyTorch versions of the port's kernels.

The CPU tests run these, ``kernels.ops`` falls back to them only for tensors
on the CPU, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card.  Port of ``repro/kernels/ref.py`` (the partition-sweep part).
"""
from __future__ import annotations

from typing import Mapping

import torch

# The MEC constants of the partition sweep, in the order of a scalar row.
SCALAR_NAMES = ("rho", "kappa", "p_tx", "w_hz", "n0", "f_max_ue", "f_max_es",
                "v", "gamma_ue", "gamma_es", "stability_margin")


def pack_scalars(scalars: Mapping[str, float], device=None) -> torch.Tensor:
    """One (11,) float32 scalar row from a dict of the MEC constants."""
    return torch.tensor([float(scalars[k]) for k in SCALAR_NAMES],
                        dtype=torch.float32, device=device)


def partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain, q_energy,
                        q_memory, scalars):
    """Plain partition sweep: builds the per-cut tables from RAW per-layer
    arrays, then delegates to ``repro_torch.core.sweep``.

    Tables are (..., N, C), vectors (..., N), ``scalars`` the (..., 11)
    float32 rows of ``SCALAR_NAMES``, one per cell (a single (11,) row
    serves every cell); the even split uses the per-cell N
    (``macs.shape[-2]``).
    """
    from ..core import sweep

    prefix_macs = torch.cumsum(macs, dim=-1)
    prefix_params = torch.cumsum(params_b, dim=-1)
    suffix_macs = prefix_macs[..., -1:] - prefix_macs
    suffix_params = prefix_params[..., -1:] - prefix_params
    c = macs.shape[-1]
    idx = torch.arange(c, device=macs.device)
    acts_m = torch.where((idx >= 1) & (idx <= L[..., None]), acts, 0.0)
    prefix_act_max = torch.cummax(acts_m, dim=-1).values
    suffix_inc = torch.flip(torch.cummax(torch.flip(acts_m, (-1,)), dim=-1).values,
                            (-1,))
    suffix_act_max = torch.cat(
        [suffix_inc[..., 1:], torch.zeros_like(suffix_inc[..., :1])], dim=-1)
    consts = {k: scalars[..., i, None, None] for i, k in enumerate(SCALAR_NAMES)}
    return sweep.objective_table(
        prefix_macs=prefix_macs, suffix_macs=suffix_macs, psi=psi,
        prefix_params=prefix_params, suffix_params=suffix_params,
        prefix_act_max=prefix_act_max, suffix_act_max=suffix_act_max,
        L=L, lam=lam, gain=gain, q_energy=q_energy, q_memory=q_memory,
        **consts)


def partition_sweep_batched_ref(macs, params_b, acts, psi, L, lam, gain,
                                q_energy, q_memory, scalars):
    """Batched plain sweep: tables (B, N, C), vectors (B, N), scalars
    (B, 11) or one (11,) row.  The per-cell even split is
    ``partition_sweep_ref``'s own, over the N axis."""
    if macs.dim() != 3:
        raise ValueError(f"expected (B, N, C) tables, got {tuple(macs.shape)}")
    return partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain,
                               q_energy, q_memory, scalars)
