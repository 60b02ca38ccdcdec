"""Lyapunov virtual queues and drift-plus-penalty (Sec. IV-A, eqs. 8, 9, 11, 14).

Port of ``repro/core/lyapunov.py``.  Queues are ``(..., N)``; every sum is
over the last (UE) axis, so a stack of B cells gives B per-cell values.
Where ``ues`` (a ``gridshard.GridSharding``) says the UE axis is split over
"model", the per-UE terms are all-gathered first and every rank sums whole
rows, in the unsharded order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class VirtualQueues(NamedTuple):
    energy: torch.Tensor  # Q(t), one per UE
    memory: torch.Tensor  # W(t), one per UE

    @staticmethod
    def zeros(shape, device=None, dtype=torch.float32) -> "VirtualQueues":
        return VirtualQueues(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device))


def update_queues(q: VirtualQueues, energy, mem_cost, e_budget, c_budget,
                  nu_e, nu_c) -> VirtualQueues:
    """Eqs. (8)-(9)."""
    return VirtualQueues(
        energy=torch.clamp_min(q.energy + nu_e * (energy - e_budget), 0.0),
        memory=torch.clamp_min(q.memory + nu_c * (mem_cost - c_budget), 0.0),
    )


def lyapunov_function(q: VirtualQueues):
    """L(Theta) = 1/2 sum_n (Q_n^2 + W_n^2), per cell."""
    return 0.5 * (torch.sum(q.energy * q.energy, dim=-1)
                  + torch.sum(q.memory * q.memory, dim=-1))


def per_slot_objective(q: VirtualQueues, energy, mem_cost, delay, v,
                       ues=None):
    """Eq. (11) / negative of reward (14): sum_n Q E + W C + V T, per cell."""
    terms = q.energy * energy + q.memory * mem_cost + v * delay
    if ues is not None:
        terms, = ues.ue_whole([terms])
    return torch.sum(terms, dim=-1)


def reward(q: VirtualQueues, energy, mem_cost, delay, v, ues=None):
    """Eq. (14)."""
    return -per_slot_objective(q, energy, mem_cost, delay, v, ues)
