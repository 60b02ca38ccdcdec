"""Decoupled per-slot objective sweep over every (UE, cut) pair.

Port of ``repro/core/sweep.py``: the drift-plus-penalty objective (eq. 11)
for all candidate partitions at once.  ``objective_table`` is the plain
semantics the ``partition_sweep`` CUDA kernel is held to
(``repro_torch.kernels.ref`` builds its inputs from raw per-layer tables);
the Oracle policies decide through ``kernel_table_p``, which goes through
the kernel's entry point.

Decoupling approximation: resources that couple UEs are split evenly
(alpha = 1/N, f_es = f_max_es/N); f_ue is solved per cell (P3).  The chosen
cut is then re-evaluated with the exact allocators by ``step_p``.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import SCALAR_NAMES
from . import convex, energymem, queueing

_BIG = 1e30


def objective_table(*, prefix_macs, suffix_macs, psi, prefix_params,
                    suffix_params, prefix_act_max, suffix_act_max, L,
                    lam, gain, q_energy, q_memory,
                    rho, kappa, p_tx, w_hz, n0, f_max_ue, f_max_es, v,
                    gamma_ue, gamma_es, stability_margin=1e-3, n_total=None):
    """Returns the (..., N, C) objective table; infeasible cells hold +BIG.

    Tables are (..., N, C); lam/gain/q_* and L are (..., N); the constants
    are Python floats or tensors that broadcast against (..., N, C).  The
    even split is over ``n_total`` UEs: the per-cell UE count N by default,
    a cell's whole count where the rows are a rank's share of its UEs.
    """
    n, c = prefix_macs.shape[-2:]
    if n_total is not None:
        n = n_total
    lam_ = lam[..., None]
    gain_ = gain[..., None]
    qe = q_energy[..., None]
    qm = q_memory[..., None]

    d_ue = rho * prefix_macs
    d_es = rho * suffix_macs

    # P3 per cell (elementwise over the (..., N, C) grid).
    f_ue = convex.solve_p3(qe, kappa, d_ue, lam_, v, f_max_ue,
                           stability_margin=stability_margin)
    # Even-split decoupling for the coupled resources.
    alpha = torch.where(psi > 0, 1.0 / n, 0.0)
    f_es = torch.where(d_es > 0, f_max_es / n, 0.0)

    t_ue = queueing.ue_sojourn(lam_, f_ue, d_ue)
    t_tx = queueing.trans_delay(psi, alpha, w_hz, p_tx, gain_, n0)
    t_es = queueing.es_sojourn(f_es, d_es)
    delay = t_ue + t_tx + t_es

    energy = energymem.ue_energy(f_ue, d_ue, lam_, kappa, p_tx, t_tx)
    mem = energymem.memory_cost(prefix_params, suffix_params,
                                prefix_act_max, suffix_act_max,
                                gamma_ue, gamma_es)

    obj = qe * energy + qm * mem + v * delay

    cuts = torch.arange(c, device=prefix_macs.device)
    feasible = (cuts <= L[..., None]) & (
        d_ue * lam_ * (1.0 + stability_margin) < f_max_ue)
    return torch.where(feasible, obj, _BIG)


def objective_table_p(params, state):
    """Over a ``MecParams`` and ``MecState`` (one cell or a stacked grid)."""
    cell = lambda x: x[..., None, None]
    return objective_table(
        prefix_macs=params.prefix_macs, suffix_macs=params.suffix_macs,
        psi=params.psi, prefix_params=params.prefix_params,
        suffix_params=params.suffix_params,
        prefix_act_max=params.prefix_act_max,
        suffix_act_max=params.suffix_act_max,
        L=params.L, lam=state.lam, gain=state.gain,
        q_energy=state.queues.energy, q_memory=state.queues.memory,
        rho=cell(params.rho), kappa=cell(params.kappa),
        p_tx=cell(params.p_tx), w_hz=cell(params.w_hz), n0=cell(params.n0),
        f_max_ue=cell(params.f_max_ue), f_max_es=cell(params.f_max_es),
        v=cell(params.v), gamma_ue=cell(params.gamma_ue),
        gamma_es=cell(params.gamma_es),
        stability_margin=cell(params.stability_margin))


def _stack_scalars(params) -> torch.Tensor:
    return torch.stack([getattr(params, k) for k in SCALAR_NAMES],
                       dim=-1).to(torch.float32).contiguous()


def scalar_rows_p(params) -> torch.Tensor:
    """The sweep kernel's (..., 11) float32 rows of MEC constants, one per
    cell, in ``kernels.ref.SCALAR_NAMES`` order.  A grid or a run builds
    them once; on CUDA tensors they are checked then against the kernel's
    range (``partition_sweep.check_scalar_rows``: one read of the rows,
    raises ValueError), on CPU ones not (the plain sweep has no limit)."""
    rows = _stack_scalars(params)
    if rows.is_cuda:
        ops.check_scalar_rows(rows)
    return rows


def kernel_table_p(params, state, scalars=None, n_total=None):
    """``objective_table_p`` through ``kernels.ops``: one partition-sweep
    kernel launch for a cell or a whole (B, ...) grid on CUDA tensors, the
    plain version on CPU ones.  ``scalars`` is ``scalar_rows_p(params)``,
    which a caller deciding many slots builds once (and which checks the
    rows); built here, per call, they are not checked, since that would
    read the device every slot.  ``n_total`` is the even split's UE count
    where ``params`` hold a rank's share of each cell's UEs."""
    if scalars is None:
        scalars = _stack_scalars(params)
    args = (params.macs, params.param_bytes, params.act_bytes, params.psi,
            params.L, state.lam, state.gain, state.queues.energy,
            state.queues.memory, scalars)
    if params.macs.dim() == 2:
        return ops.partition_sweep(*args, n_total)
    return ops.partition_sweep_batched(*args, n_total)


def kernel_oracle_cut_p(params, state, scalars=None):
    """The Oracle decision (first argmin) over ``kernel_table_p``."""
    return torch.argmin(kernel_table_p(params, state, scalars), dim=-1)


def oracle_cut_p(params, state):
    """Per-slot decoupled-oracle partitioning decision (first argmin)."""
    return torch.argmin(objective_table_p(params, state), dim=-1)


def env_objective_table(env, state):
    """Convenience wrapper binding an ``MecEnv``'s tables and scalars."""
    return objective_table_p(env.params, state)


def oracle_cut(env, state):
    """Per-slot decoupled-oracle partitioning decision."""
    return torch.argmin(env_objective_table(env, state), dim=-1)
