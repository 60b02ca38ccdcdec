"""Kernel entry points of the port.

Dispatch is by device alone: a CUDA tensor launches the CUDA kernel and a
CPU tensor runs the plain version in ``kernels.ref``.  There is no other
switch and no fallback: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from . import ref


def partition_sweep(macs, params_b, acts, psi, L, lam, gain, q_energy,
                    q_memory, scalars):
    """Per-(UE, cut) drift-plus-penalty table (paper eq. 11) of one cell:
    tables (N, C), vectors (N,), ``scalars`` the cell's (11,) float32 row of
    ``ref.SCALAR_NAMES`` (``ref.pack_scalars`` makes it from a dict)."""
    if macs.is_cuda:
        from .partition_sweep import partition_sweep_cuda
        return partition_sweep_cuda(macs, params_b, acts, psi, L, lam, gain,
                                    q_energy, q_memory,
                                    scalars.reshape(1, -1).contiguous())
    return ref.partition_sweep_ref(macs, params_b, acts, psi, L, lam, gain,
                                   q_energy, q_memory, scalars)


def partition_sweep_batched(macs, params_b, acts, psi, L, lam, gain,
                            q_energy, q_memory, scalars):
    """(B, N, C) sweep over every cell of a grid in one kernel launch.

    The B*N rows are flattened onto the kernel's rows; the even split stays
    per cell through ``n_total=N``.  ``scalars`` is (B, 11), one row per
    cell, or one (11,) row for every cell.
    """
    if macs.is_cuda:
        from .partition_sweep import partition_sweep_cuda
        b, n, c = macs.shape
        flat = lambda t: t.reshape((b * n,) + tuple(t.shape[2:])).contiguous()
        rows = torch.broadcast_to(scalars, (b, scalars.shape[-1])).contiguous()
        out = partition_sweep_cuda(
            flat(macs), flat(params_b), flat(acts), flat(psi), flat(L),
            flat(lam), flat(gain), flat(q_energy), flat(q_memory), rows,
            n_total=n)
        return out.reshape(b, n, c)
    return ref.partition_sweep_batched_ref(macs, params_b, acts, psi, L, lam,
                                           gain, q_energy, q_memory, scalars)
