"""CUDA partition sweep (paper eq. 11 over every (UE, cut) pair).

The Hopper kernel is ``csrc/partition_sweep.cu``; it replaces the TPU kernel
``repro/kernels/partition_sweep.py::_kernel``.  This module builds it on
first use through ``kernels._build`` (``nvcc`` into ``build/``, keyed by a
hash of the source, loaded with ``ctypes``) and launches it on PyTorch's
current stream.  Nothing is compiled or loaded at import time.  A UE row
of C cuts takes ``lanes_per_row(C)`` lanes of a warp (the least power of
two >= C, at most 32), so ``rows_per_block(C)`` rows share a block of 8
warps; past 32 cuts a row's lanes stride over them in chunks of 32.

``partition_sweep_cuda.launches`` counts launches: it rises by one each
time the wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import SCALAR_NAMES

N_SCALARS = 11
WARPS_PER_BLOCK = 8            # csrc kWarpsPerBlock
# The largest UE clock (Hz) the kernel takes.  Its P3 search divides with
# __fdividef, which returns 0 for a divisor above 2^126; the divisor grows
# as f_max_ue^3 (csrc p3_obj), to about 2^119.6 at this limit.
F_MAX_UE_LIMIT = 1e12

# Float32 operations of the sweep's function, counted from the plain
# version's arithmetic (a division or a log2 as one; the kernel evaluates
# the P3 objective in 13 operations with one division where the plain
# version takes 11 with two, and the bound counts the function's): per row, the even split's rate and edge share and the
# search's row constants; per cut, the four scan steps, d_ue and the
# feasibility test; per feasible cut, the 40-step Fibonacci search (28 a
# step: span, two probes, two 11-operation objective evaluations, compare),
# its end (25), its lower bound and loop invariants (6), and d_es, delays,
# energy, memory and objective (37).  Infeasible cuts skip the rest.
OPS_PER_ROW = 13
OPS_PER_CUT = 9
OPS_PER_FEASIBLE_CUT = 40 * 28 + 25 + 6 + 37


def lanes_per_row(cols: int) -> int:
    """Lanes of a warp one UE row takes (csrc partition_sweep_launch)."""
    lanes = 1
    while lanes < min(cols, 32):
        lanes *= 2
    return lanes


def rows_per_block(cols: int) -> int:
    """UE rows one block of WARPS_PER_BLOCK warps holds."""
    return WARPS_PER_BLOCK * (32 // lanes_per_row(cols))


def op_count(rows: int, cols: int, feasible: int) -> int:
    """Float32 operations the sweep needs for these inputs."""
    return (OPS_PER_ROW * rows + OPS_PER_CUT * rows * cols
            + OPS_PER_FEASIBLE_CUT * feasible)


def byte_count(rows: int, cols: int, cells: int) -> int:
    """Bytes the sweep must move: each input read once, the output written
    once (four float32 tables, int64 L, four float32 vectors, the scalar
    rows, the float32 table out)."""
    return (4 * rows * cols * 4 + rows * 8 + 4 * rows * 4
            + cells * N_SCALARS * 4 + rows * cols * 4)


def check_scalar_rows(scalars: torch.Tensor) -> None:
    """Refuse scalar rows the kernel would score wrongly: any cell whose
    ``f_max_ue`` is above ``F_MAX_UE_LIMIT``.  It reads the rows once on
    the host, so it belongs where a grid or a run builds its rows for the
    kernel (``core.sweep.scalar_rows_p`` on CUDA tensors), never beside a
    launch.  The plain version keeps the reference's semantics, which have
    no such limit: rows for the CPU are deliberately not checked."""
    f_max_ue = float(scalars[..., SCALAR_NAMES.index("f_max_ue")].max())
    if f_max_ue > F_MAX_UE_LIMIT:
        raise ValueError(
            f"f_max_ue = {f_max_ue:.4g} Hz is above the CUDA partition "
            f"sweep's F_MAX_UE_LIMIT = {F_MAX_UE_LIMIT:.0e} Hz (its P3 "
            f"search's approximate division leaves its range there)")


def _bind(lib) -> None:
    fn = lib.partition_sweep_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = _build.Library("partition_sweep", _build.CSRC / "partition_sweep.cu",
                         _bind, extra_flags=("-fmad=false",))


def partition_sweep_cuda(macs, params_b, acts, psi, L, lam, gain, q_energy,
                         q_memory, scalars, *, n_total: int | None = None,
                         cell_rows: int | None = None):
    """Launch the CUDA sweep.  Tables (R, C) float32, ``L`` (R,) int64,
    vectors (R,) float32, ``scalars`` (R / cell_rows, 11) float32 -- one
    row of ``kernels.ref.SCALAR_NAMES`` per cell -- all contiguous on one
    CUDA device.  Rows [g * cell_rows, (g + 1) * cell_rows) are cell g;
    ``n_total`` is the UE count of a cell's even split.  ``cell_rows``
    defaults to ``n_total``, and that to R (one cell); a rank holding
    N / M of each cell's N UEs passes ``cell_rows=N // M, n_total=N``.
    Returns the (R, C) table, infeasible cells = 1e30.
    """
    tables = (macs, params_b, acts, psi)
    vectors = (lam, gain, q_energy, q_memory)
    if macs.dim() != 2:
        raise ValueError(f"tables must be (R, C), got {tuple(macs.shape)}")
    rows, c = macs.shape
    if cell_rows is None:
        cell_rows = rows if n_total is None else n_total
    cell_rows = int(cell_rows)
    n_total = cell_rows if n_total is None else int(n_total)
    if cell_rows <= 0 or rows % cell_rows:
        raise ValueError(f"the rows of a cell ({cell_rows}) must be "
                         f"positive and divide the {rows} rows")
    if n_total <= 0:
        raise ValueError(f"n_total={n_total} must be positive")
    for t in tables:
        if t.shape != (rows, c) or t.dtype != torch.float32:
            raise ValueError("tables must all be float32 of shape "
                             f"{(rows, c)}, got {t.dtype} {tuple(t.shape)}")
    for t in vectors:
        if t.shape != (rows,) or t.dtype != torch.float32:
            raise ValueError(f"vectors must be float32 of shape {(rows,)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if L.shape != (rows,) or L.dtype != torch.int64:
        raise ValueError(f"L must be int64 of shape {(rows,)}")
    cells = rows // cell_rows
    if scalars.shape != (cells, N_SCALARS) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars must be float32 of shape "
                         f"{(cells, N_SCALARS)}, got {scalars.dtype} "
                         f"{tuple(scalars.shape)}")
    device = macs.device
    if device.type != "cuda":
        raise ValueError("partition_sweep_cuda takes CUDA tensors; the plain "
                         "version is kernels.ref.partition_sweep_ref")
    for t in (*tables, *vectors, L, scalars):
        if t.device != device:
            raise ValueError("all inputs must lie on one device")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")

    lib = LIBRARY.load()
    out = torch.empty((rows, c), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.partition_sweep_launch(
        *(t.data_ptr() for t in tables), L.data_ptr(),
        *(t.data_ptr() for t in vectors), scalars.data_ptr(), out.data_ptr(),
        rows, c, cell_rows, n_total, device.index if device.index is not None
        else torch.cuda.current_device(), stream)
    LIBRARY.check(err)
    partition_sweep_cuda.launches += 1
    return out


partition_sweep_cuda.launches = 0
