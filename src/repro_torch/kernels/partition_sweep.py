"""CUDA partition sweep (paper eq. 11 over every (UE, cut) pair).

The Hopper kernel is ``csrc/partition_sweep.cu``; it replaces the TPU kernel
``repro/kernels/partition_sweep.py::_kernel``.  This module builds it on
first use with ``nvcc`` into ``build/`` at the root of the checkout, keyed
by a hash of the source, loads it with ``ctypes`` and launches it on
PyTorch's current stream.  Nothing is compiled or loaded at import time.

``partition_sweep_cuda.launches`` counts launches: it rises by one each
time the wrapper launches the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "partition_sweep.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
N_SCALARS = 11

# Float32 operations of the sweep, counted from the kernel body (a division
# or a log2 as one): per row, the even split's rate and edge share and the
# search's row constants; per cut, the four scan steps, d_ue and the
# feasibility test; per feasible cut, the 40-step Fibonacci search (28 a
# step: span, two probes, two 11-operation objective evaluations, compare),
# its end (25), its lower bound and loop invariants (6), and d_es, delays,
# energy, memory and objective (37).  Infeasible cuts skip the rest.
OPS_PER_ROW = 13
OPS_PER_CUT = 9
OPS_PER_FEASIBLE_CUT = 40 * 28 + 25 + 6 + 37


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


_lib = None
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA partition sweep cannot be built")


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"partition_sweep-{digest}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless a build of this exact source exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        build_log = proc.stdout + proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.partition_sweep_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.partition_sweep_error_string.argtypes = [ctypes.c_int]
        lib.partition_sweep_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def partition_sweep_cuda(macs, params_b, acts, psi, L, lam, gain, q_energy,
                         q_memory, scalars, *, n_total: int | None = None):
    """Launch the CUDA sweep.  Tables (R, C) float32, ``L`` (R,) int64,
    vectors (R,) float32, ``scalars`` (R / n_total, 11) float32 -- one row
    of ``kernels.ref.SCALAR_NAMES`` per cell -- all contiguous on one CUDA
    device.  ``n_total`` is the per-cell UE count of the even split
    (defaults to R, one cell); rows [g * n_total, (g + 1) * n_total) are
    cell g.  Returns the (R, C) table, infeasible cells = 1e30.
    """
    tables = (macs, params_b, acts, psi)
    vectors = (lam, gain, q_energy, q_memory)
    if macs.dim() != 2:
        raise ValueError(f"tables must be (R, C), got {tuple(macs.shape)}")
    rows, c = macs.shape
    n_total = rows if n_total is None else int(n_total)
    if n_total <= 0 or rows % n_total:
        raise ValueError(f"n_total={n_total} must be positive and divide "
                         f"the {rows} rows")
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
    cells = rows // n_total
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

    lib = _load()
    out = torch.empty((rows, c), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.partition_sweep_launch(
        *(t.data_ptr() for t in tables), L.data_ptr(),
        *(t.data_ptr() for t in vectors), scalars.data_ptr(), out.data_ptr(),
        rows, c, n_total, device.index if device.index is not None
        else torch.cuda.current_device(), stream)
    if err != 0:
        raise RuntimeError("partition_sweep launch failed: "
                           + lib.partition_sweep_error_string(err).decode())
    partition_sweep_cuda.launches += 1
    return out


partition_sweep_cuda.launches = 0
