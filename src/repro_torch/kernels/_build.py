"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  On first
use it is compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the root
of the checkout, under a name keyed by a hash of the source and the flags,
and loaded with ``ctypes``.  Nothing is compiled or loaded at import time:
the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


class Library:
    """One kernel source, built once into a shared library and loaded.

    The source exports ``<name>_launch`` functions, which return a CUDA
    error code, and ``<name>_error_string``.  ``bind(lib)`` sets the launch
    functions' ``argtypes``/``restype`` when the library is first loaded.
    ``build_log`` holds what nvcc printed (``-Xptxas -v``: registers, shared
    memory, spills) after a build in this process.  ``builds`` and
    ``loads`` count the nvcc runs and the ``ctypes`` loads of this library
    in this process: each is at most 1 (``analysis.retrace``).
    """

    def __init__(self, name: str, source: pathlib.Path, bind,
                 extra_flags: tuple = ()):
        self.name = name
        self.source = pathlib.Path(source)
        self.flags = BASE_FLAGS + tuple(extra_flags)
        self._bind = bind
        self._lib = None
        self.build_log = ""
        self.builds = 0
        self.loads = 0

    def path(self) -> pathlib.Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(self.flags).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def _command(self, out: str) -> list[str]:
        return [nvcc(), *self.flags, "-Xptxas", "-v", "-o", out,
                str(self.source)]

    def build(self) -> pathlib.Path:
        """Compile unless a build of this exact source and flags exists."""
        return build_all([self])[0]

    def load(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self.loads += 1
            self._bind(lib)
            err_str = getattr(lib, f"{self.name}_error_string")
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int) -> None:
        """Raise when a launch function returned a nonzero CUDA error."""
        if err != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(err)
            raise RuntimeError(f"{self.name} launch failed: {msg.decode()}")


def all_libraries() -> list[Library]:
    """The port's kernel libraries, one per ``csrc/*.cu`` source."""
    from . import (decode_attention, flash_attention, partition_sweep,
                   rglru_scan, ssd_scan)
    return [partition_sweep.LIBRARY, flash_attention.LIBRARY,
            decode_attention.LIBRARY, ssd_scan.LIBRARY, rglru_scan.LIBRARY]


def build_all(libraries) -> list[pathlib.Path]:
    """Build every library that is not built yet, one nvcc process per
    source, all started together; raise if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for lib in libraries:
        out = lib.path()
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(lib._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lib.builds += 1
        jobs.append((lib, out, tmp, proc))
    errors = []
    for lib, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        try:
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {lib.source.name} "
                              f"({proc.returncode}):\n{log}")
            else:
                lib.build_log = log
                os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [lib.path() for lib in libraries]

