"""PyTorch + CUDA port of the LyMDO cooperative-inference controller.

Mirrors ``repro``'s module layout (``repro_torch/core/env.py`` is the
counterpart of ``repro/core/env.py``, and so on) and imports nothing of it:
the JAX package is the reference the port is tested against, not a
dependency.  Every entry point takes ``device=None``, which means CUDA and
raises where there is none; pass ``device="cpu"`` to run on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
