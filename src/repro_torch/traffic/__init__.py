"""Arrival processes and the trace format (port of ``repro.traffic``)."""
from .processes import (Diurnal, FixedRate, FlashCrowd, IidUniform, MMPP,
                        PROCESSES, PeakWindow, PoissonArrivals, TraceArrivals,
                        arrival_process, make_mmpp, materialize, per_ue)
from .trace import Trace, from_process

__all__ = [
    "Diurnal", "FixedRate", "FlashCrowd", "IidUniform", "MMPP", "PROCESSES",
    "PeakWindow", "PoissonArrivals", "TraceArrivals", "arrival_process",
    "make_mmpp", "materialize", "per_ue", "Trace", "from_process",
]
