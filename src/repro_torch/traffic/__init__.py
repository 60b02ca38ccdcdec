"""Arrival processes, the trace format and the traffic recorder (port of
``repro.traffic``).

``python -m repro_torch.traffic --list`` prints the generator and scenario
catalogue; ``--show trace.npz`` summarizes a saved trace.
"""
from .processes import (Diurnal, FixedRate, FlashCrowd, IidUniform, MMPP,
                        PROCESSES, PeakWindow, PoissonArrivals, TraceArrivals,
                        arrival_process, make_mmpp, materialize, per_ue)
from .recorder import RequestEvents, TrafficRecorder
from .trace import Trace, from_process

__all__ = [
    "Diurnal", "FixedRate", "FlashCrowd", "IidUniform", "MMPP", "PROCESSES",
    "PeakWindow", "PoissonArrivals", "TraceArrivals", "arrival_process",
    "make_mmpp", "materialize", "per_ue", "RequestEvents", "TrafficRecorder",
    "Trace", "from_process",
]
