"""Canonical arrival-trace format: slot-indexed per-UE rate tensors on disk.

Port of ``repro/traffic/trace.py``.  The ``.npz`` layout is the reference's
(``rates`` float32 (T, N), ``slot_s``, ``version``, ``meta`` as JSON bytes),
so a trace saved by either package loads bit-exactly in the other.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .processes import TraceArrivals, materialize

_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Trace:
    """Slot-indexed per-UE arrival-rate trace."""

    rates: np.ndarray                      # (T, N) float32 req/s
    slot_s: float = 1.0
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        rates = np.asarray(self.rates, np.float32)
        if rates.ndim != 2:
            raise ValueError(f"rates must be (T, N), got {rates.shape}")
        object.__setattr__(self, "rates", rates)

    @property
    def n_slots(self) -> int:
        return self.rates.shape[0]

    @property
    def n_ue(self) -> int:
        return self.rates.shape[1]

    def process(self) -> TraceArrivals:
        """The env-side arrival process replaying this trace (wraps at T)."""
        return TraceArrivals(rates=torch.as_tensor(self.rates.copy()))

    def shifted(self, offset: int) -> "Trace":
        """Rotate the trace by ``offset`` slots."""
        return dataclasses.replace(
            self, rates=np.roll(self.rates, -int(offset), axis=0),
            meta={**self.meta, "shifted_by": int(offset)})

    def save(self, path) -> None:
        np.savez(path, rates=self.rates,
                 slot_s=np.float64(self.slot_s),
                 version=np.int64(_FORMAT_VERSION),
                 meta=np.bytes_(json.dumps(self.meta).encode()))

    @staticmethod
    def load(path) -> "Trace":
        with np.load(path, allow_pickle=False) as z:
            version = int(z["version"])
            if version > _FORMAT_VERSION:
                raise ValueError(f"trace format v{version} is newer than "
                                 f"this reader (v{_FORMAT_VERSION})")
            return Trace(rates=z["rates"], slot_s=float(z["slot_s"]),
                         meta=json.loads(z["meta"].item().decode()))


def from_process(process, horizon: int, generator=None, slot_s: float = 1.0,
                 meta: dict | None = None) -> Trace:
    """Materialize any arrival process into a Trace."""
    rates = materialize(process, horizon, generator)
    base = {"source": f"process:{getattr(process, 'kind', type(process).__name__)}"}
    return Trace(rates=rates, slot_s=slot_s, meta={**base, **(meta or {})})
