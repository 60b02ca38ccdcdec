"""Process-local metrics registry: counters, gauges, log-bucketed histograms.

Copy of ``repro/obs/metrics.py``: the same names, semantics and text
exposition, byte for byte, for the same observations.  Pure host-side
bookkeeping (stdlib only -- no torch, no numpy): every
``inc``/``set``/``observe`` is a couple of Python float ops on values the
caller already holds, so instrumented hot paths never pay a device->host
sync for telemetry (see ``repro_torch.obs.enginehooks``).

Naming and exposition follow Prometheus conventions:

* counters end in ``_total`` and only go up;
* gauges hold the last sampled value;
* histograms keep per-bucket counts with *inclusive* upper bounds
  (Prometheus ``le`` semantics: a value exactly on a boundary lands in that
  boundary's bucket) plus ``_sum``/``_count``, default boundaries from
  :func:`log_buckets` -- geometric, so tick latencies spanning orders of
  magnitude keep constant relative resolution.

``MetricsRegistry.to_prometheus()`` renders the whole registry in the text
exposition format (scrapeable / diffable); ``snapshot()`` gives the same
numbers as a plain dict for JSON reports.
"""
from __future__ import annotations

import bisect
from typing import Iterable


def log_buckets(lo: float = 1.0, hi: float = 1024.0,
                base: float = 2.0) -> tuple[float, ...]:
    """Geometric bucket boundaries ``lo, lo*base, ... >= hi`` (inclusive of
    the first boundary >= hi).  Constant *relative* resolution: the right
    shape for latencies, where p99 can sit orders of magnitude above p50."""
    if lo <= 0 or base <= 1 or hi < lo:
        raise ValueError(f"need lo > 0, base > 1, hi >= lo; got "
                         f"lo={lo}, hi={hi}, base={base}")
    out = [float(lo)]
    while out[-1] < hi:
        out.append(out[-1] * base)
    return tuple(out)


def _fmt(v: float) -> str:
    """Prometheus-style number: integers without a trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        self.value += n


class Gauge:
    """Last-sampled value (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed histogram with inclusive upper bounds (``le``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels=None,
                 buckets: Iterable[float] | None = None):
        self.name, self.help = name, help
        self.labels = dict(labels or {})
        self.bounds = tuple(sorted(float(b) for b in (buckets
                                                      or log_buckets())))
        if not self.bounds:
            raise ValueError(f"{self.name}: need at least one bucket bound")
        # one slot per finite bound + the +Inf overflow slot
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # first bound >= v -> that bucket (le is inclusive); past the last
        # finite bound -> +Inf
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> list[tuple[str, int]]:
        """(le, cumulative count) pairs, Prometheus-style."""
        out, running = [], 0
        for bound, c in zip(self.bounds, self.counts):
            running += c
            out.append((_fmt(bound), running))
        out.append(("+Inf", running + self.counts[-1]))
        return out


class MetricsRegistry:
    """Get-or-create registry keyed by (name, labels); one per process or
    per :class:`repro_torch.obs.Telemetry` instance."""

    def __init__(self):
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, help: str, labels: dict, **kw):
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help, labels, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", buckets=None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self):
        return len(self._metrics)

    def snapshot(self) -> dict:
        """Plain-dict view (JSON-ready): scalars for counters/gauges,
        ``{sum, count, buckets}`` for histograms."""
        out: dict = {}
        for m in self._metrics.values():
            key = m.name + _label_str(m.labels)
            if isinstance(m, Histogram):
                out[key] = {"sum": m.sum, "count": m.count,
                            "buckets": {le: n for le, n in m.cumulative()}}
            else:
                out[key] = m.value
        return out

    def to_prometheus(self) -> str:
        """Text exposition format (one HELP/TYPE header per metric name)."""
        lines: list[str] = []
        seen_headers: set[str] = set()
        for m in self._metrics.values():
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            lbl = _label_str(m.labels)
            if isinstance(m, Histogram):
                for le, c in m.cumulative():
                    blbl = dict(m.labels, le=le)
                    lines.append(f"{m.name}_bucket{_label_str(blbl)} {c}")
                lines.append(f"{m.name}_sum{lbl} {_fmt(m.sum)}")
                lines.append(f"{m.name}_count{lbl} {m.count}")
            else:
                lines.append(f"{m.name}{lbl} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")
