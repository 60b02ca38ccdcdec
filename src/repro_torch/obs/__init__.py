"""Observability: metrics, spans and the E2E delay breakdown (port of
``repro.obs``).

Three layers, all host-side and zero-cost when absent:

* :mod:`repro_torch.obs.metrics` -- a Prometheus-flavoured registry
  (counters, gauges, log-bucketed histograms) with text-exposition output;
* :mod:`repro_torch.obs.tracer` -- a bounded ring buffer of spans and
  instants that exports Chrome-trace JSON and JSONL, optionally entering
  ``torch.profiler.record_function`` so host spans line up with a torch
  profile;
* :mod:`repro_torch.obs.breakdown` -- per-request serving ticks partitioned
  onto the paper's serial-queue stages (queue wait / prefill / decode /
  preemption-recompute), summing exactly to E2E latency.

Wiring: build one :class:`Telemetry` and hand it to the engine --

    from repro_torch.obs import Telemetry
    tel = Telemetry()
    eng = ServingEngine(cfg, params, recorder=rec, telemetry=tel)
    ...
    print(tel.metrics.to_prometheus())
    tel.tracer.export_chrome("trace.json")

Without ``telemetry=`` the engine's ``obs`` attribute stays None and every
instrumentation site is one ``is None`` check; with it, every callback
reads only host state the engine already holds (never an extra
device->host sync).  ``python -m repro_torch.obs`` replays a bursty
schedule and prints the stage table, dumps Prometheus text and Chrome
traces, or runs the enabled-vs-disabled overhead gate.
"""
from .breakdown import STAGES, DelayBreakdown, from_events, stage_summary
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      log_buckets)
from .tracer import SpanTracer


class Telemetry:
    """One metrics registry + one span tracer, handed around together.

    ``sample_every`` is the gauge-sampling stride in engine ticks (see
    ``EngineHooks.sample``): counters and histograms stay exact, only the
    point-in-time gauges are decimated.  1 = sample every tick (tests).
    """

    def __init__(self, *, trace_capacity: int = 65536,
                 sample_every: int = 16):
        self.metrics = MetricsRegistry()
        self.tracer = SpanTracer(capacity=trace_capacity)
        self.sample_every = sample_every

    def span(self, name: str, **kw):
        return self.tracer.span(name, **kw)


__all__ = ["Telemetry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "log_buckets", "SpanTracer", "DelayBreakdown", "from_events",
           "stage_summary", "STAGES"]
