"""Span/event tracer: a bounded ring buffer of host-side timing events,
exportable as Chrome-trace JSON (drop the file into https://ui.perfetto.dev
or ``chrome://tracing``) or JSONL (one event per line, grep/jq-friendly).

Port of ``repro/obs/tracer.py``: the same events and files.

Timestamps are microseconds since tracer construction (``perf_counter_ns``
based -- monotonic, never wall clock), which is exactly the unit the Chrome
trace format wants in ``ts``/``dur``.  The buffer is a ``deque(maxlen=...)``:
long serving runs keep the most recent ``capacity`` events and never grow
unbounded; recording an event is an O(1) dict append, cheap enough to sit
on the engine tick path (the overhead gate in ``python -m repro_torch.obs
--overhead`` holds enabled-vs-disabled p50 within 5%).

``span(..., device=True)`` additionally enters
``torch.profiler.record_function(name)``, so a torch profile captured at
the same time shows the same region beside the device kernels.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import deque


class SpanTracer:
    """Bounded in-memory trace buffer (Chrome trace event format)."""

    def __init__(self, capacity: int = 65536, pid: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.pid = pid
        self._events: deque[dict] = deque(maxlen=capacity)
        self._t0_ns = time.perf_counter_ns()

    # -- clock ---------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer construction (monotonic)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    # -- recording -----------------------------------------------------------

    def _push(self, ev: dict) -> None:
        self._events.append(ev)

    def instant(self, name: str, cat: str = "event", tid: int = 0,
                **args) -> None:
        """Zero-duration marker (``ph: "i"``) -- lifecycle edges like
        submit/admit/preempt/complete."""
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self.now_us(), "pid": self.pid, "tid": tid,
                    "args": args})

    def complete(self, name: str, start_us: float, end_us: float,
                 cat: str = "span", tid: int = 0, **args) -> None:
        """Complete event (``ph: "X"``) from explicit start/end stamps --
        the caller timed the region itself (e.g. around a jitted dispatch
        plus its sanctioned host sync)."""
        self._push({"name": name, "cat": cat, "ph": "X",
                    "ts": start_us, "dur": max(end_us - start_us, 0.0),
                    "pid": self.pid, "tid": tid, "args": args})

    def counter(self, name: str, value: float, tid: int = 0) -> None:
        """Counter track (``ph: "C"``) -- e.g. queue depth over time."""
        self._push({"name": name, "cat": "counter", "ph": "C",
                    "ts": self.now_us(), "pid": self.pid, "tid": tid,
                    "args": {"value": float(value)}})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", device: bool = False,
             tid: int = 0, **args):
        """Context manager recording a complete event around its body.

        ``device=True`` also enters ``torch.profiler.record_function`` so
        a concurrently-captured torch profile shows the same region.
        """
        t0 = self.now_us()
        if device:
            import torch
            cm: contextlib.AbstractContextManager = \
                torch.profiler.record_function(name)
        else:
            cm = contextlib.nullcontext()
        try:
            with cm:
                yield
        finally:
            self.complete(name, t0, self.now_us(), cat=cat, tid=tid, **args)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        return list(self._events)

    def to_chrome(self) -> dict:
        """Chrome trace object (Perfetto/chrome://tracing-loadable)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)

    def export_jsonl(self, path) -> None:
        with open(path, "w") as f:
            for ev in self._events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")

    @staticmethod
    def load_chrome(path) -> list[dict]:
        """Events back out of an :meth:`export_chrome` file."""
        with open(path) as f:
            obj = json.load(f)
        if not isinstance(obj, dict) or "traceEvents" not in obj:
            raise ValueError(f"{path}: not a Chrome trace object")
        return obj["traceEvents"]

    @staticmethod
    def load_jsonl(path) -> list[dict]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
