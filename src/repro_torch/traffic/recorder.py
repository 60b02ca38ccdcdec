"""Traffic recorder: turn a live ServingEngine run into an arrival Trace.

Copy of ``repro/traffic/recorder.py`` (numpy only); ``to_trace`` builds the
port's :class:`repro_torch.traffic.trace.Trace`.

:class:`TrafficRecorder` is the observer half of the serving->trace->MEC
loop.  Attach one to a :class:`~repro_torch.serving.engine.ServingEngine`
(``ServingEngine(..., recorder=rec)``) and the engine reports, in units of
its own step clock (one ``step()`` == one tick):

* ``record_submit(rid, t, ue)``   -- request entered the queue;
* ``record_admit(rid, t)``        -- request entered a decode slot (called
  again on every re-admission after a preemption);
* ``record_prefill_done(rid, t)`` -- prompt fully prefilled and first token
  sampled; same tick as the admit for whole-prompt prefill, later for
  chunked prefill (the engine probes for it with ``getattr``, so older
  recorders keep working);
* ``record_preempt(rid, t)``      -- request evicted back to the queue
  head, output discarded (continuous mode only);
* ``record_complete(rid, t)``     -- request finished decoding.

``to_trace`` then bins one of those event streams into the canonical
slot-indexed ``(T, N)`` rate tensor (:class:`repro_torch.traffic.trace.Trace`),
which replays into the MEC environment as a
:class:`~repro_torch.traffic.processes.TraceArrivals` process.  The recorder is
duck-typed -- the engine never imports this module -- so any object with
the ``record_*`` methods can stand in (``record_preempt`` is optional: the
engine probes for it with ``getattr``).

``delay_breakdowns`` maps the recorded ticks onto the paper's serial-queue
stages (queue wait / prefill / decode / preemption-recompute) via
:mod:`repro_torch.obs.breakdown`; per-request stage sums equal E2E latency
exactly (tests/test_torch_recorder.py holds them to the reference's).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .trace import Trace


@dataclasses.dataclass
class RequestEvents:
    """Lifecycle timestamps (engine ticks) of one request.

    ``ue`` is the originating UE when the caller declared one
    (``Request.ue``); None falls back to ``rid % n_ue`` round-robin at
    trace-binning time.  ``admits``/``preempts`` hold EVERY admission /
    preemption tick (a preempted request is re-admitted later, so it can
    have several); ``admit`` exposes the first admission for the common
    no-preemption case.  ``prefill_dones`` holds the prefill-completion
    tick of each admission window that finished its prompt (chunked
    prefill spends several ticks between admit and done; a preemption
    mid-prefill leaves that window without a done entry).
    """

    rid: int
    ue: int | None = None
    submit: int | None = None
    complete: int | None = None
    admits: list[int] = dataclasses.field(default_factory=list)
    preempts: list[int] = dataclasses.field(default_factory=list)
    prefill_dones: list[int] = dataclasses.field(default_factory=list)

    @property
    def admit(self) -> int | None:
        """First admission tick (time-to-first-service)."""
        return self.admits[0] if self.admits else None

    @property
    def last_admit(self) -> int | None:
        return self.admits[-1] if self.admits else None

    @property
    def queueing_ticks(self) -> int | None:
        """Submit -> first admission (initial queue wait)."""
        if self.submit is None or not self.admits:
            return None
        return self.admits[0] - self.submit

    @property
    def service_ticks(self) -> int | None:
        """Final admission -> complete (the service that counted)."""
        if not self.admits or self.complete is None:
            return None
        return self.complete - self.admits[-1]


class TrafficRecorder:
    """Collects per-request lifecycle events and bins them into a Trace."""

    def __init__(self):
        self.events: dict[int, RequestEvents] = {}

    # -- engine-facing hooks -------------------------------------------------

    def record_submit(self, rid: int, t: int, ue: int | None = None) -> None:
        if ue is not None and ue < 0:
            raise ValueError(f"request {rid}: ue must be >= 0, got {ue}")
        ev = self.events.setdefault(rid, RequestEvents(rid=rid, ue=ue))
        if ue is not None:
            # a resubmit without ue= must not wipe the UE declared earlier
            # (the request would silently fall back to rid % n_ue binning)
            ev.ue = ue
        ev.submit = t

    def record_admit(self, rid: int, t: int) -> None:
        self.events.setdefault(rid, RequestEvents(rid=rid)).admits.append(t)

    def record_preempt(self, rid: int, t: int) -> None:
        self.events.setdefault(rid, RequestEvents(rid=rid)).preempts.append(t)

    def record_prefill_done(self, rid: int, t: int) -> None:
        self.events.setdefault(rid,
                               RequestEvents(rid=rid)).prefill_dones.append(t)

    def record_complete(self, rid: int, t: int) -> None:
        self.events.setdefault(rid, RequestEvents(rid=rid)).complete = t

    # -- analysis ------------------------------------------------------------

    def timestamps(self, which: str = "submit") -> list[tuple[int, int]]:
        """(tick, rid) pairs of the chosen event, in rid order; unseen events
        are skipped (e.g. requests still in flight have no ``complete``)."""
        if which not in ("submit", "admit", "complete"):
            raise ValueError(f"unknown event {which!r}")
        out = []
        for rid in sorted(self.events):
            t = getattr(self.events[rid], which)
            if t is not None:
                out.append((int(t), rid))
        return out

    def latencies(self, start: str = "submit",
                  end: str = "complete") -> np.ndarray:
        """Tick deltas ``end - start`` for every request that has both
        events, in rid order.  The default pair is E2E latency
        (submit->complete ticks) -- the paper's end-to-end delay in units
        of the engine clock."""
        for which in (start, end):
            if which not in ("submit", "admit", "complete"):
                raise ValueError(f"unknown event {which!r}")
        out = []
        for rid in sorted(self.events):
            ev = self.events[rid]
            a, b = getattr(ev, start), getattr(ev, end)
            if a is not None and b is not None:
                out.append(b - a)
        return np.asarray(out, np.int64)

    def latency_stats(self, start: str = "submit",
                      end: str = "complete") -> dict:
        """Summary stats of :meth:`latencies`: count, mean, p50, p90, p99,
        max, plus ``mean_queue_wait``.

        Units are ENGINE TICKS throughout (one ``ServingEngine.step()`` ==
        one tick; idle ticks advance the clock too), not wall seconds --
        tick stats are deterministic across machines, wall time is not.
        ``mean_queue_wait`` averages the queue-wait stage of
        :meth:`delay_breakdowns` (total queued ticks including post-
        preemption requeues, excluding each admission tick) over the
        requests with a full lifecycle; it is omitted when none completed.
        Safe on empty (``{"n": 0}``) and single-event sets -- no numpy
        warnings either way.
        """
        lat = self.latencies(start, end)
        if not len(lat):
            return {"n": 0}
        out = {"n": int(len(lat)),
               "mean": float(np.mean(lat)),
               "p50": float(np.percentile(lat, 50)),
               "p90": float(np.percentile(lat, 90)),
               "p99": float(np.percentile(lat, 99)),
               "max": int(np.max(lat))}
        waits = [b.queue_wait for b in self.delay_breakdowns().values()]
        if waits:
            out["mean_queue_wait"] = float(np.mean(waits))
        return out

    def delay_breakdowns(self) -> dict:
        """rid -> :class:`repro_torch.obs.DelayBreakdown` for every request with
        a full lifecycle (submit + >=1 admit + complete): E2E ticks split
        onto the paper's serial-queue stages, summing exactly (see
        ``repro_torch/obs/breakdown.py`` for the stage table and proof)."""
        from ..obs.breakdown import from_events
        out = {}
        for rid in sorted(self.events):
            ev = self.events[rid]
            b = from_events(rid, ev.submit, ev.admits, ev.preempts,
                            ev.complete,
                            prefill_dones=ev.prefill_dones or None)
            if b is not None:
                out[rid] = b
        return out

    def to_trace(self, n_ue: int, *, bin_ticks: int = 1, slot_s: float = 1.0,
                 which: str = "submit", horizon: int | None = None) -> Trace:
        """Bin events into a (T, N) rate trace.

        One trace slot aggregates ``bin_ticks`` engine ticks and spans
        ``slot_s`` seconds of MEC time, so ``rate = count / slot_s`` req/s.
        Requests that declared no ``ue`` spread round-robin (``rid %
        n_ue``); a declared ``ue >= n_ue`` folds onto ``ue % n_ue``.
        ``horizon`` pads/truncates to a fixed slot count (replay wraps, so
        padding with zero-rate slots models an idle tail).
        """
        if bin_ticks < 1:
            raise ValueError("bin_ticks must be >= 1")
        stamps = self.timestamps(which)
        if not stamps and horizon is None:
            raise ValueError(f"no {which!r} events recorded")
        last = max((t for t, _ in stamps), default=0)
        n_slots = horizon if horizon is not None else last // bin_ticks + 1
        counts = np.zeros((n_slots, n_ue), np.float32)
        for t, rid in stamps:
            ue = self.events[rid].ue
            if ue is None:
                ue = rid
            slot = t // bin_ticks
            if slot < n_slots:
                counts[slot, ue % n_ue] += 1.0
        return Trace(rates=counts / np.float32(slot_s), slot_s=slot_s,
                     meta={"source": "serving_recorder", "event": which,
                           "bin_ticks": int(bin_ticks),
                           "n_requests": len(self.events)})
