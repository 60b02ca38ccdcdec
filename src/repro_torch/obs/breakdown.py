"""Per-request E2E delay breakdown: serving ticks -> the paper's serial
queueing stages.

Copy of ``repro/obs/breakdown.py`` (numpy only).

The paper evaluates end-to-end delay as a serial queue (UE compute ->
uplink -> ES queue -> ES compute).  The serving engine measures the same
request journey in *ticks* (one ``ServingEngine.step()`` == one tick), and
this module partitions each completed request's E2E tick count into stages
that sum EXACTLY -- no tick is lost or double-counted, on both engine
modes including preemption (tests/test_torch_obs.py):

========== ==================================== ==========================
stage      serving definition (ticks)           paper-stage analog
========== ==================================== ==========================
queue_wait ticks spent queued, excluding each   ES queue wait (the arrival
           admission tick; re-queues after      backlog A_i(t) draining)
           preemption count here too
prefill    admit tick through prefill-done      UE-side compute + uplink
           tick, inclusive, per admission       (the request's input
           window: 1 tick for whole-prompt      reaching ES service)
           prefill (first token sampled at the
           admit tick), several for chunked
           prefill; a preempted-mid-prefill
           window counts admit..preempt here
decode     complete - last prefill-done:        ES compute (ES-side
           decode dispatches the request rode   inference service)
preempted  ticks decoded then discarded by a    recompute overhead -- the
           preemption (output cleared, KV       price of contention; no
           freed, re-queued)                    paper analog (the paper's
                                                queues never evict)
========== ==================================== ==========================

Identity (per request): ``queue_wait + prefill + decode + preempted ==
complete - submit``.  Derivation: with enqueue times ``q_0 = submit, q_i =
preempt_{i-1}``, admissions ``a_0..a_k`` and per-window prefill-done ticks
``f_i`` (``a_i <= f_i <= p_i``; ``f_i = p_i`` when window ``i`` was
preempted mid-prefill, ``f_k <= complete``), the stage sums telescope --
``sum(a_i - q_i - 1) + sum(f_i - a_i + 1) + sum_{i<k}(p_i - f_i) +
(complete - f_k)`` collapses to ``complete - submit`` because ``q_{i+1} =
p_i``.  The identity holds for ANY in-window choice of ``f_i``, so legacy
event streams without prefill-done ticks still sum exactly under the
``f_i = a_i`` fallback (the pre-chunked one-tick-per-admission accounting).

The raw events come from :class:`repro_torch.traffic.recorder.TrafficRecorder`
(which grew ``record_preempt`` and ``record_prefill_done`` alongside
submit/admit/complete); use ``TrafficRecorder.delay_breakdowns()`` for the
recorder-facing entry point.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping


@dataclasses.dataclass(frozen=True)
class DelayBreakdown:
    """One completed request's E2E ticks split into paper stages."""

    rid: int
    queue_wait: int     # queued ticks (initial + every post-preempt requeue)
    prefill: int        # admit..prefill-done ticks, summed over admissions
    decode: int         # decode ticks after the final prefill completed
    preempted: int      # decoded-then-discarded ticks
    n_admits: int
    n_preempts: int

    @property
    def e2e(self) -> int:
        """Stage sum == ``complete - submit`` exactly (see module doc)."""
        return self.queue_wait + self.prefill + self.decode + self.preempted

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["e2e"] = self.e2e
        return d


def from_events(rid: int, submit, admits, preempts, complete,
                prefill_dones=None) -> DelayBreakdown | None:
    """Build a breakdown from raw lifecycle ticks; None while the request
    is still in flight (no submit/admit/complete yet).

    ``prefill_dones`` are the prefill-completion ticks (one per admission
    window that finished its prompt, in order).  Each done tick is matched
    to the admission window ``[a_i, p_i]`` (final window: ``[a_k,
    complete]``) containing it -- the windows are disjoint because a
    re-admission always follows its preemption.  A non-final window with
    no done was preempted mid-prefill: its whole residency ``a_i..p_i``
    counts as prefill (``f_i = p_i``) and contributes zero preempted
    ticks.  ``None`` (legacy streams) falls back to ``f_i = a_i``: one
    prefill tick per admission, the whole-prompt accounting.
    """
    admits, preempts = list(admits), list(preempts)
    if submit is None or complete is None or not admits:
        return None
    if len(admits) != len(preempts) + 1:
        raise ValueError(
            f"request {rid}: {len(admits)} admissions vs {len(preempts)} "
            f"preemptions -- a completed request must have exactly one more "
            f"admit than preempt")
    ends = preempts + [complete]
    if prefill_dones is None:
        dones = list(admits)            # legacy: prefill done at admit tick
    else:
        pool = sorted(prefill_dones)
        dones = []
        for i, (a, e) in enumerate(zip(admits, ends)):
            hit = next((d for d in pool if a <= d <= e), None)
            if hit is not None:
                pool.remove(hit)
            elif i < len(preempts):
                hit = e                 # preempted mid-prefill: all prefill
            else:
                hit = a                 # completed without a done: legacy
            dones.append(hit)
        if pool:
            raise ValueError(
                f"request {rid}: prefill_done ticks {pool} fall outside "
                f"every admission window (admits={admits}, "
                f"preempts={preempts}, complete={complete})")
    enqueues = [submit] + preempts
    queue_wait = sum(a - q - 1 for a, q in zip(admits, enqueues))
    prefill = sum(f - a + 1 for f, a in zip(dones, admits))
    preempted = sum(p - f for p, f in zip(preempts, dones))
    if queue_wait < 0 or preempted < 0 or complete < dones[-1]:
        raise ValueError(f"request {rid}: non-causal event order "
                         f"(submit={submit}, admits={admits}, "
                         f"preempts={preempts}, "
                         f"prefill_dones={prefill_dones}, "
                         f"complete={complete})")
    return DelayBreakdown(rid=rid, queue_wait=queue_wait,
                          prefill=prefill,
                          decode=complete - dones[-1],
                          preempted=preempted,
                          n_admits=len(admits), n_preempts=len(preempts))


STAGES = ("queue_wait", "prefill", "decode", "preempted", "e2e")


def stage_summary(breakdowns: Mapping[int, DelayBreakdown]
                  | Iterable[DelayBreakdown]) -> dict[str, dict]:
    """Per-stage {n, mean, p50, p90, p99, max} over completed requests
    (ticks) -- the ``python -m repro_torch.obs`` summary table's data."""
    import numpy as np
    if isinstance(breakdowns, Mapping):
        breakdowns = breakdowns.values()
    bds = list(breakdowns)
    out: dict[str, dict] = {}
    for stage in STAGES:
        vals = np.asarray([getattr(b, stage) for b in bds], np.int64)
        if not len(vals):
            out[stage] = {"n": 0}
            continue
        out[stage] = {"n": int(len(vals)),
                      "mean": float(np.mean(vals)),
                      "p50": float(np.percentile(vals, 50)),
                      "p90": float(np.percentile(vals, 90)),
                      "p99": float(np.percentile(vals, 99)),
                      "max": int(np.max(vals))}
    return out
