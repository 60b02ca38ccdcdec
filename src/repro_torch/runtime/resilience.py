"""Straggler mitigation + elastic restart policies.

A copy of ``repro/runtime/resilience.py`` (pure Python): the port keeps its
own so that it imports nothing of the reference package.  Pure
control-plane logic, unit-testable with a fake clock:

* ``StragglerMonitor`` -- per-step deadline derived from a running median;
  steps exceeding ``threshold x median`` are flagged; repeated offenders
  trigger a re-dispatch recommendation (on a real cluster: swap the slow
  host out of the mesh and resume from the last checkpoint).
* ``ElasticPolicy`` -- given the live device count, decide the next mesh and
  whether a restore-and-reshard is needed (checkpoints are mesh-agnostic,
  runtime/checkpoint.py).
* ``RestartLoop`` -- the driver wrapper: run step fn, on failure restore
  latest checkpoint and continue; bounded retries.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 50,
                 patience: int = 3, clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.window: deque = deque(maxlen=window)
        self.patience = patience
        self.clock = clock
        self.consecutive_slow = 0
        self.events: list[StragglerEvent] = []
        self._t0 = None
        self._step = 0

    def start_step(self, step: int):
        self._step = step
        self._t0 = self.clock()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        dt = self.clock() - self._t0
        median = self.median()
        self.window.append(dt)
        if median is not None and dt > self.threshold * median:
            self.consecutive_slow += 1
            self.events.append(StragglerEvent(self._step, dt, median))
            return True
        self.consecutive_slow = 0
        return False

    def median(self):
        if len(self.window) < 5:
            return None
        s = sorted(self.window)
        return s[len(s) // 2]

    @property
    def should_redispatch(self) -> bool:
        """Persistent slowness -> recommend swapping hardware + restore."""
        return self.consecutive_slow >= self.patience

    def deadline(self) -> float | None:
        m = self.median()
        return None if m is None else self.threshold * m


class ElasticPolicy:
    """Largest (data, model) mesh the live device pool supports, preferring
    to keep the model axis intact (resharding params across a changed model
    axis is the expensive path)."""

    def __init__(self, target_model: int):
        self.target_model = target_model

    def plan(self, live_devices: int, current_shape: tuple | None = None):
        model = min(self.target_model, live_devices)
        while live_devices % model:
            model -= 1
        shape = (live_devices // model, model)
        changed = current_shape is not None and shape != tuple(current_shape)
        return {"shape": shape, "axes": ("data", "model"),
                "reshard_required": changed}


class RestartLoop:
    """run(step_fn) with restore-on-failure semantics.

    ``step_fn(state, step) -> state``;  ``save_fn(state, step)``;
    ``restore_fn() -> (state, step) | None``.
    """

    def __init__(self, save_fn, restore_fn, checkpoint_every: int = 100,
                 max_restarts: int = 3):
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.every = checkpoint_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, step_fn, state, n_steps: int, start_step: int = 0):
        step = start_step
        while step < n_steps:
            try:
                state = step_fn(state, step)
                step += 1
                if step % self.every == 0:
                    self.save_fn(state, step)
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                restored = self.restore_fn()
                if restored is None:
                    raise
                state, step = restored
        return state, step
