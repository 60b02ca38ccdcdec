"""Arrival-process library: per-slot, per-UE arrival rates for the MEC env.

Port of ``repro/traffic/processes.py``.  Each process is a frozen dataclass
of tensors; calling it as ``process(noise, t)`` returns the rate vector
``lam`` (req/s) of slot ``t``:

* ``noise`` is a ``torch.Generator`` for the stochastic processes (the
  deterministic ones ignore it and accept ``None``).  ``IidUniform`` also
  takes a tensor of U(0, 1) draws in its place, so a test can feed it the
  exact noise of another implementation.
* ``t`` is a Python int or an integer tensor.

Per-UE fields are shaped ``(..., N)`` and scalar fields ``(...)``, so B cells
stack along a leading axis (``repro_torch._tree.stack``) and one call serves
the whole batch, with ``t`` either shared or shaped ``(B,)``.  ``jax.random``
and torch's Philox draw different streams from one seed: parity with the
reference never rests on seeds, only on injected draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# name -> process class
PROCESSES: dict[str, type] = {}


def arrival_process(name: str):
    """Class decorator: a frozen dataclass registered under ``name``."""
    def deco(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
        if name in PROCESSES:
            raise ValueError(f"arrival process {name!r} already registered")
        PROCESSES[name] = cls
        cls.kind = name
        return cls
    return deco


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def per_ue(x, n: int) -> torch.Tensor:
    """Broadcast a scalar or (N,) array-like to a (N,) float32 tensor."""
    return torch.as_tensor(np.broadcast_to(np.asarray(x, np.float32), (n,)).copy())


def _slot(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, device=like.device)


def _at_slot(table: torch.Tensor, t) -> torch.Tensor:
    """Row ``t % T`` of a ``(..., T, N)`` table, per cell when ``t`` is batched."""
    horizon, n = table.shape[-2], table.shape[-1]
    idx = torch.remainder(_slot(t, table).long(), horizon)
    idx = idx.reshape(idx.shape + (1, 1)).expand(*table.shape[:-2], 1, n)
    return torch.gather(table, -2, idx).squeeze(-2)


def _uniform(noise, like: torch.Tensor) -> torch.Tensor:
    if isinstance(noise, torch.Tensor):
        return noise
    return torch.rand(like.shape, generator=noise, device=like.device,
                      dtype=torch.float32)


# ---------------------------------------------------------------------------
# Deterministic-in-t processes (noise unused)
# ---------------------------------------------------------------------------

@arrival_process("fixed")
class FixedRate:
    """Constant per-UE rate (the paper's Fig. 4 sweep points)."""

    lam: torch.Tensor       # (..., N) req/s

    def __call__(self, noise, t) -> torch.Tensor:
        del noise, t
        return self.lam


@arrival_process("peak_window")
class PeakWindow:
    """Constant base rate + an additive peak inside [start, stop) (Fig. 5)."""

    base: torch.Tensor      # (..., N) req/s
    boost: torch.Tensor     # (...), added req/s inside the window
    start: torch.Tensor     # (...) int slot
    stop: torch.Tensor      # (...) int slot

    def __call__(self, noise, t) -> torch.Tensor:
        del noise
        t = _slot(t, self.base)
        in_peak = (t >= self.start) & (t < self.stop)
        bump = torch.where(in_peak, self.boost, torch.zeros_like(self.boost))
        return self.base + bump[..., None]


@arrival_process("diurnal")
class Diurnal:
    """Sinusoidal day/night load: lam = max(0, base + amp*sin(2pi(t+phase)/period))."""

    base: torch.Tensor      # (..., N) req/s
    amp: torch.Tensor       # (..., N) req/s swing
    period: torch.Tensor    # (...), slots per cycle
    phase: torch.Tensor     # (...), slot offset

    def __call__(self, noise, t) -> torch.Tensor:
        del noise
        ang = 2.0 * math.pi * (_slot(t, self.base) + self.phase) / self.period
        return torch.clamp_min(self.base + self.amp * torch.sin(ang)[..., None],
                               0.0)


@arrival_process("flash_crowd")
class FlashCrowd:
    """Base load + a flash-crowd spike at t0 with exponential decay."""

    base: torch.Tensor      # (..., N) req/s
    spike: torch.Tensor     # (...), peak added req/s at t0
    t0: torch.Tensor        # (...) int, event slot
    decay: torch.Tensor     # (...), e-folding time of the spike [slots]

    def __call__(self, noise, t) -> torch.Tensor:
        del noise
        t = _slot(t, self.base)
        dt = torch.clamp_min(t - self.t0, 0).to(torch.float32)
        burst = self.spike * torch.exp(-dt / self.decay)
        burst = torch.where(t >= self.t0, burst, torch.zeros_like(burst))
        return self.base + burst[..., None]


# ---------------------------------------------------------------------------
# Stochastic processes (per-slot draws from ``noise``)
# ---------------------------------------------------------------------------

@arrival_process("iid_uniform")
class IidUniform:
    """lam ~ U(low, high) iid per UE and slot (the paper's training default)."""

    low: torch.Tensor       # (..., N) req/s
    high: torch.Tensor      # (..., N) req/s

    def __call__(self, noise, t) -> torch.Tensor:
        del t
        u = _uniform(noise, self.low)
        # the reference's jax.random.uniform(minval, maxval) form
        return torch.maximum(self.low, u * (self.high - self.low) + self.low)


@arrival_process("poisson")
class PoissonArrivals:
    """Empirical rate of a Poisson arrival count: N_t ~ Pois(lam * slot_s)."""

    lam: torch.Tensor       # (..., N) nominal req/s
    slot_s: torch.Tensor    # (...), slot length in seconds

    def __call__(self, noise, t) -> torch.Tensor:
        del t
        if not isinstance(noise, torch.Generator):
            raise TypeError("poisson arrivals draw from a torch.Generator")
        slot = self.slot_s[..., None]
        counts = torch.poisson(self.lam * slot, generator=noise)
        return counts / slot


@arrival_process("mmpp")
class MMPP:
    """Markov-modulated (bursty) process: a K-state chain picks the rate.

    ``regimes`` holds the pre-simulated modulating chains (one independent
    chain per UE, wrapped at the horizon T); see :func:`make_mmpp`.
    """

    rates: torch.Tensor     # (..., K) req/s per regime
    regimes: torch.Tensor   # (..., T, N) int64 regime index per slot and UE

    def __call__(self, noise, t) -> torch.Tensor:
        del noise
        return torch.gather(self.rates, -1, _at_slot(self.regimes, t))


@arrival_process("trace")
class TraceArrivals:
    """Replay a slot-indexed (T, N) rate tensor, wrapping at the horizon."""

    rates: torch.Tensor     # (..., T, N) req/s

    def __call__(self, noise, t) -> torch.Tensor:
        del noise
        return _at_slot(self.rates, t)


# ---------------------------------------------------------------------------
# Constructors (host-side; deterministic in their seed)
# ---------------------------------------------------------------------------

def make_mmpp(n_ue: int, seed: int = 0, rates=(0.5, 3.0), p_stay: float = 0.92,
              horizon: int = 400, trans: np.ndarray | None = None) -> MMPP:
    """Simulate per-UE modulating Markov chains and wrap them in an MMPP.

    Same host-side numpy simulation as the reference, so one seed gives the
    same regimes in both packages.
    """
    k = len(rates)
    if trans is None:
        if k == 1:
            trans = np.ones((1, 1))
        else:
            off = (1.0 - p_stay) / (k - 1)
            trans = np.full((k, k), off)
            np.fill_diagonal(trans, p_stay)
    trans = np.asarray(trans, np.float64)
    if trans.shape != (k, k) or not np.allclose(trans.sum(1), 1.0):
        raise ValueError(f"trans must be ({k},{k}) with rows summing to 1")
    rng = np.random.default_rng(seed)
    regimes = np.empty((horizon, n_ue), np.int64)
    state = rng.integers(0, k, n_ue)
    cdf = np.cumsum(trans, axis=1)
    for t in range(horizon):
        regimes[t] = state
        u = rng.random(n_ue)
        state = (u[:, None] > cdf[state]).sum(axis=1)
    return MMPP(rates=_f32(rates), regimes=torch.as_tensor(regimes))


def materialize(process, horizon: int, generator=None) -> np.ndarray:
    """Evaluate a process over slots 0..horizon-1 -> (T, N) float32 rates.

    Stochastic processes draw from ``generator`` (seeded 0 when omitted);
    the stream differs from the reference's, deterministic ones agree.
    """
    if generator is None:
        leaf = next(getattr(process, f.name)
                    for f in dataclasses.fields(process))
        generator = torch.Generator(device=leaf.device).manual_seed(0)
    rates = torch.stack([process(generator, t) for t in range(horizon)])
    return rates.to(torch.float32).cpu().numpy()


def describe() -> str:
    """One line per registered process (the --list catalogue)."""
    lines = []
    for name in sorted(PROCESSES):
        doc = (PROCESSES[name].__doc__ or "").strip().splitlines()
        lines.append(f"{name}: {doc[0] if doc else ''}")
    return "\n".join(lines)
