"""MEC cooperative-inference environment (paper Sec. II + V-A).

Port of ``repro/core/env.py``.  One ``step_p`` is one time slot of LyMDO's
inner loop given the partitioning action: feasibility projection (C7),
convex resource allocation (P3-P5), delay/energy/memory evaluation
(eqs. 1-6), reward (14) and virtual-queue updates (8)-(9).

``MecParams`` is a dataclass of tensors.  Tables are ``(..., N, C)``,
per-UE vectors ``(..., N)`` and per-cell scalars ``(...)``: one cell has no
leading dims, a grid of B cells has a leading ``(B,)`` written out (where
the reference ``vmap``s), and every function here serves both.

Randomness is explicit.  The state carries a ``torch.Generator`` that draws
the next slot's channel gains and arrival rates, and every entry point that
draws also takes ``draws=(gain, lam)`` to use given values instead -- the
way a test feeds the reference's exact draws through the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from .. import _tree
from ..device import resolve_device
from ..profiling.profiles import LayerProfile, ProfileBatch
from ..traffic import processes as arrivals
from . import convex, energymem, queueing
from .lyapunov import VirtualQueues, reward as lyapunov_reward, update_queues

LAM_IID_UNIFORM = 0   # lambda ~ U(low, high) iid per UE/slot (training default)
LAM_FIXED = 1         # constant per-UE rate (Fig. 4 evaluation sweeps)
LAM_PEAK = 2          # constant base + peak window (Fig. 5 stability runs)
LAM_TRACE = 3         # replay a recorded (T, N) trace (needs arrival=...)


def free_space_gain(distance_m=150.0, antenna_gain=3.0, carrier_hz=915e6,
                    path_loss_exp=3.0):
    """Mean channel gain h_bar = A_d (c / 4 pi f_c d)^d_e  (Sec. V-A)."""
    wavelength_term = 3e8 / (4.0 * np.pi * carrier_hz * distance_m)
    return antenna_gain * wavelength_term ** path_loss_exp


@dataclasses.dataclass(frozen=True)
class MecConfig:
    """Scenario constants (defaults = paper Table I / Sec. V-A)."""

    w_hz: float = 5e6                 # uplink bandwidth W
    n0: float = 10 ** (-174.0 / 10.0) / 1000.0   # -174 dBm/Hz -> W/Hz
    p_tx: float = 0.1                 # UE transmit power [W]
    rho: float = 0.12                 # CPU cycles per MAC
    kappa: float = 1e-28              # energy coefficient
    f_max_ue: float = 1.5e9           # UE CPU cap [Hz]
    f_max_es: float = 15e9            # ES CPU cap [Hz]
    v: float = 10.0                   # Lyapunov penalty weight V
    nu_e: float = 100.0               # energy-queue step (eq. 8)
    nu_c: float = 10.0                # memory-queue step (eq. 9)
    gamma_ue: float = 0.2             # UE memory cost factor
    gamma_es: float = 0.8             # ES memory cost factor
    lam_low: float = 0.5              # request/s
    lam_high: float = 2.5
    lam_mode: int = LAM_IID_UNIFORM
    peak_start: int = 75              # Fig. 5 peak-workload window
    peak_stop: int = 110
    peak_boost: float = 1.0           # added req/s inside the window
    stability_margin: float = 1e-3    # C7 projection slack
    edge_queueing: bool = False       # eq. 4 (False) vs G/D/1 correction (True)
    queue_obs_scale: float = 1e-2     # observation scaling for Q/W entries
    arrival: Any = None               # explicit arrival process (overrides
                                      # lam_mode; see repro_torch.traffic)


# Scalar MecConfig fields carried into MecParams as per-cell tensors.
_FLOAT_FIELDS = ("w_hz", "n0", "p_tx", "rho", "kappa", "f_max_ue", "f_max_es",
                 "v", "nu_e", "nu_c", "gamma_ue", "gamma_es",
                 "stability_margin", "queue_obs_scale")

# Raw per-layer tables (the sweep kernel's inputs) and per-cut tables.
_RAW_TABLES = ("macs", "param_bytes", "act_bytes")
_CUT_TABLES = ("prefix_macs", "suffix_macs", "psi", "prefix_params",
               "suffix_params", "prefix_act_max", "suffix_act_max")


@dataclasses.dataclass(frozen=True)
class MecParams:
    """Everything ``step_p`` reads, as tensors (see the module docstring for
    shapes).  ``arrival`` is the per-slot arrival-rate process; cells of one
    stacked grid share its type while its tensors vary per cell."""

    macs: torch.Tensor
    param_bytes: torch.Tensor
    act_bytes: torch.Tensor
    prefix_macs: torch.Tensor
    suffix_macs: torch.Tensor
    psi: torch.Tensor
    prefix_params: torch.Tensor
    suffix_params: torch.Tensor
    prefix_act_max: torch.Tensor
    suffix_act_max: torch.Tensor
    L: torch.Tensor                 # (..., N) int64
    e_budget: torch.Tensor
    c_budget: torch.Tensor
    arrival: Any
    mean_gain: torch.Tensor
    w_hz: torch.Tensor
    n0: torch.Tensor
    p_tx: torch.Tensor
    rho: torch.Tensor
    kappa: torch.Tensor
    f_max_ue: torch.Tensor
    f_max_es: torch.Tensor
    v: torch.Tensor
    nu_e: torch.Tensor
    nu_c: torch.Tensor
    gamma_ue: torch.Tensor
    gamma_es: torch.Tensor
    stability_margin: torch.Tensor
    queue_obs_scale: torch.Tensor
    edge_queueing: bool = False

    @property
    def n_ue(self) -> int:
        return self.L.shape[-1]

    @property
    def num_cuts(self) -> int:
        return self.prefix_macs.shape[-1]

    @property
    def obs_dim(self) -> int:
        return 4 * self.n_ue

    @property
    def device(self) -> torch.device:
        return self.L.device


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32))


def arrival_from_config(cfg: MecConfig, n: int,
                        lam_fixed: Sequence[float] | None = None):
    """Translate the MecConfig enum/knobs into an arrival process (on the CPU)."""
    base = _f32(np.full(n, cfg.lam_high, np.float32) if lam_fixed is None
                else np.asarray(lam_fixed, np.float32))
    if cfg.lam_mode == LAM_IID_UNIFORM:
        return arrivals.IidUniform(low=arrivals.per_ue(cfg.lam_low, n),
                                   high=arrivals.per_ue(cfg.lam_high, n))
    if cfg.lam_mode == LAM_FIXED:
        return arrivals.FixedRate(lam=base)
    if cfg.lam_mode == LAM_PEAK:
        return arrivals.PeakWindow(base=base, boost=_f32(cfg.peak_boost),
                                   start=torch.tensor(int(cfg.peak_start)),
                                   stop=torch.tensor(int(cfg.peak_stop)))
    if cfg.lam_mode == LAM_TRACE:
        raise ValueError(
            "LAM_TRACE needs an explicit process: pass arrival="
            "repro_torch.traffic.TraceArrivals(...) (e.g. "
            "Trace.load(p).process())")
    raise ValueError(f"unknown lam_mode {cfg.lam_mode!r}")


def make_params(profiles: Sequence[LayerProfile], cfg: MecConfig,
                e_budget: Sequence[float], c_budget: Sequence[float],
                mean_gain: float | None = None,
                lam_fixed: Sequence[float] | None = None,
                arrival=None, device=None) -> MecParams:
    """Build a single-cell MecParams on the host, then move it to ``device``.

    The arrival process resolves in priority order: the ``arrival``
    argument, then ``cfg.arrival``, then the ``cfg.lam_mode`` translation.
    """
    device = resolve_device(device)
    batch = ProfileBatch(profiles)
    n = batch.n
    e_budget = _f32(e_budget)
    c_budget = _f32(c_budget)
    if e_budget.shape != (n,) or c_budget.shape != (n,):
        raise ValueError("budgets must have one entry per UE")
    if arrival is None:
        arrival = cfg.arrival
    if arrival is None:
        arrival = arrival_from_config(cfg, n, lam_fixed)
    fields = {name: _f32(getattr(batch, name))
              for name in _RAW_TABLES + _CUT_TABLES}
    fields.update(
        L=torch.as_tensor(batch.L.astype(np.int64)),
        e_budget=e_budget, c_budget=c_budget, arrival=arrival,
        mean_gain=_f32(free_space_gain() if mean_gain is None else mean_gain),
        edge_queueing=cfg.edge_queueing)
    for f in _FLOAT_FIELDS:
        fields[f] = _f32(getattr(cfg, f))
    return _tree.to_device(MecParams(**fields), device)


def _as_leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(a).to(device=device, dtype=dtype)


def params_from_numpy(leaves, arrival_kind: str, arrival_leaves,
                      edge_queueing: bool = False, device=None) -> MecParams:
    """MecParams from another implementation's arrays.

    ``leaves`` maps every MecParams tensor field name to an array (any
    leading cell dims), ``arrival_kind`` names a registered arrival process
    and ``arrival_leaves`` maps its fields to arrays.  Integer arrays become
    int64 and the rest float32.  This carries the reference's parameters
    into the port for parity tests.
    """
    device = resolve_device(device)
    cls = arrivals.PROCESSES[arrival_kind]
    arrival = cls(**{f.name: _as_leaf(arrival_leaves[f.name], device)
                     for f in dataclasses.fields(cls)})
    fields = {f.name: _as_leaf(leaves[f.name], device)
              for f in dataclasses.fields(MecParams)
              if f.name not in ("arrival", "edge_queueing")}
    return MecParams(**fields, arrival=arrival, edge_queueing=edge_queueing)


@dataclasses.dataclass(frozen=True)
class MecState:
    gen: Any                  # torch.Generator for the next draws (or None)
    t: torch.Tensor           # (...) int64 slot index
    gain: torch.Tensor        # (..., N) current channel gains h
    lam: torch.Tensor         # (..., N) current arrival rates
    queues: VirtualQueues     # Q(t), W(t)


def state_from_numpy(t, gain, lam, q_energy, q_memory, gen=None,
                     device=None) -> MecState:
    """MecState from another implementation's arrays."""
    device = resolve_device(device)
    leaf = lambda a: _as_leaf(a, device)
    return MecState(gen=gen, t=leaf(np.asarray(t).astype(np.int64)),
                    gain=leaf(gain), lam=leaf(lam),
                    queues=VirtualQueues(leaf(q_energy), leaf(q_memory)))


class SlotResult(NamedTuple):
    """Everything the algorithms/benchmarks need from one slot."""

    reward: torch.Tensor
    delay: torch.Tensor       # (..., N) T_E2E
    t_ue: torch.Tensor
    t_tx: torch.Tensor
    t_es: torch.Tensor
    energy: torch.Tensor      # (..., N) E_ue [J/slot]
    mem_cost: torch.Tensor    # (..., N) C_tot [GB]
    cut: torch.Tensor         # (..., N) projected partition decision
    alpha: torch.Tensor
    f_ue: torch.Tensor
    f_es: torch.Tensor
    q_energy: torch.Tensor    # Q(t) used in the reward (pre-update)
    q_memory: torch.Tensor


def _ue(x: torch.Tensor) -> torch.Tensor:
    """A per-cell scalar, broadcast against per-UE vectors."""
    return x[..., None]


# ---------------------------------------------------------------------------
# Params-first API (single cell or a stacked grid)
# ---------------------------------------------------------------------------

def observe_p(p: MecParams, state: MecState) -> torch.Tensor:
    """s^t = {h, lambda, Q, W} (Sec. IV-B1), scaled to O(1)."""
    return torch.cat([
        state.gain / _ue(p.mean_gain),
        state.lam,
        _ue(p.queue_obs_scale) * state.queues.energy,
        _ue(p.queue_obs_scale) * state.queues.memory,
    ], dim=-1)


def _draw_p(p: MecParams, gen, t, draws=None):
    """This slot's (gain, lam): given ``draws``, else drawn from ``gen``."""
    if draws is not None:
        gain, lam = draws
        as_f32 = lambda x: torch.as_tensor(x).to(device=p.device,
                                                 dtype=torch.float32)
        return as_f32(gain), as_f32(lam)
    if gen is None:
        raise ValueError("need a torch.Generator or explicit draws")
    beta = torch.empty(p.L.shape, dtype=torch.float32,
                       device=p.device).exponential_(generator=gen)
    gain = beta * _ue(p.mean_gain)  # Rayleigh fading power
    return gain, p.arrival(gen, t)


def reset_p(p: MecParams, gen=None, draws=None) -> MecState:
    t = torch.zeros(p.L.shape[:-1], dtype=torch.int64, device=p.device)
    gain, lam = _draw_p(p, gen, t, draws)
    return MecState(gen=gen, t=t, gain=gain, lam=lam,
                    queues=VirtualQueues.zeros(p.L.shape, device=p.device))


def max_feasible_cut_p(p: MecParams, lam: torch.Tensor) -> torch.Tensor:
    """Largest cut whose local queue is stable: rho*prefix*lam < f_max (C7)."""
    cell = lambda x: x[..., None, None]
    demand = (cell(p.rho) * p.prefix_macs * lam[..., None]
              * cell(1.0 + p.stability_margin))
    feasible = demand < cell(p.f_max_ue)      # (..., N, C); monotone in cut
    return torch.minimum(torch.sum(feasible, dim=-1) - 1, p.L)


def project_cut_p(p: MecParams, cut: torch.Tensor,
                  lam: torch.Tensor) -> torch.Tensor:
    cut = torch.as_tensor(cut, device=p.device).long()
    return torch.minimum(torch.clamp_min(cut, 0), max_feasible_cut_p(p, lam))


def _gather(table: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    return torch.gather(table, -1, cut[..., None]).squeeze(-1)


def step_p(p: MecParams, state: MecState, cut: torch.Tensor,
           draws=None, ues=None) -> tuple[MecState, SlotResult]:
    """LyMDO inner loop: partitioning action + exact convex allocation.

    ``draws=(gain, lam)`` sets the next slot's draws instead of the
    state's generator.  ``ues`` (a ``gridshard.GridSharding`` whose UE
    axis is split) says that ``p``, ``state`` and ``cut`` hold this rank's
    UE columns of each cell: P4 and P5, which couple a cell's UEs, then
    solve the whole cell from inputs all-gathered once (one collective),
    and the rank keeps its columns of their answers.
    """
    cut = project_cut_p(p, cut, state.lam)
    d_ue = _ue(p.rho) * _gather(p.prefix_macs, cut)
    d_es = _ue(p.rho) * _gather(p.suffix_macs, cut)
    psi = _gather(p.psi, cut)

    q = state.queues
    f_ue = convex.solve_p3(q.energy, _ue(p.kappa), d_ue, state.lam, _ue(p.v),
                           _ue(p.f_max_ue),
                           stability_margin=_ue(p.stability_margin))
    own = (lambda x: x) if ues is None else ues.ue_own
    d_es_c, qe_c, lam_c, psi_c, gain_c = (
        (d_es, q.energy, state.lam, psi, state.gain) if ues is None
        else ues.ue_whole([d_es, q.energy, state.lam, psi, state.gain]))
    f_es = own(convex.solve_p4(d_es_c, _ue(p.f_max_es)))
    alpha = own(convex.solve_p5(qe_c, _ue(p.p_tx), lam_c, _ue(p.v), psi_c,
                                _ue(p.w_hz), gain_c, _ue(p.n0)))
    return _evaluate_p(p, state, cut, alpha, f_ue, f_es, d_ue, d_es, psi,
                       draws, ues)


def step_joint_p(p: MecParams, state: MecState, cut, alpha, f_ue, f_es,
                 draws=None) -> tuple[MecState, SlotResult]:
    """Paper's "PPO" baseline: all four decisions come from the agent.

    Only hard physics is enforced: C7 projection on the cut and a clamp of
    f_ue into the stable band.
    """
    cut = project_cut_p(p, cut, state.lam)
    d_ue = _ue(p.rho) * _gather(p.prefix_macs, cut)
    d_es = _ue(p.rho) * _gather(p.suffix_macs, cut)
    psi = _gather(p.psi, cut)
    lo = torch.where(d_ue > 0,
                     d_ue * state.lam * _ue(1.0 + p.stability_margin) + 1.0,
                     0.0)
    f_ue = torch.minimum(torch.maximum(torch.as_tensor(f_ue), lo),
                         _ue(p.f_max_ue))
    f_ue = torch.where(d_ue > 0, f_ue, 0.0)
    f_es = torch.where(d_es > 0, f_es, 0.0)
    alpha = torch.where(psi > 0, alpha, 0.0)
    return _evaluate_p(p, state, cut, alpha, f_ue, f_es, d_ue, d_es, psi,
                       draws)


def _evaluate_p(p: MecParams, state, cut, alpha, f_ue, f_es, d_ue, d_es, psi,
                draws, ues=None):
    q = state.queues
    delay, (t_ue, t_tx, t_es) = queueing.e2e_delay(
        state.lam, f_ue, f_es, d_ue, d_es, psi, alpha,
        _ue(p.w_hz), _ue(p.p_tx), state.gain, _ue(p.n0),
        edge_queueing=p.edge_queueing)

    energy = energymem.ue_energy(f_ue, d_ue, state.lam, _ue(p.kappa),
                                 _ue(p.p_tx), t_tx)
    mem = energymem.memory_cost(
        _gather(p.prefix_params, cut),
        _gather(p.suffix_params, cut),
        _gather(p.prefix_act_max, cut),
        _gather(p.suffix_act_max, cut),
        _ue(p.gamma_ue), _ue(p.gamma_es))

    rew = lyapunov_reward(q, energy, mem, delay, _ue(p.v), ues=ues)
    new_queues = update_queues(q, energy, mem, p.e_budget, p.c_budget,
                               _ue(p.nu_e), _ue(p.nu_c))

    t_next = state.t + 1
    gain, lam = _draw_p(p, state.gen, t_next, draws)
    new_state = MecState(gen=state.gen, t=t_next, gain=gain, lam=lam,
                         queues=new_queues)
    result = SlotResult(
        reward=rew, delay=delay, t_ue=t_ue, t_tx=t_tx, t_es=t_es,
        energy=energy, mem_cost=mem, cut=cut, alpha=alpha,
        f_ue=f_ue, f_es=f_es,
        q_energy=q.energy, q_memory=q.memory)
    return new_state, result


# ---------------------------------------------------------------------------
# Object API (single-cell scripts use this)
# ---------------------------------------------------------------------------

class MecEnv:
    """N-UE cooperative-inference environment over a ProfileBatch.

    The instance holds constants only (``self.params``); states are values.
    """

    def __init__(self, profiles: Sequence[LayerProfile], cfg: MecConfig,
                 e_budget: Sequence[float], c_budget: Sequence[float],
                 mean_gain: float | None = None,
                 lam_fixed: Sequence[float] | None = None,
                 arrival=None, device=None):
        self.cfg = cfg
        self.batch = ProfileBatch(profiles)
        self.params = make_params(profiles, cfg, e_budget, c_budget,
                                  mean_gain=mean_gain, lam_fixed=lam_fixed,
                                  arrival=arrival, device=device)

    @property
    def device(self) -> torch.device:
        return self.params.device

    @property
    def arrival(self):
        return self.params.arrival

    @arrival.setter
    def arrival(self, process):
        self.params = dataclasses.replace(
            self.params, arrival=_tree.to_device(process, self.device))

    @property
    def lam_fixed(self) -> torch.Tensor:
        """Base rate of a fixed/peak arrival process."""
        arr = self.params.arrival
        if isinstance(arr, arrivals.FixedRate):
            return arr.lam
        if isinstance(arr, arrivals.PeakWindow):
            return arr.base
        raise AttributeError(
            f"lam_fixed is only defined for fixed/peak arrivals, not "
            f"{type(arr).__name__}; mutate env.arrival instead")

    @lam_fixed.setter
    def lam_fixed(self, value):
        arr = self.params.arrival
        value = torch.as_tensor(np.asarray(value, np.float32), device=self.device)
        if isinstance(arr, arrivals.FixedRate):
            arr = dataclasses.replace(arr, lam=value)
        elif isinstance(arr, arrivals.PeakWindow):
            arr = dataclasses.replace(arr, base=value)
        else:
            raise AttributeError(
                f"lam_fixed is only defined for fixed/peak arrivals, not "
                f"{type(arr).__name__}; set env.arrival instead")
        self.params = dataclasses.replace(self.params, arrival=arr)

    @property
    def obs_dim(self) -> int:
        return 4 * self.n_ue

    @property
    def action_dim(self) -> int:
        return self.n_ue

    def generator(self, seed: int) -> torch.Generator:
        """A generator on this env's device, seeded for reproducible draws."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def observe(self, state: MecState) -> torch.Tensor:
        return observe_p(self.params, state)

    def reset(self, gen=None, draws=None) -> MecState:
        return reset_p(self.params, gen, draws)

    def max_feasible_cut(self, lam: torch.Tensor) -> torch.Tensor:
        return max_feasible_cut_p(self.params, lam)

    def project_cut(self, cut, lam: torch.Tensor) -> torch.Tensor:
        return project_cut_p(self.params, cut, lam)

    def step(self, state: MecState, cut, draws=None):
        return step_p(self.params, state, cut, draws)

    def step_joint(self, state: MecState, cut, alpha, f_ue, f_es, draws=None):
        return step_joint_p(self.params, state, cut, alpha, f_ue, f_es, draws)


def _delegate(name):
    return property(lambda self: getattr(self.params, name),
                    doc=f"Read-only view of ``params.{name}``.")


for _f in ("n_ue", "num_cuts", "L", "prefix_macs", "suffix_macs", "psi",
           "prefix_params", "suffix_params", "prefix_act_max",
           "suffix_act_max", "e_budget", "c_budget", "mean_gain"):
    setattr(MecEnv, _f, _delegate(_f))


def paper_env(cfg: MecConfig = MecConfig(), n_alexnet: int = 2,
              n_resnet: int = 3, device=None) -> MecEnv:
    """The paper's Sec. V-A scenario: 5 UEs = 2x AlexNet + 3x ResNet18,
    e = (40, 60) mJ, eps = (100, 30) MB (J / GB canonical units)."""
    from ..profiling.convnets import alexnet_profile, resnet18_profile

    profiles = [alexnet_profile()] * n_alexnet + [resnet18_profile()] * n_resnet
    e_budget = [0.040] * n_alexnet + [0.060] * n_resnet
    c_budget = [0.100] * n_alexnet + [0.030] * n_resnet
    return MecEnv(profiles, cfg, e_budget, c_budget, device=device)
