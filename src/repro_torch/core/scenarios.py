"""Scenario registry + batched multi-cell evaluation engine.

Port of ``repro/core/scenarios.py``.  A :class:`ScenarioGrid` stacks B
single-cell ``MecParams`` into one (B, ...) parameter set and advances
every cell per slot with the same ``step_p`` the single cell uses: the
batch dimension is written out where the reference ``vmap``s, and the slot
loop is a Python loop where the reference ``lax.scan``s.  Cell tables are
built on the host and the stacked tensors move to the device once.

``use_mesh`` shards the grid over a cells mesh (one process a rank; see
``repro_torch.core.gridshard``): each rank advances its own rows of the
padded stack, and on a ``("cells", "model")`` mesh its own UE columns of
each of them; draws stay those of the unsharded grid, and a rollout
gathers its outputs once at the end, so every rank returns the logical B.

The batched Oracle's per-slot (B, N, C) objective table goes through the
``partition_sweep`` CUDA kernel in one launch for all cells, with the even
split pinned to the per-cell UE count and one row of MEC constants per
cell, so cells need not share them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from .. import _tree
from ..device import resolve_device
from ..profiling.profiles import LayerProfile
from ..traffic import processes as traffic
from . import gridshard, sweep
from .env import (LAM_FIXED, LAM_PEAK, LAM_TRACE, MecConfig, MecEnv,
                  MecParams, MecState, SlotResult, _draw_p, free_space_gain,
                  make_params, reset_p, step_p)


# ---------------------------------------------------------------------------
# Scenario spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative single-cell scenario: everything needed to build an env."""

    name: str
    cfg: MecConfig
    profiles: tuple[LayerProfile, ...]
    e_budget: tuple[float, ...]
    c_budget: tuple[float, ...]
    mean_gain: float | None = None          # None -> paper free-space default
    lam_fixed: tuple[float, ...] | None = None
    arrival: object | None = None           # explicit arrival process
    description: str = ""

    @property
    def n_ue(self) -> int:
        return len(self.profiles)

    def _kwargs(self) -> dict:
        return dict(mean_gain=self.mean_gain,
                    lam_fixed=None if self.lam_fixed is None
                    else list(self.lam_fixed), arrival=self.arrival)

    def build(self, device=None) -> MecEnv:
        return MecEnv(list(self.profiles), self.cfg, list(self.e_budget),
                      list(self.c_budget), device=device, **self._kwargs())

    def params(self, device=None) -> MecParams:
        return make_params(list(self.profiles), self.cfg, list(self.e_budget),
                           list(self.c_budget), device=device, **self._kwargs())


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[..., Scenario]] = {}


def register(name: str):
    """Decorator: register a named scenario constructor."""
    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = fn
        fn.scenario_name = name
        return fn
    return deco


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make(name: str, **knobs) -> Scenario:
    """Build a registered scenario by name (knobs forwarded verbatim)."""
    try:
        ctor = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; have {names()}") from None
    return ctor(**knobs)


def describe() -> str:
    """One line per registered scenario (the --list catalogue)."""
    lines = []
    for name in names():
        doc = (_REGISTRY[name].__doc__ or "").strip().splitlines()
        lines.append(f"{name}: {doc[0] if doc else ''}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Built-in scenario constructors
# ---------------------------------------------------------------------------

def _paper_fleet(n_alexnet: int, n_resnet: int):
    from ..profiling.convnets import alexnet_profile, resnet18_profile
    profiles = ([alexnet_profile()] * n_alexnet
                + [resnet18_profile()] * n_resnet)
    e = (0.040,) * n_alexnet + (0.060,) * n_resnet
    c = (0.100,) * n_alexnet + (0.030,) * n_resnet
    return tuple(profiles), e, c


def _f32(x) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32)


@register("paper_table1")
def paper_table1(n_alexnet: int = 2, n_resnet: int = 3,
                 cfg: MecConfig = MecConfig()) -> Scenario:
    """Paper Sec. V-A / Table I: 2x AlexNet + 3x ResNet18, iid-uniform rates."""
    profiles, e, c = _paper_fleet(n_alexnet, n_resnet)
    return Scenario(name="paper_table1", cfg=cfg, profiles=profiles,
                    e_budget=e, c_budget=c,
                    description="paper Table I single cell")


@register("fixed_rate")
def fixed_rate(rate: float = 2.5, n_alexnet: int = 2,
               n_resnet: int = 3) -> Scenario:
    """Fig. 4 sweep point: constant per-UE arrival rate (req/s)."""
    profiles, e, c = _paper_fleet(n_alexnet, n_resnet)
    n = len(profiles)
    return Scenario(name=f"fixed_rate[{rate:g}]",
                    cfg=MecConfig(lam_mode=LAM_FIXED),
                    profiles=profiles, e_budget=e, c_budget=c,
                    lam_fixed=(float(rate),) * n,
                    description=f"Fig. 4 fixed-rate cell @ {rate:g} req/s")


@register("peak_window")
def peak_window(base_rate: float = 2.5, boost: float = 1.0, start: int = 75,
                stop: int = 110) -> Scenario:
    """Fig. 5 stability run: constant base rate + a peak-workload window."""
    profiles, e, c = _paper_fleet(2, 3)
    n = len(profiles)
    cfg = MecConfig(lam_mode=LAM_PEAK, peak_start=int(start),
                    peak_stop=int(stop), peak_boost=float(boost))
    return Scenario(name=f"peak_window[{base_rate:g}+{boost:g}]",
                    cfg=cfg, profiles=profiles, e_budget=e, c_budget=c,
                    lam_fixed=(float(base_rate),) * n,
                    description="Fig. 5 peak-workload cell")


@register("hetero_fleet")
def hetero_fleet(n_ue: int = 8, seed: int = 0,
                 rate_range: tuple[float, float] = (0.5, 2.5)) -> Scenario:
    """Heterogeneous fleet: random AlexNet/ResNet mix, budgets and rates."""
    from ..profiling.convnets import alexnet_profile, resnet18_profile
    rng = np.random.default_rng(seed)
    pool = (alexnet_profile(), resnet18_profile())
    picks = rng.integers(0, len(pool), n_ue)
    profiles = tuple(pool[i] for i in picks)
    e = tuple(float(x) for x in rng.uniform(0.030, 0.080, n_ue))
    c = tuple(float(x) for x in rng.uniform(0.025, 0.120, n_ue))
    lam = tuple(float(x) for x in rng.uniform(*rate_range, n_ue))
    return Scenario(name=f"hetero_fleet[{n_ue}@{seed}]",
                    cfg=MecConfig(lam_mode=LAM_FIXED),
                    profiles=profiles, e_budget=e, c_budget=c,
                    lam_fixed=lam,
                    description="random device/budget/rate mix")


@register("mmpp_burst")
def mmpp_burst(seed: int = 0, rates: tuple[float, ...] = (0.5, 3.0),
               p_stay: float = 0.92, horizon: int = 400,
               n_alexnet: int = 2, n_resnet: int = 3) -> Scenario:
    """Bursty cell: per-UE Markov-modulated (MMPP) rates over the paper fleet."""
    profiles, e, c = _paper_fleet(n_alexnet, n_resnet)
    arrival = traffic.make_mmpp(len(profiles), seed=seed, rates=rates,
                                p_stay=p_stay, horizon=horizon)
    return Scenario(name=f"mmpp_burst[{seed}]", cfg=MecConfig(),
                    profiles=profiles, e_budget=e, c_budget=c,
                    arrival=arrival,
                    description="Markov-modulated bursty arrivals "
                                f"(regimes {rates}, p_stay={p_stay:g})")


@register("diurnal")
def diurnal(base: float = 1.5, amp: float = 1.0, period: float = 200.0,
            phase: float = 0.0, n_alexnet: int = 2,
            n_resnet: int = 3) -> Scenario:
    """Day/night cell: sinusoidal arrival rates around a base load."""
    profiles, e, c = _paper_fleet(n_alexnet, n_resnet)
    n = len(profiles)
    arrival = traffic.Diurnal(base=traffic.per_ue(base, n),
                              amp=traffic.per_ue(amp, n),
                              period=_f32(period), phase=_f32(phase))
    return Scenario(name=f"diurnal[{base:g}±{amp:g}]", cfg=MecConfig(),
                    profiles=profiles, e_budget=e, c_budget=c,
                    arrival=arrival,
                    description=f"sinusoidal load, period {period:g} slots")


@register("flash_crowd")
def flash_crowd(base: float = 1.0, spike: float = 2.5, t0: int = 100,
                decay: float = 30.0, n_alexnet: int = 2,
                n_resnet: int = 3) -> Scenario:
    """Flash-crowd cell: base load + an exponentially decaying spike at t0."""
    profiles, e, c = _paper_fleet(n_alexnet, n_resnet)
    n = len(profiles)
    arrival = traffic.FlashCrowd(base=traffic.per_ue(base, n),
                                 spike=_f32(spike), t0=torch.tensor(int(t0)),
                                 decay=_f32(decay))
    return Scenario(name=f"flash_crowd[{spike:g}@{t0}]", cfg=MecConfig(),
                    profiles=profiles, e_budget=e, c_budget=c,
                    arrival=arrival,
                    description=f"flash crowd +{spike:g} req/s at slot {t0}")


@register("trace_replay")
def trace_replay(trace=None, path: str | None = None, offset: int = 0,
                 seed: int = 0, rate_range: tuple[float, float] = (0.5, 2.5),
                 ) -> Scenario:
    """Replay a recorded arrival trace (repro_torch.traffic.Trace) as the cell load.

    With neither ``trace`` nor ``path``, a small deterministic MMPP demo
    trace is materialized, the same one the reference builds.
    """
    from ..traffic.trace import Trace, from_process
    if trace is None:
        if path is None:
            proc = traffic.make_mmpp(4, seed=seed, horizon=64)
            trace = from_process(proc, 64)
        else:
            trace = Trace.load(path)
    if offset:
        trace = trace.shifted(offset)
    cell = hetero_fleet(n_ue=trace.n_ue, seed=seed, rate_range=rate_range)
    return dataclasses.replace(
        cell, name=f"trace_replay[{trace.n_ue}ue+{offset}]",
        cfg=MecConfig(lam_mode=LAM_TRACE), arrival=trace.process(),
        lam_fixed=None,
        description=f"replays a {trace.n_slots}-slot recorded trace "
                    f"(offset {offset})")


def multicell_grid(cells: int = 16, ues: int = 8, seed: int = 0,
                   d_min_m: float = 60.0, d_max_m: float = 300.0,
                   rate_range: tuple[float, float] = (0.5, 2.5),
                   uniform_scalars: bool = True) -> list[Scenario]:
    """B independent cells for one batched grid: each cell is a heterogeneous
    fleet at its own ES distance (per-cell mean channel gain).

    ``uniform_scalars=True`` keeps every ``MecConfig`` scalar at Table I
    values; ``False`` draws a per-cell Lyapunov weight V.  Either way the
    grid's Oracle sweep is one kernel launch, with one row of constants per
    cell.
    """
    rng = np.random.default_rng(seed)
    out = []
    for b in range(cells):
        cell = hetero_fleet(n_ue=ues, seed=seed * 10_007 + b,
                            rate_range=rate_range)
        dist = float(rng.uniform(d_min_m, d_max_m))
        cfg = cell.cfg
        if not uniform_scalars:
            cfg = dataclasses.replace(cfg, v=float(rng.uniform(5.0, 20.0)))
        out.append(dataclasses.replace(
            cell, name=f"cell[{b}]@{dist:.0f}m", cfg=cfg,
            mean_gain=free_space_gain(distance_m=dist),
            description=f"grid cell {b}, ES distance {dist:.0f} m"))
    return out


# ---------------------------------------------------------------------------
# Stacking
# ---------------------------------------------------------------------------

def _pad_cuts(p: MecParams, cmax: int) -> MecParams:
    """Pad a cell's cut axis to ``cmax`` columns.

    Per-cut tables are constant for c >= L_n, so edge replication preserves
    them; raw per-layer tables (what the sweep kernel reads) get zeros, as
    there is no layer there, and psi's edge value is already 0.
    """
    c = p.num_cuts
    if c == cmax:
        return p
    pad_edge = lambda t: torch.cat([t, t[..., -1:].expand(*t.shape[:-1], cmax - c)],
                                   dim=-1)
    pad_zero = lambda t: torch.cat([t, t.new_zeros(*t.shape[:-1], cmax - c)],
                                   dim=-1)
    return dataclasses.replace(
        p,
        macs=pad_zero(p.macs), param_bytes=pad_zero(p.param_bytes),
        act_bytes=pad_zero(p.act_bytes),
        prefix_macs=pad_edge(p.prefix_macs),
        suffix_macs=pad_edge(p.suffix_macs),
        psi=pad_zero(p.psi),
        prefix_params=pad_edge(p.prefix_params),
        suffix_params=pad_edge(p.suffix_params),
        prefix_act_max=pad_edge(p.prefix_act_max),
        suffix_act_max=pad_edge(p.suffix_act_max))


def stack_params(params_list: Sequence[MecParams]) -> MecParams:
    """Stack B single-cell params into one (B, ...) set.

    Cells must share the UE count, ``edge_queueing`` and the arrival-process
    type (and its tensor shapes); the cut axis is padded to the widest cell.
    """
    if not params_list:
        raise ValueError("need at least one cell")
    n_ues = {p.n_ue for p in params_list}
    if len(n_ues) != 1:
        raise ValueError(f"cells must share the UE count, got {sorted(n_ues)}")
    if len({p.edge_queueing for p in params_list}) != 1:
        raise ValueError("cells must share edge_queueing")
    kinds = {type(p.arrival) for p in params_list}
    if len(kinds) != 1:
        raise ValueError(
            "cells must share the arrival-process type; got "
            f"{sorted(k.__name__ for k in kinds)}")
    cmax = max(p.num_cuts for p in params_list)
    return _tree.stack([_pad_cuts(p, cmax) for p in params_list])


# ---------------------------------------------------------------------------
# Batched policies: (params, states, generator) -> (B, N) cuts
# ---------------------------------------------------------------------------

def oracle_policy(params: MecParams, state: MecState, gen) -> torch.Tensor:
    """Decoupled per-slot argmin over each cell's objective table, through
    the partition-sweep kernel on CUDA tensors."""
    del gen
    return sweep.kernel_oracle_cut_p(params, state)


def local_policy(params: MecParams, state: MecState, gen) -> torch.Tensor:
    del state, gen
    return params.L


def edge_policy(params: MecParams, state: MecState, gen) -> torch.Tensor:
    del state, gen
    return torch.zeros_like(params.L)


def random_policy(params: MecParams, state: MecState, gen) -> torch.Tensor:
    """Uniform cut in [0, L] per UE (``torch.randint`` takes one bound only,
    so the per-UE bound scales a uniform draw)."""
    del state
    u = torch.rand(params.L.shape, generator=gen, device=params.device)
    cut = torch.floor(u * (params.L + 1).to(u.dtype)).long()
    return torch.minimum(cut, params.L)


POLICIES: dict[str, Callable] = {
    "oracle": oracle_policy,
    "local": local_policy,
    "edge": edge_policy,
    "random": random_policy,
}


# ---------------------------------------------------------------------------
# Batched engine
# ---------------------------------------------------------------------------

def _summary(results: SlotResult) -> dict:
    """Per-cell (B,) means of a (steps, B, N) result stack."""
    return {
        "reward": torch.mean(results.reward, dim=0),
        "delay": torch.mean(results.delay, dim=(0, 2)),
        "energy": torch.mean(results.energy, dim=(0, 2)),
        "mem": torch.mean(results.mem_cost, dim=(0, 2)),
        "q_energy_final": torch.mean(results.q_energy[-1], dim=-1),
        "q_memory_final": torch.mean(results.q_memory[-1], dim=-1),
        "cut_mean": torch.mean(results.cut.to(torch.float32), dim=(0, 2)),
    }


class ScenarioGrid:
    """B independent cells advanced together, one slot at a time.

    ``params`` is the stacked (B, ...) ``MecParams`` on ``device``;
    ``reset`` / ``step`` act on stacked states.

    ``use_mesh`` (or the ``mesh=`` constructor argument) shards the grid
    over a cells mesh's ranks: B is padded to a rank multiple, and each
    rank keeps its ``b_local`` rows of the padded stack in ``_run_params``
    and advances only those.  ``params`` always stays the logical stack,
    and the stack a state batch needs is picked from its width.
    """

    def __init__(self, scenarios: Sequence[Scenario], device=None,
                 mesh=None):
        self.scenarios = tuple(scenarios)
        if not self.scenarios:
            raise ValueError("empty grid")
        self.device = resolve_device(device)
        host = stack_params([s.params(device="cpu") for s in self.scenarios])
        self.params = _tree.to_device(host, self.device)
        self.b = len(self.scenarios)
        self.n_ue = self.scenarios[0].n_ue
        self.num_cuts = int(self.params.num_cuts)
        # (B, 11) rows of MEC constants, one per cell, for the sweep kernel
        self.sweep_scalars = sweep.scalar_rows_p(self.params)
        self.gridshard: gridshard.GridSharding | None = None
        self._run_params, self._run_scalars = self.params, self.sweep_scalars
        if mesh is not None:
            self.use_mesh(mesh)

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- rank sharding ------------------------------------------------------

    @property
    def b_run(self) -> int:
        """Cell-axis width of the padded stack (b unless sharded)."""
        return self.b if self.gridshard is None else self.gridshard.b_padded

    @property
    def b_local(self) -> int:
        """Cells this rank advances (b unless sharded)."""
        return self.b if self.gridshard is None else self.gridshard.b_local

    def use_mesh(self, mesh=None, *, model: int = 1,
                 pad_to: int | None = None):
        """Shard the stacked grid over ``mesh``'s ``"cells"`` axis.

        ``mesh=None`` builds a mesh over every rank of the default process
        group (``repro_torch.launch.mesh.make_cells_mesh(model=model)``);
        ``model=M > 1`` makes it the 2-D ``("cells", "model")`` mesh, which
        splits each cell's UE axis M ways where M divides it (and holds
        whole cells on every "model" rank where it does not).  A mesh
        passed explicitly must agree with a non-default ``model``.  B is
        padded up to a multiple of the cells-axis size (``pad_to`` forces
        a wider pad -- mainly for tests); padded cells replicate the last
        real cell and are sliced off everything a rollout returns.  The
        sweep's constant rows are taken with the shard, so they stay
        checked.  Sharded rollouts equal unsharded ones bit for bit on the
        CPU.  Returns ``self``.
        """
        if model < 1:
            raise ValueError(f"model axis size must be >= 1, got model={model}")
        if mesh is None:
            from ..launch.mesh import make_cells_mesh
            mesh = make_cells_mesh(model=model)
        elif model != 1:
            names = tuple(mesh.mesh_dim_names or ())
            have = (int(mesh.size(names.index(gridshard.MODEL_AXIS)))
                    if gridshard.MODEL_AXIS in names else 1)
            if have != model:
                raise ValueError(
                    f"use_mesh(model={model}) but the given mesh has a "
                    f"{have}-way {gridshard.MODEL_AXIS!r} axis; pass "
                    "mesh=None to build a matching one (make_cells_mesh)")
        gs = gridshard.plan(self.b, mesh, pad_to=pad_to, n_ue=self.n_ue)
        # the arrival process is drawn on the logical stack only
        # (``_draws``); the shard keeps its cells' rows of it whole
        self._run_params = dataclasses.replace(
            gridshard.local(dataclasses.replace(self.params, arrival=None),
                            gs, ues=True),
            arrival=gridshard.local(self.params.arrival, gs))
        self._run_scalars = gridshard.local(self.sweep_scalars, gs)
        self.gridshard = gs
        return self

    @property
    def ue_sharding(self):
        """The grid's ``GridSharding`` where it splits the UE axis over
        "model" (a rank's shard then holds N / M UEs a cell), else None."""
        gs = self.gridshard
        return gs if gs is not None and gs.ue_shards > 1 else None

    def _params_for(self, states: MecState) -> tuple[MecParams, torch.Tensor]:
        """The (params, sweep rows) matching a state batch's cell width:
        this rank's shard, or the logical stack."""
        lead, width = states.t.shape[0], states.gain.shape[-1]
        if (lead, width) == (self.b_local, self._run_params.n_ue):
            return self._run_params, self._run_scalars
        if (lead, width) == (self.b, self.n_ue):
            return self.params, self.sweep_scalars
        raise ValueError(
            f"state batch of {lead} cells x {width} UEs matches neither "
            f"b={self.b} x {self.n_ue} UEs nor this rank's shard of "
            f"{self.b_local} x {self._run_params.n_ue}")

    def _draws(self, gen, t, draws=None):
        """A sharded slot's (gain, lam) on this rank's rows: the rows of
        ``draws`` if given, else of the logical (b, N) draw from ``gen``,
        which consumes the generator as the unsharded grid does."""
        if draws is None:
            draws = _draw_p(self.params, gen, t)
        return tuple(gridshard.local([torch.as_tensor(x) for x in draws],
                                     self.gridshard, ues=True))

    # -- per-slot primitives ------------------------------------------------

    def reset(self, gen=None, draws=None) -> MecState:
        """Stacked states, (b_local, ...) on a sharded grid; ``draws=(gain,
        lam)`` (B, N) overrides the generator."""
        if self.gridshard is None:
            return reset_p(self.params, gen, draws)
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        return reset_p(self._run_params, gen, self._draws(gen, zero, draws))

    def step(self, states: MecState, cuts: torch.Tensor,
             draws=None) -> tuple[MecState, SlotResult]:
        """(B, N) cuts -> stacked next states + (B, N) slot results.  A
        shard's next draws are the logical draw's rows; its cells advance
        in lock step, so the shard's first slot index stands for all."""
        params, _ = self._params_for(states)
        ues = None
        if self.gridshard is not None and params is self._run_params:
            draws = self._draws(states.gen, states.t[:1] + 1, draws)
            ues = self.ue_sharding
        return step_p(params, states, cuts, draws, ues)

    # -- batched oracle sweep ----------------------------------------------

    def objective_tables(self, states: MecState) -> torch.Tensor:
        """(B, N, C) drift-plus-penalty tables for every cell at once: one
        ``partition_sweep`` kernel launch over the flattened (B*N, C) rows
        on CUDA (the even split per cell, each cell its own constants), the
        plain version on the CPU.  A rank holding N / M of each cell's UEs
        sweeps its (b_local * N / M) rows with the even split over N."""
        params, scalars = self._params_for(states)
        return sweep.kernel_table_p(params, states, scalars, self.n_ue)

    def oracle_cuts(self, states: MecState) -> torch.Tensor:
        """Batched Oracle decision: argmin over each cell's objective table."""
        return torch.argmin(self.objective_tables(states), dim=-1)

    # -- rollout ------------------------------------------------------------

    def make_rollout(self, policy: str | Callable = "oracle",
                     steps: int = 200, draws=None):
        """Reset all cells and advance ``steps`` slots.

        ``policy`` is a registry name or a callable
        ``(params, states, generator) -> (B, N) cuts``; ``"oracle"`` goes
        through ``oracle_cuts``.  ``draws=(gains, lams)``, each
        (steps + 1, B, N), replaces the channel and arrival draws (entry 0
        at reset, entry t + 1 after slot t).  Returns
        ``fn(gen_or_seed) -> (final_states, results, summary)`` with results
        stacked (steps, B, N) and summary per-cell (B,) means.

        On a sharded grid each rank runs its shard; the random policy draws
        the logical cuts and keeps its block, a callable sees the shard (and
        ``grid.gridshard`` says which).  The results and final states are
        gathered once at the end (over both axes) and the padding sliced
        off, so every rank returns the logical B x N.
        """
        gs = self.gridshard
        if policy == "oracle":
            act = lambda params, sts, gen: self.oracle_cuts(sts)
        else:
            act = POLICIES[policy] if isinstance(policy, str) else policy
        if gs is not None and act is random_policy:
            act = lambda params, sts, gen: gridshard.local(
                random_policy(self.params, None, gen), gs, ues=True)
        at = (lambda t: None) if draws is None else (
            lambda t: (draws[0][t], draws[1][t]))

        def rollout(gen):
            if not isinstance(gen, torch.Generator):
                gen = self.generator(int(gen))
            states = self.reset(gen, at(0))
            results = []
            for t in range(steps):
                cuts = act(self._run_params, states, gen)
                states, res = self.step(states, cuts, at(t + 1))
                results.append(res)
            results = _tree.stack(results)
            if gs is not None:
                states = gridshard.unpad(
                    gridshard.gather(states, gs, ues=True), gs)
                results = gridshard.unpad(
                    gridshard.gather(results, gs, lead=1, ues=True), gs,
                    lead=1)
            return states, results, _summary(results)

        return rollout

    def rollout(self, policy: str | Callable = "oracle", steps: int = 200,
                seed: int = 0, telemetry=None):
        """Convenience one-shot: build + run the rollout.

        ``telemetry=`` (a :class:`repro_torch.obs.Telemetry`) wraps the run
        in a ``grid_rollout`` span and records throughput gauges --
        ``grid_slots_per_s`` (one slot = one (cell, time-slot) advance of
        all N UEs) and ``grid_cells_per_s`` -- from one host-side timing
        around the whole run, between two device synchronizations.
        """
        fn = self.make_rollout(policy, steps)
        if telemetry is None:
            return fn(seed)
        import time
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        m = telemetry.metrics
        with telemetry.tracer.span("grid_rollout", device=True,
                                   cells=self.b, steps=steps):
            sync()
            t0 = time.perf_counter()
            out = fn(seed)
            sync()
            dt = time.perf_counter() - t0
        m.counter("grid_rollouts_total", "jitted grid rollouts run").inc()
        m.gauge("grid_slots_per_s", "cell x time-slot advances per second "
                "(all N UEs), last rollout").set(self.b * steps / dt)
        m.gauge("grid_cells_per_s", "whole-episode cell throughput, last "
                "rollout").set(self.b / dt)
        return out


def grid_from_names(specs: Sequence[str | tuple[str, dict]],
                    device=None) -> ScenarioGrid:
    """Build a grid from registry names, e.g. ``[("fixed_rate", {"rate": r})
    for r in (0.5, 1.0, 1.5, 2.0, 2.5)]``."""
    cells = []
    for spec in specs:
        if isinstance(spec, str):
            cells.append(make(spec))
        else:
            name, knobs = spec
            cells.append(make(name, **knobs))
    return ScenarioGrid(cells, device=device)
