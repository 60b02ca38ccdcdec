"""Layer 3: shardcheck -- static sharding, rank-layout and dtype checks.

Port of ``repro/analysis/shardcheck.py``.  Every check walks meta tensors
(``analysis.contracts.traced``: the parameter tree, the dense prefill's
cache and the paged pool of each registered architecture at full size), so
only the donation probe needs a device.

The policy's specs (checks ``spec`` / ``kv-heads`` / ``batch`` / ``cache``
/ ``pool`` / ``consistency``), walked for every architecture x "model"
degree in :data:`MODEL_DEGREES` on a ``contracts.ShapeOnlyMesh``, as the
reference walks them:

* every sharded dim divides the product of its mesh axes, no mesh axis is
  consumed twice in one spec, no spec outranks its leaf
  (``launch.sharding.validate_spec``);
* attention projections shard head-granularly: a wq/wk/wv/wo/bias leaf
  that carries "model" needs its head count to divide the degree;
* batch inputs never shard over "model";
* paged-pool leaves: only KV ``k``/``v`` shard, only on their kv-head dim;
  everything else replicates;
* the prefill cache and the paged pool agree, for each KV leaf, on whether
  the kv-head dim shards (else every admission would reshard).

The rank-local layout (check ``rank-layout``), the port's own: for each
architecture, each of :data:`LAYOUT_OPTIONS`, each "model" degree and
(for the options that read "data") data degrees 1 and 2, every rank's
shard of every leaf is built on the meta device through
``sharding.place_params``, and

* the ranks' shards put together give each whole leaf's shape: a leaf is
  whole on every rank, or its ranks' equal parts along one dim add up to
  it, once each rank's ZeRO-3 slice and "data" split are undone; the kv
  heads that several ranks hold (query heads that divide M over kv heads
  that do not) cover every kv head, and the SSD's fused columns add up to
  the whole once the B and C columns every rank holds are counted once;
* no head is split across ranks: each rank holds whole query, kv and SSD
  heads, and its kv heads are the ones its query heads read.

An option that has nothing to act on (an expert layout on a stack with no
experts) is a recorded skip, not a pass.

Dtype flow (check ``dtype``): ``float64`` / ``complex128`` leaves in the
prefill cache, the pool and the paged logits, the pool's dtypes kept over
a tick, and ``MecParams`` of a ``fixed_rate`` scenario.  The reference
also flags weak-typed floats; torch has no weak types (a Python scalar
takes the tensor's dtype), so there is no such check here.

Donation (check ``donation``), in torch terms: the port has no donation;
its pool is written in place.  One tiny engine (reduced qwen3-0.6b at one
layer) runs two ``decode_step_paged`` ticks, one ``commit_prefill`` and
one ``commit_chunk``, and every pool leaf must keep its storage, so a tick
never holds two pools.  On CUDA the second tick's peak memory must also
grow by less than one pool (:func:`donation_probe` returns both figures).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import _tree
from ..configs import base as config_base
from ..launch.sharding import BASELINE, ShardingOptions
from ..launch.specs import params_specs
from .contracts import MetaMemo, ShapeOnlyMesh, _B, _S, batch_struct, traced

MODEL_DEGREES = (1, 2, 4, 8)
DATA_DEGREES = (1, 2)

# attention-projection leaves and which head count guards their "model" use
_Q_NAMES = ("wq", "bq", "wo")
_KV_NAMES = ("wk", "wv", "bk", "bv")


# the rank-layout check's options
LAYOUT_OPTIONS = {
    "baseline": BASELINE,
    "vocab-only": ShardingOptions(tp_mode="vocab-only"),
    "moe-only": ShardingOptions(tp_mode="moe-only"),
    "fsdp": ShardingOptions(fsdp_override=True),
    "seq_shard": ShardingOptions(seq_shard=True),
    "expert_shard_dff": ShardingOptions(expert_shard_dff=True),
    "expert_mesh=data": ShardingOptions(expert_mesh="data"),
}


@dataclasses.dataclass(frozen=True)
class ShardFailure:
    arch: str
    check: str
    message: str

    def render(self) -> str:
        return f"{self.arch} [shardcheck:{self.check}]: {self.message}"


@dataclasses.dataclass(frozen=True)
class ShardcheckReport:
    covered: tuple            # (arch, check) pairs actually walked
    skipped: tuple            # (arch, check, reason)
    failures: tuple
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return not self.failures


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_axes(spec) -> set:
    out: set = set()
    for entry in tuple(spec):
        out.update(_axes_of(entry))
    return out


def _leaf_name(pstr: str) -> str:
    return pstr.rsplit("/", 1)[-1]


def _tensor_leaves(tree) -> list:
    """[(path, tensor)] of ``tree`` (dicts, lists, named tuples and
    dataclasses), paths as ``launch.sharding.map_with_paths`` writes
    them; leaves that are not tensors are left out."""
    out: list = []

    def walk(path, t):
        if isinstance(t, torch.Tensor):
            out.append((path, t))
            return
        join = (lambda k: f"{path}/{k}") if path else str
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                walk(join(f.name), getattr(t, f.name))
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for name, v in zip(t._fields, t):
                walk(join(name), v)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(join(k), v)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(join(i), v)

    walk("", tree)
    return out


# ---------------------------------------------------------------------------
# the policy's specs
# ---------------------------------------------------------------------------

def _check_param_specs(cfg, params, mesh, m: int, failures: list):
    from ..launch import sharding
    arch = cfg.name
    for pstr, leaf in _tensor_leaves(params):
        spec = sharding.param_spec(mesh, cfg, pstr, tuple(leaf.shape))
        for err in sharding.validate_spec(mesh, leaf.shape, spec):
            failures.append(ShardFailure(
                arch, "spec", f"model={m} {pstr}: {err}"))
        # head-granular TP: "model" on an attention projection is only
        # legal when the head count divides the degree
        name = _leaf_name(pstr)
        if "model" in _spec_axes(spec):
            heads = None
            if name in _Q_NAMES and len(leaf.shape) <= 3:
                heads = cfg.n_heads
            elif name in _KV_NAMES:
                heads = cfg.n_kv or cfg.n_heads
            if heads is not None and heads % m:
                failures.append(ShardFailure(
                    arch, "kv-heads",
                    f"model={m} {pstr}: spec {spec} splits {heads} head(s) "
                    f"across a {m}-way model axis (head-granular TP "
                    f"contract)"))


def _check_batch_specs(cfg, mesh, m: int, failures: list):
    from ..launch import sharding
    arch = cfg.name
    for pstr, leaf in sorted(batch_struct(cfg, _B, _S).items()):
        spec = sharding.batch_spec(mesh, leaf)
        for err in sharding.validate_spec(mesh, leaf.shape, spec):
            failures.append(ShardFailure(
                arch, "batch", f"model={m} {pstr}: {err}"))
        if "model" in _spec_axes(spec):
            failures.append(ShardFailure(
                arch, "batch",
                f"model={m} {pstr}: batch inputs replicate across the "
                f"model axis (got {spec})"))


def _kv_dim_axes(leaf_ndim: int, spec) -> tuple:
    """Axes on the kv-head dim (index -2) of a (..., S-or-block, KV, hd)
    leaf, given specs are leading-aligned."""
    entries = tuple(spec)
    kv_dim = leaf_ndim - 2
    if kv_dim < len(entries):
        return _axes_of(entries[kv_dim])
    return ()


def _check_cache_specs(cfg, cache, mesh, m: int, failures: list) -> dict:
    """Validate prefill-cache specs; returns {path: kv-dim-sharded?} for
    the consistency check."""
    from ..launch import sharding
    arch = cfg.name
    kv_sharded: dict[str, bool] = {}
    for pstr, leaf in _tensor_leaves(cache):
        spec = sharding.cache_spec(mesh, pstr, leaf, _B)
        for err in sharding.validate_spec(mesh, leaf.shape, spec):
            failures.append(ShardFailure(
                arch, "cache", f"model={m} {pstr}: {err}"))
        name = _leaf_name(pstr)
        if name in ("k", "v") and leaf.ndim >= 4:
            kv_axes = _kv_dim_axes(leaf.ndim, spec)
            kv_sharded[pstr] = "model" in kv_axes
            if "model" in kv_axes and leaf.shape[-2] % m:
                failures.append(ShardFailure(
                    arch, "cache",
                    f"model={m} {pstr}: kv-head dim {leaf.shape[-2]} "
                    f"split {m} ways"))
        elif "model" in _spec_axes(spec):
            failures.append(ShardFailure(
                arch, "cache",
                f"model={m} {pstr}: non-KV cache leaf shards over "
                f"'model' (got {spec})"))
    return kv_sharded


def _check_pool_specs(cfg, state, mesh, m: int, cache_kv: dict,
                      failures: list):
    from ..launch import sharding
    from ..serving import kvpool
    arch = cfg.name
    for pstr, shape, spec in kvpool.decode_state_specs(mesh, state):
        for err in sharding.validate_spec(mesh, shape, spec):
            failures.append(ShardFailure(
                arch, "pool", f"model={m} {pstr}: {err}"))
        name = _leaf_name(pstr)
        axes_used = _spec_axes(spec)
        if name in ("k", "v") and len(shape) >= 4:
            kv_axes = _kv_dim_axes(len(shape), spec)
            bad = axes_used - set(kv_axes)
            if bad:
                failures.append(ShardFailure(
                    arch, "pool",
                    f"model={m} {pstr}: pool KV leaf shards non-kv-head "
                    f"dim(s) over {sorted(bad)} -- the block axis must "
                    f"stay whole (block tables index it on every shard)"))
            if "model" in kv_axes and shape[-2] % m:
                failures.append(ShardFailure(
                    arch, "pool",
                    f"model={m} {pstr}: kv-head dim {shape[-2]} split "
                    f"{m} ways"))
            want = cache_kv.get(pstr)
            got = "model" in kv_axes
            if want is not None and want != got:
                failures.append(ShardFailure(
                    arch, "consistency",
                    f"model={m} {pstr}: prefill cache "
                    f"{'shards' if want else 'replicates'} the kv-head "
                    f"dim but the paged pool "
                    f"{'shards' if got else 'replicates'} it -- "
                    f"commit_prefill reshards every admission"))
        elif axes_used:
            failures.append(ShardFailure(
                arch, "pool",
                f"model={m} {pstr}: non-KV pool leaf (bookkeeping / "
                f"recurrent state) must replicate, got {spec}"))


# ---------------------------------------------------------------------------
# the rank-local layout
# ---------------------------------------------------------------------------

class RankMesh:
    """One rank of a ("data", "model") mesh, as ``place_params`` reads a
    ``DeviceMesh``: the axes' names and sizes, and the rank's index on
    each."""

    def __init__(self, coords: dict, **axes: int):
        self.mesh_dim_names = tuple(axes)
        self._sizes = dict(axes)
        self._coords = coords

    def size(self, i: int) -> int:
        return self._sizes[self.mesh_dim_names[i]]

    def get_local_rank(self, name: str) -> int:
        return self._coords.get(name, 0)


def _reads_data(cfg, opts) -> bool:
    """Whether ``opts`` put anything of ``cfg`` over "data": ZeRO-3
    storage, or an expert layout over "data"."""
    fsdp = cfg.fsdp if opts.fsdp_override is None else opts.fsdp_override
    return bool(fsdp or cfg.n_experts and (opts.expert_shard_dff
                                           or opts.expert_mesh == "data"))


def _layout_skip(cfg, name: str) -> str:
    """Why option ``name`` has nothing to act on in ``cfg`` ("" where it
    has)."""
    if name in ("expert_shard_dff", "expert_mesh=data") and not cfg.n_experts:
        return "no experts: the expert layouts act on nothing"
    return ""


def _kv_run_leaf(cfg, m: int, pstr: str) -> bool:
    parts = pstr.split("/")
    return (len(parts) > 1 and parts[-2] in ("attn", "xattn")
            and parts[-1] in _KV_NAMES and cfg.n_kv % m != 0)


def _ssm_cols_leaf(pstr: str) -> bool:
    parts = pstr.split("/")
    return len(parts) > 1 and parts[-2] == "ssm" \
        and parts[-1] in ("in_proj", "conv")


def _unsliced(view, pstr: str, shape: list, sizes: dict) -> list:
    """A rank's shard shape with its ZeRO-3 slice and its "data" split of
    an expert leaf undone: the shape it computes with on the model axis."""
    from ..launch.sharding import expert_data_dim
    from ..shardctx import zero_entry
    entry = zero_entry(view, pstr)
    if entry is not None:
        dim, axes = entry
        shape[dim] *= math.prod(sizes[a] for a in axes)
    dim = expert_data_dim(view, pstr)
    if dim is not None:
        shape[dim] *= sizes["data"]
    return shape


def _check_heads(cfg, view, local: dict, where: str, failures: list):
    """No head split across ranks: whole query, kv and SSD heads, and the
    kv heads the rank's query heads read."""
    arch = cfg.name
    m, r = view.model_size, view.model_rank
    if "attn" in view.split:
        hd = cfg.resolved_head_dim
        if view.n_heads * m != cfg.n_heads:
            failures.append(ShardFailure(
                arch, "rank-layout",
                f"{where} rank {r}: {view.n_heads} query heads a rank x {m} "
                f"!= {cfg.n_heads}"))
        group = cfg.n_heads // cfg.n_kv
        need = {(r * view.n_heads + j) // group for j in range(view.n_heads)}
        held = set(range(view.kv_offset, view.kv_offset + view.n_kv))
        if not need <= held:
            failures.append(ShardFailure(
                arch, "rank-layout",
                f"{where} rank {r}: holds kv heads {sorted(held)}, its "
                f"query heads read {sorted(need)}"))
        for pstr, shape in local.items():
            parts = pstr.split("/")
            if len(parts) < 2 or parts[-2] not in ("attn", "xattn"):
                continue
            width = shape[-2] if parts[-1] == "wo" else shape[-1]
            if parts[-1] in _Q_NAMES + _KV_NAMES and width % hd:
                failures.append(ShardFailure(
                    arch, "rank-layout",
                    f"{where} rank {r} {pstr}: width {width} is not whole "
                    f"heads of {hd}"))
    if "ssm" in view.split:
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
        if view.ssm_heads * m != heads:
            failures.append(ShardFailure(
                arch, "rank-layout",
                f"{where} rank {r}: {view.ssm_heads} SSD heads a rank x "
                f"{m} != {heads}"))


def _check_tiling(cfg, m: int, whole: dict, by_rank: list, where: str,
                  failures: list):
    """The model ranks' shards (data rank 0's, slices undone) of each leaf
    put together give the whole leaf's shape."""
    arch = cfg.name
    for pstr, w in whole.items():
        shapes = [shards[pstr] for _, shards in by_rank]
        if all(s == w for s in shapes):
            continue
        if any(len(s) != len(w) for s in shapes):
            failures.append(ShardFailure(
                arch, "rank-layout", f"{where} {pstr}: shard ranks "
                                     f"{shapes} != whole {w}"))
            continue
        dims = [d for d in range(len(w)) if any(s[d] != w[d]
                                                for s in shapes)]
        if len(dims) != 1:
            failures.append(ShardFailure(
                arch, "rank-layout",
                f"{where} {pstr}: shards {shapes} differ from the whole "
                f"{w} on dims {dims}"))
            continue
        d = dims[0]
        total = sum(s[d] for s in shapes)
        if _kv_run_leaf(cfg, m, pstr):
            runs = set()
            for view, _ in by_rank:
                runs |= set(range(view.kv_offset, view.kv_offset + view.n_kv))
            ok = runs == set(range(cfg.n_kv))
        elif _ssm_cols_leaf(pstr):
            ok = total - (m - 1) * 2 * cfg.ssm_state == w[d]
        else:
            ok = total == w[d] and len({s[d] for s in shapes}) == 1
        if not ok:
            failures.append(ShardFailure(
                arch, "rank-layout",
                f"{where} {pstr}: the ranks' shards {shapes} do not put "
                f"together to the whole {w}"))


def check_rank_layout(cfg, params, opts, m: int, d: int, where: str,
                      failures: list) -> None:
    """Every rank's shard of ``cfg``'s parameters (``params``, a meta tree)
    under ``opts`` on a (data ``d``, model ``m``) mesh: tiling and heads
    (see the module's docstring)."""
    from ..launch.sharding import map_with_paths, place_params
    whole: dict = {}
    map_with_paths(lambda p, t: whole.__setitem__(p, list(t.shape)), params)
    sizes = {"data": d, "model": m}
    by_data: dict = {}
    for dr in range(d):
        for r in range(m):
            local, view = place_params(
                RankMesh({"data": dr, "model": r}, data=d, model=m), cfg,
                params, opts)
            shards: dict = {}
            map_with_paths(lambda p, t: shards.__setitem__(
                p, _unsliced(view, p, list(t.shape), sizes)), local)
            if shards.keys() != whole.keys():
                failures.append(ShardFailure(
                    cfg.name, "rank-layout",
                    f"{where} rank {r}: leaves {sorted(shards.keys() ^ whole.keys())} "
                    f"missing or extra"))
                return
            _check_heads(cfg, view, shards, where, failures)
            by_data.setdefault(dr, []).append((view, shards))
    for ranks in by_data.values():
        _check_tiling(cfg, m, whole, ranks, where, failures)


def _check_rank_layouts(cfg, params, degrees, failures, covered, skipped):
    from ..launch.sharding import check_options
    for name, opts in LAYOUT_OPTIONS.items():
        why = _layout_skip(cfg, name)
        if not why:
            try:
                check_options(opts)
            except ValueError as e:
                why = str(e)
        if why:
            skipped.append((cfg.name, f"rank-layout[{name}]", why))
            continue
        for m in degrees:
            for d in DATA_DEGREES if _reads_data(cfg, opts) else (1,):
                leg = f"rank-layout[{name} model={m} data={d}]"
                try:
                    check_rank_layout(cfg, params, opts, m, d, leg,
                                      failures)
                except Exception as e:
                    failures.append(ShardFailure(cfg.name, "rank-layout",
                                                 f"{leg}: {e!r}"))
                covered.append((cfg.name, leg))


# ---------------------------------------------------------------------------
# dtype flow
# ---------------------------------------------------------------------------

_BAD_DTYPES = (torch.float64, torch.complex128)


def dtype_failures(tree, *, arch: str, what: str,
                   check: str = "dtype") -> list[ShardFailure]:
    """Flag float64 / complex128 tensors anywhere in ``tree``."""
    failures: list[ShardFailure] = []
    for pstr, leaf in _tensor_leaves(tree):
        if leaf.dtype in _BAD_DTYPES:
            name = str(leaf.dtype).removeprefix("torch.")
            failures.append(ShardFailure(
                arch, check,
                f"{what}/{pstr}: dtype {name} (silent x64 promotion; "
                f"the stack is f32-sized end to end)"))
    return failures


def _check_dtype_flow(cfg, run, failures: list):
    """The prefill cache, the pool state and the per-tick paged update hold
    no 64-bit floats, and the tick keeps the pool's dtypes."""
    arch = cfg.name
    failures.extend(dtype_failures(run.cache, arch=arch,
                                   what="prefill-cache"))
    if run.state is None:
        return
    failures.extend(dtype_failures(run.state, arch=arch, what="pool-state"))
    failures.extend(dtype_failures(run.paged_logits, arch=arch,
                                   what="paged-logits"))
    before = run.state_dtypes
    after = [t.dtype for t in _tree.leaves(run.paged_state)]
    for i, (a, b) in enumerate(zip(before, after)):
        if a != b:
            failures.append(ShardFailure(
                arch, "dtype",
                f"paged decode promotes state leaf {i}: {a} -> {b} "
                f"(tick-to-tick drift)"))


def mec_params_dtype_failures() -> list[ShardFailure]:
    """MecParams (the scenario-side tree every rollout threads) must hold
    no 64-bit floats; built on the meta device (the dtypes do not depend
    on it)."""
    from ..core import scenarios
    params = scenarios.make("fixed_rate", rate=1.0).params(device="meta")
    return dtype_failures(params, arch="mec-params", what="MecParams")


# ---------------------------------------------------------------------------
# donation, in torch terms: the pool written in place
# ---------------------------------------------------------------------------

def pool_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(state))


def donation_failures(before: list, after, *, arch: str,
                      what: str) -> list[ShardFailure]:
    """The pool ``after`` a dispatch must keep the storages of the leaves
    ``before`` it (``_tree.leaves`` of the pool), leaf for leaf.  The
    caller holds ``before``, so no storage it names can be freed and its
    address handed to a new one."""
    now = _tree.leaves(after)
    moved = [i for i, (a, b) in enumerate(zip(before, now))
             if a.untyped_storage().data_ptr()
             != b.untyped_storage().data_ptr()]
    if len(now) != len(before) or moved:
        return [ShardFailure(
            arch, "donation",
            f"{what}: {len(moved)} of {len(before)} pool leaves moved to "
            f"new storage (leaves {moved}; {len(now)} leaves after) -- the "
            f"pool must be written in place, or every tick holds two "
            f"pools")]
    return []


def donation_probe(device=None, arch: str = "qwen3-0.6b"):
    """One tiny engine (``arch`` reduced, one layer; slots 2, s_max 32, and
    one with ``prefill_chunk=8``): two ``decode_step_paged`` ticks, one
    ``commit_prefill``, one ``commit_chunk``, each checked by
    :func:`donation_failures`.  Returns (failures, figures): on CUDA the
    figures hold the pool's bytes and the second tick's peak memory growth
    (the first makes the process's one-time workspaces), which must stay
    under one pool."""
    from ..configs.base import get_config, reduced
    from ..device import resolve_device
    from ..launch.serve import kernel_head_dim
    from ..models import transformer
    from ..serving import kvpool
    from ..serving.engine import Request, ServingEngine

    device = resolve_device(device)
    cfg = reduced(get_config(arch), n_layers=1, **kernel_head_dim(device))
    params = transformer.init_params(0, cfg, device)
    eng = ServingEngine(cfg, params, slots=2, s_max=32)
    state = eng._pool_state
    figures: dict = {"pool_bytes": pool_bytes(state)}
    toks = eng._tensor(np.zeros(eng.slots, np.int32))
    table, lens = eng._tensor(eng.block_tables), eng._tensor(eng.seq_lens)
    tick = lambda st: transformer.decode_step_paged(eng.params, eng.cfg, st,
                                                    toks, table, lens)[1]
    # the first tick also loads the kernels and makes the process's
    # one-time workspaces (cuBLAS's 32 MiB); the second is the steady one
    before = _tree.leaves(state)
    state = tick(state)
    failures = donation_failures(before, state, arch=cfg.name,
                                 what="decode_step_paged tick")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    after = tick(state)
    failures += donation_failures(before, after, arch=cfg.name,
                                  what="decode_step_paged tick")
    if cuda:
        torch.cuda.synchronize(device)
        grew = torch.cuda.max_memory_allocated(device) - base
        figures["tick_peak_growth_bytes"] = grew
        if grew >= figures["pool_bytes"]:
            failures.append(ShardFailure(
                cfg.name, "donation",
                f"decode_step_paged tick: peak memory grew {grew} B, not "
                f"under one pool ({figures['pool_bytes']} B)"))
    # the commit bridge: a solo prefill written into the pool
    req = Request(rid=0, prompt=np.arange(5, dtype=np.int32), max_new=2)
    _, solo, pad = eng._solo_prefill(req)
    before = _tree.leaves(eng._pool_state)
    after = kvpool.commit_prefill(eng._pool_state, solo, pad, 0,
                                  eng._tensor(np.zeros(1, np.int32)),
                                  block_size=eng.kv_block)
    failures += donation_failures(before, after, arch=cfg.name,
                                  what="commit_prefill admission bridge")
    # the streaming commit (auto chunking is off at this s_max)
    eng_c = ServingEngine(cfg, params, slots=2, s_max=32, prefill_chunk=8)
    before = _tree.leaves(eng_c._pool_state)
    after = kvpool.commit_chunk(
        eng_c._pool_state, solo, 0, 5, 0,
        eng_c._tensor(np.zeros(eng_c.table_width, np.int32)),
        block_size=eng_c.kv_block)
    failures += donation_failures(before, after, arch=cfg.name,
                                  what="commit_chunk streaming bridge")
    return failures, figures


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def run_shardcheck(arch_names=None, *, model_degrees=MODEL_DEGREES,
                   donation: bool = True, rank_layout: bool = True,
                   device=None, verbose: bool = False) -> ShardcheckReport:
    """Every check above over the registry (or ``arch_names``).  ``device``
    is the donation probe's (default: CUDA); the rest runs on the meta
    device."""
    configs = config_base.load_all()
    if arch_names:
        configs = {n: configs[n] for n in arch_names}
    t0 = time.perf_counter()
    failures: list[ShardFailure] = []
    covered: list[tuple[str, str]] = []
    skipped: list[tuple[str, str, str]] = []

    with MetaMemo():
        for name, cfg in sorted(configs.items()):
            t1 = time.perf_counter()
            try:
                params = params_specs(cfg)
            except Exception as e:
                failures.append(ShardFailure(name, "init", repr(e)))
                continue
            try:
                run = traced(cfg, params)
            except Exception as e:
                failures.append(ShardFailure(name, "cache-trace", repr(e)))
                continue
            if run.state is None:
                skipped.append((name, "pool", run.skip_reason))
            for m in model_degrees:
                mesh = ShapeOnlyMesh(cells=1, model=m)
                _check_param_specs(cfg, params, mesh, m, failures)
                _check_batch_specs(cfg, mesh, m, failures)
                cache_kv = _check_cache_specs(cfg, run.cache, mesh, m,
                                              failures)
                if run.state is not None:
                    _check_pool_specs(cfg, run.state, mesh, m, cache_kv,
                                      failures)
            covered.extend((name, c) for c in ("spec", "batch", "cache"))
            if run.state is not None:
                covered.extend((name, c) for c in ("pool", "consistency"))
            _check_dtype_flow(cfg, run, failures)
            covered.append((name, "dtype"))
            if rank_layout:
                _check_rank_layouts(cfg, params, model_degrees, failures,
                                    covered, skipped)
            if verbose:
                print(f"  {name}: {time.perf_counter() - t1:.2f}s")

    failures.extend(mec_params_dtype_failures())
    covered.append(("mec-params", "dtype"))
    if donation:
        failures.extend(donation_probe(device)[0])
        covered.append(("qwen3-0.6b", "donation"))
    else:
        skipped.append(("qwen3-0.6b", "donation", "disabled by caller"))
    return ShardcheckReport(covered=tuple(covered), skipped=tuple(skipped),
                            failures=tuple(failures),
                            elapsed_s=time.perf_counter() - t0)
