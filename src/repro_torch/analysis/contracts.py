"""Layer 2: the contract harness, on meta tensors.

Port of ``repro/analysis/contracts.py``.  The reference traces every
registered architecture through every serving path with
``jax.eval_shape``; the port runs the same entry points on tensors on the
meta device (``launch.specs``' ``sds`` and ``params_specs``): shapes and
dtypes, no storage and no arithmetic, so the whole registry at full width
and depth checks on the CPU.  The paths are ``transformer.prefill``,
``decode_step``, ragged ``prefill(pad=)`` with its decode,
``decode_step_paged`` with ``kvpool.commit_prefill``, and
``prefill_chunk`` with ``kvpool.commit_chunk``; logits must be
(B, vocab) float32, and the pool state and the stream cache must keep
their structure over a tick or a commit (:func:`structure`, what the
reference's treedef is).

Every leg runs on meta tensors as the entry points stand: the arguments
that the engine passes as host ints (the commit's pad and slot, the
chunk's start and length) are host ints here too, and no leg reads a
value on the host, so none needs ``FakeTensorMode``.  Meta tensors are not
CUDA tensors, so ``kernels.ops`` takes its plain path.  Most meta kernels
of elementwise ops are Python (about 0.2 ms an op), and a stack of
identical layers asks each the same question again: :class:`MetaMemo`
answers a repeated (op, input shapes, strides and dtypes, other
arguments) from the first answer, which is what the meta kernel would
return again, and leaves ops that mutate or alias their inputs to the
kernel (the sweep took 57 s without it, 19 s with it, on one CPU core).

A further leg sweeps ``launch.sharding.param_spec`` over "model" degrees
{1, 2, 4, 8} on a :class:`ShapeOnlyMesh` and checks that every sharded
dim divides.  Skips are the reference's: stacks the paged pool refuses
(``kvpool.check_pattern``) skip paged and chunked, and MoE stacks skip
chunked; each is recorded with its reason, not counted as covered.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree

from .. import _tree
from ..configs import base as config_base
from ..launch.specs import params_specs, sds

MODEL_DEGREES = (1, 2, 4, 8)

_B, _S, _SMAX = 2, 24, 48              # batch, prompt width, cache budget
_SLOTS, _BLOCK = 4, 8                  # paged-pool geometry


@dataclasses.dataclass(frozen=True)
class ContractFailure:
    arch: str
    path: str
    message: str

    def render(self) -> str:
        return f"{self.arch} [{self.path}]: {self.message}"


@dataclasses.dataclass(frozen=True)
class ContractReport:
    covered: tuple            # (arch, path) pairs actually run
    skipped: tuple            # (arch, path, reason)
    failures: tuple
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return not self.failures


class ShapeOnlyMesh:
    """Stand-in mesh for the sharding policy, which reads only
    ``axis_names`` and ``shape`` (``shardctx.mesh_axes``)."""

    def __init__(self, **axes: int):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not a meta tensor")   # its values may matter
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, *map(_meta_key, x))
    if isinstance(x, dict):
        return ("D", *((k, _meta_key(x[k])) for k in sorted(x)))
    return x


class MetaMemo(TorchDispatchMode):
    """Within (``with MetaMemo():``): a repeated meta op answered from its
    first answer (see the module's docstring); ops that mutate or alias an
    input, take a tensor that is not on the meta device, or return
    anything but meta tensors run as they are."""

    def __init__(self):
        super().__init__()
        self.answers: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if schema.is_mutable or any(r.alias_info is not None
                                    for r in schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        known = self.answers.get(key)
        if known is not None:
            spec, metas = known
            return _pytree.tree_unflatten(
                [torch.empty_strided(shape, stride, dtype=dt, device="meta")
                 for shape, stride, dt in metas], spec)
        out = func(*args, **kwargs)
        flat, spec = _pytree.tree_flatten(out)
        if all(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in flat):
            self.answers[key] = (spec, [(tuple(t.shape), t.stride(), t.dtype)
                                        for t in flat])
        return out


def structure(tree):
    """The containers of ``tree`` (named tuples with their fields, dicts by
    sorted key, lists and tuples), each tensor "T" and any other leaf its
    type: two trees that the engine may thread one into the other have
    equal structures."""
    if isinstance(tree, torch.Tensor):
        return "T"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,
                tuple((f, structure(v)) for f, v in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return ("dict", tuple((k, structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(structure(v) for v in tree))
    return type(tree).__name__


def batch_struct(cfg, batch: int, width: int) -> dict:
    out = {"tokens": sds((batch, width), torch.int32)}
    if cfg.frontend == "vision":
        out["image_embeds"] = sds((batch, 8, cfg.d_model), torch.float32)
    if cfg.enc_layers:
        out["src_embeds"] = sds((batch, 16, cfg.d_model), torch.float32)
    return out


@dataclasses.dataclass
class Traced:
    """One architecture's meta run of the dense prefill and one paged tick,
    which the contract legs check and shardcheck reads."""
    params: dict
    prefill_logits: torch.Tensor
    cache: dict                       # the dense prefill's cache
    state: dict | None = None         # the paged pool (None: skipped)
    state_structure: tuple = ()       # the pool's structure before a tick
    state_dtypes: list = dataclasses.field(default_factory=list)
    paged_logits: torch.Tensor | None = None
    paged_state: dict | None = None   # the pool after one tick
    skip_reason: str = ""             # why the pool legs were skipped


def traced(cfg, params=None) -> Traced:
    """``cfg``'s dense prefill and, where the pool serves it, one paged tick
    on the meta device (``params``: its meta parameter tree, built here
    when not given)."""
    from ..models import transformer
    from ..serving import kvpool
    params = params_specs(cfg) if params is None else params
    logits, cache = transformer.prefill(params, cfg,
                                        batch_struct(cfg, _B, _S), s_max=_SMAX)
    out = Traced(params=params, prefill_logits=logits, cache=cache)
    try:
        kvpool.check_pattern(cfg)
    except ValueError as e:
        out.skip_reason = str(e).split(";")[0]
        return out
    n_blocks = _SLOTS * (_SMAX // _BLOCK) + 1
    out.state = kvpool.init_decode_state(cfg, params, _SLOTS, n_blocks,
                                         _BLOCK)
    out.state_structure = structure(out.state)
    out.state_dtypes = [t.dtype for t in _tree.leaves(out.state)]
    out.paged_logits, out.paged_state = transformer.decode_step_paged(
        params, cfg, out.state, sds((_SLOTS,), torch.int32),
        sds((_SLOTS, -(-_SMAX // _BLOCK)), torch.int32),
        sds((_SLOTS,), torch.int32))
    return out


def _expect_logits(got, batch: int, vocab: int, arch: str, path: str,
                   failures: list):
    if tuple(got.shape) != (batch, vocab):
        failures.append(ContractFailure(
            arch, path, f"logits shape {tuple(got.shape)} != "
                        f"({batch}, {vocab})"))
    if got.dtype != torch.float32:
        failures.append(ContractFailure(
            arch, path, f"logits dtype {got.dtype} != float32 (serving "
                        f"contract: fp32 logits regardless of "
                        f"compute_dtype)"))


def _check_model_paths(cfg, params, failures: list) -> list[tuple[str, str]]:
    """prefill / decode / ragged / paged / chunked legs for one arch.
    Returns the list of (path, reason) skips."""
    from ..models import transformer
    from ..serving import kvpool
    arch = cfg.name
    skips: list[tuple[str, str]] = []
    run = traced(cfg, params)

    # -- prefill (dense) + decode ------------------------------------------
    _expect_logits(run.prefill_logits, _B, cfg.vocab, arch, "prefill",
                   failures)
    toks = sds((_B,), torch.int32)
    logits_d, _ = transformer.decode_step(params, cfg, run.cache, toks)
    _expect_logits(logits_d, _B, cfg.vocab, arch, "decode", failures)

    # -- ragged prefill + decode (left-pad vector rides in the cache) ------
    logits_r, cache_r = transformer.prefill(
        params, cfg, batch_struct(cfg, _B, _S), s_max=_SMAX,
        pad=sds((_B,), torch.int32))
    _expect_logits(logits_r, _B, cfg.vocab, arch, "ragged", failures)
    transformer.decode_step(params, cfg, cache_r, toks)

    # -- paged decode + the commit_prefill admission bridge ----------------
    if run.state is None:
        skips.append(("paged", run.skip_reason))
        skips.append(("chunked", run.skip_reason))
        return skips
    state = run.state
    _expect_logits(run.paged_logits, _SLOTS, cfg.vocab, arch, "paged",
                   failures)
    if structure(run.paged_state) != run.state_structure:
        failures.append(ContractFailure(
            arch, "paged", "decode_step_paged changed the pool-state "
                           "structure (engine threads it tick to tick)"))

    # admission: a solo (batch-1) bucketed prefill commits into the pool
    _, solo = transformer.prefill(params, cfg, batch_struct(cfg, 1, 16),
                                  s_max=16, pad=sds((1,), torch.int32))
    solo_core = {"units": solo["units"], "tail": solo["tail"]}
    ids = sds((-(-16 // _BLOCK),), torch.int64)
    committed = kvpool.commit_prefill(state, solo_core, 3, 0, ids,
                                      block_size=_BLOCK)
    if structure(committed) != run.state_structure:
        failures.append(ContractFailure(
            arch, "paged", "commit_prefill changed the pool-state "
                           "structure"))

    # -- chunked prefill (streaming admission) -----------------------------
    if "m" in (*cfg.block_pattern, *cfg.tail_pattern):
        skips.append(("chunked", "MoE capacity routing couples tokens "
                                 "across a dispatch group; the engine falls "
                                 "back to whole-prompt prefill"))
        return skips
    before = structure(solo_core)
    logits_c, cache_c = transformer.prefill_chunk(
        params, cfg, solo_core, sds((1, _BLOCK), torch.int32), 0, _BLOCK)
    _expect_logits(logits_c, 1, cfg.vocab, arch, "chunked", failures)
    if structure(cache_c) != before:
        failures.append(ContractFailure(
            arch, "chunked", "prefill_chunk changed the stream-cache "
                             "structure (the engine threads it chunk to "
                             "chunk)"))
    ids_full = sds((-(-_SMAX // _BLOCK),), torch.int64)
    committed_c = kvpool.commit_chunk(state, cache_c, 0, 5, 0, ids_full,
                                      block_size=_BLOCK)
    if structure(committed_c) != run.state_structure:
        failures.append(ContractFailure(
            arch, "chunked", "commit_chunk changed the pool-state "
                             "structure"))
    return skips


def _check_pspecs(cfg, params, failures: list):
    """Every param leaf x every model degree: named axes must divide."""
    from ..launch.sharding import map_with_paths, param_spec
    arch = cfg.name
    leaves: list = []
    map_with_paths(lambda path, t: leaves.append((path, tuple(t.shape))),
                   params)
    for m in MODEL_DEGREES:
        mesh = ShapeOnlyMesh(cells=1, model=m)
        for pstr, shape in leaves:
            spec = param_spec(mesh, cfg, pstr, shape)
            for dim, axes in enumerate(tuple(spec)):
                if axes is None:
                    continue
                names = axes if isinstance(axes, tuple) else (axes,)
                total = math.prod(mesh.shape[a] for a in names)
                if dim >= len(shape) or shape[dim] % total:
                    failures.append(ContractFailure(
                        arch, "pspec",
                        f"{pstr}: dim {dim} of shape {shape} "
                        f"not divisible by {names}={total} (model={m})"))


def run_contracts(arch_names=None, *, verbose: bool = False) -> ContractReport:
    configs = config_base.load_all()
    if arch_names:
        configs = {n: configs[n] for n in arch_names}
    t0 = time.perf_counter()
    failures: list[ContractFailure] = []
    covered: list[tuple[str, str]] = []
    skipped: list[tuple[str, str, str]] = []
    with MetaMemo():
        _sweep(configs, failures, covered, skipped, verbose)
    return ContractReport(covered=tuple(covered), skipped=tuple(skipped),
                          failures=tuple(failures),
                          elapsed_s=time.perf_counter() - t0)


def _sweep(configs, failures, covered, skipped, verbose):
    for name, cfg in sorted(configs.items()):
        t1 = time.perf_counter()
        try:
            params = params_specs(cfg)
        except Exception as e:           # an arch that cannot even build
            failures.append(ContractFailure(name, "init", repr(e)))
            continue
        try:
            skips = _check_model_paths(cfg, params, failures)
        except Exception as e:
            failures.append(ContractFailure(name, "trace", repr(e)))
            skips = []
        skip_paths = {p for p, _ in skips}
        covered.extend((name, p) for p in ("prefill", "decode", "ragged"))
        covered.extend((name, p) for p in ("paged", "chunked")
                       if p not in skip_paths)
        skipped.extend((name, p, why) for p, why in skips)
        try:
            _check_pspecs(cfg, params, failures)
            covered.append((name, "pspec"))
        except Exception as e:
            failures.append(ContractFailure(name, "pspec", repr(e)))
        if verbose:
            print(f"  {name}: {time.perf_counter() - t1:.2f}s")
