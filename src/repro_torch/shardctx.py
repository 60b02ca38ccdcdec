"""Activation-sharding context and the "model" axis's collectives.

Port of ``repro/shardctx.py``.  The reference activates logical axes under
``with mesh:`` and lets GSPMD insert the collectives that its
``constrain`` calls and its sharded weights imply.  The port runs tensor
parallelism explicitly (Megatron-style): every rank holds its own shard of
the weights (``launch.sharding.place_params``) and the model code calls
the collectives here, by name, where a sharded contraction ends.  So

* :func:`activation_sharding` records the "model" axis and this rank's
  sub-group on it, where the reference activates its logical axes;
* :func:`model_all_reduce` and :func:`model_all_gather` run over that
  sub-group; under NCCL on the device, under gloo on host copies (as
  ``core.gridshard.gather`` does); the backend is the mesh's, and no path
  catches a failure to take another;
* training goes through them too: each has the backward its call site
  needs (Megatron's rule).  Every rank computes the same loss, so the
  gradient of the replicated residual stream is the same on every rank: a
  row-parallel sum passes it back as it is, :func:`enter` sums the
  partial gradients of a replicated input that split weights read, an
  all-gather read by each rank's own channels sums and scatters, and one
  read by a loss every rank repeats takes the rank's slice;
* the reference's ``constrain`` (a layout constraint that only asks GSPMD
  to move data) has no counterpart: every tensor already lives where the
  explicit collectives put it;
* ZeRO-3 storage (``launch.sharding`` under ``ShardingOptions``): a leaf
  whose policy spec names "data" (or ("data", "model")) is kept as the
  rank's slice on that dim, and :func:`gather_tree` all-gathers the
  slices where the leaf is used (one collective a dtype for a unit's
  leaves), its backward reduce-scattering (summing) the gradient back to
  the slice;
* the MoE's collectives over the data axes (``models.ffn.apply_moe``):
  where a train step's rows are the rank's share of the logical batch
  (``activation_sharding(..., data_rows=True)``), the dispatch groups
  are the reference's, formed over the whole microbatch's token stream
  across the data ranks: :func:`dp_gather_counts` (each round's
  per-group expert counts, outside autograd) and :func:`dp_sum` (the aux
  loss's sums; its backward sums too, as every rank's aux reads the
  group's).  The dispatched tokens go over "data" by
  :func:`data_all_gather` (backward a reduce-scatter) and come back by
  :func:`data_reduce_scatter` (backward an all-gather), or go out and
  back by :func:`data_all_to_all` (its own reverse backward);
* sequence parallelism (``seq_shard``, Megatron's sense): where a
  full-sequence call's length divides "model", the residual stream
  between sub-blocks is the rank's block of the sequence
  (:func:`seq_parallel` marks the call's view, ``RankConfig.seq_block``);
  :func:`enter` then all-gathers a sub-block's input over the sequence
  (backward a reduce-scatter) and :func:`reduce` reduce-scatters its
  partial output (:func:`model_reduce_scatter`, backward an
  all-gather), where it all-reduced them before;
* :func:`collective_ledger` records every collective the port issues
  (these, ``runtime.compression``'s sync, ``core.gridshard``'s gather and
  ``launch.mesh.broadcast_tree``) by the reference's HLO names, with its
  result's bytes and dtype: what ``launch.dryrun`` reads where the
  reference parses HLO text.

Where the "cells" (or "data") axis is larger than 1, each row of the mesh
is a replica that runs the same requests on its own "model" sub-group,
which is what GSPMD does with unsharded inputs.

:class:`RankConfig` is one rank's view of an ``ArchConfig``: the local
head, FFN, recurrent-width, SSD-head, expert and vocabulary counts, and
which sub-blocks it holds as shards (``split``).  The model code asks
:func:`split` before each collective; a plain ``ArchConfig`` splits
nothing, so the one-device path runs no collective at all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Tuple

import torch
import torch.distributed as dist

from .configs.base import ArchConfig

_CTX: dict = {"active": False, "tp_n": 1, "group": None, "mesh": None,
              "remat_offload": False, "moe_dp": True, "data_rows": False,
              "seq_shard": False}
_LEDGER: list | None = None
# the sub-blocks that read other positions of the sequence: under
# sequence parallelism a whole one gathers its input and keeps its block
MIXING = ("attn", "rglru", "ssm")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only stand-in
    (anything with ``axis_names`` and a ``shape`` dict, as the reference's
    ``analysis.contracts.ShapeOnlyMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        if hasattr(mesh, "size"):   # sizes without building the rank tensor
            return {a: int(mesh.size(i)) for i, a in enumerate(names)}
        return dict(zip(names, mesh.mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class RankConfig(ArchConfig):
    """One rank's view of an ``ArchConfig`` under tensor parallelism over
    "model" (``launch.sharding.place_params`` builds it).  ``n_heads``,
    ``n_kv``, ``d_ff`` and ``rnn_width`` are the rank's own counts
    (``head_dim`` is set explicitly); ``n_experts`` and ``vocab`` stay the
    model's, because the router and the greedy argmax see all of them, and
    the rank's own counts are ``local_experts`` and ``local_vocab``.

    * ``split``: the sub-blocks the rank holds as shards, each ending in a
      collective: "attn", "ffn", "moe", "shared", "rglru", "ssm", "vocab";
    * ``kv_offset``: the first global kv head the rank holds; where the
      query heads divide M but the kv heads do not, ``n_kv`` is the run of
      kv heads the rank's query heads read (a kv head may then sit on
      several ranks), and its weights and KV cache hold just those;
    * ``q_kv``: where that run does not serve each of its kv heads with
      the same number of local query heads, each local query head's kv
      head, counted from ``kv_offset`` (empty where GQA's own mapping
      holds);
    * ``ssm_heads``: the local SSD heads where "ssm" is split;
    * ``expert_offset`` / ``vocab_offset``: the first global expert and
      vocabulary row the rank holds;
    * ``expert_mesh``: the axis the experts lie on ("model", or "data",
      where "model" splits each expert's F instead: "moe" in ``split``
      then means that F split);
    * ``moe_data``: what "data" splits of the expert leaves: "" nothing,
      "dff" each expert's F (``expert_shard_dff``), "experts" the experts
      (``expert_mesh="data"``); ``local_dff`` / ``dff_offset``: the
      rank's F columns of each expert it holds (the whole F from 0 where
      nothing splits it);
    * ``seq_block``: this call's residual stream is the rank's block of
      the sequence (``seq_shard``; set for one full-sequence call by
      :func:`seq_parallel`, never by the layout);
    * ``zero``: the leaves kept as ZeRO-3 storage slices, each
      ``(path, dim, axes)``: the leaf at ``path`` ("units/slot0/attn/wq",
      "embed", ...) is the rank's equal part, on ``dim`` (counted from
      the end, so a unit's leaf and its stack agree), over the mesh axes
      ``axes``, of its compute shard;
    * ``whole``: the model's ``ArchConfig``.
    """
    model_rank: int = 0
    model_size: int = 1
    split: Tuple[str, ...] = ()
    kv_offset: int = 0
    q_kv: Tuple[int, ...] = ()
    ssm_heads: int = 0
    local_experts: int = 0
    expert_offset: int = 0
    local_vocab: int = 0
    vocab_offset: int = 0
    expert_mesh: str = "model"
    moe_data: str = ""
    local_dff: int = 0
    dff_offset: int = 0
    zero: Tuple[Tuple[str, int, Tuple[str, ...]], ...] = ()
    seq_block: bool = False
    # the model's own config, for what a rank must know of the others'
    # shards (``launch.sharding``: gathering them, summing the gradients
    # several ranks hold); not part of the view's identity
    whole: ArchConfig | None = dataclasses.field(default=None, compare=False,
                                                 repr=False)


def split(cfg, part: str) -> bool:
    """Whether ``cfg`` (a ``RankConfig``) holds only its shard of
    ``part``; a plain ``ArchConfig`` holds everything."""
    return isinstance(cfg, RankConfig) and part in cfg.split


@contextlib.contextmanager
def activation_sharding(mesh, *, seq_shard: bool = False,
                        moe_dp_groups: bool = True,
                        remat_offload: bool = False,
                        expert_axis: str = "model",
                        data_rows: bool = False):
    """Activate the mesh's "model" axis: its size and this rank's "model"
    sub-group, for the collectives, and the mesh itself, for the ZeRO-3
    and data-axis groups.  The other axes ("cells", "data", "pod") hold
    replicas, or a train step's own rows of the batch
    (``launch.train.make_mesh_train_step``).

    The reference's knobs, with its signature: ``remat_offload`` streams
    each remat unit's saved input to host memory
    (``models.transformer.run_units``; :func:`remat_offload_active`);
    ``moe_dp_groups=False`` runs each MoE expert on the dispatched tokens
    of every data rank (all-gathered over "data" before the experts, the
    outputs reduce-scattered or sliced back after: what the reference's
    unsharded group dim means), which ``expert_shard_dff`` needs;
    ``expert_axis`` names the axis the experts lie on ("data": the rank
    layout's ``RankConfig.expert_mesh`` then sends the tokens by an
    all-to-all).  ``seq_shard`` splits the residual stream's sequence
    over "model" in every full-sequence call whose length the axis
    divides (:func:`seq_parallel`); at a size of 1 it shards nothing.

    ``data_rows`` (the port's own): the activations are this rank's equal
    share of a logical batch split over the data axes ("pod", "data"),
    in rank order, as a train step's are; the MoE then forms its dispatch
    groups over the whole token stream across those ranks, as the
    reference forms them (:func:`dp_rows`).  Without it each data rank is
    a replica that groups its own tokens."""
    axes = mesh_axes(mesh)
    tp_n = axes.get("model", 1)
    if expert_axis not in ("model", "data"):
        raise ValueError(f"expert_axis {expert_axis!r} is not \"model\" or "
                         f"\"data\"")
    group = None
    if tp_n > 1 and hasattr(mesh, "get_group"):
        group = mesh.get_group("model")
    old = dict(_CTX)
    _CTX.update(active=True, tp_n=tp_n, group=group, mesh=mesh,
                remat_offload=bool(remat_offload),
                moe_dp=bool(moe_dp_groups), data_rows=bool(data_rows),
                seq_shard=bool(seq_shard) and tp_n > 1)
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(old)


def remat_offload_active() -> bool:
    """Whether remat units keep their saved input in host memory."""
    return bool(_CTX["active"] and _CTX["remat_offload"])


def mesh_context(mesh):
    """``activation_sharding(mesh)``, or no context where ``mesh`` is
    None: what the serving stack enters around each call that runs its
    layers."""
    if mesh is None:
        return contextlib.nullcontext()
    return activation_sharding(mesh)


def model_size() -> int:
    """Ranks on the active "model" axis (1 outside a mesh)."""
    return _CTX["tp_n"] if _CTX["active"] else 1


def _group():
    if not _CTX["active"] or _CTX["group"] is None:
        raise RuntimeError(
            "a model-sharded layer needs its \"model\" sub-group: run it "
            "under shardctx.activation_sharding(mesh) on a mesh whose "
            "\"model\" axis is larger than 1")
    return _CTX["group"]


def _on_host(group) -> bool:
    """Gloo's collectives take CPU tensors only; NCCL's take CUDA ones."""
    return dist.get_backend(group) != "nccl"


def _all_reduce(x, op=dist.ReduceOp.SUM, group=None):
    """The sum (or ``op``) of ``x`` over the "model" sub-group (or
    ``group``), written into ``x`` (contiguous); under gloo a CUDA tensor
    goes through a host copy."""
    group = _group() if group is None else group
    record("all-reduce", x)
    with torch.profiler.record_function("model_all_reduce"):
        if x.is_cuda and _on_host(group):
            buf = x.cpu()
            dist.all_reduce(buf, op=op, group=group)
            return x.copy_(buf)
        dist.all_reduce(x, op=op, group=group)
        return x


def _all_gather(x, dim: int):
    group = _group()
    with torch.profiler.record_function("model_all_gather"):
        host = x.is_cuda and _on_host(group)
        buf = (x.cpu() if host else x).contiguous()
        parts = [torch.empty_like(buf) for _ in range(_CTX["tp_n"])]
        dist.all_gather(parts, buf, group=group)
        out = torch.cat(parts, dim=dim)
        record("all-gather", out)
        return out.to(x.device) if host else out


def own_block(g, dim: int = 1):
    """This rank's part of ``g`` along ``dim`` (M equal parts, in rank
    order); under autograd the gradient of the rest is zero."""
    size = g.shape[dim] // _CTX["tp_n"]
    return g.narrow(dim, dist.get_rank(_group()) * size, size)


class _AllReduce(torch.autograd.Function):
    """All-reduce forward; the backward is the identity, or an all-reduce
    of the gradient (``both``)."""

    @staticmethod
    def forward(ctx, x, both: bool):
        ctx.both = both
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        if ctx.both:
            g = _all_reduce(g.contiguous().clone())
        return g, None


class _Enter(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


class _AllGather(torch.autograd.Function):
    """All-gather forward; backward the sum over ranks of the gradient,
    each keeping its slice (a reduce-scatter), or the slice alone where
    every rank computed the same whole gradient (``scatter`` False)."""

    @staticmethod
    def forward(ctx, x, dim: int, scatter: bool):
        ctx.dim, ctx.scatter = dim, scatter
        return _all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            g = _all_reduce(g.contiguous().clone())
        return own_block(g, ctx.dim).contiguous(), None, None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def model_all_reduce(x, *, backward: str = "identity"):
    """The sum of ``x`` over the "model" sub-group, in ``x``'s dtype.
    Where autograd records, the gradient goes back as it came
    (``backward="identity"``: the result feeds computation every rank
    repeats, as a row-parallel product's sum feeds the residual stream)
    or summed over the ranks too (``"all_reduce"``: every rank's own
    computation reads the sum, as the SSD's split norm reads its sum of
    squares).  Without autograd a fresh tensor is reduced in place and
    returned."""
    if backward not in ("identity", "all_reduce"):
        raise ValueError(f"unknown backward {backward!r}")
    if _tracked(x):
        return _AllReduce.apply(x, backward == "all_reduce")
    return _all_reduce(x.contiguous())


def model_max(x):
    """The elementwise max of ``x`` over the "model" sub-group, outside
    autograd (a fresh tensor)."""
    return _all_reduce(x.detach().contiguous().clone(), dist.ReduceOp.MAX)


def model_all_gather(x, dim: int = -1, *, backward: str = "reduce_scatter"):
    """Every rank's ``x`` of the "model" sub-group, concatenated along
    ``dim`` in rank order.  Where autograd records, each rank's gradient
    is summed over the ranks and the rank keeps its part
    (``backward="reduce_scatter"``: each rank's own computation reads the
    whole, as the RG-LRU gates read the whole u), or the rank takes its
    part of a gradient every rank computed whole (``"slice"``: the logits
    before a loss every rank repeats)."""
    if backward not in ("reduce_scatter", "slice"):
        raise ValueError(f"unknown backward {backward!r}")
    if _tracked(x):
        return _AllGather.apply(x, dim, backward == "reduce_scatter")
    return _all_gather(x, dim)


def sum_grad(x):
    """``x`` forward; where autograd records, its gradient summed over
    "model" backward: a replicated tensor that each rank reads in part (a
    split sub-block's input, or under sequence parallelism the rows of
    the rank's block)."""
    return _Enter.apply(x) if _tracked(x) else x


def enter(cfg, part: str, x):
    """``x`` as it enters ``part``'s sub-block.  Under tensor parallelism,
    where ``cfg`` splits ``part``: the same tensor forward, and where
    autograd records, its gradient summed over "model" backward (each
    rank's shard contributes its part of the replicated input's
    gradient).  Under sequence parallelism (``cfg.seq_block``): x is the
    rank's block of the sequence, all-gathered over it (backward a
    reduce-scatter) where the sub-block is split or reads other
    positions (:data:`MIXING`); a whole row-wise sub-block (a dense FFN)
    runs on the block.  Call it once on each residual-stream tensor that
    a sub-block reads."""
    if seq_block(cfg):
        return seq_gather(x) if split(cfg, part) or part in MIXING else x
    if split(cfg, part):
        return sum_grad(x)
    return x


def reduce(cfg, part: str, x):
    """``x``, the sub-block's output (``(B, S, D)`` under sequence
    parallelism), back into the residual stream: all-reduced over
    "model" where ``cfg`` splits ``part`` (a row-parallel product's
    partial sum), else as it is.  Under sequence parallelism the partial
    sum is reduce-scattered over the sequence instead, and a whole
    :data:`MIXING` sub-block, which ran on the gathered sequence, keeps
    the rank's block."""
    if seq_block(cfg):
        if split(cfg, part):
            return model_reduce_scatter(x, 1)
        return own_block(x) if part in MIXING else x
    return model_all_reduce(x) if split(cfg, part) else x


# ---------------------------------------------------------------------------
# sequence parallelism over "model" (seq_shard)
# ---------------------------------------------------------------------------

def seq_parallel(cfg, s: int):
    """The view a full-sequence call of ``s`` positions runs under: ``cfg``
    with ``seq_block`` set where ``seq_shard`` is active on a "model" axis
    above 1 that divides ``s`` (the reference's rule: a dim its axis
    does not divide is not split, so a decode step at S = 1 runs the
    plain tensor-parallel path), else ``cfg`` itself."""
    if (not (_CTX["active"] and _CTX["seq_shard"])
            or not isinstance(cfg, RankConfig) or cfg.model_size == 1
            or s % cfg.model_size or cfg.seq_block):
        return cfg
    return dataclasses.replace(cfg, seq_block=True)


def seq_block(cfg) -> bool:
    """Whether ``cfg``'s residual stream is the rank's block of the
    sequence (:func:`seq_parallel`)."""
    return isinstance(cfg, RankConfig) and cfg.seq_block


def model_reduce_scatter(x, dim: int):
    """The sum of ``x`` over the "model" sub-group, each rank keeping its
    block along ``dim`` (a float32 sum rounded once); the backward
    all-gathers the gradient."""
    return _ReduceScatter.apply(_group(), _CTX["tp_n"], dim, x)


def seq_gather(x, *, backward: str = "reduce_scatter"):
    """Every rank's block of the sequence (dim 1), joined in rank order:
    one all-gather.  Where autograd records, each rank's gradient is
    summed over the ranks and the rank keeps its block
    (``"reduce_scatter"``: each rank's computation reads the whole in
    part, as its shard of a split sub-block does), or the rank takes its
    block of a gradient every rank computed whole (``"slice"``: the
    hidden before a loss every rank repeats)."""
    if backward == "slice":
        return model_all_gather(x, 1, backward="slice")
    if backward != "reduce_scatter":
        raise ValueError(f"unknown backward {backward!r}")
    return _ZeroGather.apply(_group(), _CTX["tp_n"], (1,), x)[0]


class _GatherPair(torch.autograd.Function):
    """One all-gather along dim 1, two results: the first's gradient
    reduce-scattered back, the second's sliced (see :func:`seq_gather`)."""

    @staticmethod
    def forward(ctx, group, n, x):
        ctx.group, ctx.n, ctx.shape = group, n, x.shape
        rows = _gather_flat(x.reshape(-1), group, n)
        out = _joined(rows, x.shape, 1)
        return out, out.clone()

    @staticmethod
    def backward(ctx, g_sum, g_rep):
        send = _blocks(g_sum, ctx.shape, 1, ctx.n)
        g = _reduce_scatter_flat(send, ctx.group, ctx.n).view(ctx.shape)
        return None, None, g + own_block(g_rep, 1)


def seq_gather_pair(x):
    """``(seq_gather(x), seq_gather(x, backward="slice"))`` from one
    all-gather: what split computation reads, beside what computation
    every rank repeats whole reads (the MoE's experts and its router)."""
    if _tracked(x):
        return _GatherPair.apply(_group(), _CTX["tp_n"], x)
    out = _all_gather(x, 1)
    return out, out


class _Split(torch.autograd.Function):
    """The rank's block along dim 1 forward; the all-gather of the
    blocks' gradients backward (every rank computed the whole)."""

    @staticmethod
    def forward(ctx, x):
        return own_block(x, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), 1)


def seq_split(x):
    """The rank's block of the sequence of ``x``, a tensor every rank
    holds whole (the embedding of the whole sequence); where autograd
    records, its gradient is every rank's block all-gathered, so the whole
    tensor's gradient is whole on every rank."""
    return _Split.apply(x) if _tracked(x) else own_block(x, 1)


def model_gather_rows(x):
    """Every rank's ``x`` of the "model" sub-group, stacked in rank order
    (M, *x.shape), outside autograd: one all-gather."""
    return _gather_flat(x.detach().reshape(-1), _group(),
                        _CTX["tp_n"]).view(_CTX["tp_n"], *x.shape)


# ---------------------------------------------------------------------------
# the KV cache's sequence over "model" (ROADMAP 7d)
# ---------------------------------------------------------------------------

def kv_run(n_heads: int, n_kv: int, m: int, r: int) -> Tuple[int, ...]:
    """The kv heads rank ``r`` of an ``m``-way "model" axis reads, each of
    its ``n_heads / m`` query heads' (GQA: query head h reads kv head
    h // (n_heads / n_kv))."""
    h, group = n_heads // m, n_heads // n_kv
    return tuple((r * h + j) // group for j in range(h))


def seq_caches(cfg) -> bool:
    """Whether ``cfg``, a rank's view, keeps its dense and ring KV caches
    split over "model" along the sequence, every kv head of the rank's
    block of positions: where its query heads are split and the kv heads
    do not divide the axis, as the policy's ``cache_spec`` splits them
    (its ``model_size`` must also divide the cache's length)."""
    return (split(cfg, "attn") and cfg.whole is not None
            and cfg.whole.n_kv % cfg.model_size != 0)


# ---------------------------------------------------------------------------
# the collective ledger
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def collective_ledger():
    """Record every collective the port issues while the block runs: the
    list it yields gets ``(kind, result bytes, dtype)`` for each, ``kind``
    one of :data:`KINDS` (the reference's HLO names; a broadcast is an
    all-reduce, as ``broadcast_one_to_all`` lowers it).  Ledgers nest: an
    inner one records into its own list only."""
    global _LEDGER
    old, _LEDGER = _LEDGER, []
    try:
        yield _LEDGER
    finally:
        _LEDGER = old


def record(kind: str, result, dtype=None) -> None:
    """Add one collective to the active ledger, if any: ``result`` its
    result tensor, or its result's bytes with ``dtype``."""
    if _LEDGER is None:
        return
    if isinstance(result, torch.Tensor):
        nbytes, dtype = result.numel() * result.element_size(), result.dtype
    else:
        nbytes = int(result)
    _LEDGER.append((kind, int(nbytes), str(dtype).replace("torch.", "")))


def ledger_totals(entries) -> dict:
    """The reference's ``collective_bytes`` record of a ledger: bytes and
    ops by kind, the total, the float32 bytes, and the bf16-wire figure,
    equal to the total (the port's collectives carry their own types)."""
    by_kind = {k: 0.0 for k in KINDS}
    ops = {k: 0 for k in KINDS}
    f32 = 0.0
    for kind, nbytes, dtype in entries:
        by_kind[kind] += nbytes
        ops[kind] += 1
        if dtype == "float32":
            f32 += nbytes
    total = float(sum(by_kind.values()))
    return {"bytes_by_kind": by_kind, "ops_by_kind": ops,
            "total_bytes": total, "f32_bytes": f32,
            "bf16_wire_corrected_bytes": total}


# ---------------------------------------------------------------------------
# ZeRO-3 storage: the gather where a leaf is used, and its groups
# ---------------------------------------------------------------------------

_ROOTS = ("embed", "head", "units", "tail", "encoder", "final_norm")


def param_path(path: str) -> str:
    """The parameter's own path within a longer one ("1/mu/units/slot0/
    attn/wq" -> "units/slot0/attn/wq"): from its first root key on."""
    parts = path.split("/")
    for i, p in enumerate(parts):
        if p in _ROOTS:
            return "/".join(parts[i:])
    return path


@functools.lru_cache(maxsize=256)
def _zero_map(zero: tuple) -> dict:
    return {path: (dim, axes) for path, dim, axes in zero}


def zero_entry(cfg, path: str):
    """``(dim, axes)`` of the ZeRO-3 storage of the leaf at ``path`` (any
    path that ends in the parameter's, as a tree of moments gives), or
    None where the rank keeps its whole compute shard."""
    if not isinstance(cfg, RankConfig) or not cfg.zero:
        return None
    return _zero_map(cfg.zero).get(param_path(path))


def storage_group(axes: tuple):
    """(this rank's process group over the mesh axes ``axes`` of the
    active mesh, its size), made once a mesh."""
    mesh = _CTX["mesh"] if _CTX["active"] else None
    if mesh is None or not hasattr(mesh, "get_group"):
        raise RuntimeError(
            "a ZeRO-3 leaf is gathered over its mesh axes: run it under "
            "shardctx.activation_sharding(mesh)")
    cache = mesh.__dict__.setdefault("_repro_storage_groups", {})
    if axes not in cache:
        from .launch.mesh import axes_group
        cache[axes] = axes_group(mesh, axes)
    return cache[axes]


def axes_coord(axes: tuple) -> int:
    """This rank's row-major index over the active mesh's ``axes``."""
    mesh = _CTX["mesh"]
    sizes = mesh_axes(mesh)
    at = 0
    for a in axes:
        at = at * sizes[a] + mesh.get_local_rank(a)
    return at


def storage_all_reduce(x, axes: tuple):
    """The sum of ``x`` over the active mesh's ``axes``, outside autograd
    (a fresh tensor)."""
    group, n = storage_group(axes)
    x = x.detach().contiguous().clone()
    return _all_reduce(x, group=group) if n > 1 else x


def _gather_flat(flat, group, n: int):
    """Every rank's ``flat`` of ``group`` as the rows of an (n, numel)
    tensor, in rank order (one all-gather; under gloo on a host copy, the
    result back on ``flat``'s device)."""
    host = flat.is_cuda and _on_host(group)
    buf = (flat.cpu() if host else flat).contiguous()
    out = buf.new_empty(n * buf.numel())
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, buf, group=group)
    record("all-gather", out)
    out = out.view(n, -1)
    return out.to(flat.device) if host else out


def _reduce_scatter_flat(send, group, n: int):
    """The sum over ``group`` of row r of each rank's (n, k) ``send``, on
    rank r: an all-to-all of the rows, then a float32 sum rounded once to
    ``send``'s dtype."""
    host = send.is_cuda and _on_host(group)
    buf = (send.cpu() if host else send).contiguous()
    got = torch.empty_like(buf)
    dist.all_to_all_single(got, buf, group=group)
    out = got.float().sum(dim=0).to(send.dtype)
    record("reduce-scatter", out)
    return out.to(send.device) if host else out


def _joined(rows, shape, dim: int):
    """(n, *shape) rows -> the n blocks joined along ``dim`` in row order."""
    n = rows.shape[0]
    dim = dim % len(shape)
    x = rows.view(n, *shape).movedim(0, dim)
    return x.reshape(*shape[:dim], n * shape[dim], *shape[dim + 1:])


def _blocks(g, shape, dim: int, n: int):
    """The inverse of ``_joined``: ``g``'s n blocks along ``dim`` as the
    rows of an (n, numel) tensor."""
    dim = dim % len(shape)
    x = g.reshape(*shape[:dim], n, shape[dim], *shape[dim + 1:])
    return x.movedim(dim, 0).reshape(n, -1)


class _ZeroGather(torch.autograd.Function):
    """Forward: each shard all-gathered along its dim over ``group`` (one
    collective for all of them); backward: each gradient reduce-scattered
    (summed) back to the shard (one collective)."""

    @staticmethod
    def forward(ctx, group, n, dims, *shards):
        ctx.group, ctx.n, ctx.dims = group, n, dims
        ctx.shapes = [s.shape for s in shards]
        rows = _gather_flat(torch.cat([s.reshape(-1) for s in shards]),
                            group, n)
        out, at = [], 0
        for s, dim in zip(shards, dims):
            k = s.numel()
            out.append(_joined(rows[:, at:at + k], s.shape, dim))
            at += k
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        send = torch.cat([_blocks(g, shape, dim, ctx.n) for g, dim, shape
                          in zip(grads, ctx.dims, ctx.shapes)], dim=1)
        summed = _reduce_scatter_flat(send, ctx.group, ctx.n)
        out, at = [], 0
        for shape in ctx.shapes:
            k = shape.numel()
            out.append(summed[at:at + k].view(shape))
            at += k
        return (None, None, None, *out)


def _walk(prefix: str, tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        _walk(f"{prefix}/{k}" if prefix else str(k), v, out)


def _rebuild(prefix: str, tree, new: dict):
    if isinstance(tree, torch.Tensor):
        return new.get(prefix, tree)
    if isinstance(tree, dict):
        return {k: _rebuild(f"{prefix}/{k}" if prefix else str(k), v, new)
                for k, v in tree.items()}
    return [_rebuild(f"{prefix}/{i}" if prefix else str(i), v, new)
            for i, v in enumerate(tree)]


def gather_tree(cfg, prefix: str, tree):
    """``tree`` (the parameters at ``prefix``: "units" for one unit's
    leaves, "tail/0", "embed", ...) with each ZeRO-3 leaf all-gathered
    over its storage axes into the rank's compute shard: one collective a
    (storage axes, dtype), whose backward reduce-scatters each gradient
    back to the slice.  The tree itself where ``cfg`` stores nothing."""
    if not isinstance(cfg, RankConfig) or not cfg.zero:
        return tree
    leaves: list = []
    _walk(prefix, tree, leaves)
    table = _zero_map(cfg.zero)
    groups: dict = {}
    for path, t in leaves:
        entry = table.get(path)
        if entry is not None:
            groups.setdefault((entry[1], t.dtype), []).append(
                (path, t, entry[0]))
    if not groups:
        return tree
    new = {}
    for (axes, _), items in groups.items():
        group, n = storage_group(axes)
        outs = _ZeroGather.apply(group, n, tuple(d for _, _, d in items),
                                 *(t for _, t, _ in items))
        new.update({path: o for (path, _, _), o in zip(items, outs)})
    return _rebuild(prefix, tree, new)


# ---------------------------------------------------------------------------
# the MoE's collectives over the data axes
# ---------------------------------------------------------------------------

def _dp_axes() -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axes(_CTX["mesh"]))


def dp_rows() -> Tuple[int, int]:
    """(this rank's row-major index, ranks) over the active mesh's data
    axes ("pod", "data") where the activations are the rank's equal share
    of a logical batch (``activation_sharding(..., data_rows=True)``);
    (0, 1) elsewhere."""
    if not (_CTX["active"] and _CTX["data_rows"]):
        return 0, 1
    axes = _dp_axes()
    n = 1
    for a in axes:
        n *= mesh_axes(_CTX["mesh"])[a]
    return (axes_coord(axes), n) if n > 1 else (0, 1)


def data_size() -> int:
    """Ranks on the active mesh's "data" axis (1 outside a mesh)."""
    if not _CTX["active"]:
        return 1
    return mesh_axes(_CTX["mesh"]).get("data", 1)


def gathers_experts() -> bool:
    """Whether the MoE runs each expert on every data rank's dispatched
    tokens (``moe_dp_groups=False`` on a "data" axis above 1)."""
    return _CTX["active"] and not _CTX["moe_dp"] and data_size() > 1


def dp_gather_counts(x):
    """Every data rank's ``x`` (over the ``dp_rows`` ranks), stacked in
    rank order, outside autograd: one all-gather."""
    group, n = storage_group(_dp_axes())
    return _gather_flat(x.detach().reshape(-1), group, n).view(n, *x.shape)


class _DataSum(torch.autograd.Function):
    """All-reduce over ``group`` forward; all-reduce of the gradient
    backward (each rank's computation reads the sum)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g.contiguous().clone(), group=ctx.group)


def dp_sum(x):
    """The sum of ``x`` over the ``dp_rows`` ranks.  Where autograd
    records, its gradient is summed over them too: every rank computes
    the same function of the sum (the MoE's aux loss), so each rank's
    share of the data-parallel mean is 1 / n of it, and the sum makes that
    up for the terms of ``x`` the rank alone holds."""
    group, _ = storage_group(_dp_axes())
    if _tracked(x):
        return _DataSum.apply(group, x)
    return _all_reduce(x.detach().contiguous().clone(), group=group)


def _data_group():
    return storage_group(("data",))


def data_all_gather(x, dim: int):
    """Every "data" rank's ``x`` joined along ``dim`` in rank order; the
    backward reduce-scatters (sums, then keeps the rank's block)."""
    group, n = _data_group()
    return _ZeroGather.apply(group, n, (dim,), x)[0]


class _ReduceScatter(torch.autograd.Function):
    """The sum over ``group`` of each rank's ``x``, the rank keeping its
    block along ``dim`` (n equal blocks); backward the all-gather."""

    @staticmethod
    def forward(ctx, group, n, dim, x):
        dim = dim % x.dim()
        shape = list(x.shape)
        shape[dim] //= n
        ctx.group, ctx.n, ctx.dim, ctx.shape = group, n, dim, tuple(shape)
        send = _blocks(x, ctx.shape, dim, n)
        return _reduce_scatter_flat(send, group, n).view(ctx.shape)

    @staticmethod
    def backward(ctx, g):
        rows = _gather_flat(g.reshape(-1), ctx.group, ctx.n)
        return None, None, None, _joined(rows, ctx.shape, ctx.dim)


def data_reduce_scatter(x, dim: int):
    """The sum of ``x`` over the "data" ranks, each keeping its block
    along ``dim`` (a float32 sum rounded once); the backward
    all-gathers."""
    group, n = _data_group()
    return _ReduceScatter.apply(group, n, dim, x)


def _all_to_all(x, group):
    host = x.is_cuda and _on_host(group)
    buf = (x.cpu() if host else x).contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    record("all-to-all", out)
    return out.to(x.device) if host else out


class _AllToAll(torch.autograd.Function):
    """Block r of dim 0 to rank r, block r back from rank r; the backward
    is the same exchange (its own reverse)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(g, ctx.group)


def data_all_to_all(x):
    """``x`` (n, ...) over the n "data" ranks: block r of dim 0 goes to
    rank r, and block r of the result came from rank r."""
    group, n = _data_group()
    if x.shape[0] != n:
        raise ValueError(f"an all-to-all over {n} data ranks takes {n} "
                         f"blocks, got {x.shape[0]}")
    return _AllToAll.apply(group, x)
