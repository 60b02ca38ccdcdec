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
  explicit collectives put it.

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
from typing import Tuple

import torch
import torch.distributed as dist

from .configs.base import ArchConfig

_CTX: dict = {"active": False, "tp_n": 1, "group": None}


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only stand-in
    (anything with ``axis_names`` and a ``shape`` dict, as the reference's
    ``analysis.contracts.ShapeOnlyMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
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
def activation_sharding(mesh):
    """Activate the mesh's "model" axis: its size and this rank's "model"
    sub-group, for the collectives.  The other axes ("cells", "data",
    "pod") hold replicas, or a train step's own rows of the batch
    (``launch.train.make_mesh_train_step``), and need nothing here.  The
    reference's other knobs (sequence sharding, MoE dispatch groups over
    dp, remat offload, the expert axis) shard nothing under explicit
    tensor parallelism and are not taken (ROADMAP queue 1, item 7c, part
    3)."""
    tp_n = mesh_axes(mesh).get("model", 1)
    group = None
    if tp_n > 1 and hasattr(mesh, "get_group"):
        group = mesh.get_group("model")
    old = dict(_CTX)
    _CTX.update(active=True, tp_n=tp_n, group=group)
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(old)


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


def _all_reduce(x, op=dist.ReduceOp.SUM):
    """The sum (or ``op``) of ``x`` over the "model" sub-group, written
    into ``x`` (contiguous); under gloo a CUDA tensor goes through a host
    copy."""
    group = _group()
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
        return out.to(x.device) if host else out


def _own_slice(g, dim: int):
    """This rank's part of ``g`` along ``dim`` (M equal parts)."""
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
        return _own_slice(g, ctx.dim).contiguous(), None, None


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


def enter(cfg, part: str, x):
    """``x`` as it enters ``part``'s shard where ``cfg`` splits ``part``:
    the same tensor forward, and where autograd records, its gradient
    summed over "model" backward (each rank's shard contributes its part
    of the replicated input's gradient).  Call it once on each replicated
    tensor that a split sub-block reads."""
    if split(cfg, part) and _tracked(x):
        return _Enter.apply(x)
    return x


def reduce(cfg, part: str, x):
    """``x``, all-reduced over "model" where ``cfg`` splits ``part`` (a
    row-parallel product's partial sum), else as it is."""
    return model_all_reduce(x) if split(cfg, part) else x
