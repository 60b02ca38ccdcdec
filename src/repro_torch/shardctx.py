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
      vocabulary row the rank holds.
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


def split(cfg, part: str) -> bool:
    """Whether ``cfg`` (a ``RankConfig``) holds only its shard of
    ``part``; a plain ``ArchConfig`` holds everything."""
    return isinstance(cfg, RankConfig) and part in cfg.split


@contextlib.contextmanager
def activation_sharding(mesh):
    """Activate the mesh's "model" axis: its size and this rank's "model"
    sub-group, for the collectives.  The other axes
    ("cells", "data", "pod") hold replicas and need nothing here.  The
    reference's other knobs (sequence sharding, MoE dispatch groups over
    dp, remat offload, the expert axis) shard nothing under explicit
    tensor parallelism and are not taken: they come with the training
    half of the model axis (ROADMAP queue 1, item 7c)."""
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


def model_all_reduce(x):
    """The sum of ``x`` over the "model" sub-group, in ``x``'s dtype.  A
    fresh tensor is reduced in place and returned; under gloo a CUDA
    tensor goes through a host copy."""
    group = _group()
    with torch.profiler.record_function("model_all_reduce"):
        x = x.contiguous()
        if x.is_cuda and _on_host(group):
            buf = x.cpu()
            dist.all_reduce(buf, group=group)
            return x.copy_(buf)
        dist.all_reduce(x, group=group)
        return x


def model_all_gather(x, dim: int = -1):
    """Every rank's ``x`` of the "model" sub-group, concatenated along
    ``dim`` in rank order."""
    group = _group()
    with torch.profiler.record_function("model_all_gather"):
        host = x.is_cuda and _on_host(group)
        buf = (x.cpu() if host else x).contiguous()
        parts = [torch.empty_like(buf) for _ in range(_CTX["tp_n"])]
        dist.all_gather(parts, buf, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if host else out


def reduce(cfg, part: str, x):
    """``x``, all-reduced over "model" where ``cfg`` splits ``part`` (a
    row-parallel product's partial sum), else as it is."""
    return model_all_reduce(x) if split(cfg, part) else x
