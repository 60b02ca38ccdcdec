"""Sharding policy: logical-axis rules -> partition specs for every leaf,
and the rank-local layout that the port's explicit tensor parallelism runs.

Port of ``repro/launch/sharding.py``.  Two things are kept apart:

* **The policy** (``param_spec``, ``cache_spec``, ``batch_spec``,
  ``validate_spec``, and ``serving.kvpool``'s ``_pool_leaf_spec``) is the
  reference's, copied rule for rule, and returns :class:`P`, a small tuple
  type of the port's own with the entries of a ``jax.sharding.
  PartitionSpec``: per dim None, a mesh axis name or a tuple of names.
  The reference's policy in its own words:

  * batch -> all DP axes ("pod", "data");
  * attention heads, FFN hidden, vocab, experts -> "model" (TP / EP);
  * params and optimizer moments additionally over "data" (FSDP/ZeRO-3)
    when ``cfg.fsdp``, experts keeping E on "model";
  * KV caches: batch -> "data", kv heads -> "model" when divisible, else
    the sequence axis -> "model";
  * anything that does not divide its mesh axis stays replicated.

* **The rank-local layout** (``place_params(mesh, cfg, params, opts)``):
  the shard of each weight that a rank holds and computes with, one
  process a rank, and the rank's ``shardctx.RankConfig``.  Under
  ``ShardingOptions``:

  * ``tp_mode`` chooses the sub-blocks split over "model"
    (``RankConfig.split``), as ``param_spec``'s ``layer_tp`` / ``moe_tp``
    do: "full" every one the policy splits, "vocab-only" the vocabulary
    alone (every layer whole on each model rank), "moe-only" the experts
    and the vocabulary;
  * ZeRO-3 storage (``cfg.fsdp``, or ``fsdp_override``): a leaf whose
    policy spec names "data" (or ("data", "model"), where layers take no
    TP) is stored as the rank's equal slice of its compute shard on that
    dim (``RankConfig.zero``), and gathered where it is used
    (``shardctx.gather_tree``); the optimizer moments mirror it.  The
    serving stack passes :data:`SERVING`, which stores nothing (every
    "data" replica holds its whole "model" shard, as the recommended
    decode options keep the weights resident); a caller that passes
    ZeRO-3 gets it in serving too (the dry run's prefill and decode
    cells);
  * ``expert_shard_dff``: each expert's F over "data" (its E over
    "model" where ``tp_mode`` splits the experts), the rank holding its F
    columns (``RankConfig.moe_data`` "dff", ``local_dff`` from
    ``dff_offset``); ``expert_mesh="data"``: the experts over "data"
    ("experts") and each one's F over "model" (``RankConfig.expert_mesh``;
    "moe" in ``split`` then means that F split).  A leaf so split over
    "data" is the rank's own: its gradient already sums every data
    rank's tokens (``launch.train.make_mesh_train_step`` scales it to the
    mean and syncs nothing), and a gather joins it over "data";
  * ``seq_shard``: sequence parallelism in Megatron's sense
    (``shardctx.seq_parallel``).  It moves no weight: in a full-sequence
    call whose length "model" divides, the residual stream between
    sub-blocks is the rank's block of the sequence; each sub-block
    all-gathers its input over the sequence and reduce-scatters its
    partial output, so attention, the scans and the experts still see
    the whole sequence of the rank's heads, channels or experts.  The
    norms run on the block, and so does a whole dense FFN; a whole
    sub-block that reads other positions (attention, a scan, the MoE)
    runs on the gathered sequence and keeps its block.  The gradients of
    those leaves are then the rank's rows' alone, and
    ``reduce_partial_grads(..., seq=True)`` sums them over "model"
    (:func:`seq_partial`).

  It departs from the policy where GSPMD would reshard behind the
  reference's back:

  * **The SSD's ``in_proj``** is one fused (d, 2 d_inner + 2 g n + h)
    matrix: 290 columns at reduced width, which ``param_spec`` splits at
    column 145 on a 2-way axis, not on a head boundary
    (``repro/models/ssm.py:50,54-62``).  The layout shards z, x and dt by
    SSD head and replicates B and C (g = 1); ``conv`` likewise (x by head,
    B and C whole), and ``gate_norm`` (replicated by the policy) by head.
    Where the heads do not divide the axis, the whole layer is replicated.
  * **Query heads that divide M over kv heads that do not** (recurrentgemma
    at 10/1, reduced hybrid-grs at 4/2 with M = 4, qwen1.5-110b's 64/8 on
    the 16-way production axis): the rank keeps the run of kv heads its
    query heads read and no other (columns of ``wk``/``wv``, which the
    policy replicates), so its KV cache holds just those (one kv head
    each at 64/8 over 16).  Where that run serves its kv heads unevenly
    (6/3 over 2: kv heads (0, 0, 1) and (1, 2, 2)), each local query head
    reads its own kv head (``models.attention._kv_for_q``); no uniform
    group is assumed.  Its dense and ring KV caches follow the policy
    (``cache_spec``): every kv head, for the rank's block of positions or
    ring slots (``shardctx.seq_caches``; ``models.attention``'s decode
    and chunk paths get the other ranks' kv heads of a new token by an
    all-gather); the paged pool keeps the run, as ``kvpool``'s policy
    does.
  * **The RG-LRU gates** take the full (R, R) ``w_r``/``w_i`` on the full
    u: the rank holds their columns (the policy's split) and u is
    all-gathered once a layer.
  * **Expert leaves under "moe-only" with ZeRO-3**: the policy names
    "model" twice (E over "model", d_model over ("data", "model"));
    the layout splits E over "model" and stores d_model over "data"
    alone.

``init_rank_params`` draws a rank's shard without the whole tree, one layer
at a time on the host.  ``place_params`` is idempotent: a ``RankConfig`` marks parameters that are
already the rank's, and they pass through.  On a mesh whose "model" axis
is 1 nothing is split and every tensor passes through as it is, so the
engine on a 1 x 1 mesh equals the engine without one bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any

import torch

from .. import _tree
from ..configs.base import ArchConfig
from ..shardctx import RankConfig, kv_run, mesh_axes
from ..runtime.checkpoint import _map_with_path


class P(tuple):
    """A partition spec: one entry a dim, each None (replicated), a mesh
    axis name, or a tuple of names (the dim split over their product).  As
    ``PartitionSpec`` does, an empty tuple of names is None and a tuple of
    one name is that name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:          # PartitionSpec's, so messages match
        return f"PartitionSpec{tuple.__repr__(self)}"


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    """Hillclimb knobs.  Defaults = the paper-faithful baseline (naive TP
    x DP everywhere)."""

    tp_mode: str = "full"          # "full" | "vocab-only" | "moe-only"
    expert_shard_dff: bool = False  # experts: shard F over data (keep EP resident)
    seq_shard: bool = False        # context parallelism: activations S -> model
    microbatches: int | None = None  # override models.steps.default_microbatches
    fsdp_override: bool | None = None  # force ZeRO-3 on/off (None = per-arch cfg)
    remat_offload: bool = False    # host-offload the remat carry stacks
    expert_mesh: str = "model"     # expert-parallel axis: "model" | "data"


BASELINE = ShardingOptions()
# the serving stack's layout: the model axis alone, weights resident
SERVING = ShardingOptions(fsdp_override=False)
TP_MODES = ("full", "vocab-only", "moe-only")


def context_knobs(opts: ShardingOptions) -> dict:
    """``shardctx.activation_sharding``'s keywords for ``opts``, as the
    reference's dry run passes them."""
    return dict(seq_shard=opts.seq_shard,
                moe_dp_groups=not (opts.expert_shard_dff
                                   or opts.expert_mesh == "data"),
                remat_offload=opts.remat_offload,
                expert_axis=opts.expert_mesh)


def check_options(opts: ShardingOptions, mesh=None) -> None:
    """Refuse the options the rank-local layout does not take: unknown
    modes."""
    if opts.tp_mode not in TP_MODES:
        raise ValueError(f"tp_mode {opts.tp_mode!r} is not one of {TP_MODES}")
    if opts.expert_mesh not in ("model", "data"):
        raise ValueError(f"expert_mesh {opts.expert_mesh!r} is not "
                         f"\"model\" or \"data\"")


def recommended_options(cfg, shape_kind: str) -> ShardingOptions:
    """The reference's per-family defaults: decode always baseline TP (the
    weights stay resident); MoE resident-expert layout only where expert
    params dominate (llama4 yes, moonshot no); enc-dec baseline for
    training; under 8 B parameters pure-DP layers with ZeRO over data (2
    microbatches for training); 90 B+ dense prefill pure-DP with ZeRO-2D,
    training baseline TP with 8 microbatches."""
    from ..profiling.roofline import param_count
    if shape_kind == "decode":
        return BASELINE
    if cfg.n_experts:
        expert_params = cfg.n_experts * (3 if cfg.gated_ffn else 2) \
            * cfg.d_model * cfg.resolved_moe_dff
        if expert_params * 2 > 8e9:        # bytes: resident layout pays off
            return ShardingOptions(
                tp_mode="moe-only", expert_shard_dff=True, remat_offload=True,
                microbatches=4 if shape_kind == "train" else None)
        return BASELINE
    if cfg.enc_layers and shape_kind == "train":
        return BASELINE
    n = param_count(cfg)
    if n < 8e9:
        return ShardingOptions(tp_mode="vocab-only", fsdp_override=True,
                               microbatches=2 if shape_kind == "train" else None)
    if shape_kind == "prefill":
        return ShardingOptions(tp_mode="vocab-only", fsdp_override=True)
    return ShardingOptions(microbatches=8)   # big-dense training: baseline TP


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

def _axis_size(mesh, name: str) -> int:
    return mesh_axes(mesh).get(name, 1)


def _shard_if(mesh, dim: int, axis):
    """Use ``axis`` (a mesh axis name or tuple of names) only if the dim
    divides evenly."""
    if axis is None:
        return None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    names = mesh_axes(mesh)
    n = 1
    for a in axes:
        if a not in names:
            return None
        n *= names[a]
    if dim % n != 0:
        return None
    return axis if isinstance(axis, str) else tuple(axes)


def _path_str(path) -> str:
    """A leaf's path as "a/b/0/c": ``path`` is such a string already, or a
    sequence of keys (strings, ints, or the reference's key objects)."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def param_spec(mesh, cfg, path: str, shape: tuple,
               opts: ShardingOptions = BASELINE) -> P:
    """Partition spec for one parameter identified by its tree path."""
    names = mesh_axes(mesh)
    use_fsdp = cfg.fsdp if opts.fsdp_override is None else opts.fsdp_override
    fsdp = "data" if (use_fsdp and "data" in names) else None
    stacked = bool(re.search(r"units/slot\d+", path)) and len(shape) >= 1
    lead: tuple = (None,) if stacked else ()
    body = shape[1:] if stacked else shape

    def spec(*axes):
        return P(*lead, *axes)

    name = path.rsplit("/", 1)[-1]
    layer_tp = opts.tp_mode == "full"        # TP on layer weights?
    moe_tp = opts.tp_mode in ("full", "moe-only")

    if name == "embed" or path.endswith("embed"):
        return P(_shard_if(mesh, shape[0], "model"),
                 _shard_if(mesh, shape[1], fsdp) if fsdp else None)
    if name == "head":
        return P(_shard_if(mesh, shape[0], fsdp) if fsdp else None,
                 _shard_if(mesh, shape[1], "model"))

    # Without layer TP, ZeRO-3 storage for layer weights can use both axes
    if fsdp and not layer_tp:
        fsdp = ("data", "model")

    if len(body) == 0:
        return spec()
    # MoE expert tensors: (E, D, F) / (E, F, D) -- E on the expert axis
    if name in ("wi", "wg") and len(body) == 3:
        if opts.expert_mesh == "data":   # EP over data, F over model
            return spec(_shard_if(mesh, body[0], "data"), None,
                        _shard_if(mesh, body[2], "model"))
        e_ax = _shard_if(mesh, body[0], "model") if moe_tp else None
        if opts.expert_shard_dff:   # keep weights resident, shard F over data
            return spec(e_ax, None, _shard_if(mesh, body[2], "data"))
        return spec(e_ax,
                    _shard_if(mesh, body[1], fsdp) if fsdp else None, None)
    if name == "wo" and len(body) == 3:
        if opts.expert_mesh == "data":
            return spec(_shard_if(mesh, body[0], "data"),
                        _shard_if(mesh, body[1], "model"), None)
        e_ax = _shard_if(mesh, body[0], "model") if moe_tp else None
        if opts.expert_shard_dff:
            return spec(e_ax, _shard_if(mesh, body[1], "data"), None)
        return spec(e_ax, None,
                    _shard_if(mesh, body[2], fsdp) if fsdp else None)
    if name == "router":
        return spec(_shard_if(mesh, body[0], fsdp) if fsdp else None, None)

    # attention / dense FFN 2D weights: attention projections shard on
    # "model" only when the head count divides the axis (head-granular TP)
    if name in ("wq", "wk", "wv", "w1", "w3", "w_x", "w_gate", "in_proj"):
        tp_ax = "model" if layer_tp else None
        if name in ("wq", "wk", "wv"):
            heads = cfg.n_heads if name == "wq" else (cfg.n_kv or cfg.n_heads)
            if heads % _axis_size(mesh, "model"):
                tp_ax = None
        return spec(_shard_if(mesh, body[0], fsdp) if fsdp else None,
                    _shard_if(mesh, body[1], tp_ax))
    if name in ("wo", "w2", "w_out", "out_proj"):
        tp_ax = "model" if layer_tp else None
        if name == "wo" and cfg.n_heads % _axis_size(mesh, "model"):
            tp_ax = None
        return spec(_shard_if(mesh, body[0], tp_ax),
                    _shard_if(mesh, body[1], fsdp) if fsdp else None)
    if name in ("w_r", "w_i"):   # RG-LRU channel-coupling gates
        return spec(None, _shard_if(mesh, body[1], "model") if layer_tp else None)
    if name in ("bq", "bk", "bv"):
        heads = cfg.n_heads if name == "bq" else (cfg.n_kv or cfg.n_heads)
        b_ax = ("model" if layer_tp
                and heads % _axis_size(mesh, "model") == 0 else None)
        return spec(_shard_if(mesh, body[0], b_ax))
    if name == "conv":
        return spec(None, _shard_if(mesh, body[1], "model") if layer_tp else None)
    if name in ("lam", "a_log", "dt_bias", "d_skip"):
        return spec(_shard_if(mesh, body[0], "model") if layer_tp else None)
    # norms / scalars / anything else: replicated (beyond the stack axis)
    return spec(*([None] * len(body)))


def batch_spec(mesh, leaf, *, shard_batch=True) -> P:
    """Partition spec for one token/embedding input leaf: batch over all DP
    axes when divisible, replicated otherwise."""
    names = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    if (not shard_batch or leaf.ndim == 0
            or leaf.shape[0] % _mesh_prod(mesh, dp) != 0):
        return P()
    return P(dp, *([None] * (len(leaf.shape) - 1)))


def _mesh_prod(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= _axis_size(mesh, a)
    return n


def cache_spec(mesh, path, leaf, batch: int) -> P:
    """Partition spec for one serving-cache leaf: KV tensors (units, B, S,
    KV, hd) or (B, S, KV, hd) put batch over DP when divisible (else the
    sequence over "data"), kv heads over "model" when divisible (else the
    sequence over "model"); recurrent states, ring positions and conv
    tails shard the batch dim only where the cache layout puts it."""
    names = mesh_axes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_n = _mesh_prod(mesh, dp)
    shape = leaf.shape
    p = _path_str(path)
    # exact leaf-name match: "conv" ends with "v"
    if leaf.ndim >= 4 and p.rsplit("/", 1)[-1] in ("k", "v"):
        stacked = leaf.ndim == 5
        lead = (None,) if stacked else ()
        b, s, kv, hd = shape[-4:]
        batch_ax = dp if b % dp_n == 0 else None
        seq_ax = None
        kv_ax = _shard_if(mesh, kv, "model")
        if kv_ax is None:
            seq_ax = _shard_if(mesh, s, "model")
        if batch_ax is None and seq_ax is None:
            seq_ax = _shard_if(mesh, s, "data")
        return P(*lead, batch_ax, seq_ax, kv_ax, None)
    if dp and batch % dp_n == 0 and leaf.ndim >= 1:
        if shape[0] == batch:
            return P(dp, *[None] * (leaf.ndim - 1))
        if leaf.ndim >= 2 and shape[1] == batch:
            return P(None, dp, *[None] * (leaf.ndim - 2))
    return P()


def validate_spec(mesh, shape: tuple, spec) -> list[str]:
    """Static invariants for one leaf's spec; returns error strings: every
    entry names axes that exist on the mesh, no mesh axis is consumed by
    more than one dimension, the spec is no longer than the leaf's rank,
    and every sharded dimension divides the product of its axis sizes."""
    names = mesh_axes(mesh)
    errs: list[str] = []
    entries = tuple(spec)
    if len(entries) > len(shape):
        return [f"spec {spec} has {len(entries)} entries for a "
                f"rank-{len(shape)} leaf"]
    used: dict[str, int] = {}
    for dim, axes in enumerate(entries):
        if axes is None:
            continue
        group = (axes,) if isinstance(axes, str) else tuple(axes)
        total = 1
        for a in group:
            if a not in names:
                errs.append(f"dim {dim}: unknown mesh axis {a!r}")
                continue
            if a in used:
                errs.append(f"mesh axis {a!r} consumed twice "
                            f"(dims {used[a]} and {dim})")
            else:
                used[a] = dim
            total *= names[a]
        if total > 1 and shape[dim] % total:
            errs.append(f"dim {dim} of shape {tuple(shape)} not divisible "
                        f"by {group} (={total})")
    return errs


# ---------------------------------------------------------------------------
# shardings: a spec on a mesh, and the shard of a leaf this rank keeps
# ---------------------------------------------------------------------------

def _coord(mesh, axis: str) -> int:
    """This rank's index on ``axis`` of a ``DeviceMesh``."""
    return mesh.get_local_rank(axis)


def _take_spec(mesh, spec, t):
    """This rank's block of ``t`` under ``spec``: each sharded dim cut into
    equal parts, the part at this rank's (row-major) index over its axes."""
    names = mesh_axes(mesh)
    for dim, axes in enumerate(tuple(spec)):
        if axes is None:
            continue
        group = (axes,) if isinstance(axes, str) else tuple(axes)
        n, at = 1, 0
        for a in group:
            at = at * names[a] + _coord(mesh, a)
            n *= names[a]
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, at * size, size)
    return t.contiguous()


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The rank-local compute layout of one config on one mesh."""
    cfg: ArchConfig          # the model's
    view: RankConfig         # the rank's
    m: int                   # ranks on "model"
    r: int                   # this rank's index on it
    coords: tuple = ()       # ((axis, size, this rank's index), ...)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's partition spec on ``mesh`` and the shard of the leaf this
    rank keeps (:meth:`local`): a parameter's by the rank-local compute
    layout (``layout`` and ``path`` set), any other leaf by its spec."""
    mesh: Any
    spec: P
    layout: _Layout | None = None
    path: str = ""

    def local(self, t):
        if self.layout is not None:
            return _store(self.layout, self.path,
                          _local_leaf(self.layout, self.path, t))
        return _take_spec(self.mesh, self.spec, t)


def _splits(m: int, cfg, opts: ShardingOptions = BASELINE) -> dict:
    """{sub-block: split?} on an ``m``-way "model" axis, from the policy's
    own conditions under ``opts`` (and the layout's, for "ssm"):
    ``tp_mode`` "vocab-only" keeps only "vocab", "moe-only" "moe" and
    "vocab"."""
    if m == 1:
        return {}
    layer_tp = opts.tp_mode == "full"
    moe_tp = opts.tp_mode in ("full", "moe-only")
    kinds = set(cfg.block_pattern) | set(cfg.tail_pattern) | (
        {"e"} if cfg.enc_layers else set())
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_headdim if cfg.ssm_headdim else 0
    out = {
        "attn": layer_tp and cfg.n_heads > 0 and cfg.n_heads % m == 0
        and bool(kinds - {"r", "s"}),
        "ffn": layer_tp and cfg.d_ff > 0 and cfg.d_ff % m == 0
        and bool(kinds - {"m", "s"}),
        "shared": layer_tp and "m" in kinds and cfg.shared_expert
        and cfg.resolved_moe_dff % m == 0,
        # the experts over "model", or under expert_mesh="data" their F
        "moe": "m" in kinds and (
            cfg.resolved_moe_dff % m == 0 if opts.expert_mesh == "data"
            else moe_tp and cfg.n_experts % m == 0),
        "rglru": layer_tp and "r" in kinds
        and cfg.resolved_rnn_width % m == 0,
        "ssm": layer_tp and "s" in kinds and heads > 0 and heads % m == 0,
        "vocab": cfg.vocab % m == 0,
    }
    return {k: v for k, v in out.items() if v}


def rank_config(mesh, cfg, opts: ShardingOptions = BASELINE) -> RankConfig:
    """This rank's view of ``cfg`` on ``mesh`` under ``opts`` (see
    ``shardctx.RankConfig``); a ``RankConfig`` is returned as it is."""
    if isinstance(cfg, RankConfig):
        return cfg
    m = _axis_size(mesh, "model")
    view = rank_view(cfg, m, _coord(mesh, "model") if m > 1 else 0, opts)
    sizes = tuple(sorted(mesh_axes(mesh).items()))
    over = {}
    n = _axis_size(mesh, "data")
    how = _moe_data(cfg, n, opts)
    if how:
        at = _coord(mesh, "data")
        if how == "dff":
            f = cfg.resolved_moe_dff // n
            over.update(moe_data=how, local_dff=f, dff_offset=at * f)
        else:
            e = cfg.n_experts // n
            over.update(moe_data=how, local_experts=e, expert_offset=at * e)
    return dataclasses.replace(
        view, zero=_zero_table(cfg, sizes, opts, view.split), whole=cfg,
        **over)


def _moe_data(cfg, n: int, opts: ShardingOptions) -> str:
    """What an ``n``-way "data" axis splits of ``cfg``'s expert leaves
    under ``opts``, as the policy's specs say: "experts" (E,
    ``expert_mesh="data"``), "dff" (each expert's F,
    ``expert_shard_dff``) or "" (nothing, or a dim it does not divide)."""
    if n == 1 or not cfg.n_experts:
        return ""
    if opts.expert_mesh == "data":
        return "experts" if cfg.n_experts % n == 0 else ""
    if opts.expert_shard_dff and cfg.resolved_moe_dff % n == 0:
        return "dff"
    return ""


def rank_view(cfg, m: int, r: int,
              opts: ShardingOptions = BASELINE) -> RankConfig:
    """Rank ``r``'s view of ``cfg`` on an ``m``-way "model" axis under
    ``opts``' ``tp_mode`` (no ZeRO-3 storage: ``rank_config`` adds it)."""
    split = _splits(m, cfg, opts)
    base = {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(ArchConfig)}
    over: dict = dict(model_rank=r, model_size=m, split=tuple(sorted(split)),
                      whole=cfg,
                      head_dim=cfg.resolved_head_dim,
                      moe_dff=cfg.resolved_moe_dff if cfg.n_experts
                      else cfg.moe_dff)
    if "attn" in split:
        h = cfg.n_heads // m
        over["n_heads"] = h
        if cfg.n_kv % m == 0:
            over["n_kv"] = cfg.n_kv // m
            over["kv_offset"] = r * (cfg.n_kv // m)
        else:   # the kv heads this rank's query heads read, and no others
            kv = kv_run(cfg.n_heads, cfg.n_kv, m, r)
            n = kv[-1] + 1 - kv[0]
            over["n_kv"], over["kv_offset"] = n, kv[0]
            if h % n or any(k - kv[0] != j // (h // n)
                            for j, k in enumerate(kv)):
                over["q_kv"] = tuple(k - kv[0] for k in kv)
    if "ffn" in split:
        over["d_ff"] = cfg.d_ff // m
    if "rglru" in split:
        over["rnn_width"] = cfg.resolved_rnn_width // m
    if "ssm" in split:
        over["ssm_heads"] = cfg.ssm_expand * cfg.d_model \
            // cfg.ssm_headdim // m
    if cfg.n_experts:
        over["expert_mesh"] = opts.expert_mesh
        over["local_dff"] = cfg.resolved_moe_dff
    if "moe" in split and opts.expert_mesh == "data":
        over["local_experts"] = cfg.n_experts
        over["local_dff"] = cfg.resolved_moe_dff // m
        over["dff_offset"] = r * (cfg.resolved_moe_dff // m)
    elif "moe" in split:
        over["local_experts"] = cfg.n_experts // m
        over["expert_offset"] = r * (cfg.n_experts // m)
    if "vocab" in split:
        over["local_vocab"] = cfg.vocab // m
        over["vocab_offset"] = r * (cfg.vocab // m)
    return RankConfig(**{**base, **over})


def _part(t, dim: int, r: int, m: int):
    """Part ``r`` of ``m`` equal parts of ``t`` along ``dim``, contiguous."""
    size = t.shape[dim] // m
    return t.narrow(dim, r * size, size).contiguous()


def _ssm_columns(cfg, r: int, m: int, conv: bool) -> list[int]:
    """The columns of the fused ``in_proj`` (z | x | B | C | dt), or of
    ``conv`` (x | B | C), that rank ``r`` of ``m`` keeps: its heads' z, x
    and dt, and all of B and C."""
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // cfg.ssm_headdim
    gn = cfg.ssm_state            # one B/C group
    dl, hl = d_in // m, h // m
    mine = list(range(r * dl, (r + 1) * dl))
    if conv:
        return mine + list(range(d_in, d_in + 2 * gn))
    return (mine + [d_in + c for c in mine]
            + list(range(2 * d_in, 2 * d_in + 2 * gn))
            + list(range(2 * d_in + 2 * gn + r * hl,
                         2 * d_in + 2 * gn + (r + 1) * hl)))


def _kv_heads(view: RankConfig, t, dim: int, width: int = 1):
    """The rank's kv heads (``view.kv_offset`` on, ``view.n_kv`` of them)
    of ``t``, whose ``dim`` holds every kv head ``width`` entries each;
    ``t`` itself where the rank reads every kv head."""
    if view.n_kv * width == t.shape[dim]:
        return t
    return t.narrow(dim, view.kv_offset * width,
                    view.n_kv * width).contiguous()


def _rule(lay: _Layout, path: str) -> tuple:
    """How the rank-local layout cuts the parameter at ``path``:
    ("whole",) where every rank holds all of it, ("part", dim) for the
    rank's equal contiguous part along ``dim``, ("kv", width) for the run
    of kv heads on the last dim (``width`` entries a head), ("cols", conv)
    for the SSD's fused columns (``_ssm_columns``)."""
    split = lay.view.split
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    if name == "embed" and "vocab" in split:
        return ("part", 0)
    if name == "head" and "vocab" in split:
        return ("part", -1)
    if parent in ("attn", "xattn") and "attn" in split:
        if name in ("wq", "bq"):
            return ("part", -1)
        if name in ("wk", "wv", "bk", "bv"):
            return ("kv", lay.cfg.resolved_head_dim)
        if name == "wo":
            return ("part", -2)
    if parent in ("ffn", "shared") and parent in split:
        if name in ("w1", "w3"):
            return ("part", -1)
        if name == "w2":
            return ("part", -2)
    if parent == "moe" and "moe" in split and name in ("wi", "wg", "wo"):
        if lay.view.expert_mesh == "data":      # each expert's F
            return ("part", -2 if name == "wo" else -1)
        return ("part", -3)
    if parent == "rglru" and "rglru" in split:
        if name in ("w_x", "w_gate", "conv", "w_r", "w_i", "lam"):
            return ("part", -1)
        if name == "w_out":
            return ("part", -2)
    if parent == "ssm" and "ssm" in split:
        if name in ("in_proj", "conv"):
            return ("cols", name == "conv")
        if name in ("a_log", "dt_bias", "d_skip", "gate_norm"):
            return ("part", -1)
        if name == "out_proj":
            return ("part", -2)
    return ("whole",)


def expert_data_dim(view: RankConfig, path: str):
    """The dim of the leaf at ``path`` that "data" splits in ``view``'s
    layout (an expert leaf's E or F, ``RankConfig.moe_data``), or None."""
    how = view.moe_data
    parts = path.split("/")
    if not how or len(parts) < 2 or parts[-2] != "moe" \
            or parts[-1] not in ("wi", "wg", "wo"):
        return None
    if how == "experts":
        return -3
    return -2 if parts[-1] == "wo" else -1


def _local_leaf(lay: _Layout, path: str, t):
    """The shard of parameter ``t`` (at ``path``) that the rank computes
    with; the tensor itself where the rank holds all of it."""
    dim = expert_data_dim(lay.view, path)
    if dim is not None:
        coords = {a: (n, c) for a, n, c in lay.coords}
        t = _part(t, dim, coords["data"][1], coords["data"][0])
    rule = _rule(lay, path)
    if rule[0] == "part":
        return _part(t, rule[1], lay.r, lay.m)
    if rule[0] == "kv":
        return _kv_heads(lay.view, t, -1, rule[1])
    if rule[0] == "cols":
        cols = torch.tensor(_ssm_columns(lay.cfg, lay.r, lay.m, rule[1]),
                            device=t.device)
        return t.index_select(-1, cols)
    return t


def _layout(mesh, cfg, opts: ShardingOptions = BASELINE) -> _Layout:
    check_options(opts, mesh)
    view = rank_config(mesh, cfg, opts)
    sizes = mesh_axes(mesh)
    coords = tuple((a, n, _coord(mesh, a) if n > 1 else 0)
                   for a, n in sizes.items())
    return _Layout(cfg=cfg, view=view, m=view.model_size, r=view.model_rank,
                   coords=coords)


class _Axes:
    """A shape-only mesh: axis names and sizes, for ``param_spec``."""

    def __init__(self, sizes: tuple):
        self.axis_names = tuple(a for a, _ in sizes)
        self.shape = dict(sizes)


@functools.lru_cache(maxsize=64)
def _leaf_shapes(cfg) -> tuple:
    """((path, shape), ...) of ``cfg``'s whole parameters (a meta tree)."""
    from ..models import transformer
    out: list = []
    map_with_paths(lambda path, t: out.append((path, tuple(t.shape))),
                   transformer.init_params(0, cfg, "meta"))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _zero_table(cfg, sizes: tuple, opts: ShardingOptions,
                split: tuple) -> tuple:
    """``RankConfig.zero`` of ``cfg`` on a mesh of axis ``sizes`` under
    ``opts``: each leaf whose policy spec names "data" is stored on that
    dim over the entry's axes, "model" dropped where the layout splits
    the leaf over "model" already; axes of one rank in all store
    nothing, and an expert leaf that the layout splits over "data" for
    its computation (``RankConfig.moe_data``) stores no slice of it."""
    mesh = _Axes(sizes)
    names = dict(sizes)
    use_fsdp = cfg.fsdp if opts.fsdp_override is None else opts.fsdp_override
    if not use_fsdp or "data" not in names:
        return ()
    m = names.get("model", 1)
    view = dataclasses.replace(rank_view(cfg, m, 0, opts),
                               moe_data=_moe_data(cfg, names["data"], opts))
    lay = _Layout(cfg=cfg, view=view, m=m, r=0)
    out = []
    for path, shape in _leaf_shapes(cfg):
        if expert_data_dim(view, path) is not None:   # a compute split
            continue
        spec = tuple(param_spec(mesh, cfg, path, shape, opts))
        for dim, entry in enumerate(spec):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if "data" not in axes:
                continue
            if "model" in axes and _rule(lay, path)[0] != "whole":
                axes = tuple(a for a in axes if a != "model")
            n = 1
            for a in axes:
                n *= names[a]
            if n > 1 and shape[dim] % n == 0:
                out.append((path, dim - len(shape), axes))
    return tuple(out)


def _store(lay: _Layout, path: str, t):
    """The rank's ZeRO-3 slice of its compute shard ``t`` where the layout
    stores the leaf at ``path`` so; ``t`` itself elsewhere."""
    from ..shardctx import zero_entry
    entry = zero_entry(lay.view, path)
    if entry is None:
        return t
    dim, axes = entry
    coords = {a: (n, c) for a, n, c in lay.coords}
    n, at = 1, 0
    for a in axes:
        at = at * coords[a][0] + coords[a][1]
        n *= coords[a][0]
    return _part(t, dim, at, n)


def map_with_paths(fn, tree):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, ``path`` the
    leaf's "units/slot0/attn/wq" string (dict keys, list indices and
    named-tuple fields joined by "/", as ``_path_str`` makes them)."""
    return _map_with_path(lambda key, leaf: fn(_strip(key), leaf), tree)


def _strip(key: str) -> str:
    """A checkpoint key's "units/slot0/attn/wq" path."""
    return "/".join(p.split(":", 1)[1] for p in key.split("/"))


def params_shardings(mesh, cfg, params: Any,
                     opts: ShardingOptions = BASELINE):
    """A tree of :class:`NamedSharding`, one a parameter leaf: the policy's
    spec (``param_spec`` under ``opts``) and the rank-local shard it keeps
    (its ZeRO-3 slice where it has one).  ``params`` need only give each
    leaf's shape (a tree on the meta device does; a tree of moments or of
    (params, moments) takes the same layout).  On a ``("cells",
    "model")`` mesh weights replicate across "cells" (each cells row
    holds a full replica) and split their head/FFN/vocab dims over
    "model"."""
    lay = _layout(mesh, cfg, opts)
    return map_with_paths(
        lambda path, leaf: NamedSharding(
            mesh, param_spec(mesh, cfg, path, tuple(leaf.shape), opts), lay,
            path), params)


def place_params(mesh, cfg, params, opts: ShardingOptions = BASELINE):
    """(this rank's shard of ``params`` under ``opts``, its
    ``RankConfig``): the entry into tensor parallelism and ZeRO-3 storage.
    Every rank passes the whole parameter tree (the same weights); the
    shards are contiguous copies, so the caller may drop the whole tree
    after.  ``cfg`` already a ``RankConfig`` means ``params`` are the
    rank's (from :func:`init_rank_params` or a ``restore`` with
    ``params_shardings``, which never hold a whole tree): both pass
    through."""
    if isinstance(cfg, RankConfig):
        if cfg.model_size != _axis_size(mesh, "model"):
            raise ValueError(
                f"parameters placed for a {cfg.model_size}-way model axis "
                f"given a mesh whose model axis is "
                f"{_axis_size(mesh, 'model')}")
        return params, cfg
    lay = _layout(mesh, cfg, opts)
    return map_with_paths(
        lambda path, t: _store(lay, path, _local_leaf(lay, path, t)),
        params), lay.view


def _view_layout(view: RankConfig) -> _Layout:
    """The layout that ``view``, a rank's view, belongs to."""
    return _Layout(cfg=view.whole, view=view, m=view.model_size,
                   r=view.model_rank)


def _ssm_bc(cfg, m: int, conv: bool) -> slice:
    """The B and C columns among a rank's ``_ssm_columns``: every rank
    holds them."""
    dl = cfg.ssm_expand * cfg.d_model // m
    first = dl if conv else 2 * dl
    return slice(first, first + 2 * cfg.ssm_state)


def _whole_shape(lay: _Layout, path: str, shape) -> tuple:
    """The whole parameter's shape, from the shape of a rank's shard."""
    rule, shape = _rule(lay, path), list(shape)
    cfg = lay.cfg
    if rule[0] == "part":
        shape[rule[1]] *= lay.m
    elif rule[0] == "kv":
        shape[-1] = cfg.n_kv * rule[1]
    elif rule[0] == "cols":
        d_in = cfg.ssm_expand * cfg.d_model
        shape[-1] = d_in + 2 * cfg.ssm_state + (
            0 if rule[1] else d_in + d_in // cfg.ssm_headdim)
    return tuple(shape)


def _owned_index(lay: _Layout, path: str) -> tuple | None:
    """(positions in the rank's shard, positions in the whole last dim)
    of the entries the rank owns of a "kv" or "cols" leaf, which several
    ranks hold (the lowest holder owns an entry); None for any other
    rule."""
    rule = _rule(lay, path)
    if rule[0] == "kv":
        first, stop = lay.view.kv_offset, lay.view.kv_offset + lay.view.n_kv
        if lay.r > 0:
            prev = rank_view(lay.cfg, lay.m, lay.r - 1)
            first = max(first, prev.kv_offset + prev.n_kv)
        w, at = rule[1], lay.view.kv_offset
        return (torch.arange((first - at) * w, (stop - at) * w),
                torch.arange(first * w, stop * w))
    if rule[0] == "cols":
        cols = torch.tensor(_ssm_columns(lay.cfg, lay.r, lay.m, rule[1]))
        keep = torch.ones(len(cols), dtype=torch.bool)
        if lay.r > 0:
            keep[_ssm_bc(lay.cfg, lay.m, rule[1])] = False
        return torch.arange(len(cols))[keep], cols[keep]
    return None


def gather_params(view: RankConfig, tree):
    """The inverse of ``place_params``: every rank's shards of ``tree``
    (parameters, or a tree shaped like them, such as Adam's moments) joined
    into the whole tree, on every rank of the active "model" sub-group
    (``shardctx.activation_sharding``).  ``view`` a plain config: ``tree``
    is already whole.  See :func:`gathered_leaves`."""
    if not _sharded(view):
        return tree
    lay = _view_layout(view)
    return map_with_paths(lambda path, t: _whole_leaf(lay, path, t), tree)


def gathered_leaves(view: RankConfig, tree):
    """Each leaf of ``tree`` whole, one at a time, in the tree's order:
    ``(key, leaf)``, ``key`` the checkpoint's (``runtime.checkpoint``), so
    a device holds one whole leaf at a time (a checkpoint writes each as
    it comes).  Every rank of the active "model" sub-group iterates to the
    end: each leaf is a collective.  ``view`` a plain config: the leaves
    as they are."""
    items: list = []
    _map_with_path(lambda key, t: items.append((key, t)), tree)
    if not _sharded(view):
        yield from items
        return
    lay = _view_layout(view)
    for key, t in items:
        yield key, _whole_leaf(lay, _strip(key), t)


def _sharded(view) -> bool:
    """Whether ``view`` holds anything less than the whole model."""
    return isinstance(view, RankConfig) and (
        view.model_size > 1 or bool(view.zero) or bool(view.moe_data))


def _whole_leaf(lay: _Layout, path: str, t):
    """The whole leaf of a rank's shard ``t``.  A ZeRO-3 slice is first
    all-gathered over its storage axes; an equal part is all-gathered;
    the kv-head runs and the SSD's fused columns, which several ranks
    hold, are summed over the ranks from each entry's owner alone, so the
    sum is exact.  An expert leaf split over "data" is all-gathered over
    it."""
    from ..shardctx import (data_all_gather, gather_tree, model_all_gather,
                            model_all_reduce, param_path)
    with torch.no_grad():
        t = gather_tree(lay.view, param_path(path), t)
        dim = expert_data_dim(lay.view, path)
        if dim is not None:
            t = data_all_gather(t, dim)
    if lay.m == 1:
        return t
    rule = _rule(lay, path)
    if rule[0] == "whole":
        return t
    if rule[0] == "part":
        return model_all_gather(t, rule[1])
    out = t.new_zeros(_whole_shape(lay, path, t.shape))
    local, at = _owned_index(lay, path)
    out.index_copy_(-1, at.to(t.device), t.index_select(-1, local.to(t.device)))
    return model_all_reduce(out)


def _partial_grad(lay: _Layout, path: str):
    """Where the gradient of a leaf is summed over ranks: the slice of its
    last dim that every rank holds and reads inside a split sub-block
    (each rank then computes part of its gradient), "kv" for a kv-head
    run that several ranks hold, None where each rank's gradient is
    already whole (a shard of its own, or a replicated leaf read outside
    the split sub-blocks)."""
    split, cfg = lay.view.split, lay.cfg
    parts = path.split("/")
    name, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if parent in ("attn", "xattn") and "attn" in split:
        if name in ("q_norm", "k_norm"):
            return slice(None)
        if name in ("wk", "wv", "bk", "bv") and cfg.n_kv % lay.m:
            return "kv"
    if parent == "ssm" and "ssm" in split and name in ("in_proj", "conv"):
        return _ssm_bc(cfg, lay.m, name == "conv")
    return None


def seq_partial(view: RankConfig, path: str) -> bool:
    """Whether, under sequence parallelism (``seq_shard``), the gradient of
    the leaf at ``path`` is the rank's rows' alone, so that the sum over
    "model" is the whole one: every norm scale of the decoder stack
    (``norm1``, ``norm2``, ``norm_x``, the SSD's ``norm``,
    ``final_norm``), which runs on the rank's block, and each leaf of a
    sub-block the layout leaves whole (its output is the rank's block).
    The embedding's, the router's and the head's gradients are whole on
    every rank, and the encoder runs no sequence parallelism."""
    parts = path.split("/")
    if parts[0] == "encoder":
        return False
    if path == "final_norm":
        return True
    name, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if name in ("norm1", "norm2", "norm_x") or (parent, name) == ("ssm",
                                                               "norm"):
        return True
    part = {"xattn": "attn"}.get(parent, parent)
    if part == "moe":
        return name in ("wi", "wg", "wo") and "moe" not in view.split
    return (part in ("attn", "ffn", "shared", "rglru", "ssm")
            and part not in view.split)


def reduce_partial_grads(view: RankConfig, grads, *, seq: bool = False):
    """``grads`` with the gradients that ranks hold in part summed over
    the active "model" sub-group (one all-reduce a dtype): the QK-norm
    scales, which each rank applies to its own heads; the SSD's B and C
    columns, which each rank's heads read; a kv head that several ranks'
    query heads read; and with ``seq`` (the step ran under sequence
    parallelism) the leaves of :func:`seq_partial`, but for a ZeRO-3
    slice stored over "model", whose gather's backward summed it over
    "model" already.  Every other gradient is already the rank's whole
    share: its own shard's, or a replicated leaf's that the replicated
    residual stream gives every rank in full."""
    if not isinstance(view, RankConfig) or view.model_size == 1:
        return grads
    from ..shardctx import model_all_reduce, zero_entry
    from .mesh import pack, unpack
    lay = _view_layout(view)
    at = view.kv_offset * lay.cfg.resolved_head_dim
    picks: dict = {}

    def take(path, g):
        where = _partial_grad(lay, path)
        if seq and seq_partial(view, path):
            entry = zero_entry(view, path)
            if entry is not None and "model" in entry[1]:
                return g
            where = slice(None)
        if where == "kv":         # the rank's run within all the kv heads
            part = g.new_zeros(_whole_shape(lay, path, g.shape))
            part[..., at:at + g.shape[-1]] = g
            picks[path] = (where, part)
        elif where is not None:
            picks[path] = (where, g[..., where].contiguous())
        return g

    map_with_paths(take, grads)
    if not picks:
        return grads
    buffers, layout = pack([part for _, part in picks.values()])
    for dt in buffers:
        buffers[dt] = model_all_reduce(buffers[dt])
    summed = dict(zip(picks, unpack(buffers, layout)))

    def put(path, g):
        if path not in summed:
            return g
        where, s = picks[path][0], summed[path]
        if where == "kv":
            return s[..., at:at + g.shape[-1]].clone()
        g = g.clone()
        g[..., where] = s
        return g

    return map_with_paths(put, grads)


def global_norm(view: RankConfig, tree) -> torch.Tensor:
    """The global norm of a tree whose leaves are this rank's shards of
    the whole model's (``place_params``), in float32, the same on every
    rank: each rank sums the squares of the entries it owns (its own
    parts; a replicated leaf is rank 0's; an entry several ranks hold is
    its lowest holder's), and the sums are added over "model".  Where the
    view stores ZeRO-3 slices, a slice's entries are its rank's (over
    ("data", "model") every rank's slice is its own; over "data" the
    model rule above picks among the slices' holders), a leaf the data
    ranks replicate is data rank 0's, and the sums are added over
    ("data", "model").  So is an expert leaf that "data" splits
    (``RankConfig.moe_data``): each data rank's part is its own."""
    from ..shardctx import axes_coord, model_all_reduce, storage_all_reduce
    from ..shardctx import zero_entry
    lay = _view_layout(view)
    total = []
    over_data = bool(view.zero) or bool(view.moe_data)
    data0 = not over_data or axes_coord(("data",)) == 0

    def add(path, g):
        entry = zero_entry(view, path)
        if (entry is None and not data0
                and expert_data_dim(view, path) is None):
            return g
        if entry is None or "model" not in entry[1]:
            if _rule(lay, path)[0] == "whole" and lay.r > 0:
                return g
            owned = _owned_index(lay, path)
            if owned is not None:
                g = g.index_select(-1, owned[0].to(g.device))
        total.append(torch.sum(torch.square(g.float())))
        return g

    map_with_paths(add, tree)
    device = _tree.leaves(tree)[0].device
    ss = torch.stack(total).sum() if total else torch.zeros((), device=device)
    if over_data:
        return torch.sqrt(storage_all_reduce(ss.reshape(1),
                                             ("data", "model"))[0])
    return torch.sqrt(model_all_reduce(ss.reshape(1))[0])


def init_rank_params(seed, mesh, cfg, device=None,
                     opts: ShardingOptions = BASELINE):
    """(this rank's shard of ``models.transformer.init_params(seed, cfg,
    "cpu")`` on ``device`` under ``opts``, its ``RankConfig``), what
    ``place_params`` of that whole tree gives, without the whole tree: the
    host draws one layer at a time and keeps each leaf's shard, which
    alone goes to ``device``.  So a model larger than one card is placed
    over the mesh; the host holds one layer (and the embedding) at
    most."""
    from ..device import resolve_device
    from ..models import transformer
    device = resolve_device(device)
    lay = _layout(mesh, cfg, opts)
    params = transformer.init_params(
        seed, cfg, "cpu",
        keep=lambda path, t: _store(lay, path, _local_leaf(lay, path, t))
        .contiguous().to(device))
    return params, lay.view


def batch_shardings(mesh, cfg, batch_shape: Any, *, shard_batch=True):
    """Token/embedding inputs: batch over all DP axes (when divisible)."""
    return map_with_paths(
        lambda _, leaf: NamedSharding(mesh, batch_spec(
            mesh, leaf, shard_batch=shard_batch)), batch_shape)


def cache_shardings(mesh, cfg, cache_shape: Any, batch: int):
    """Serving-cache shardings by ``cache_spec``."""
    return map_with_paths(
        lambda path, leaf: NamedSharding(
            mesh, cache_spec(mesh, path, leaf, batch)), cache_shape)


def replicated(mesh, tree: Any):
    return map_with_paths(lambda _, leaf: NamedSharding(mesh, P()), tree)
