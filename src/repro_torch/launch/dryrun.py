"""Production-mesh dry run: what each (architecture x input shape) cell
costs one device, in the rank-local layout.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell's step against the production meshes, (16, 16) and (2, 16, 16), on
512 placeholder host devices, and reads XLA's memory and cost analyses
and the HLO's collectives.  The port has no compiler to ask: one process
plays one rank of the mesh and runs the cell's real step on meta tensors.

* **The rank.**  ``launch.mesh.fake_world(256 or 512, rank)`` joins a
  default group on torch's ``fake`` backend (collectives move nothing) and
  ``make_production_mesh`` lays the mesh over it.  The rank is the model
  rank whose view (``sharding.rank_view``) holds the largest arguments, at
  index 0 of every other axis; the record names it (``"rank"``).
* **The step.**  The rank's parameters, optimizer state, batch rows and
  cache under ``ShardingOptions`` (``arg_shardings``, the rank-local
  layout of ``launch.sharding``) are tensors on the meta device: shapes
  and dtypes, no storage, so nothing of the model's size is allocated.
  The cell's step is the port's own: ``launch.train.
  make_mesh_train_step``'s step, ``transformer.prefill``,
  ``transformer.decode_step``, run eagerly on them; the fake backend's
  collectives take them as they are.  Meta tensors are not CUDA tensors,
  so ``kernels.ops`` takes the plain path (the blocked attention above
  its threshold), which is what the reference compiles on its host
  devices (no Pallas there).  Fake CPU tensors
  (``torch._subclasses.fake_tensor.FakeTensorMode``) give the same
  figures but dispatch each op through Python: qwen3-0.6b's train_4k
  step took 85 s so, against 26 s on the meta device (one CPU core).
* **The record** has the reference's keys, measured so:

  * ``memory.argument_bytes``: the rank's arguments (parameters or their
    ZeRO-3 slices, moments, batch rows, cache);
  * ``memory.output_bytes``: the step's results;
  * ``memory.temp_bytes``: the peak of live storages while the step runs
    (each storage an op makes, counted until it is freed), less the
    arguments;
  * ``memory.alias_bytes``: the donated arguments, the parameters and
    moments (train) or the cache (decode);
  * ``flops``: ``torch.utils.flop_counter``'s formulas over the ops
    (matrix products and attention, as XLA's cost analysis counts
    them);
  * ``bytes_accessed``: the unfused sum of every aten op's reads and
    writes (its tensor inputs and outputs; views move nothing);
  * ``collectives``: ``shardctx.collective_ledger`` over the step, by the
    reference's kinds: bytes (each result's), ops, total, float32 bytes;
    ``bf16_wire_corrected_bytes`` equals ``total_bytes``, because the
    port's collectives carry their own types and there is no XLA:CPU
    upcast to correct;
  * ``lower_s``: building the rank's arguments and its step;
    ``compile_s``: running it on the meta device;

  and the port's own: ``rank``; ``ledger`` (each collective's kind,
  bytes, dtype, in order); ``policy_argument_bytes`` (the reference
  policy's per-device bytes of the same arguments) and
  ``departure_bytes`` (where the rank-local layout holds another amount:
  its documented departures, by leaf); ``options``, ``split`` and
  ``zero_leaves`` (the layout); ``cell`` (sequence, batch, layers).

* **Not ported: the HLO parsers** (``_shape_bytes``, ``_result_bytes``,
  ``collective_bytes``): they read XLA's HLO text, and the port's
  programs have none.  The ledger is their counterpart: an eager step
  issues every collective it makes, so no loop-trip multipliers are
  needed.

Cells under ``seq_shard`` run sequence-parallel (``shardctx.seq_parallel``):
the ledger shows each sub-block's input all-gathered over the sequence
and its partial output reduce-scattered where the baseline all-reduces.
A decode cell whose kv heads the "model" axis does not divide holds its
cache's sequence over "model", as the policy's ``cache_spec`` does
(``models.attention.SeqKVCache``).  Cells under ``expert_shard_dff`` or ``expert_mesh="data"``
(``--recommended`` gives the first for llama4's train and prefill) run
the MoE's data-axis collectives (``models.ffn``): the dispatched tokens
all-gathered and the partial outputs reduce-scattered over "data", or
both moved by all-to-alls.  Where a rank's rows are its share of the
batch, the dispatch groups and their counts span the data ranks, as in
a train step.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single --recommended
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun

``--mesh-shape 2x2`` (with ``--layers``, ``--batch``, ``--seq``) runs a
cell on a (data, model) mesh of that shape at a cut depth and size, as a
card run of ``launch.train`` on that mesh would hold it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch

from .. import _tree, shardctx
from ..configs.base import get_config, load_all
from ..models import transformer
from ..models.steps import default_microbatches
from . import sharding, specs
from .mesh import _device_mesh, fake_world, make_production_mesh

NAMES = {False: ("data", "model"), True: ("pod", "data", "model")}
SHAPE = {False: (16, 16), True: (2, 16, 16)}


class _RankMesh:
    """A shape-only mesh that answers as one rank of it: axis names,
    sizes and this rank's index on each (``place_params`` reads no
    more)."""

    def __init__(self, names: tuple, sizes: tuple, coords: dict):
        self.mesh_dim_names = names
        self._sizes, self._coords = sizes, coords

    def size(self, i: int) -> int:
        return self._sizes[i]

    def get_local_rank(self, axis) -> int:
        return self._coords.get(axis, 0)


def _nbytes(tree) -> int:
    tree = list(tree) if type(tree) is tuple else tree
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))


def _rows(mesh, shape) -> int:
    """The batch rows a rank takes: its share over the data axes where
    they divide the batch, else all of them (every data rank a replica)."""
    n = 1
    for a in ("pod", "data"):
        n *= shardctx.mesh_axes(mesh).get(a, 1)
    return shape.batch // n if shape.batch % n == 0 else shape.batch


def _microbatches(cfg, shape, opts, rows: int) -> int:
    mb = opts.microbatches or default_microbatches(cfg, shape.batch)
    return min(mb, rows)


def arg_shardings(mesh, cfg, shape: specs.ShapeSpec, args,
                  opts: sharding.ShardingOptions = sharding.BASELINE):
    """The rank-local layout of the cell's whole arguments ``args`` under
    ``opts``: a tree of ``sharding.NamedSharding`` for each argument,
    whose ``local`` gives the rank's share.  The decode cache is the
    rank's own (``specs.cache_specs`` of its view: its kv heads, its
    rows), which no sharding of the whole cache gives: its entry is None."""
    params_sh = sharding.params_shardings(mesh, cfg, args[0], opts)
    if shape.kind == "train":
        opt = args[1]
        opt_sh = type(opt)(
            step=sharding.NamedSharding(mesh, sharding.P()),
            mu=sharding.params_shardings(mesh, cfg, opt.mu, opts),
            nu=sharding.params_shardings(mesh, cfg, opt.nu, opts))
        return (params_sh, opt_sh,
                sharding.batch_shardings(mesh, cfg, args[2]))
    if shape.kind == "prefill":
        return (params_sh, sharding.batch_shardings(mesh, cfg, args[1]))
    return (params_sh, None, sharding.NamedSharding(mesh, sharding.P()))


def _local(shardings, tree):
    """Each leaf of ``tree`` as its sharding in ``shardings`` (the same
    structure) keeps it."""
    return _tree.map_tensors(lambda t, sh: sh.local(t), tree, shardings)


def rank_args(mesh, cfg, shape: specs.ShapeSpec, args,
              opts: sharding.ShardingOptions = sharding.BASELINE):
    """(the rank's arguments as meta tensors, its view): ``args`` through
    ``arg_shardings``; the batch the rank's rows; the decode cache its
    view's at its rows."""
    sh = arg_shardings(mesh, cfg, shape, args, opts)
    params = _local(sh[0], args[0])
    view = sharding.rank_config(mesh, cfg, opts)
    if shape.kind == "train":
        opt = type(args[1])(step=args[1].step,
                            mu=_local(sh[1].mu, args[1].mu),
                            nu=_local(sh[1].nu, args[1].nu))
        return (params, opt, _local(sh[2], args[2])), view
    if shape.kind == "prefill":
        return (params, _local(sh[1], args[1])), view
    rows = _rows(mesh, shape)
    cache = specs.cache_specs(view, shape, batch=rows)
    return (params, cache, specs.sds((rows,), torch.int32)), view


def build_step(cfg, shape: specs.ShapeSpec,
               opts: sharding.ShardingOptions = sharding.BASELINE,
               mesh=None):
    """(fn, the cell's whole arguments, donated argument indices): ``fn``
    takes the rank's arguments (``rank_args``) on ``mesh`` and runs the
    cell's step under ``shardctx.activation_sharding`` with ``opts``'
    knobs."""
    args = build_args(cfg, shape, specs.params_specs(cfg))
    view = sharding.rank_config(mesh, cfg, opts)
    knobs = sharding.context_knobs(opts)
    if shape.kind == "train":
        from .train import make_mesh_train_step
        mb = _microbatches(cfg, shape, opts, _rows(mesh, shape))
        _, step = make_mesh_train_step(mesh, view, microbatches=mb,
                                       opts=opts)

        def train_step(p, opt, rows):
            # make_mesh_train_step takes the logical batch and keeps its
            # rows: hand it a batch whose rows are this rank's
            n = shape.batch // rows["tokens"].shape[0]
            whole = {k: v.expand(n, *v.shape).reshape(-1, *v.shape[1:])
                     for k, v in rows.items()}
            return step(p, opt, whole)
        return train_step, args, (0, 1)
    # the rank's rows are its share of the batch, as in a train step
    knobs["data_rows"] = _rows(mesh, shape) < shape.batch
    if shape.kind == "prefill":
        s_max = specs.decoder_seq(cfg, shape) + specs.DECODE_MARGIN

        def prefill_step(p, batch):
            with shardctx.activation_sharding(mesh, **knobs):
                return transformer.prefill(p, view, batch, s_max=s_max)
        return prefill_step, args, ()

    def serve_step(p, cache, tokens):
        with shardctx.activation_sharding(mesh, **knobs):
            return transformer.decode_step(p, view, cache, tokens)
    return serve_step, args, (1,)


class _Meter(torch.utils._python_dispatch.TorchDispatchMode):
    """One dispatch mode for the step's counts: the unfused bytes of every
    aten op (its tensor inputs and outputs; views move nothing), its flops
    (``torch.utils.flop_counter``'s formulas, as ``FlopCounterMode``
    counts them), and the peak of live storages (each storage an op makes
    counted until it is freed) above ``base`` bytes already held.  One
    mode, not three: each op goes through Python once."""

    def __init__(self, base: int):
        super().__init__()
        self.bytes = self.flops = 0
        self.live = self.peak = int(base)
        self._sizes: dict = {}

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _made(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if func.namespace == "aten":
            if not func.is_view:
                ins = [t for t in torch.utils._pytree.tree_leaves(
                    (args, kwargs)) if isinstance(t, torch.Tensor)]
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
            count = flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self._made(t)
        return out


def policy_bytes(names, sizes, cfg, shape: specs.ShapeSpec, args, local,
                 opts: sharding.ShardingOptions = sharding.BASELINE):
    """(the policy's per-device bytes of the cell's arguments, {path: the
    policy's bytes less the rank's} where they differ): each whole leaf of
    ``args`` over its spec's axes (``param_spec`` for parameters and
    moments, ``batch_spec`` for the batch, ``cache_spec`` for the cache),
    beside the rank's own ``local``.  The differences are the rank-local
    layout's documented departures."""
    mesh = sharding._Axes(tuple(zip(names, sizes)))
    axes = dict(zip(names, sizes))

    def per_device(path, leaf):
        i = path.split("/", 1)[0]
        kind = {"train": ("p", "p", "b"), "prefill": ("p", "b"),
                "decode": ("p", "c", "t")}[shape.kind][int(i)]
        if kind == "p":
            spec = sharding.param_spec(mesh, cfg, path, tuple(leaf.shape),
                                       opts)
        elif kind == "b":
            spec = sharding.batch_spec(mesh, leaf)
        elif kind == "c":
            spec = sharding.cache_spec(mesh, path, leaf, shape.batch)
        else:
            spec = sharding.P()
        n = leaf.numel()
        for entry in tuple(spec):
            for a in (() if entry is None else (entry,) if isinstance(
                    entry, str) else entry):
                n //= axes[a]
        return n * leaf.element_size()

    want, got = {}, {}
    sharding.map_with_paths(lambda p, t: want.__setitem__(
        p, per_device(p, t)), list(args))
    sharding.map_with_paths(lambda p, t: got.__setitem__(
        p, t.numel() * t.element_size()), list(local))
    diff = {p: want[p] - got.get(p, 0) for p in want if want[p] != got.get(p)}
    return sum(want.values()), diff


def _mesh_of(multi_pod: bool, mesh_shape):
    if mesh_shape is not None:
        return ("data", "model"), tuple(mesh_shape)
    return NAMES[multi_pod], SHAPE[multi_pod]


def pick_rank(cfg, shape, opts, names, sizes, args) -> tuple:
    """(model rank, its argument bytes): the model rank whose share of
    ``args`` is largest (the lowest such), at index 0 elsewhere."""
    m = dict(zip(names, sizes)).get("model", 1)
    best = None
    for r in range(m):
        mesh = _RankMesh(names, sizes, {"model": r})
        local, _ = rank_args(mesh, cfg, shape, args, opts)
        nbytes = _nbytes(local)
        if best is None or nbytes > best[1]:
            best = (r, nbytes)
    return best


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: sharding.ShardingOptions = sharding.BASELINE, *,
             cfg=None, shape: specs.ShapeSpec | None = None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's record.  ``cfg`` / ``shape`` / ``mesh_shape`` (data,
    model) replace the registry's config, the shape table's entry and the
    production mesh (a cut cell, as a card run holds it)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = specs.SHAPES[shape_name] if shape is None else shape
    mesh_name = "multi" if multi_pod else "single"
    if mesh_shape is not None:
        mesh_name = "x".join(map(str, mesh_shape))
    ok, reason = specs.cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    names, sizes = _mesh_of(multi_pod, mesh_shape)
    n = 1
    for s in sizes:
        n *= s
    sharding.check_options(opts, _RankMesh(names, sizes, {}))
    t0 = time.time()
    params = specs.params_specs(cfg)
    whole = build_args(cfg, shape, params)
    rank, _ = pick_rank(cfg, shape, opts, names, sizes, whole)
    with fake_world(n, rank):
        mesh = (make_production_mesh(multi_pod=multi_pod)
                if mesh_shape is None else _device_mesh(sizes, names))
        fn, args, donate = build_step(cfg, shape, opts, mesh)
        local, view = rank_args(mesh, cfg, shape, args, opts)
        # the knobs' refusals, and the ZeRO-3 groups made before the step
        # runs (as a rank's first step would make them)
        with shardctx.activation_sharding(mesh,
                                          **sharding.context_knobs(opts)):
            for axes in sorted({axes for _, _, axes in view.zero}):
                shardctx.storage_group(axes)
            if view.zero:
                shardctx.storage_group(("data", "model"))
        arg_bytes = _nbytes(local)
        run_args = list(local)
        if shape.kind == "decode":
            run_args[1] = dict(run_args[1], pos=specs.decoder_seq(cfg, shape))
        t_lower = time.time() - t0
        held = run_args[:2] if shape.kind == "train" else run_args[:1]
        meter = _Meter(_nbytes(held))
        with shardctx.collective_ledger() as ledger, meter:
            out = fn(*run_args)
        t_run = time.time() - t0 - t_lower
        out_bytes = _nbytes(out)
    held_bytes = _nbytes(local[0]) + (_nbytes(local[1])
                                      if shape.kind == "train" else 0)
    peak = meter.peak
    alias = {"train": held_bytes, "prefill": 0,
             "decode": _nbytes(local[1])}[shape.kind]
    total_flops = float(meter.flops)
    policy, departures = policy_bytes(names, sizes, cfg, shape, args, local,
                                      opts)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "devices": n, "rank": rank, "status": "ok",
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": int(max(peak - held_bytes, 0)),
                   "alias_bytes": alias},
        "flops": total_flops,
        "bytes_accessed": float(meter.bytes),
        "cost_raw": {"flops": total_flops,
                     "bytes accessed": float(meter.bytes)},
        "collectives": shardctx.ledger_totals(ledger),
        "ledger": [list(e) for e in ledger],
        "policy_argument_bytes": policy,
        "departure_bytes": departures,
        "options": dataclasses.asdict(opts),
        "split": list(view.split), "zero_leaves": len(view.zero),
        "cell": {"seq": shape.seq, "batch": shape.batch,
                 "layers": cfg.n_layers},
    }


def build_args(cfg, shape, params):
    """The cell's whole arguments as stand-ins (``specs``)."""
    if shape.kind == "train":
        return (params, specs.opt_specs(cfg, params),
                specs.batch_specs(cfg, shape, train=True))
    if shape.kind == "prefill":
        return (params, specs.batch_specs(cfg, shape, train=False))
    return (params, specs.cache_specs(cfg, shape),
            specs.sds((shape.batch,), torch.int32))


def options_of(args) -> sharding.ShardingOptions:
    return sharding.ShardingOptions(
        tp_mode=args.tp_mode, expert_shard_dff=args.expert_dff,
        seq_shard=args.seq_shard, microbatches=args.microbatches,
        fsdp_override=None if args.fsdp is None else bool(args.fsdp),
        remat_offload=args.offload, expert_mesh=args.expert_mesh)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(specs.SHAPES) + [None])
    ap.add_argument("--mesh", type=str, default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="build/dryrun")
    ap.add_argument("--tp-mode", default="full",
                    choices=list(sharding.TP_MODES))
    ap.add_argument("--expert-dff", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--fsdp", type=int, default=None, choices=[0, 1],
                    help="force ZeRO-3 on/off (default: per-arch cfg)")
    ap.add_argument("--offload", action="store_true",
                    help="host-offload the remat carries")
    ap.add_argument("--expert-mesh", default="model",
                    choices=["model", "data"])
    ap.add_argument("--recommended", action="store_true",
                    help="per-arch options (sharding.recommended_options)")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--mesh-shape", default=None,
                    help="DATAxMODEL: a (data, model) mesh instead of the "
                         "production ones")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    opts = options_of(args)
    archs = sorted(load_all()) if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(specs.SHAPES) if args.shape is None else [args.shape]
    mesh_shape = None
    if args.mesh_shape:
        mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x"))
        meshes = [False]
    else:
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    written = []
    for arch in archs:
        cfg = get_config(arch)
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        for shape_name in shapes:
            shape = specs.SHAPES[shape_name]
            shape = dataclasses.replace(
                shape, batch=args.batch or shape.batch,
                seq=args.seq or shape.seq)
            for multi in meshes:
                mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                             else "multi" if multi else "single")
                tag = f"{arch}__{shape_name}__{mesh_name}"
                if args.tag:
                    tag += f"__{args.tag}"
                path = os.path.join(args.out, tag + ".json")
                written.append(path)
                if os.path.exists(path):
                    print(f"[skip-existing] {tag}", flush=True)
                    continue
                print(f"[run] {tag}", flush=True)
                try:
                    cell_opts = opts
                    if args.recommended:
                        cell_opts = sharding.recommended_options(
                            cfg, shape.kind)
                    result = run_cell(arch, shape_name, multi, cell_opts,
                                      cfg=cfg, shape=shape,
                                      mesh_shape=mesh_shape)
                except Exception:
                    result = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "status": "error",
                              "traceback": traceback.format_exc()}
                with open(path, "w") as f:
                    json.dump(result, f, indent=1)
                status = result["status"]
                extra = ""
                if status == "ok":
                    mem = result["memory"]
                    extra = (f" rank={result['rank']}"
                             f" args={mem['argument_bytes']:.3e}B"
                             f" temp={mem['temp_bytes']:.3e}B"
                             f" flops={result['flops']:.3e}"
                             f" coll={result['collectives']['total_bytes']:.3e}B"
                             f" run={result['compile_s']}s")
                print(f"[done] {tag}: {status}{extra}", flush=True)
    return written


if __name__ == "__main__":
    main()
