"""Rank bodies for ZeRO-3 training over a (data, model) mesh
(tests/test_torch_zero_train.py, tests/test_torch_dryrun.py): each runs
inside a world that ``repro_torch.launch.mesh.run_world`` spawns (gloo,
CPU) and returns numpy trees.  Imports no JAX: the reference's parameters
arrive as numpy arguments.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

import _model_axis_train as mt
from repro_torch import shardctx
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import sharding, train
from repro_torch.launch.mesh import _device_mesh
from repro_torch.models import transformer
from repro_torch.runtime.checkpoint import CheckpointManager

STACKS = {"g": lambda: reduced(get_config("qwen3-0.6b")),
          "m": mt._moonshot_no_drop}
# tokens a row, and moonshot's dispatch group (``ffn.MOE_GROUP``, 1,024
# tokens at full size, set to one row here on both sides): a data rank's
# rows, and each microbatch's, are then whole groups of the reference's
# batch, and a rank routes its tokens as the reference does
SEQ = {"g": mt.S, "m": 64}
MOE_GROUP = 64


@contextlib.contextmanager
def moe_group(module, name: str):
    """``module.MOE_GROUP`` at :data:`MOE_GROUP` for stack "m"."""
    if name != "m":
        yield
        return
    saved, module.MOE_GROUP = module.MOE_GROUP, MOE_GROUP
    try:
        yield
    finally:
        module.MOE_GROUP = saved


def batch(name: str, step: int = 0) -> dict:
    """Batch ``step`` of stack ``name``: B rows of SEQ[name] tokens."""
    import numpy as np
    cfg = STACKS[name]()
    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(0, cfg.vocab, (mt.B, SEQ[name] + 1))
    return {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
            "targets": torch.from_numpy(tokens[:, 1:].copy())}


def options(name: str, layout: str, microbatches: int):
    """The layouts the tests train under: the recommended options
    (vocab-only, ZeRO-3 over ("data", "model")), full TP with ZeRO-3 over
    "data", and moe-only with ZeRO-3."""
    cfg = STACKS[name]()
    base = {"rec": sharding.recommended_options(cfg, "train"),
            "zero_full": sharding.ShardingOptions(fsdp_override=True),
            "moe": sharding.ShardingOptions(tp_mode="moe-only",
                                            fsdp_override=True)}[layout]
    return dataclasses.replace(base, microbatches=microbatches)


def _mesh():
    n = dist.get_world_size()
    return _device_mesh((2, n // 2), ("data", "model"))


def run_case(mesh, name: str, layout: str, microbatches: int, steps_n: int,
             ref_params) -> dict:
    """``steps_n`` steps of ``make_mesh_train_step`` under the layout from
    the reference's parameters; each step's loss and the whole
    parameters and moments, gathered."""
    cfg = STACKS[name]()
    opts = options(name, layout, microbatches)
    whole = transformer.params_from_reference(ref_params, cfg, "cpu")
    local, view = sharding.place_params(mesh, cfg, whole, opts)
    init, step = train.make_mesh_train_step(
        mesh, view, lr=1e-3, microbatches=microbatches, opts=opts)
    opt = init(local)
    losses = []
    from repro_torch.models import ffn
    with moe_group(ffn, name):
        for i in range(steps_n):
            local, opt, metrics = step(local, opt, batch(name, i))
            losses.append(float(metrics["loss"]))
    with shardctx.activation_sharding(mesh):
        out = {k: mt._np(sharding.gather_params(view, tree)) for k, tree in
               (("params", local), ("mu", opt.mu), ("nu", opt.nu))}
    out["losses"] = losses
    out["zero"] = len(view.zero)
    out["split"] = view.split
    return out


def offload_case(mesh) -> dict:
    """One remat step of reduced qwen3 under the recommended options with
    and without ``remat_offload``: the rank's parameters and moments of
    both, and what the offload moved to the host (one carry a unit and
    microbatch, nothing else)."""
    cfg = dataclasses.replace(STACKS["g"](), remat=True)
    moved: list = []
    real = transformer._offload_carry

    def counting(carry):
        hooks = real(carry)

        def pack(t):
            out = hooks.pack_hook(t)
            if isinstance(out, tuple):
                moved.append(tuple(t.shape))
            return out
        return torch.autograd.graph.saved_tensors_hooks(pack,
                                                        hooks.unpack_hook)

    out = {}
    for offload in (False, True):
        opts = dataclasses.replace(options("g", "rec", 2),
                                   remat_offload=offload)
        local, view = sharding.init_rank_params(mt.SEED, mesh, cfg, "cpu",
                                                opts)
        init, step = train.make_mesh_train_step(mesh, view, lr=1e-3,
                                                microbatches=2, opts=opts)
        transformer._offload_carry = counting
        try:
            new, opt, _ = step(local, init(local), batch("g"))
        finally:
            transformer._offload_carry = real
        out[offload] = {"params": mt._np(new), "mu": mt._np(opt.mu),
                        "nu": mt._np(opt.nu)}
    out["moved"] = moved
    out["units"] = cfg.n_units
    return out


def checkpoint_case(mesh, ckpt_dir: str) -> dict:
    """``train.save_checkpoint`` of reduced qwen3's rank-drawn ZeRO-3
    slices and fresh moments (every data rank gathers)."""
    cfg = STACKS["g"]()
    opts = options("g", "rec", 2)
    local, view = sharding.init_rank_params(mt.SEED, mesh, cfg, "cpu", opts)
    opt = train.make_mesh_train_step(mesh, view, opts=opts)[0](local)
    train.save_checkpoint(CheckpointManager(ckpt_dir), mesh, view, 3,
                          (local, opt))
    return {"zero": len(view.zero)}


def one_step_ledger(mesh, name: str = "g", layout: str = "rec",
                    microbatches: int = 2) -> list:
    """The collectives of one step of the case, as the ledger records
    them (after a first step, so nothing is made for the first time)."""
    cfg = STACKS[name]()
    opts = options(name, layout, microbatches)
    local, view = sharding.init_rank_params(mt.SEED, mesh, cfg, "cpu", opts)
    init, step = train.make_mesh_train_step(
        mesh, view, lr=1e-3, microbatches=microbatches, opts=opts)
    opt = init(local)
    local, opt, _ = step(local, opt, batch(name, 0))
    with shardctx.collective_ledger() as ledger:
        step(local, opt, batch(name, 1))
    return list(ledger)


def zero_world(cases: list, refs: dict, ckpt_dir: str | None) -> dict:
    """Each ``(name, layout, microbatches, steps)`` of ``cases`` from
    ``refs[name]`` (the reference's initial parameters), on a (data 2,
    model world/2) mesh; on the 4-rank world also the offload and
    checkpoint cases and one step's ledger."""
    mesh = _mesh()
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    for name, layout, mb, n in cases:
        out[(name, layout, mb)] = run_case(mesh, name, layout, mb, n,
                                           refs[name])
    if ckpt_dir is not None:
        out["offload"] = offload_case(mesh)
        out["checkpoint"] = checkpoint_case(mesh, ckpt_dir)
        out["ledger"] = one_step_ledger(mesh)
    return out


def ledger_world() -> list:
    """One step's ledger of the recommended layout on reduced qwen3 (2
    microbatches), on a (data 2, model 2) mesh."""
    return one_step_ledger(_mesh())
