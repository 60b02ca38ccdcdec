"""Rank bodies for sequence parallelism over "model" (``seq_shard``;
tests/test_torch_seq_shard.py): each runs inside a world that
``repro_torch.launch.mesh.run_world`` spawns (gloo, CPU) and returns numpy
results.  Imports no JAX: the reference's parameters arrive as numpy
arguments.

Shared here too: the stacks, batches and cases both sides run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree, shardctx
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import sharding, train
from repro_torch.launch.mesh import _device_mesh
from repro_torch.models import steps, transformer
from repro_torch.runtime import compression

import _model_axis as ma

B, S, ODD_S = 4, 16, 15          # ODD_S: a length a 2-way axis does not divide

# every layer kind the sequence passes through, float32, reduced: g;
# gemma3's (l, g) unit with an "l" tail and one kv head; attention, RG-LRU
# and SSD in one unit (on a 4-way axis its 2 SSD heads stay whole); the
# MoE at the no-drop capacity
STACKS = {
    "g": lambda: reduced(get_config("qwen3-0.6b")),
    "lg": lambda: reduced(get_config("gemma3-1b"), block_pattern=("l", "g"),
                          tail_pattern=("l",), n_layers=5),
    "grs": lambda: ma.hybrid_grs(get_config, reduced),
    "m": lambda: ma.moonshot_no_drop(get_config, reduced),
}
SO = sharding.ShardingOptions
LAYOUTS = {
    "full": SO(seq_shard=True),
    # every layer whole on each model rank, ZeRO-3 slices over (data,
    # model): qwen3-0.6b's recommended training layout
    "vocab-only": SO(seq_shard=True, tp_mode="vocab-only",
                     fsdp_override=True),
}
# (stack, sequence length, layout) a world takes the gradient of
GRAD_CASES = [(name, S, "full") for name in STACKS] + [
    ("g", ODD_S, "full"), ("g", S, "vocab-only")]


def batch(cfg, s: int = S, step: int = 0) -> dict:
    rng = np.random.default_rng(200 + step)
    tokens = rng.integers(0, cfg.vocab, (B, s + 1)).astype(np.int64)
    return {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
            "targets": torch.from_numpy(tokens[:, 1:].copy())}


def _np(tree):
    return _tree.map_tensors(lambda x: x.detach().float().cpu().numpy(),
                             tree)


def named(tree) -> dict:
    """{path: numpy leaf} of a parameter-shaped tree."""
    out = {}
    sharding.map_with_paths(
        lambda path, t: out.__setitem__(path, t.detach().float().numpy()),
        tree)
    return out


def grad_case(mesh, name: str, s: int, layout: str, ref_params) -> dict:
    """The gradient of the mean loss over the logical batch, from the
    rank's rows and its shard under ``LAYOUTS[layout]``: the partial
    gradients summed over "model" (``reduce_partial_grads``), the mean
    taken over "data", then gathered whole.  Also the loss, whether the
    call ran sequence-parallel, and the step's collectives by kind."""
    cfg = STACKS[name]()
    whole = transformer.params_from_reference(ref_params, cfg, "cpu")
    opts = LAYOUTS[layout]
    local, view = sharding.place_params(mesh, cfg, whole, opts)
    rows = compression.rows(batch(cfg, s), mesh)
    d = shardctx.mesh_axes(mesh)["data"]
    knobs = sharding.context_knobs(opts)
    with shardctx.activation_sharding(mesh, **knobs, data_rows=True), \
            shardctx.collective_ledger() as ledger:
        seq = shardctx.seq_block(shardctx.seq_parallel(view, s))
        (loss, (ce, aux)), g = steps.value_and_grad(local, view, rows)
        kinds = sorted({k for k, _, _ in ledger})
        g = sharding.reduce_partial_grads(view, g, seq=seq)
        # a ZeRO-3 slice's gradient is summed over its storage axes; a
        # slice over "model" too holds the sum of the model ranks' parts
        # under sequence parallelism, whole otherwise
        zero = lambda path: shardctx.zero_entry(view, path)

        def mean(path, t):
            entry = zero(path)
            if entry is not None:
                n = 1
                for a in entry[1]:
                    if not (a == "model" and seq
                            and sharding.seq_partial(view, path)):
                        n *= shardctx.mesh_axes(mesh)[a]
                return t / n
            return shardctx.storage_all_reduce(t, ("data",)) / d

        g = sharding.map_with_paths(mean, g)
        stats = shardctx.storage_all_reduce(
            torch.stack([loss.detach(), ce.detach(), aux.detach()]),
            ("data",)) / d
        whole_g = sharding.gather_params(view, g)
    return {"loss": stats.tolist(), "grads": named(whole_g), "seq": seq,
            "kinds": kinds, "split": view.split}


def grad_world(cases: list, model: int, refs: dict) -> dict:
    """``grad_case`` of each (stack, length, layout) on a ("data",
    "model") mesh whose model axis is ``model``."""
    n = dist.get_world_size()
    mesh = _device_mesh((n // model, model), ("data", "model"))
    return {case: grad_case(mesh, *case, refs[case[0]]) for case in cases}


def step_world(ref_params, launch_argv: list) -> dict:
    """On a (data 2, model 2) mesh: one ``make_mesh_train_step`` step of
    reduced qwen3 from the reference's parameters under each layout
    (the whole parameters and moments after it, and its loss); and two
    steps of ``launch.train.main(mesh=)`` on its recommended options with
    and without ``seq_shard``, their losses."""
    mesh = _device_mesh((2, 2), ("data", "model"))
    cfg = STACKS["g"]()
    out = {}
    for layout, opts in LAYOUTS.items():
        whole = transformer.params_from_reference(ref_params, cfg, "cpu")
        local, view = sharding.place_params(mesh, cfg, whole, opts)
        init, step = train.make_mesh_train_step(mesh, view, lr=1e-3,
                                                opts=opts)
        new, opt, metrics = step(local, init(local), batch(cfg))
        with shardctx.activation_sharding(mesh):
            out[layout] = {k: _np(sharding.gather_params(view, t))
                           for k, t in (("params", new), ("mu", opt.mu),
                                        ("nu", opt.nu))}
        out[layout]["loss"] = float(metrics["loss"])
    base = sharding.recommended_options(cfg, "train")
    for label, opts in (("plain", base),
                        ("seq", dataclasses.replace(base, seq_shard=True))):
        run = train.main(launch_argv, mesh=mesh, opts=opts)
        out[("launch", label)] = [run["losses"][s]
                                  for s in sorted(run["losses"])]
    return out
