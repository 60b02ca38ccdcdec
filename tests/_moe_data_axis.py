"""Rank bodies for the MoE over the data axes
(tests/test_torch_moe_data_axis.py): each runs inside a world that
``repro_torch.launch.mesh.run_world`` spawns (gloo, CPU) and returns numpy
results.  Imports no JAX: the reference's parameters arrive as numpy
arguments.

Shared here too: the config, the batches and the cases both sides run.
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
from repro_torch.models import ffn, transformer

# a microbatch is 4 rows of 320 tokens: 1,280 tokens, so the natural
# dispatch group (ffn.MOE_GROUP, 1,024) straddles the two data ranks'
# 640 each, and the second group holds 256 tokens and 768 zero pads
ROWS, S = 4, 320
EXPERTS = 16                     # top-6 of 16: capacity 480 a group at 1.25
CAPACITY = 1.25                  # moonshot's own
NO_DROP = float(-(-EXPERTS // 6))    # ceil(E / k): cap = the group


def config(capacity: float):
    """Reduced moonshot-v1-16b-a3b (1 layer, d_model 64) with 16 experts
    at ``capacity``."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"), n_experts=EXPERTS,
                  n_layers=1)
    return dataclasses.replace(cfg, capacity_factor=capacity)


def batch(microbatches: int) -> dict:
    """``microbatches`` x ROWS rows of S tokens (the first rows of one
    draw), int64."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 256, (2 * ROWS, S + 1))[:ROWS * microbatches]
    return {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
            "targets": torch.from_numpy(tokens[:, 1:].copy())}


SO = sharding.ShardingOptions
# layout name -> (options, moe_dp_groups); "gather" is the context knob
# alone, which no ShardingOptions sets
LAYOUTS = {
    "base": (SO(), True),
    "gather": (SO(), False),
    "dff": (SO(expert_shard_dff=True), True),
    "moe-dff": (SO(tp_mode="moe-only", expert_shard_dff=True), True),
    "edata": (SO(expert_mesh="data"), True),
}


def _np(tree):
    return _tree.map_tensors(lambda x: x.detach().float().cpu().numpy(),
                             tree)


def run_case(mesh, layout: str, capacity: float, microbatches: int,
             ref_params) -> dict:
    """One step of ``make_mesh_train_step`` under ``layout`` from the
    reference's parameters (``step_case``)."""
    cfg = config(capacity)
    whole = transformer.params_from_reference(ref_params, cfg, "cpu")
    return step_case(mesh, cfg, whole, layout, microbatches)


def step_case(mesh, cfg, whole, layout: str, microbatches: int,
              device="cpu") -> dict:
    """One step of ``make_mesh_train_step`` under ``layout`` from the whole
    parameters ``whole`` (on the host), on ``device``: its metrics, the
    gathered parameters and moments (on the host), the rank's view, and
    each MoE call's kept (token, expert) mask of the rank's routed
    positions with their first stream position."""
    opts, moe_dp = LAYOUTS[layout]
    opts = dataclasses.replace(opts, microbatches=microbatches)
    local, view = sharding.place_params(mesh, cfg,
                                        _tree.to_device(whole, device), opts)
    knobs = train.context_knobs
    if not moe_dp:
        train.context_knobs = lambda o: dict(knobs(o), moe_dp_groups=False)
    try:
        init, step = train.make_mesh_train_step(
            mesh, view, lr=1e-3, microbatches=microbatches, opts=opts)
    finally:
        train.context_knobs = knobs
    kept, route = [], ffn.route

    def spy(router, cfg_, xg, st=None):
        out = route(router, cfg_, xg, st)
        mask = (out[0].sum(-1) > 0).reshape(-1, out[0].shape[2])
        kept.append((st.rank * st.tokens,
                     mask[st.lead:st.lead + st.held].cpu().numpy()))
        return out

    ffn.route = spy
    try:
        new, opt, metrics = step(local, init(local),
                                 _tree.to_device(batch(microbatches), device))
    finally:
        ffn.route = route
    with shardctx.activation_sharding(mesh):
        out = {k: _np(sharding.gather_params(view, tree)) for k, tree in
               (("params", new), ("mu", opt.mu), ("nu", opt.nu))}
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["kept"] = kept
    out["view"] = {k: getattr(view, k) for k in (
        "split", "expert_mesh", "moe_data", "local_experts",
        "expert_offset", "local_dff", "dff_offset")}
    return out


def world(cases: list, ref_params) -> dict:
    """Each ``(layout, capacity, microbatches)`` of ``cases`` on a (data
    2, model world / 2) mesh, from the reference's ``ref_params``."""
    n = dist.get_world_size()
    mesh = _device_mesh((2, n // 2), ("data", "model"))
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    for case in cases:
        out[case] = run_case(mesh, *case, ref_params)
    return out


def card_world(device: str) -> dict:
    """The baseline step at 2 microbatches on a (data 2) world on
    ``device`` (two ranks on cuda:0 over gloo, or on the CPU), from seed
    0's weights drawn on the host, the heads widened to the attention
    kernels' smallest head dim, float32 without TF32."""
    from repro_torch.launch.serve import kernel_head_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _device_mesh((2, 1), ("data", "model"))
    cfg = dataclasses.replace(config(CAPACITY), **kernel_head_dim("cuda"))
    whole = transformer.init_params(0, cfg, "cpu")
    return step_case(mesh, cfg, whole, "base", 2, device)

