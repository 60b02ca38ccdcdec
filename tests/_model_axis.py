"""Shared by the port's model-axis tests: the reduced stacks, the engine
cases, the runs both packages make of them, and the rank body of the gloo
worlds that ``repro_torch.launch.mesh.run_world`` spawns.  Imports no JAX:
the reference's parameters reach the ranks as numpy trees, and the test
process runs the reference's engine with the same ``run_engine``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def hybrid_grs(get_config, reduced):
    """tests/test_model_axis.py's mixed stack: attention, RG-LRU and SSD in
    one unit, no tail."""
    return dataclasses.replace(
        reduced(get_config("mamba2-1.3b")), name="hybrid-grs-tp-smoke",
        block_pattern=("g", "r", "s"), n_layers=6, n_heads=4, n_kv=2,
        head_dim=16, d_ff=128, rnn_width=32)


def moonshot_no_drop(get_config, reduced):
    """Reduced moonshot at the capacity factor ceil(E / k) = 4, at which
    an expert takes its whole group: a token's route then does not depend
    on the rest of its group, as a bucketed prefill's pad tokens would
    make it."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    return dataclasses.replace(
        cfg, capacity_factor=float(-(-cfg.n_experts // cfg.top_k)))


def uneven_gqa(get_config, reduced):
    """Reduced qwen3 with 6 query heads over 3 kv heads: on a 2-way model
    axis each rank's 3 query heads read kv heads (0, 0, 1) or (1, 2, 2),
    groups of uneven size, and the kv heads (3) do not divide the axis."""
    return reduced(get_config("qwen3-0.6b"), name="qwen3-uneven-gqa",
                   n_heads=6, n_kv=3)


STACKS = {
    "qwen3": lambda g, r: r(g("qwen3-0.6b")),
    "moonshot": moonshot_no_drop,
    "hybrid-grs": hybrid_grs,
    "recurrentgemma": lambda g, r: r(g("recurrentgemma-2b")),
    "uneven-gqa": uneven_gqa,
}
PARTITIONABLE = ("qwen3", "moonshot", "hybrid-grs", "uneven-gqa")  # no tail
PLM_ONLY = ("uneven-gqa",)          # held through PartitionedLM alone

ENGINE_CASES = {
    # (engine kwargs, [(prompt length, max_new)])
    "ragged": (dict(slots=3, s_max=64), [(5, 4), (9, 4), (12, 4)]),
    "chunked": (dict(slots=3, s_max=64, prefill_chunk=16),
                [(41, 4), (7, 4), (22, 4)]),
    # 3 slots need ~9 blocks of 4; the pool has 6
    "preempt": (dict(slots=3, s_max=32, kv_block=4, kv_blocks=7),
                [(9, 8), (10, 8), (12, 8)]),
    "sync": (dict(slots=3, s_max=64, sync_batching=True),
             [(5, 4), (9, 4), (12, 4)]),
}
COUNTERS = ("clock", "decode_steps", "preemptions")
PLM_CUTS = (1, 0)
PLM_BATCH, PLM_SEQ = 2, 12


def prompts(cfg, spec, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in spec]


def plm_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, cfg.vocab, (PLM_BATCH, PLM_SEQ)).astype(np.int32)


def run_engine(module, cfg, params, case: str, mesh=None) -> dict:
    """``case`` through ``module.ServingEngine`` (the reference's or the
    port's): each request's tokens and the engine's counters."""
    kwargs, spec = ENGINE_CASES[case]
    if mesh is not None:
        kwargs = dict(kwargs, mesh=mesh)
    eng = module.ServingEngine(cfg, params, **kwargs)
    reqs = [module.Request(rid=i, prompt=p, max_new=m)
            for i, (p, (_, m)) in enumerate(zip(prompts(cfg, spec), spec))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    out = {"out": [list(map(int, r.out)) for r in reqs]}
    out.update({k: int(getattr(eng, k)) for k in COUNTERS})
    return out


def _np(x):
    return x.detach().float().cpu().numpy()


def port_cfg(name: str):
    from repro_torch.configs.base import get_config, reduced
    return STACKS[name](get_config, reduced)


def model_axis_world(cases: dict) -> dict:
    """Every case on this rank, for each mesh in ``cases["meshes"]``
    (``make_cells_mesh(model=M)`` over the whole world): each stack of
    ``cases["stacks"]`` (name -> the reference's parameters as numpy)
    through every engine case, and ``PartitionedLM`` at each of
    ``PLM_CUTS`` (logits and boundary, numpy) for the partitionable ones.
    ``cases["restore"]`` (a checkpoint directory of qwen3's parameters)
    adds that checkpoint restored with ``params_shardings`` next to
    ``place_params`` of the same weights, on the last mesh;
    ``cases["init_rank"]`` (a seed) the "chunked" case on qwen3's weights
    drawn by ``init_rank_params``, on the last mesh."""
    import torch.distributed as dist

    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import elastic_mesh, make_cells_mesh
    from repro_torch.models import transformer
    from repro_torch.serving import engine
    from repro_torch.serving.partitioned import PartitionedLM

    out: dict = {"rank": dist.get_rank()}
    mesh = None
    for m in cases["meshes"]:
        mesh = make_cells_mesh(model=m)
        for name, tree in cases["stacks"].items():
            cfg = port_cfg(name)
            params = transformer.params_from_reference(tree, cfg, "cpu")
            for case in () if name in PLM_ONLY else cases["engine"]:
                out[(m, name, case)] = run_engine(engine, cfg, params, case,
                                                  mesh)
            if name in PARTITIONABLE:
                toks = torch.as_tensor(plm_tokens(cfg), dtype=torch.int64)
                for cut in PLM_CUTS:
                    logits, boundary = PartitionedLM(cfg, params, cut,
                                                     mesh=mesh).infer(toks)
                    out[(m, name, "plm", cut)] = (_np(logits), _np(boundary))
    if "restore" in cases:
        from repro_torch.runtime.checkpoint import CheckpointManager
        cfg = port_cfg("qwen3")
        params = transformer.params_from_reference(
            cases["stacks"]["qwen3"], cfg, "cpu")
        placed, view = sharding.place_params(mesh, cfg, params)
        got, _ = CheckpointManager(cases["restore"], async_save=False) \
            .restore(placed, shardings=sharding.params_shardings(
                mesh, cfg, params))
        same = [torch.equal(a, b) for a, b in zip(_leaves(got),
                                                  _leaves(placed))]
        out["restore"] = {"leaves": len(same), "equal": sum(same),
                          "shapes": [tuple(t.shape) for t in _leaves(got)],
                          "split": view.split}
    if "init_rank" in cases:
        cfg = port_cfg("qwen3")
        params, view = sharding.init_rank_params(cases["init_rank"], mesh,
                                                 cfg, "cpu")
        out["init_rank"] = run_engine(engine, view, params, "chunked", mesh)
    if "elastic" in cases:
        out["elastic"] = [tuple(elastic_mesh(t).mesh.shape)
                          for t in cases["elastic"]]
    return out


def _leaves(tree) -> list:
    from repro_torch import _tree
    return _tree.leaves(tree)


CARD_NAMES = ("qwen3", "hybrid-grs")
CARD_CASES = ("chunked", "preempt")


def card_cfg(name: str):
    """``name``'s float32 stack for the card tests: qwen3-0.6b at full
    width and 2 layers; hybrid-grs reduced (one g, r, s unit) with the
    attention kernels' smallest head dim, 32."""
    from repro_torch.configs.base import get_config, reduced
    if name == "qwen3":
        return dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                                   param_dtype="float32",
                                   compute_dtype="float32")
    return dataclasses.replace(hybrid_grs(get_config, reduced), n_layers=3,
                               head_dim=32)


def card_world(model: int = 2) -> dict:
    """The card tests' rank: each of CARD_NAMES through each of CARD_CASES
    on ``make_cells_mesh(model=model)``, with the rank's shard of seed 0's
    weights drawn on the host (``init_rank_params``) and kept on its
    card."""
    from repro_torch.launch.mesh import make_cells_mesh
    from repro_torch.launch.sharding import init_rank_params
    from repro_torch.serving import engine

    mesh = make_cells_mesh(model=model)
    out = {}
    for name in CARD_NAMES:
        params, view = init_rank_params(0, mesh, card_cfg(name), "cuda")
        for case in CARD_CASES:
            out[(name, case)] = run_engine(engine, view, params, case, mesh)
    return out
