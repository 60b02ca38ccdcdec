"""Rank bodies for LM training over a (data, model) mesh
(tests/test_torch_model_axis_train.py): each runs inside a world that
``repro_torch.launch.mesh.run_world`` spawns (gloo, CPU) and returns numpy
trees for the test process to hold against one rank's.  Imports no JAX:
the reference's parameters and results arrive as numpy arguments.

Shared here too: the stacks, batches and steps both sides run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import _tree, shardctx
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import sharding, train
from repro_torch.models import steps, transformer

B, S, CTX = 4, 12, 6
SEED = 0


def _moonshot_no_drop():
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    return dataclasses.replace(
        cfg, capacity_factor=float(-(-cfg.n_experts // cfg.top_k)))


# Every layer kind, float32, reduced: g; gemma3's (l, g) unit with an "l"
# tail and one kv head (a kv head every rank holds); recurrentgemma's
# (r, r, l) with an (r, r) tail; SSD heads of 16 (8 heads: 2 and 4 split
# them); the MoE at the no-drop capacity (routes independent of the
# group); 6 query heads over 3 kv heads (uneven runs at M = 2); vision's
# x and seamless' e/d.
STACKS = {
    "g": lambda: reduced(get_config("qwen3-0.6b")),
    "lg": lambda: reduced(get_config("gemma3-1b"), block_pattern=("l", "g"),
                          tail_pattern=("l",), n_layers=5),
    "rrl": lambda: reduced(get_config("recurrentgemma-2b"), n_layers=5),
    "s": lambda: reduced(get_config("mamba2-1.3b"), ssm_headdim=16),
    "m": _moonshot_no_drop,
    "uneven": lambda: reduced(get_config("qwen3-0.6b"), n_heads=6, n_kv=3),
    "x": lambda: reduced(get_config("llama-3.2-vision-90b"), n_layers=5),
    "ed": lambda: reduced(get_config("seamless-m4t-large-v2")),
}


def batch(cfg, step: int = 0, rows: int = B) -> dict:
    rng = np.random.default_rng(100 + step)
    tokens = rng.integers(0, cfg.vocab, (rows, S + 1)).astype(np.int64)
    out = {"tokens": torch.from_numpy(tokens[:, :-1].copy()),
           "targets": torch.from_numpy(tokens[:, 1:].copy())}
    key = ("image_embeds" if cfg.frontend == "vision" else
           "src_embeds" if cfg.enc_layers else None)
    if key:
        out[key] = torch.from_numpy(
            (rng.normal(size=(rows, CTX, cfg.d_model)) * 0.5)
            .astype(np.float32))
    return out


def params(cfg, remat: bool = False):
    cfg = dataclasses.replace(cfg, remat=remat)
    return cfg, transformer.init_params(SEED, cfg, "cpu")


def _np(tree):
    return _tree.map_tensors(lambda x: x.detach().float().cpu().numpy(),
                             tree)


def shard_of(mesh, cfg, tree):
    """This rank's shard of a whole tree (``place_params``'s layout)."""
    return sharding.place_params(mesh, cfg, tree)[0]


def grad_case(mesh, name: str, remat: bool) -> dict:
    """The rank's gradient of its shard (the partial ones summed), beside
    its shard of the one-rank gradient, both computed here."""
    cfg, p = params(STACKS[name](), remat)
    data = batch(cfg)
    (loss_one, _), whole = steps.value_and_grad(p, cfg, data)
    local, view = sharding.place_params(mesh, cfg, p)
    with shardctx.activation_sharding(mesh):
        (loss, _), g = steps.value_and_grad(local, view, data)
        g = sharding.reduce_partial_grads(view, g)
        back = sharding.gather_params(view, local)
    return {"grad": _np(g), "want": _np(shard_of(mesh, cfg, whole)),
            "loss": float(loss), "loss_one": float(loss_one),
            "round_trip": _np(back), "params": _np(p)}


CLIP = 1e-2       # binds: the reduced models' gradient norms are ~1


def clip_case(mesh, name: str) -> dict:
    """One Adam step with a clip that binds: the rank's moments beside its
    shard of the one-rank step's (the clip's norm must be the whole
    model's)."""
    cfg, p = params(STACKS[name]())
    data = batch(cfg)
    init, step = steps.make_train_step(cfg, lr=1e-3, grad_clip=CLIP)
    _, opt, _ = step(p, init(p), data)
    local, view = sharding.place_params(mesh, cfg, p)
    init_l, step_l = train.make_mesh_train_step(mesh, view, lr=1e-3,
                                                grad_clip=CLIP)
    _, opt_l, _ = step_l(local, init_l(local), data)
    return {"mu": _np(opt_l.mu), "want": _np(shard_of(mesh, cfg, opt.mu))}


def grad_world(cases: list, model: int) -> dict:
    """``grad_case`` of each (stack, remat) and ``clip_case`` of "g" on a
    ("data", "model") mesh whose model axis is ``model`` (data = 1)."""
    from repro_torch.launch.mesh import _device_mesh
    import torch.distributed as dist
    mesh = _device_mesh((dist.get_world_size() // model, model),
                        ("data", "model"))
    out = {"rank": mesh.get_local_rank("model")}
    for name, remat in cases:
        out[("grad", name, remat)] = grad_case(mesh, name, remat)
    out["clip"] = clip_case(mesh, "g")
    return out


def reference_step_world(ref_params, cfg_name: str, steps_n: int,
                         microbatches: int) -> dict:
    """``steps_n`` steps of ``make_mesh_train_step`` on a (data 2, model 2)
    mesh from the reference's parameters; the whole parameters, moments
    and each step's loss, gathered."""
    from repro_torch.launch.mesh import _device_mesh
    cfg = reduced(get_config(cfg_name))
    mesh = _device_mesh((2, 2), ("data", "model"))
    whole = transformer.params_from_reference(ref_params, cfg, "cpu")
    local, view = sharding.place_params(mesh, cfg, whole)
    init, step = train.make_mesh_train_step(mesh, view, lr=1e-3,
                                            microbatches=microbatches)
    opt = init(local)
    losses = []
    for i in range(steps_n):
        data = batch(cfg, i)
        local, opt, metrics = step(local, opt, data)
        losses.append(float(metrics["loss"]))
    with shardctx.activation_sharding(mesh):
        params_w = sharding.gather_params(view, local)
        mu = sharding.gather_params(view, opt.mu)
        nu = sharding.gather_params(view, opt.nu)
    return {"params": _np(params_w), "mu": _np(mu), "nu": _np(nu),
            "losses": losses}


def train_world(ckpt_dir: str, argv: list, stop: int, steps_n: int) -> dict:
    """``launch.train.main`` on a (data 2, model 2) mesh: ``stop`` steps
    with a checkpoint, then resumed to ``steps_n``; and ``steps_n`` steps
    uninterrupted.  The rank's parameters and moments of both runs."""
    from repro_torch.launch.mesh import _device_mesh
    mesh = _device_mesh((2, 2), ("data", "model"))
    whole_argv = argv + ["--steps", str(steps_n)]
    first = train.main(argv + ["--steps", str(stop), "--ckpt-dir", ckpt_dir,
                               "--ckpt-every", str(stop)], mesh=mesh)
    resumed = train.main(whole_argv + ["--ckpt-dir", ckpt_dir], mesh=mesh)
    straight = train.main(whole_argv, mesh=mesh)
    keep = lambda run: {"params": _np(run["params"]),
                        "mu": _np(run["opt"].mu), "losses": run["losses"],
                        "start": run["start"]}
    return {"first": keep(first), "resumed": keep(resumed),
            "straight": keep(straight)}


def save_world(ckpt_dir: str, step: int) -> dict:
    """``launch.train.save_checkpoint`` of reduced qwen3's rank-drawn
    parameters and fresh moments on a (data 2, model 2) mesh, with the
    rank's collectives counted and the whole leaves the gather has made
    that are still alive at each leaf it yields (a gather of the whole
    tree would keep them all)."""
    import weakref

    import torch.distributed as dist
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.runtime.checkpoint import CheckpointManager
    mesh = _device_mesh((2, 2), ("data", "model"))
    cfg = reduced(get_config("qwen3-0.6b"))
    local, view = sharding.init_rank_params(SEED, mesh, cfg, "cpu")
    tree = (local, steps.make_train_step(view)[0](local))
    mine = {id(t) for t in _tree.leaves(list(tree))}
    calls, alive, made = [], [], []
    real = train.gathered_leaves

    def watched(view, tree):
        for key, leaf in real(view, tree):
            if id(leaf) not in mine:
                made.append(weakref.ref(leaf))
            alive.append(sum(r() is not None for r in made))
            yield key, leaf

    def counted(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    saved = {n: getattr(dist, n) for n in ("all_gather", "all_reduce")}
    train.gathered_leaves = watched
    for n, fn in saved.items():
        setattr(dist, n, counted(n, fn))
    try:
        train.save_checkpoint(CheckpointManager(ckpt_dir), mesh, view, step,
                              tree)
    finally:
        train.gathered_leaves = real
        for n, fn in saved.items():
            setattr(dist, n, fn)
    return {"data": mesh.get_local_rank("data"), "calls": calls,
            "alive": alive, "made": len(made)}


def card_train_cfg():
    """The card test's stack: qwen3-0.6b at full width, 2 layers, float32."""
    return dataclasses.replace(
        get_config("qwen3-0.6b"), n_layers=2, param_dtype="float32",
        compute_dtype="float32", opt_state_dtype="float32")


def card_train_world() -> dict:
    """A rank of the card test: on ``elastic_mesh(2)`` (model 2; data 2
    where the world has 4 ranks), one float32 step of ``card_train_cfg``
    from seed 0's weights (drawn on the host) on one rank and on the mesh.
    Returns the worst moment errors over each leaf's max and the next
    batch's loss both ways."""
    from repro_torch.data.pipeline import for_arch
    from repro_torch.launch.mesh import elastic_mesh
    mesh = elastic_mesh(2)
    cfg = card_train_cfg()
    stream = for_arch(cfg, batch=4, seq=64, seed=3)
    b0 = _tree.to_device(stream.get_batch(0), "cuda")
    b1 = _tree.to_device(stream.get_batch(1), "cuda")
    whole = _tree.to_device(transformer.init_params(SEED, cfg, "cpu"),
                            "cuda")
    init, step = steps.make_train_step(cfg, lr=1e-3)
    new, opt, _ = step(whole, init(whole), b0)
    out = {"loss_one": float(steps.loss_fn(new, cfg, b1)[0])}
    scale = {k: [float(t.abs().max()) for t in _tree.leaves(getattr(opt, k))]
             for k in ("mu", "nu")}
    ref = {k: shard_of(mesh, cfg, getattr(opt, k)) for k in ("mu", "nu")}
    local, view = sharding.place_params(mesh, cfg, whole)
    del whole, new, opt
    init, step = train.make_mesh_train_step(mesh, view, lr=1e-3)
    new, opt, _ = step(local, init(local), b0)
    with shardctx.activation_sharding(mesh):
        out["loss_mesh"] = float(steps.loss_fn(new, view, b1)[0])
    for k in ("mu", "nu"):
        out[k] = max(float((g - w).abs().max()) / max(s, 1e-30) for g, w, s
                     in zip(_tree.leaves(getattr(opt, k)),
                            _tree.leaves(ref[k]), scale[k]))
    out["shape"] = tuple(mesh.mesh.shape)
    return out
