"""Rank bodies and shared inputs of tests/test_torch_compression.py: the
port's ``runtime.compression`` on a gloo world that
``repro_torch.launch.mesh.run_world`` spawns, on the per-rank gradients
and batches the test also feeds the reference.  Imports no JAX."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.optim.adam import adam

MODES = ("none", "bf16", "int8")
EF_STEPS, DP_STEPS, LR = 50, 3, 1e-2


def grads(n: int) -> dict:
    """Per-rank gradients, stacked on a leading rank axis: a (n, 8, 8) and
    a (n, 1, 5) leaf (each rank's a leading 1 of its own), with rows of
    very different scales, so each leaf's int8 scale is its own."""
    rng = np.random.default_rng(n)
    return {"w": rng.normal(size=(n, 8, 8)).astype(np.float32),
            "b": (rng.normal(size=(n, 1, 5)) * 1e-3).astype(np.float32)}


def linear_params() -> dict:
    rng = np.random.default_rng(9)
    return {"w": (rng.normal(size=(8, 4)) * 0.3).astype(np.float32),
            "b": np.zeros(4, np.float32)}


def linear_batch(n: int, step: int) -> dict:
    rng = np.random.default_rng(50 + step)
    x = rng.normal(size=(2 * n, 8)).astype(np.float32)
    return {"x": x, "y": (x[:, :4] * 2.0 - 0.5).astype(np.float32)}


def linear_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean()


def _rank_of(tree: dict, r: int) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v[r:r + 1]))
            for k, v in tree.items()}


def _np(tree):
    return _tree.map_tensors(lambda x: x.detach().cpu().numpy(), tree)


def sync_world(n: int) -> dict:
    """Each mode's (mean, residual) of the rank's gradients, 50 int8 steps
    with error feedback (the mean of the means and the last residual),
    ``make_dp_train_step`` for 3 steps per mode, and a bad mode's
    refusal."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.runtime import compression
    mesh = _device_mesh((n,), ("data",))
    r = dist.get_rank()
    g = _rank_of(grads(n), r)
    zeros = _tree.map_tensors(torch.zeros_like, g)
    out: dict = {}
    for mode in MODES:
        synced, res = compression.make_grad_sync(mesh, "data", mode)(g, zeros)
        out[("sync", mode)] = (_np(synced), _np(res))
    sync = compression.make_grad_sync(mesh, "data", "int8")
    res, acc = zeros, _tree.map_tensors(torch.zeros_like, g)
    for _ in range(EF_STEPS):
        synced, res = sync(g, res)
        acc = _tree.map_tensors(lambda a, s: a + s, acc, synced)
    out["ef"] = (_np(_tree.map_tensors(lambda a: a / EF_STEPS, acc)),
                 _np(res))
    for mode in MODES:
        init, update = adam(LR)
        params = {k: torch.from_numpy(v) for k, v in
                  linear_params().items()}
        step = compression.make_dp_train_step(mesh, linear_loss, update,
                                              "data", mode)
        opt, res = init(params), _tree.map_tensors(torch.zeros_like, params)
        losses = []
        for i in range(DP_STEPS):
            batch = {k: torch.from_numpy(v)
                     for k, v in linear_batch(n, i).items()}
            params, opt, res, loss = step(params, opt, res, batch)
            losses.append(float(loss))
        out[("dp", mode)] = {"params": _np(params), "mu": _np(opt.mu),
                             "nu": _np(opt.nu), "losses": losses}
    try:
        compression.make_grad_sync(mesh, "data", "fp4")
    except ValueError as exc:
        out["bad_mode"] = str(exc)
    return out
