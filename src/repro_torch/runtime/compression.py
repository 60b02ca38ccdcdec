"""Gradient compression for the data-parallel sync.

Port of ``repro/runtime/compression.py``.  The reference runs its sync
inside ``shard_map`` with ``lax.psum`` / ``pmax`` over a mesh axis; here
every rank is a process, and the sync runs over the axis's sub-group of a
``DeviceMesh`` (``launch.mesh.axes_group``; gloo on host copies, NCCL on
the device):

* ``"bf16"``: the wire is bfloat16 both ways (half the bytes): each rank
  sends every other rank its chunk of the gradient (an all-to-all), sums
  the chunks it receives in float32 in rank order and rounds once, then
  the bf16 sums are all-gathered -- a ring all-reduce's bytes, with the
  reference's rounding (its ``psum`` of bf16 adds in float32 and rounds
  once; a backend's bf16 all-reduce would round after every add);
* ``"int8"``: per-tensor symmetric quantization: the scale's all-reduce
  MAX, then the gradient requantized against that global scale and summed
  in int32, so the sum is exact (a quarter of the bytes).  The scale is
  max|g| times the float32 1/127 and the residual rounds once, as XLA
  compiles the reference's ``/ 127.0`` and its multiply-subtract;
* ``"none"``: the float32 mean, the reference's plain ``psum`` / n;
* optional error feedback: each rank's quantization residual is added to
  its next gradient, so the compression's bias vanishes over steps.

A wire is bucketed: one collective a dtype for the whole tree (packed with
``launch.mesh.pack``), and in int8 mode one MAX for every leaf's scale,
each leaf keeping its own scale.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import _tree
from ..launch.mesh import _on_host, axes_group, pack, unpack
from ..shardctx import record

MODES = ("none", "bf16", "int8")


_INV_127 = float(torch.tensor(1.0) / 127.0)      # the float32 1/127


def _quantize_scale(x):
    return torch.clamp_min(torch.max(torch.abs(x)), 1e-12) * _INV_127


def _bf16_sum(wire: list, group, n: int) -> list:
    """The sum over ``group`` of each bf16 tensor of ``wire``: an
    all-to-all of chunks, a float32 sum in rank order rounded once, an
    all-gather of the bf16 sums."""
    buffers, layout = pack(wire)
    flat = buffers[torch.bfloat16]
    size = flat.numel()
    chunk = -(-size // n)
    host = flat.is_cuda and _on_host(group)
    buf = torch.cat([flat, flat.new_zeros(chunk * n - size)])
    buf = buf.cpu() if host else buf
    got = torch.empty_like(buf)
    dist.all_to_all_single(got, buf, group=group)
    record("all-to-all", got)
    rows = got.view(n, chunk)
    acc = rows[0].float()
    for i in range(1, n):
        acc = acc + rows[i].float()
    parts = [torch.empty(chunk, dtype=torch.bfloat16, device=buf.device)
             for _ in range(n)]
    dist.all_gather(parts, acc.to(torch.bfloat16), group=group)
    out = torch.cat(parts)[:size].to(flat.device)
    record("all-gather", n * chunk * 2, torch.bfloat16)
    return unpack({torch.bfloat16: out}, layout)


def _all_reduce(bufs: list, group, op=dist.ReduceOp.SUM,
                divide: int = 1) -> list:
    """Each of ``bufs`` reduced over ``group`` (one collective a dtype),
    divided by ``divide``; the results are views of one buffer a dtype."""
    buffers, layout = pack(bufs)
    host = bufs[0].is_cuda and _on_host(group)
    for dt, buf in buffers.items():
        wire = buf.cpu() if host else buf
        dist.all_reduce(wire, op=op, group=group)
        record("all-reduce", wire)
        buf = buf.copy_(wire) if host else wire
        buffers[dt] = buf.div_(divide) if divide != 1 else buf
    return unpack(buffers, layout)


def make_grad_sync(mesh, axis="data", mode: str = "bf16",
                   error_feedback: bool = True):
    """Returns ``sync(grads, residual) -> (mean_grads, new_residual)`` over
    ``mesh``'s ``axis`` (a name or a tuple of names): each rank passes its
    own gradients and residual (trees alike) and gets the mean over the
    axis's ranks and its new residual (zeros without error feedback or in
    mode "none"; None where ``residual`` is None, which counts as zeros)."""
    if mode not in MODES:
        raise ValueError(mode)
    group, n = axes_group(mesh, axis)

    def sync(grads, residual):
        leaves = _tree.leaves(grads)
        if residual is None or not error_feedback:
            local = leaves
        else:
            local = [g + r for g, r in zip(leaves, _tree.leaves(residual))]
        if mode == "bf16":
            wire = [x.to(torch.bfloat16) for x in local]
            summed = _bf16_sum(wire, group, n)
            synced = [s.to(torch.float32) / n for s in summed]
            new_res = [x - w.to(torch.float32) if error_feedback
                       else torch.zeros_like(x) for x, w in zip(local, wire)]
        elif mode == "int8":
            scales = torch.stack([_quantize_scale(x) for x in local])
            gscale = _all_reduce([scales], group, dist.ReduceOp.MAX)[0]
            q = [torch.clamp(torch.round(x / gscale[i]), -127, 127)
                 .to(torch.int32) for i, x in enumerate(local)]
            summed = _all_reduce(q, group)
            synced = [(s.to(torch.float32) * gscale[i]) / n
                      for i, s in enumerate(summed)]
            # x - q * scale rounded once (a fused multiply-subtract)
            new_res = [(x.double() - qi.double() * gscale[i].double()).float()
                       if error_feedback else torch.zeros_like(x)
                       for i, (x, qi) in enumerate(zip(local, q))]
        else:
            synced = _all_reduce(local, group, divide=n)
            new_res = [torch.zeros_like(x) for x in local]
        return (_tree.unflatten(grads, synced),
                None if residual is None
                else _tree.unflatten(residual, new_res))

    return sync


def rows(batch: dict, mesh, axis="data") -> dict:
    """This rank's rows of a logical batch sharded on ``axis``: the part at
    the rank's (row-major) index over the axis's names, of equal parts."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    names = tuple(mesh.mesh_dim_names)
    n, at = 1, 0
    for a in axes:
        size = int(mesh.size(names.index(a)))
        at, n = at * size + mesh.get_local_rank(a), n * size
    out = {}
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(
                f"batch {key!r} has {x.shape[0]} rows, not a multiple of "
                f"the {n} ranks of {axes}")
        b = x.shape[0] // n
        out[key] = x[at * b:(at + 1) * b]
    return out


def make_dp_step(mesh, grads_of, opt_update, axis="data",
                 mode: str = "bf16", error_feedback: bool = True,
                 local=None):
    """The data-parallel step that ``make_dp_train_step`` and
    ``launch.train.make_mesh_train_step`` build on: each rank takes its
    rows of the logical batch over ``axis``, ``grads_of(params, rows) ->
    (stats, grads)`` gives its gradients and a 1-D float32 tensor of
    statistics (its loss ...), the gradients are synced through
    ``make_grad_sync`` and applied with ``opt_update(grads, opt_state,
    params) -> (params, opt_state)``.  Returns ``step(params, opt_state,
    residual, batch) -> (params, opt_state, residual, stats)``, ``stats``
    the mean over the axis's ranks.  Over one rank, mode "none" syncs
    nothing.  ``local(grads)``, where given, marks (one bool a leaf, in
    ``_tree.leaves`` order) the gradients that are already the mean (a
    ZeRO-3 slice, reduce-scattered in the backward): they are not synced,
    and ``residual`` must then be None."""
    sync = make_grad_sync(mesh, axis, mode, error_feedback)
    group, n = axes_group(mesh, axis)

    def step(params, opt_state, residual, batch):
        stats, grads = grads_of(params, rows(batch, mesh, axis))
        if n > 1 or mode != "none":
            if local is None:
                grads, residual = sync(grads, residual)
            else:
                if residual is not None:
                    raise ValueError("local gradients take no residual")
                leaves, keep = _tree.leaves(grads), local(grads)
                synced = iter(sync([g for g, k in zip(leaves, keep)
                                    if not k], None)[0])
                grads = _tree.unflatten(grads, [
                    g if k else next(synced) for g, k in zip(leaves, keep)])
            stats = _all_reduce([stats.detach()], group, divide=n)[0]
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, residual, stats

    return step


def make_dp_train_step(mesh, loss_fn, opt_update, axis="data",
                       mode: str = "bf16", error_feedback: bool = True):
    """Explicit data-parallel train step: parameters replicated, each rank
    takes its rows of the logical batch, the gradient sync through the
    compressor.

    ``loss_fn(params, batch) -> scalar`` (torch); ``opt_update(grads,
    opt_state, params) -> (params, opt_state)``.  Returns
    ``step(params, opt_state, residual, batch) -> (params, opt_state,
    residual, loss)``, ``residual`` the rank's own (a tree like params) and
    ``loss`` the mean over the axis's ranks.
    """

    def grads_of(params, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in _tree.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_tree.unflatten(params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach().reshape(1), _tree.unflatten(params, grads)

    step = make_dp_step(mesh, grads_of, opt_update, axis, mode,
                        error_feedback)

    def dp_train_step(params, opt_state, residual, batch):
        params, opt_state, residual, loss = step(params, opt_state,
                                                 residual, batch)
        return params, opt_state, residual, loss[0]

    return dp_train_step
