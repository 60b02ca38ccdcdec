"""Train / serve step factories over the layer stack.

Port of ``repro/models/steps.py``.  ``make_train_step(cfg)`` returns
``(opt_init, train_step)`` with

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

cross-entropy over float32 logits plus the MoE load-balance aux loss, and
the port's hand-written AdamW (``optim/adam.py``; moments in
``cfg.opt_state_dtype``).  Gradients come from ``torch.autograd.grad`` on
the parameter leaves; on CUDA, attention differentiates through the flash
backward kernel, and the scan kernels, which have no backward yet, raise
(``kernels.ops``).  ``train_step`` returns new trees and leaves its inputs
as they were.  ``make_prefill`` / ``make_decode_step`` wrap the serving
paths.
"""
from __future__ import annotations

import functools

import torch

from .. import _tree, shardctx
from ..optim.adam import adam
from .common import dtype_of
from . import transformer

MOE_AUX_COEF = 0.01


def cross_entropy(logits, targets, mask=None, vocab_offset=None):
    """Mean token cross-entropy.  logits float32 (B, S, V); targets (B, S)
    int; ``mask`` (B, S) weighs each token (the mean over its sum, at
    least 1).  ``vocab_offset``: ``logits`` are this rank's columns of a
    vocabulary split over "model", the first of them at that row, and the
    loss is vocabulary-parallel: the row's max, its sum of exponentials
    and the target's logit are reduced over "model" (three all-reduces of
    (B, S), where gathering the logits moves (B, S, V)), and each rank's
    gradient is its own columns'."""
    if vocab_offset is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        top = shardctx.model_max(torch.amax(logits, dim=-1))
        logz = top + torch.log(shardctx.model_all_reduce(
            torch.sum(torch.exp(logits - top[..., None]), dim=-1)))
        local = targets.long() - vocab_offset
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1,
                            torch.where(mine, local, 0)[..., None])[..., 0]
        gold = shardctx.model_all_reduce(gold * mine.to(gold.dtype))
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def loss_fn(params, cfg, batch):
    """(loss, (ce, aux)): the cross-entropy of ``forward_train``'s logits
    plus ``MOE_AUX_COEF`` times its MoE aux loss.  Where ``cfg`` splits
    the vocabulary, the cross-entropy is vocabulary-parallel."""
    split = shardctx.split(cfg, "vocab")
    logits, aux = transformer.forward_train(params, cfg, batch,
                                            local_logits=split)
    ce = cross_entropy(logits, batch["targets"], batch.get("mask"),
                       cfg.vocab_offset if split else None)
    return ce + MOE_AUX_COEF * aux, (ce, aux)


def value_and_grad(params, cfg, batch):
    """((loss, (ce, aux)), grads): ``loss_fn`` and its gradient at every
    parameter leaf (zeros where a leaf does not reach the loss), as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them.  ``params``
    is not modified."""
    leaves = [t.detach().requires_grad_(True) for t in _tree.leaves(params)]
    with torch.enable_grad():
        loss, (ce, aux) = loss_fn(_tree.unflatten(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return ((loss.detach(), (ce.detach(), aux.detach())),
            _tree.unflatten(params, grads))


def default_microbatches(cfg, global_batch: int) -> int:
    """Split the per-step batch so remat activation stacks fit device
    memory; the reference's rule (deep splits for the FSDP giants)."""
    if not cfg.fsdp:
        return 1
    target = {True: 16}.get(cfg.n_experts > 0, 8)
    return min(target, global_batch)


def make_train_step(cfg, lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_clip: float = 1.0, microbatches: int = 1):
    """Returns (opt_init, train_step) with gradient accumulation.

    ``microbatches > 1`` runs the batch in that many equal shards, one after
    the other, and sums each shard's gradients divided by ``microbatches``
    (in float32, or bf16 for the FSDP giants, as the reference does) before
    a single optimizer update.  A batch whose rows ``microbatches`` does not
    divide raises ``ValueError`` before any gradient is taken (the
    reference's reshape refuses it too).  On a mesh,
    ``launch.train.make_mesh_train_step`` composes the same gradients with
    the data-parallel sync."""
    opt_init, opt_update = adam(lr, weight_decay=weight_decay,
                                grad_clip=grad_clip,
                                state_dtype=dtype_of(cfg.opt_state_dtype))
    grads_of = microbatch_grads(cfg, microbatches)

    def train_step(params, opt_state, batch):
        loss, ce, aux, grads = grads_of(params, batch)
        params, opt_state = opt_update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux}

    return opt_init, train_step


def microbatch_grads(cfg, microbatches: int = 1):
    """``grads(params, batch) -> (loss, ce, aux, grads)`` of one batch, in
    ``microbatches`` shards (see ``make_train_step``)."""
    acc_dtype = torch.bfloat16 if cfg.fsdp else torch.float32

    def grads_of(params, batch):
        for key, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(
                    f"batch {key!r} has {x.shape[0]} rows, not a multiple "
                    f"of microbatches={microbatches}")
        if microbatches == 1:
            (loss, (ce, aux)), grads = value_and_grad(params, cfg, batch)
            return loss, ce, aux, grads

        def shard(x, m):
            b = x.shape[0] // microbatches
            return x[m * b:(m + 1) * b]

        grads = _tree.map_tensors(
            lambda p: torch.zeros(p.shape, dtype=acc_dtype, device=p.device),
            params)
        loss = ce = aux = 0.0
        for m in range(microbatches):
            micro = {k: shard(x, m) for k, x in batch.items()}
            (l, (c, a)), g = value_and_grad(params, cfg, micro)
            grads = _tree.map_tensors(
                lambda t, u: t + (u / microbatches).to(acc_dtype), grads, g)
            del g
            loss = loss + l / microbatches
            ce = ce + c / microbatches
            aux = aux + a / microbatches
        return loss, ce, aux, grads

    return grads_of


def make_prefill(cfg, s_max: int):
    return functools.partial(transformer.prefill, cfg=cfg, s_max=s_max)


def make_decode_step(cfg):
    return functools.partial(transformer.decode_step, cfg=cfg)


def make_serve_step(cfg):
    """The decode-shape target: one new token against a full cache."""
    def serve_step(params, caches, tokens):
        return transformer.decode_step(params, cfg, caches, tokens)
    return serve_step
