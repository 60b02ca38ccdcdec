"""Adam / AdamW on parameter trees, written out by hand.

Port of ``repro/optim/adam.py``.  ``torch.optim.Adam`` and
``clip_grad_norm_`` are not used: the latter divides by ``norm + 1e-6``,
where the reference scales by ``min(1, clip / max(norm, 1e-12))``, and the
reference's bias corrections and epsilon placement are kept as they are.
Trees are the port's nested dicts and lists of tensors; ``update_fn``
returns new trees and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import _tree


class AdamState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moment, a tree like params
    nu: Any              # second moment, a tree like params


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: float | None = None,
         state_dtype: torch.dtype | None = None, norm=None):
    """Returns ``(init_fn, update_fn)``.

    ``update_fn(grads, state, params) -> (new_params, new_state)``.
    ``weight_decay`` is decoupled (AdamW) decay; ``grad_clip`` is a
    global-norm clip over the whole tree, applied before the moments.
    ``norm(grads)`` is that norm (default :func:`global_norm`); where the
    tree is a rank's shard of a model split over "model", it is the whole
    model's (``launch.sharding.global_norm``).  The moments are kept in
    ``state_dtype`` (default: the params' dtype) and updated in float32.
    """
    norm = global_norm if norm is None else norm

    def _cast(x):
        return x.to(state_dtype) if state_dtype is not None else x

    def init_fn(params) -> AdamState:
        device = _tree.leaves(params)[0].device
        zeros = lambda p: _cast(torch.zeros_like(p))
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                         mu=_tree.map_tensors(zeros, params),
                         nu=_tree.map_tensors(zeros, params))

    def update_fn(grads, state: AdamState, params):
        if grad_clip is not None:
            gnorm = norm(grads)
            scale = torch.clamp_max(
                grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
            grads = _tree.map_tensors(lambda g: g * scale, grads)
        step = state.step + 1
        b1t = 1.0 - b1 ** step.to(torch.float32)
        b2t = 1.0 - b2 ** step.to(torch.float32)
        mu = _tree.map_tensors(
            lambda g, m: m.float() * b1 + (1.0 - b1) * g.float(),
            grads, state.mu)
        nu = _tree.map_tensors(
            lambda g, v: v.float() * b2 + (1.0 - b2) * torch.square(g.float()),
            grads, state.nu)

        def upd(p, m, v):
            update = (m / b1t) / (torch.sqrt(v / b2t) + eps)
            if weight_decay:
                update = update + weight_decay * p.float()
            return (p.float() - lr * update).to(p.dtype)

        new_params = _tree.map_tensors(upd, params, mu, nu)
        return new_params, AdamState(step=step,
                                     mu=_tree.map_tensors(_cast, mu),
                                     nu=_tree.map_tensors(_cast, nu))

    return init_fn, update_fn


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in _tree.leaves(tree)))
