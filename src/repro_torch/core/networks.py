"""The MLP stack of the PPO actor and critic (Sec. V-A: two hidden layers,
128 and 64 units).

Port of ``repro/core/networks.py``.  Parameters are a list of
``{"w": (din, dout), "b": (dout,)}`` dicts, the reference's pytree.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device


def mlp_init(gen: torch.Generator, sizes, device=None,
             dtype=torch.float32) -> list:
    """Normal weights times sqrt(2 / fan_in), zero biases, drawn from
    ``gen`` (a generator on ``device``)."""
    device = resolve_device(device)
    params = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((din, dout), generator=gen, device=device,
                        dtype=dtype) * math.sqrt(2.0 / din)
        params.append({"w": w, "b": torch.zeros((dout,), device=device,
                                                dtype=dtype)})
    return params


def mlp_apply(params, x: torch.Tensor, final_scale: float = 1.0):
    """tanh on the hidden layers; the last layer linear, then times
    ``final_scale`` (the policy heads' small-init trick)."""
    for layer in params[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    last = params[-1]
    return (x @ last["w"] + last["b"]) * final_scale
