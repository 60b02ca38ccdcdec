"""Leaf-wise maps over the port's containers: dataclasses, named tuples,
dicts and lists whose entries are tensors, nested containers or static
values.

This is what ``jax.tree.map`` does for the reference's pytrees: it stacks B
cells into one batch, moves a whole parameter set to a device, and slices
one cell back out.  Fields that are neither tensors nor containers (the
``edge_queueing`` flag, a ``torch.Generator``) are static and pass through
from the first argument.
"""
from __future__ import annotations

import dataclasses

import torch


def map_tensors(fn, *trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: map_tensors(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(map_tensors(fn, *leaves)
                             for leaves in zip(*trees)))
    if isinstance(first, dict):
        return {k: map_tensors(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [map_tensors(fn, *leaves) for leaves in zip(*trees)]
    return first


def stack(trees, dim: int = 0):
    """Stack same-shaped containers along a new leading axis."""
    return map_tensors(lambda *xs: torch.stack(xs, dim), *trees)


def to_device(tree, device):
    return map_tensors(lambda x: x.to(device), tree)


def index(tree, i):
    """Select entry ``i`` of every leaf's leading axis."""
    return map_tensors(lambda x: x[i], tree)
