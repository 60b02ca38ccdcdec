"""Leaf-wise maps over the port's containers: dataclasses, named tuples,
dicts and lists whose entries are tensors, nested containers or static
values.

This is what ``jax.tree.map`` does for the reference's pytrees: it stacks B
cells into one batch, moves a whole parameter set to a device, and slices
one cell back out.  Fields that are neither tensors nor containers (the
``edge_queueing`` flag, a ``torch.Generator``) are static and pass through
from the first argument.  ``from_numpy`` carries another implementation's
nested dicts and lists of arrays across as tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


def leaves(tree) -> list:
    """The tensors of ``tree`` in ``map_tensors``' order."""
    out = []
    map_tensors(lambda x: out.append(x) or x, tree)
    return out


def unflatten(tree, xs):
    """``tree`` with its tensors replaced, in ``leaves`` order, by ``xs``."""
    it = iter(xs)
    return map_tensors(lambda _: next(it), tree)


def from_numpy(tree, device, dtype=None):
    """Nested dicts, lists and tuples of numpy arrays as the same nesting of
    tensors on ``device`` (tuples become lists).  With ``dtype`` every leaf
    is cast to it; without, bfloat16 (ml_dtypes) leaves stay bfloat16, other
    floating leaves become float32 and the rest keep their type."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy(v, device, dtype) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    elif a.dtype.kind == "f":
        t = torch.from_numpy(np.array(a, np.float32))
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype)
