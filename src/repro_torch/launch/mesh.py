"""Mesh construction on ``torch.distributed``.

Port of ``repro/launch/mesh.py``.  The reference is one
controller over every live device; here every rank is a process of its own
running the same program (SPMD), one rank a device, joined by the default
process group.  So a mesh needs that group first:

* :func:`init_group` joins it -- from torchrun's environment where
  ``WORLD_SIZE`` is set, from an explicit ``rank`` / ``world_size`` /
  ``init_method`` (a test or a smoke run spawning its own ranks), or else
  as a one-rank group on a ``FileStore`` in a temporary directory -- and
  sets the rank's CUDA device;
* :func:`make_cells_mesh` lays a ``("cells",)`` or ``("cells",
  "model")`` ``DeviceMesh`` over it, :func:`make_production_mesh` the
  ``(16, 16)`` ``("data", "model")`` pod (or ``(2, 16, 16)`` with
  "pod"), :func:`elastic_mesh` the largest ``("data", "model")`` mesh the
  world divides, and :func:`make_host_mesh` a 1 x 1 ``("data", "model")``
  mesh on a one-rank group (joining one where none exists);
* :func:`run_world` spawns ranks on this host, each joined to one group,
  with a deadline (what ``torchrun --nproc-per-node N`` does for a CLI);
* :func:`fake_world` joins one rank of an ``n``-rank group on torch's
  ``fake`` backend, whose collectives move nothing: with fake tensors a
  single process runs one rank of the production mesh
  (``launch.dryrun``).

A mesh's device type follows the backend: ``"cuda"`` under NCCL, ``"cpu"``
under gloo (whose collectives run on host copies).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .. import _tree
from ..device import resolve_device
from ..shardctx import record

CELLS, MODEL = "cells", "model"


def init_group(backend: str | None = None, device=None, *,
               rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None) -> torch.device:
    """Join the default process group; returns this rank's device.

    ``device=None`` means CUDA (it raises where there is none); a CUDA
    device without an index becomes ``cuda:LOCAL_RANK``, and the rank's
    current CUDA device is set to it.  ``backend=None`` is NCCL on CUDA and
    gloo on the CPU.  ``rank`` / ``world_size`` / ``init_method`` default to
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``env://`` where ``WORLD_SIZE``
    is set, and otherwise to a one-rank group on a ``FileStore`` in a new
    temporary directory.
    """
    if dist.is_initialized():
        raise RuntimeError("the default process group already exists")
    device = resolve_device(device)
    env = "WORLD_SIZE" in os.environ
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None:
        init_method = "env://" if env else "file://" + os.path.join(
            tempfile.mkdtemp(prefix="repro_group_"), "store")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """Rank ``rank`` of an ``n``-rank default process group on torch's
    ``fake`` backend, in this process: collectives return at once and
    move nothing, so a mesh of any size (``make_production_mesh``'s 256 or
    512 ranks) is built and one rank's program runs on fake tensors.  It
    refuses to start where a default group exists, and destroys its group
    on exit."""
    if dist.is_initialized():
        raise RuntimeError("a fake world needs no default process group; "
                           "one already exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(n))
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_cells_mesh(n_devices: int | None = None, *, model: int = 1):
    """``DeviceMesh`` for sharding a ScenarioGrid's stacked cell axis (see
    ``repro_torch.core.gridshard``): 1-D ``("cells",)``, or 2-D
    ``("cells", "model")`` when ``model > 1``, over the default process
    group's ranks.  Its device type follows the backend: ``"cuda"`` under
    NCCL, ``"cpu"`` under gloo (whose collectives run on host copies).

    ``n_devices=None`` takes every rank; any other count must equal the
    world size.  Every layout precondition is checked here, with a message
    that says what to do.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "a cells mesh needs the default process group: call "
            "repro_torch.launch.mesh.init_group() (or "
            "torch.distributed.init_process_group) first, or launch with "
            "torchrun --nproc-per-node N")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    model = int(model)
    if n < 1:
        raise ValueError(f"need at least one device, got n_devices={n}")
    if n != world:
        raise ValueError(
            f"requested a {n}-device cells mesh but the default process "
            f"group has {world} rank(s), one device each; launch with "
            f"torchrun --nproc-per-node {n} (or pass n_devices=None)")
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got model={model}")
    if n % model:
        raise ValueError(
            f"model={model} does not divide the {n}-device mesh; pick a "
            f"model-axis size from the divisors of {n} "
            f"({[d for d in range(1, n + 1) if n % d == 0]})")
    if model > 1:
        return _device_mesh((n // model, model), (CELLS, MODEL))
    return _device_mesh((n,), (CELLS,))


def _device_mesh(shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks, in
    rank order, its device type the backend's."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks a pod, ``("data", "model")``; ``multi_pod``
    adds a leading 2-pod axis (512 ranks, ``("pod", "data", "model")``).
    Any other world raises ``ValueError``, as the reference's
    ``jax.make_mesh`` does on the wrong device count."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for d in shape:
        need *= d
    have = world_size()
    if have != need:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs {need} "
            f"ranks, one device each; the default process group has {have}"
            + ("" if dist.is_initialized() else " (none is initialized)")
            + f": launch {need} ranks with torchrun (e.g. torchrun --nnodes "
            f"{need // 8} --nproc-per-node 8 ...), or serve one device "
            "without --multi-pod")
    return _device_mesh(shape, names)


def make_host_mesh():
    """The degenerate 1 x 1 ``("data", "model")`` mesh of a smoke run, on a
    one-rank group: where no default group exists it joins one (gloo, a
    ``FileStore`` in a temporary directory; the caller may destroy it with
    ``torch.distributed.destroy_process_group``)."""
    if not dist.is_initialized():
        init_group("gloo", "cpu")
    if world_size() != 1:
        raise ValueError(
            f"the host mesh is one rank; the default process group has "
            f"{world_size()} (use make_cells_mesh or elastic_mesh)")
    return _device_mesh((1, 1), ("data", "model"))


def elastic_mesh(target_model: int = 16):
    """The largest ``(data, model)`` mesh the world divides: the "model"
    axis is ``target_model`` where the world allows, else the largest
    divisor of the world below it."""
    if not dist.is_initialized():
        raise RuntimeError(
            "an elastic mesh needs the default process group: call "
            "repro_torch.launch.mesh.init_group() first, or launch with "
            "torchrun --nproc-per-node N")
    n = world_size()
    model = min(int(target_model), n)
    if model < 1:
        raise ValueError(f"target_model must be >= 1, got {target_model}")
    while n % model:
        model -= 1
    return _device_mesh((n // model, model), ("data", "model"))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch (DP): ("pod","data") when present."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def data_size(mesh) -> int:
    """Ranks over ``mesh``'s data axes (1 where it has none)."""
    n = 1
    for a in data_axes(mesh):
        n *= int(mesh.size(mesh.mesh_dim_names.index(a)))
    return n


def axes_group(mesh, axes):
    """(this rank's process group over ``axes`` of ``mesh``, its size): a
    name, or a tuple of names joined row-major (the data axes ("pod",
    "data") of a multi-pod mesh)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has no {a!r} axis; axes are {names}")
    n = 1
    for a in axes:
        n *= int(mesh.size(names.index(a)))
    if len(axes) == 1:
        return mesh.get_group(axes[0]), n
    return mesh[axes]._flatten().get_group(), n


def world_size() -> int:
    """Ranks in the default process group; 1 where there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _on_host(group=None) -> bool:
    """Gloo's collectives take CPU tensors only; NCCL's take CUDA ones."""
    return dist.get_backend(group) != "nccl"


def pack(leaves) -> tuple[dict, list]:
    """One flat buffer a dtype of ``leaves`` (each flattened), and how to
    split it back: a collective then moves each dtype once."""
    groups: dict = {}
    for x in leaves:
        groups.setdefault(x.dtype, []).append(x.reshape(-1))
    return ({dt: torch.cat(xs) for dt, xs in groups.items()},
            [(x.dtype, x.numel(), x.shape) for x in leaves])


def unpack(buffers: dict, layout: list) -> list:
    offsets = {dt: 0 for dt in buffers}
    out = []
    for dt, numel, shape in layout:
        out.append(buffers[dt][offsets[dt]:offsets[dt] + numel].reshape(shape))
        offsets[dt] += numel
    return out


def broadcast_tree(tree, src: int = 0, group=None):
    """``tree`` with every tensor replaced by rank ``src``'s, on each
    rank's own device (one broadcast a dtype).  Every rank passes a tree of
    the same structure and shapes."""
    leaves = _tree.leaves(tree)
    if not leaves:
        return tree
    buffers, layout = pack(leaves)
    host = _on_host(group)
    for dt in buffers:
        buf = buffers[dt].cpu() if host else buffers[dt].contiguous()
        dist.broadcast(buf, src, group=group)
        record("all-reduce", buf)     # the reference's broadcast_one_to_all
        buffers[dt] = buf
    out = unpack(buffers, layout)
    return _tree.unflatten(tree, [x.to(leaf.device) for x, leaf
                                  in zip(out, leaves)])


def _world_rank(rank: int, fn, nprocs: int, backend: str, device: str,
                store_dir: str) -> None:
    torch.set_num_threads(1)
    args = torch.load(os.path.join(store_dir, "args.pt"), weights_only=False)
    init_group(backend, device, rank=rank, world_size=nprocs,
               init_method="file://" + os.path.join(store_dir, "store"))
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))


def run_world(fn, nprocs: int, *, args: tuple = (), backend: str = "gloo",
              device="cpu", deadline_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks spawned on this host, each
    joined to one default process group (a ``FileStore`` in a temporary
    directory, no TCP port) on ``device``; returns each rank's result, by
    rank.  ``fn`` must be importable by name (a module-level function) and
    return what ``torch.save`` can write.  A rank that raises fails the
    world: the others are ended and the error is raised here.  So is a
    world still running after ``deadline_s`` seconds.  ``args`` go to the
    ranks through a file in the world's directory: a spawned process
    reads its pickled arguments from a pipe only once it has started, so
    arguments larger than the pipe's buffer would start the ranks one
    after another."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_world_") as store_dir:
        torch.save(tuple(args), os.path.join(store_dir, "args.pt"))
        ctx = mp.start_processes(
            _world_rank, args=(fn, nprocs, backend, str(device), store_dir),
            nprocs=nprocs, join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"a {nprocs}-rank world ran past its "
                        f"{deadline_s:.0f} s deadline")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
