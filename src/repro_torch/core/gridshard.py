"""Rank-sharded ScenarioGrid support: the cell axis over a cells mesh.

Port of ``repro/core/gridshard.py``.  The reference is single-controller:
it pads the (B, ...) stack to a device multiple, places it with
``NamedSharding(P("cells", ...))`` and lets GSPMD partition one jitted
scan.  Here every rank is a process running the same program (built by
:func:`repro_torch.launch.mesh.make_cells_mesh`), so the layout is
explicit:

* :func:`plan` rounds B up to a multiple of the mesh's cell-shard count and
  records the split, and this rank's place in it, in a
  :class:`GridSharding`;
* :func:`pad_cells` edge-replicates the last real cell into the padded
  slots (their math stays finite, and :meth:`GridSharding.mask` marks them
  invalid);
* :func:`local` -- the counterpart of ``place`` -- takes this rank's
  ``b_local`` rows of the padded stack; the rank runs the batched slot on
  them alone, since cells are independent and every per-cell reduction
  stays inside one rank;
* :func:`gather` collects every rank's rows over the ``"cells"`` group into
  the padded stack, once at the end of a rollout, and :func:`unpad` slices
  the padding off.

Randomness: the reference folds the cell index into a key
(``cell_keys``), so cell i draws the same values at any padding.  The port
draws from one ``torch.Generator`` a whole (B, N) tensor at a time, so a
rank that drew only its own rows would draw other numbers.  The rule that
keeps the invariant instead: every rank draws the *logical* (b, N) tensor
from the same seeded generator and keeps the rows :func:`cell_index` names
(its own, the padded slots taking the last real cell's, as padded cells
reuse the last real cell's key in the reference).  Sharded draws then equal
unsharded ones bit for bit.  The cost is one logical draw per rank per slot
(32,768 values at 4096 x 8), and a user policy that draws from the
generator itself sees only the rank's shard.

The reference's ``constrain`` (an in-jit sharding constraint) has no
meaning without GSPMD and is not ported.

On a ``("cells", "model")`` mesh (``make_cells_mesh(model=M)``) the plan
also splits each cell's UE axis M ways where M divides N, and otherwise
holds every cell whole on every "model" rank, as the reference replicates
a dim that does not divide.  A rank then holds the (b_local, N / M) block
of every per-UE leaf (``local(..., ues=True)``), and the slot's per-UE
work (the cut projection, P3, the delays, energy, memory and queue
updates) stays on it.  What couples a cell's UEs is done whole on every
"model" rank instead of summed across ranks: the inputs of P4 and P5 are
all-gathered once a slot (:meth:`GridSharding.ue_whole`), both solves run
over the whole cell, and each rank keeps its columns
(:meth:`GridSharding.ue_own`); the per-UE terms of the reward are
all-gathered before their sum.  So a slot takes two collectives on the
"model" sub-group, whatever P5's 42 x 36 bisection does, and every sum
runs over whole rows in the unsharded order: sharded rollouts equal
unsharded ones bit for bit on the CPU.  :data:`calls` counts the slot's
collectives.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from .. import _tree
from ..launch.mesh import CELLS as CELL_AXIS
from ..launch.mesh import MODEL as MODEL_AXIS
from ..launch.mesh import _on_host, pack, unpack
from ..shardctx import record

__all__ = ["CELL_AXIS", "MODEL_AXIS", "GridSharding", "plan", "pad_cells",
           "cell_index", "local", "gather", "unpad", "calls"]

# collectives issued by ``GridSharding.ue_whole`` (a slot's all-gathers
# over "model"), by name
calls: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """The split of one stacked (B, ...) grid over ``n_shards`` ranks.

    ``b`` logical cells are padded to ``b_padded`` (a multiple of
    ``n_shards``); rank ``rank`` holds rows ``rows`` of the padded stack,
    ``b_local`` of them.  ``mesh`` is the ``DeviceMesh`` whose ``axis``
    group :func:`gather` runs over (None: one process holds every shard).

    ``n_ue`` UEs a cell are split ``ue_shards`` ways over the "model"
    axis (1: every rank holds whole cells); this rank holds the UEs
    ``ue_cols``, ``n_ue_local`` of them.
    """

    b: int
    b_padded: int
    n_shards: int = 1
    rank: int = 0
    mesh: Any = None
    axis: str = CELL_AXIS
    n_ue: int = 0
    ue_shards: int = 1
    ue_rank: int = 0

    def __post_init__(self):
        if self.b < 1:
            raise ValueError("need at least one cell")
        if self.b_padded < self.b:
            raise ValueError(f"b_padded={self.b_padded} < b={self.b}")
        if self.n_shards < 1 or self.b_padded % self.n_shards:
            raise ValueError(
                f"b_padded={self.b_padded} not a multiple of the "
                f"{self.n_shards}-way {self.axis!r} axis")
        if not 0 <= self.rank < self.n_shards:
            raise ValueError(f"rank {self.rank} outside 0..{self.n_shards - 1}")
        if self.ue_shards > 1 and self.n_ue % self.ue_shards:
            raise ValueError(
                f"{self.n_ue} UEs a cell do not split {self.ue_shards} ways")

    @property
    def pad(self) -> int:
        """Number of padded (invalid) trailing cells."""
        return self.b_padded - self.b

    @property
    def b_local(self) -> int:
        """Cells a rank holds."""
        return self.b_padded // self.n_shards

    @property
    def rows(self) -> slice:
        """This rank's rows of the padded stack."""
        return slice(self.rank * self.b_local, (self.rank + 1) * self.b_local)

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.get_group(self.axis)

    @property
    def n_ue_local(self) -> int:
        """UEs of a cell this rank holds."""
        return self.n_ue // self.ue_shards

    @property
    def ue_cols(self) -> slice:
        """This rank's UEs of every cell."""
        return slice(self.ue_rank * self.n_ue_local,
                     (self.ue_rank + 1) * self.n_ue_local)

    def ue_whole(self, xs: list) -> list:
        """Each of ``xs`` (..., n_ue_local), this rank's UE columns, joined
        with the other "model" ranks' into (..., n_ue) whole-cell rows: one
        all-gather a dtype over the "model" sub-group.  As they are where
        the UE axis is not split."""
        if self.ue_shards == 1:
            return list(xs)
        calls["ue_whole"] += 1
        return _all_gather(xs, self.mesh.get_group(MODEL_AXIS),
                           self.ue_shards, -1)

    def ue_own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's UE columns of a whole-cell (..., n_ue) tensor."""
        if self.ue_shards == 1:
            return x
        return x[..., self.ue_cols]

    def mask(self) -> torch.Tensor:
        """(b_padded,) validity mask: True for real cells, False for padding.

        Any reduction that crosses the cell axis of a padded stack must
        apply this before trusting the numbers.
        """
        return torch.arange(self.b_padded) < self.b


def plan(b: int, mesh, *, axis: str = CELL_AXIS,
         pad_to: int | None = None, n_ue: int = 0) -> GridSharding:
    """Round ``b`` up to a multiple of ``mesh``'s ``axis`` size and return
    this rank's plan.

    ``pad_to`` forces a larger padded width (it must itself be a multiple)
    -- used by tests to exercise the padding path on any rank count.
    ``n_ue`` is the UE count of a cell: on a mesh with a "model" axis of
    size M it splits M ways where M divides it, else each "model" rank
    holds whole cells.
    """
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis; axes are {names}")
    if b < 1:
        raise ValueError("need at least one cell")
    n = int(mesh.size(names.index(axis)))
    b_padded = -(-b // n) * n
    if pad_to is not None:
        if pad_to < b_padded or pad_to % n:
            raise ValueError(
                f"pad_to={pad_to} must be a multiple of {n} and >= {b_padded}")
        b_padded = pad_to
    m = (int(mesh.size(names.index(MODEL_AXIS))) if MODEL_AXIS in names
         else 1)
    split = m > 1 and n_ue > 0 and n_ue % m == 0
    return GridSharding(b=b, b_padded=b_padded, n_shards=n,
                        rank=int(mesh.get_local_rank(axis)), mesh=mesh,
                        axis=axis, n_ue=int(n_ue), ue_shards=m if split else 1,
                        ue_rank=int(mesh.get_local_rank(MODEL_AXIS))
                        if split else 0)


def _rows_of(x: torch.Tensor, idx: torch.Tensor, lead: int) -> torch.Tensor:
    if x.dim() <= lead:              # scalar rider: no cell axis
        return x
    return x.index_select(lead, idx.to(x.device))


def pad_cells(tree, gs: GridSharding, *, lead: int = 0):
    """Pad every leaf's cell axis from b to b_padded by edge replication.

    Padded cells are copies of the last real cell: every downstream op stays
    finite (zero padding would divide by zero in the queueing math), and
    ``gs.mask()`` keeps them out of reported results.
    """
    if gs.pad == 0:
        return tree
    idx = torch.clamp(torch.arange(gs.b_padded), max=gs.b - 1)
    return _tree.map_tensors(lambda x: _rows_of(x, idx, lead), tree)


def cell_index(gs: GridSharding) -> torch.Tensor:
    """(b_local,) logical cell of each of this rank's rows: its padded-stack
    row, with the padded slots clamped to the last real cell.  The twin of
    the reference's ``cell_keys``: a rank's row takes that cell's row of
    any logical (b, ...) tensor -- a parameter, or a slot's draws."""
    return torch.clamp(torch.arange(gs.rows.start, gs.rows.stop), max=gs.b - 1)


def _ue_axis(x: torch.Tensor, lead: int) -> bool:
    """Whether a leaf with the cell axis at ``lead`` has a UE axis after
    it: per-cell scalars (and scalar riders) do not."""
    return x.dim() > lead + 1


def local(tree, gs: GridSharding, *, lead: int = 0, ues: bool = False):
    """This rank's ``b_local`` rows of the padded stack of ``tree``, whose
    leaves carry the logical b cells (or the padded b_padded) on ``lead``.
    With ``ues``, every leaf with an axis after ``lead`` (the UE axis of a
    per-UE or per-(UE, cut) leaf) keeps the rank's UE columns there too.
    Scalar riders pass through."""
    idx = cell_index(gs)
    cols = gs.ue_cols if ues and gs.ue_shards > 1 else None

    def f(x):
        x = _rows_of(x, idx, lead)
        if cols is not None and _ue_axis(x, lead):
            x = x.narrow(lead + 1, cols.start, gs.n_ue_local).contiguous()
        return x

    return _tree.map_tensors(f, tree)


def _all_gather(xs: list, group, n: int, dim: int) -> list:
    """Each of ``xs`` joined along ``dim`` with the other ``n`` ranks' of
    ``group``, in rank order: one all-gather a dtype (gloo on host copies,
    the result back on each tensor's device)."""
    host = _on_host(group)
    moved = [x.movedim(dim, 0).contiguous() for x in xs]
    buffers, layout = pack(moved)
    joined = {}
    for dt, buf in buffers.items():
        buf = buf.cpu() if host else buf
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf, group=group)
        record("all-gather", n * buf.numel() * buf.element_size(), dt)
        joined[dt] = parts
    # rank r's buffer holds its part of every tensor: split each, then join
    # the ranks' pieces of one tensor along ``dim``
    per_rank = [unpack({dt: joined[dt][r] for dt in joined}, layout)
                for r in range(n)]
    return [torch.cat([pieces[i] for pieces in per_rank]).movedim(0, dim)
            .contiguous().to(x.device) for i, x in enumerate(xs)]


def gather(tree, gs: GridSharding, *, lead: int = 0, ues: bool = False):
    """Every rank's rows of ``tree`` (each leaf ``b_local`` on ``lead``)
    joined into the padded stack (``b_padded`` on ``lead``), on every rank:
    one all-gather a dtype over the ``"cells"`` group.  With ``ues``, the
    UE columns of per-UE leaves (an axis after ``lead``) are first joined
    over the "model" group, one all-gather a dtype.  Under gloo it runs on
    host copies and the result returns to each leaf's device; under NCCL
    on the device.  Scalar riders pass through."""
    if ues and gs.ue_shards > 1:
        per_ue = [x for x in _tree.leaves(tree) if _ue_axis(x, lead)]
        if per_ue:
            out = iter(_all_gather(per_ue, gs.mesh.get_group(MODEL_AXIS),
                                   gs.ue_shards, lead + 1))
            tree = _tree.map_tensors(
                lambda x: next(out) if _ue_axis(x, lead) else x, tree)
    if gs.n_shards == 1:
        return tree
    leaves = [x for x in _tree.leaves(tree) if x.dim() > lead]
    if not leaves:
        return tree
    out = iter(_all_gather(leaves, gs.group, gs.n_shards, lead))
    return _tree.map_tensors(
        lambda x: next(out) if x.dim() > lead else x, tree)


def unpad(tree, gs: GridSharding, *, lead: int = 0):
    """Slice the cell axis back to the logical b (inverse of pad_cells)."""
    if gs.pad == 0:
        return tree

    def f(x):
        if x.dim() <= lead:          # scalar rider: nothing was padded
            return x
        return x.narrow(lead, 0, gs.b)

    return _tree.map_tensors(f, tree)
