"""Partitioned-model execution: the paper's Fig. 1 on the LM stack.

Port of ``repro/serving/partitioned.py``.  A ``PartitionedLM`` splits a decoder-only stack (the
served layer kinds: g, l, m, r, s; no tail, as in the reference) at a *unit*
boundary: units ``0..cut_unit-1`` run on the device tier (UE), the
rest on the edge tier (ES), and the boundary hidden state (psi in the
paper) crosses between.  The LyMDO controller picks the cut per slot from
the arch's layer profile (``profiling.lmprofiles``); ``layer_cut_to_unit``
maps a profile-layer cut onto a unit cut.  At the full-offload cut the ES
half holds the whole stack and ``es_engine`` serves token traffic on it.

``mesh=`` (a mesh with a "model" axis) runs both halves tensor-parallel:
each rank places its shard of each half (``launch.sharding.place_params``;
``params`` already the rank's, with its ``RankConfig`` as ``cfg``, pass
through) and runs under the mesh's activation-sharding context, while the boundary
activation (psi) stays replicated over "model"; ``es_engine`` passes the
mesh and the placed ES half on.
"""
from __future__ import annotations

import torch

from .. import _tree, shardctx
from ..configs.base import ArchConfig
from ..models import transformer
from ..models.common import dtype_of
from . import kvpool


def split_params(params, cut_unit: int):
    """Slice the stacked unit params into (ue_half, es_half)."""
    ue = {"embed": params["embed"],
          "units": _tree.map_tensors(lambda a: a[:cut_unit], params["units"])}
    es = {k: v for k, v in params.items() if k != "units"}
    es["units"] = _tree.map_tensors(lambda a: a[cut_unit:], params["units"])
    return ue, es


def layer_cut_to_unit(cfg: ArchConfig, layer_cut: int) -> int:
    """Map a profile-layer cut (0..L) to a unit boundary (0..n_units).

    Profile layers: [input, embed, stack..., head]; stack layer i sits in
    unit i // len(pattern)."""
    stack_cut = max(0, layer_cut - 2 + 1)    # layers executed locally
    return min(stack_cut // len(cfg.block_pattern), cfg.n_units)


class PartitionedLM:
    """Two-tier forward pass for plain decoder stacks of the served kinds
    (g, l, m, r, s).  Like the reference, it refuses stacks with tail
    layers or an encoder, whose cuts would not fall on unit boundaries; it
    also refuses "x" stacks, whose layers need a context that the halves
    are not given (the reference fails on them at the first pass)."""

    def __init__(self, cfg: ArchConfig, params, cut_unit: int, *, mesh=None):
        if cfg.tail_pattern or cfg.enc_layers:
            raise ValueError(
                f"{cfg.name}: the partitioned model takes plain stacks, "
                f"without tail layers or an encoder (as the reference)")
        if not set(cfg.block_pattern) <= set(kvpool.SERVED):
            raise ValueError(
                f"{cfg.name}: the partitioned model takes the kinds "
                f"{'/'.join(kvpool.SERVED)}; {cfg.block_pattern} needs a "
                f"context its halves are not given")
        self.cfg = cfg
        self.cut_unit = int(cut_unit)
        self.mesh = mesh
        self.ue_params, self.es_params = split_params(params, self.cut_unit)
        if mesh is not None:
            from ..launch.sharding import SERVING, place_params
            self.ue_params, self.cfg = place_params(mesh, cfg, self.ue_params,
                                                    SERVING)
            self.es_params, _ = place_params(mesh, cfg, self.es_params,
                                             SERVING)

    def _ue_half(self, tokens):
        x = transformer._embed(self.ue_params, self.cfg, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return transformer.run_units(self.ue_params["units"], self.cfg, x,
                                     positions)[0]

    def _es_half(self, hidden):
        positions = torch.arange(hidden.shape[1], device=hidden.device)
        x, _ = transformer.run_units(self.es_params["units"], self.cfg,
                                     hidden, positions)
        return transformer._logits(self.es_params, self.cfg, x)

    def boundary_bytes(self, batch: int, seq: int) -> int:
        """psi: what crosses the uplink (eq. 3's payload)."""
        if self.cut_unit == 0:
            return batch * seq * 4                      # raw tokens
        return batch * seq * self.cfg.d_model * 2        # bf16 hidden

    def es_engine(self, **engine_kwargs):
        """A continuous-batching ``ServingEngine`` on the ES half; the
        full-offload cut only (``cut_unit == 0``)."""
        if self.cut_unit != 0:
            raise ValueError(
                f"es_engine needs the full-offload cut (cut_unit=0, the "
                f"whole stack on the ES tier); got cut_unit="
                f"{self.cut_unit}")
        from .engine import ServingEngine
        return ServingEngine(self.cfg, self.es_params, mesh=self.mesh,
                             **engine_kwargs)

    def infer(self, tokens):
        """Returns (logits, boundary activation): the latter is what the
        transmission model charges for."""
        with shardctx.mesh_context(self.mesh):
            if self.cut_unit == 0:
                # full offload: raw tokens cross the uplink, ES does it all
                x = transformer._embed(self.es_params, self.cfg, tokens)
                return (self._es_half(x.to(dtype_of(self.cfg.compute_dtype))),
                        tokens)
            hidden = self._ue_half(tokens)
            return self._es_half(hidden), hidden
