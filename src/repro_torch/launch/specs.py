"""The assigned input-shape table, and shape-only stand-ins for every input
of a cell.

Port of ``repro/launch/specs.py``.  The reference builds
``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``; here every stand-in
is a tensor on the meta device: its shape and dtype, and no storage, so
the trees of qwen1.5-110b and llama4 cost no host memory.  The parameter
tree is ``models.transformer.init_params`` on the meta device, which
draws nothing; the decode cache is ``transformer._init_caches`` (what
``prefill`` allocates) at the cell's length, ``pos`` a 0-d int32.  The
dry run (``launch.dryrun``) turns a rank's share of them into fake
tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import _tree
from ..configs.base import ArchConfig
from ..models import transformer
from ..models.common import dtype_of
from ..optim.adam import AdamState


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# decode cells write at pos=seq; the cache holds seq + margin.  128 keeps
# the padded cache length divisible by the 16-way mesh axes (32768 + 128 =
# 32896 = 16 * 2056)
DECODE_MARGIN = 128


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """The skip rules: (supported, the reason where not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full attention; 512k-KV decode needs "
                       "sub-quadratic structure (DESIGN §4)")
    return True, ""


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: a meta tensor."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def decoder_seq(cfg, shape: ShapeSpec) -> int:
    """Decoder tokens of a cell: a quarter of the frames where an encoder
    takes ``shape.seq`` of them."""
    return shape.seq // 4 if cfg.enc_layers else shape.seq


def batch_specs(cfg: ArchConfig, shape: ShapeSpec, *, train: bool) -> dict:
    """Token / embedding stand-ins for a train or prefill cell."""
    cdt = dtype_of(cfg.compute_dtype)
    dec_seq = decoder_seq(cfg, shape)
    out = {"tokens": sds((shape.batch, dec_seq), torch.int32)}
    if train:
        out["targets"] = sds((shape.batch, dec_seq), torch.int32)
    if cfg.frontend == "vision":
        out["image_embeds"] = sds(
            (shape.batch, cfg.n_frontend_tokens, cfg.d_model), cdt)
    if cfg.enc_layers:
        out["src_embeds"] = sds((shape.batch, shape.seq, cfg.d_model), cdt)
    return out


def params_specs(cfg: ArchConfig) -> dict:
    """The parameter tree's stand-ins (nothing drawn, nothing allocated)."""
    return transformer.init_params(0, cfg, "meta")


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, batch: int | None = None):
    """The serving cache of a ``shape.seq``-long context, as ``prefill``
    builds it (``batch`` rows, by default the cell's)."""
    b = shape.batch if batch is None else batch
    s_max = decoder_seq(cfg, shape) + DECODE_MARGIN
    ctx = (cfg.n_frontend_tokens if cfg.frontend == "vision" else
           shape.seq if cfg.enc_layers else 0)
    cache = transformer._init_caches(cfg, b, s_max, "meta", ctx)
    cache["pos"] = sds((), torch.int32)
    return cache


def opt_specs(cfg: ArchConfig, params) -> AdamState:
    """Adam's state for ``params``: the moments in ``cfg.opt_state_dtype``."""
    dt = dtype_of(cfg.opt_state_dtype)
    moments = lambda: _tree.map_tensors(
        lambda p: sds(p.shape, dt), params)
    return AdamState(step=sds((), torch.int32), mu=moments(), nu=moments())


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """Everything the cell's step consumes, as stand-ins."""
    shape = SHAPES[shape_name]
    params = params_specs(cfg)
    if shape.kind == "train":
        return {"params": params, "opt_state": opt_specs(cfg, params),
                "batch": batch_specs(cfg, shape, train=True)}
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_specs(cfg, shape, train=False)}
    return {"params": params, "cache": cache_specs(cfg, shape),
            "tokens": sds((shape.batch,), torch.int32)}
