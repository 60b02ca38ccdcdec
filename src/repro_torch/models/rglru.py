"""Griffin recurrent block (arXiv:2402.19427): layer kind "r".

Port of ``repro/models/rglru.py``.  Block: x -> gelu(W_gate x) *
RGLRU(conv1d(W_x x)) -> W_out, with the RG-LRU

    r_t = sigmoid(W_r u_t),  i_t = sigmoid(W_i u_t)
    log a_t = -8 softplus(Lambda) r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t)

whose linear recurrence runs as ``kernels.ops.rglru_scan`` (the CUDA
kernel on the card).  Decode keeps a (conv, h) cache whose size does not
grow with the sequence; the decode step is elementwise and updates the
cache it is given in place.

Under tensor parallelism (``cfg`` a ``shardctx.RankConfig`` that splits
"rglru") the rank holds its slice of the recurrent width R: its columns of
``w_x``, ``w_gate``, ``conv``, ``w_r`` and ``w_i``, its entries of
``lam`` and its rows of ``w_out``.  The gates couple every channel of u,
so u is all-gathered over "model" once a layer (a sequence, or a decode
step) and multiplied by the rank's gate columns; the scan, the conv and
the state stay local, and the row-parallel ``w_out`` is all-reduced.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import shardctx
from ..kernels import ops
from .common import dense_init, dtype_of, pad_reset
from .ssm import conv_full, conv_tail

_C = 8.0


class RglruCache(NamedTuple):
    conv: torch.Tensor   # (B, conv_width - 1, R)
    h: torch.Tensor      # (B, R) float32 recurrent state


def init_rglru(gen, cfg, device=None) -> dict:
    d, r = cfg.d_model, cfg.resolved_rnn_width
    dt = dtype_of(cfg.param_dtype)
    return {
        "w_x": dense_init(gen, (d, r), dt, device=device),
        "w_gate": dense_init(gen, (d, r), dt, device=device),
        "conv": dense_init(gen, (cfg.conv_width, r), dt, scale=0.5,
                           device=device),
        "w_r": dense_init(gen, (r, r), dt, device=device),
        "w_i": dense_init(gen, (r, r), dt, device=device),
        "lam": torch.full((r,), 0.65, device=device),
        "w_out": dense_init(gen, (r, d), dt, device=device),
    }


def _gates(params, cfg, u):
    """(a, drive) in float32: the decay a_t and the gated input.  Where R
    is split, the gates read the whole u (one all-gather over "model")."""
    u_all = (shardctx.model_all_gather(u, -1)
             if shardctx.split(cfg, "rglru") else u)
    r = torch.sigmoid((u_all @ params["w_r"]).float())
    i = torch.sigmoid((u_all @ params["w_i"]).float())
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, scale * i * u.float()


def _gelu(t):
    return F.gelu(t, approximate="tanh")      # jax.nn.gelu's default


def apply_rglru(params, cfg, x, want_cache: bool = False, pad_mask=None):
    """Full-sequence recurrent mixer.  x (B, S, D) -> (B, S, D)
    [, RglruCache].

    ``pad_mask`` (B, S) bool marks the valid (non-left-pad) positions: pad
    inputs are zeroed ahead of the temporal conv and a reset mask goes into
    the scan, so a padded row's outputs and cache equal its solo run's.
    """
    x = shardctx.enter(cfg, "rglru", x)
    u_pre = x @ params["w_x"]
    reset = None
    if pad_mask is not None:
        u_pre = torch.where(pad_mask[:, :, None], u_pre, 0.0)
        reset = pad_reset(pad_mask)
    u = conv_full(params["conv"], u_pre).to(u_pre.dtype)
    a, drive = _gates(params, cfg, u)
    h = ops.rglru_scan(drive, a, reset=reset)
    gate = _gelu((x @ params["w_gate"]).float())
    out = shardctx.reduce(cfg, "rglru",
                          (gate * h.float()).to(x.dtype) @ params["w_out"])
    if not want_cache:
        return out
    return out, RglruCache(conv=conv_tail(u_pre, cfg.conv_width),
                           h=h[:, -1].float())


def init_rglru_cache(cfg, batch, dtype, device=None) -> RglruCache:
    """Zeroed decode cache; ``batch`` is the row count or a tuple of
    leading dims (units, rows)."""
    r = cfg.resolved_rnn_width
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    return RglruCache(
        conv=torch.zeros(*lead, cfg.conv_width - 1, r, dtype=dtype,
                         device=device),
        h=torch.zeros(*lead, r, device=device))


def apply_rglru_decode(params, cfg, x, cache: RglruCache):
    """One token: x (B, 1, D) -> (y (B, 1, D), cache), the cache stepped in
    place."""
    u_pre = x[:, 0] @ params["w_x"]
    hist = torch.cat([cache.conv, u_pre[:, None, :]], dim=1)
    u = torch.einsum("bkr,kr->br", hist.float(),
                     params["conv"].float()).to(x.dtype)
    a, drive = _gates(params, cfg, u)
    h = a * cache.h + drive
    cache.conv.copy_(hist[:, 1:])
    cache.h.copy_(h)
    gate = _gelu((x[:, 0] @ params["w_gate"]).float())
    y = shardctx.reduce(cfg, "rglru",
                        (gate * h).to(x.dtype) @ params["w_out"])
    return y[:, None, :], cache
