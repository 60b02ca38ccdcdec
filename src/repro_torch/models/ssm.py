"""Mamba2 SSD block (arXiv:2405.21060): layer kind "s".

Port of ``repro/models/ssm.py``.  The block: in_proj -> [z | x | B | C |
dt]; a short causal depthwise conv over [x | B | C]; the SSD scan
(``kernels.ops.ssd_scan``: the CUDA kernel on the card); RMSNorm gated by
z; out_proj.  Decode keeps a (conv, state) cache whose size does not grow
with the sequence, and steps it with the plain ``ref.ssd_step_ref``, as the
reference does.  The decode step updates the cache it is given in place.

Under tensor parallelism (``cfg`` a ``shardctx.RankConfig`` that splits
"ssm") the rank holds ``cfg.ssm_heads`` SSD heads: its columns of z, x and
dt in ``in_proj`` and of x in ``conv``, its entries of ``a_log``,
``dt_bias``, ``d_skip`` and ``gate_norm``, and its rows of ``out_proj``;
B and C (one group) are replicated.  The scan, its state and the conv
tail are the local heads'; the gated RMSNorm spans all of d_inner, so its
sum of squares is all-reduced, and so is ``out_proj``'s partial sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import shardctx
from ..kernels import ops
from ..kernels.ref import ssd_step_ref
from .common import dense_init, dtype_of, pad_reset, rms_norm


class SsmCache(NamedTuple):
    conv: torch.Tensor    # (B, conv_width - 1, conv_channels)
    state: torch.Tensor   # (B, H, N, P) float32 SSD state


def _dims(cfg):
    """(d_inner, head dim, heads, state, groups, conv channels): the
    rank's own where ``cfg`` splits "ssm"."""
    d_in = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_headdim
    h = d_in // p
    if shardctx.split(cfg, "ssm"):
        h = cfg.ssm_heads
        d_in = h * p
    n = cfg.ssm_state
    g = 1                      # one B/C group
    return d_in, p, h, n, g, d_in + 2 * g * n


def init_ssm(gen, cfg, device=None) -> dict:
    d = cfg.d_model
    d_in, p, h, n, g, conv_ch = _dims(cfg)
    dt = dtype_of(cfg.param_dtype)
    return {
        "norm": torch.zeros(d, dtype=dt, device=device),
        "in_proj": dense_init(gen, (d, 2 * d_in + 2 * g * n + h), dt,
                              device=device),
        "conv": dense_init(gen, (cfg.conv_width, conv_ch), dt, scale=0.5,
                           device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.zeros(h, device=device),
        "d_skip": torch.ones(h, device=device),
        "gate_norm": torch.zeros(d_in, dtype=dt, device=device),
        "out_proj": dense_init(gen, (d_in, d), dt, device=device),
    }


def _split_proj(cfg, proj):
    d_in, p, h, n, g, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * g * n, h], dim=-1)


def _split_xbc(cfg, xbc):
    d_in, p, h, n, g, _ = _dims(cfg)
    return torch.split(xbc, [d_in, g * n, g * n], dim=-1)


def _gated_out(params, cfg, y, z):
    """RMSNorm(y * silu(z)) over d_inner, then ``out_proj``; both ends
    reduced over "model" where the heads are split."""
    split = shardctx.split(cfg, "ssm")
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"],
                 split=split)
    return shardctx.reduce(cfg, "ssm", y @ params["out_proj"])


def conv_full(weight, u):
    """Causal depthwise conv over the sequence axis of u (B, S, C), float32
    inside: out_t = sum_i w[i] u_{t - K + 1 + i}, zeros before the start."""
    w = weight.float()
    k, s = w.shape[0], u.shape[1]
    padded = F.pad(u.float(), (0, 0, k - 1, 0))
    return sum(padded[:, i:i + s] * w[i] for i in range(k))


def conv_tail(u_pre, k: int):
    """The last k - 1 conv inputs of a sequence (left zero-padded when the
    sequence is shorter): the decode cache's rolling window."""
    s = u_pre.shape[1]
    if s >= k - 1:
        return u_pre[:, s - (k - 1):]
    return F.pad(u_pre, (0, 0, k - 1 - s, 0))


def apply_ssm(params, cfg, x, want_cache: bool = False, pad_mask=None):
    """Full-sequence SSD block.  x (B, S, D) -> (B, S, D) [, SsmCache].

    ``pad_mask`` (B, S) bool marks the valid (non-left-pad) positions:
    pad inputs are zeroed ahead of the causal conv and a reset mask (the
    pads and each row's first real token) goes into the scan, so a padded
    row's outputs, state and conv tail equal its solo run's.
    """
    d_in, p, h, n, g, _ = _dims(cfg)
    normed = shardctx.enter(cfg, "ssm", rms_norm(x, params["norm"]))
    proj = normed @ params["in_proj"]
    z, xbc_pre, dt_raw = _split_proj(cfg, proj)
    reset = None
    if pad_mask is not None:
        xbc_pre = torch.where(pad_mask[:, :, None], xbc_pre, 0.0)
        reset = pad_reset(pad_mask)
    xbc = F.silu(conv_full(params["conv"], xbc_pre)).to(xbc_pre.dtype)
    xs, b, c = _split_xbc(cfg, xbc)
    bsz, s = normed.shape[0], normed.shape[1]     # the whole sequence
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    y, state = ops.ssd_scan(xs.reshape(bsz, s, h, p), dt, params["a_log"],
                            b.reshape(bsz, s, g, n), c.reshape(bsz, s, g, n),
                            params["d_skip"], chunk=min(cfg.ssm_chunk, s),
                            reset=reset)
    y = y.reshape(bsz, s, d_in)
    out = _gated_out(params, cfg, y, z)
    if not want_cache:
        return out
    return out, SsmCache(conv=conv_tail(xbc_pre, cfg.conv_width),
                         state=state)


def init_ssm_cache(cfg, batch, dtype, device=None) -> SsmCache:
    """Zeroed decode cache; ``batch`` is the row count or a tuple of
    leading dims (units, rows)."""
    d_in, p, h, n, g, conv_ch = _dims(cfg)
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    return SsmCache(
        conv=torch.zeros(*lead, cfg.conv_width - 1, conv_ch, dtype=dtype,
                         device=device),
        state=torch.zeros(*lead, h, n, p, device=device))


def apply_ssm_decode(params, cfg, x, cache: SsmCache):
    """One token: x (B, 1, D) -> (y (B, 1, D), cache), the cache stepped in
    place."""
    d_in, p, h, n, g, _ = _dims(cfg)
    bsz = x.shape[0]
    normed = rms_norm(x[:, 0], params["norm"])
    proj = normed @ params["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, proj)
    hist = torch.cat([cache.conv, xbc[:, None, :]], dim=1)      # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(),
                            params["conv"].float())
    xbc_t = F.silu(conv_out).to(x.dtype)
    xs, b, c = _split_xbc(cfg, xbc_t)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    y, state = ssd_step_ref(cache.state, xs.reshape(bsz, h, p), dt,
                            params["a_log"], b.reshape(bsz, g, n),
                            c.reshape(bsz, g, n), params["d_skip"])
    cache.conv.copy_(hist[:, 1:])
    cache.state.copy_(state)
    y = y.reshape(bsz, d_in)
    return _gated_out(params, cfg, y, z)[:, None, :], cache
