"""Shared model primitives: dtypes, initialisers, norms, RoPE, masks and
the scan-reset mask of a left-padded batch.

Port of ``repro/models/common.py``.  Norms and RoPE compute in float32 and
cast back to the input's dtype, as the reference does.  Initialisers draw
from an explicit ``torch.Generator``; they do not reproduce the reference's
numbers (parity tests carry the reference's parameters across instead).
"""
from __future__ import annotations

import torch

from .. import shardctx

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def dense_init(gen, shape, dtype, scale: float | None = None, device=None):
    """Truncated-normal (at +-2 sigma) fan-in init, cast to ``dtype``.

    A leaf of three or more axes (the MoE experts' (E, D, F)) is drawn one
    (D, F) slice at a time into the ``dtype`` result, so no float32 copy of
    the whole leaf exists; each slice draws a standard normal and redraws
    only the entries outside +-2, the same distribution at a fraction of
    ``trunc_normal_``'s draws.  On the meta device nothing is drawn."""
    if _meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    if len(shape) >= 3:
        out = torch.empty(shape, dtype=dtype, device=device)
        w = torch.empty(shape[-2:], dtype=torch.float32, device=device)
        for part in out.view(-1, *shape[-2:]):
            w.normal_(generator=gen)
            bad = w.abs() > 2.0
            while n := int(bad.sum()):
                w[bad] = torch.empty(n, dtype=torch.float32,
                                     device=device).normal_(generator=gen)
                bad = w.abs() > 2.0
            part.copy_(w * std)
        return out
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def _meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def embed_init(gen, shape, dtype, device=None):
    if _meta(device):
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * 0.02).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6, *, split: bool = False):
    """RMSNorm in float32 with a ``1 + scale`` gain, cast back to x's dtype.

    ``split``: x and ``scale`` are this rank's slices of a last axis
    sharded evenly over "model" (the SSD's gated norm over d_inner): the
    sum of squares is all-reduced before the rsqrt, so every rank divides
    by the whole row's mean square."""
    x32 = x.float()
    if split:
        ss = shardctx.model_all_reduce(
            torch.sum(x32 * x32, dim=-1, keepdim=True),
            backward="all_reduce")
        var = ss / (x.shape[-1] * shardctx.model_size())
    else:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def head_rms_norm(x, scale, eps: float = 1e-6):
    """Per-head QK-norm (Qwen3): normalises the head_dim axis."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embeddings.  x (..., S, H, hd); positions (..., S) or (S,).
    Angles and rotation in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]       # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, device=None):
    """(s_q, s_k) bool: query i sees key j iff j <= i + q_offset."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return kj <= qi


def local_mask(s_q: int, s_k: int, window: int, q_offset: int = 0,
               device=None):
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    return (kj <= qi) & (kj > qi - window)


def pad_reset(pad_mask):
    """Scan-reset mask of a LEFT-padded batch: (B, S) valid mask -> (B, S)
    bool, True on every pad position and on each row's first real token,
    so the scans zero their carried state through the pad run and again
    entering the first real token."""
    pads = ~pad_mask
    prev_pad = torch.cat([torch.zeros_like(pads[:, :1]), pads[:, :-1]], dim=1)
    return pads | prev_pad
