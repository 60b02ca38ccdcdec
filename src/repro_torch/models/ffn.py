"""Channel mixer: the dense (optionally gated) FFN.

Port of ``repro/models/ffn.py:16-61``.  The MoE mixer (kind "m") comes with
a later slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, dtype_of

FFN_CHUNK_SEQ = 8192      # chunk the token axis above this length
FFN_CHUNK = 2048


def init_ffn(gen, cfg, d_ff: int | None = None, device=None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {"w1": dense_init(gen, (d, f), dt, device=device),
         "w2": dense_init(gen, (f, d), dt, device=device)}
    if cfg.gated_ffn:
        p["w3"] = dense_init(gen, (d, f), dt, device=device)
    return p


def _ffn_block(p, cfg, x):
    h = x @ p["w1"]
    if cfg.gated_ffn:
        h = F.silu(h) * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h @ p["w2"]


def apply_ffn(p, cfg, x):
    """Dense FFN; sequences of at least FFN_CHUNK_SEQ tokens (and a
    multiple of FFN_CHUNK) run in token chunks so the (tokens, d_ff) hidden
    never exists whole."""
    s = x.shape[-2]
    if s < FFN_CHUNK_SEQ or s % FFN_CHUNK != 0:
        return _ffn_block(p, cfg, x)
    return torch.cat([_ffn_block(p, cfg, xc)
                      for xc in torch.split(x, FFN_CHUNK, dim=-2)], dim=-2)
