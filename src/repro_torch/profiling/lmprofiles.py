"""Logical-layer cost profiles for the 10 assigned architectures.

A copy of ``repro/profiling/lmprofiles.py`` (numpy only): the port keeps its
own so that it imports nothing of the reference package.

This extends the paper's CNN profiling (Sec. II-A) to modern LM stacks so the
LyMDO controller can partition *any* assigned arch between a device tier and
the edge/pod tier.  A "task" is one inference request of ``prompt_tokens``
tokens (default 128, an edge-assistant-sized request).

Logical layers:  [input] + [per-transformer-layer blocks...] + [lm head].
Per layer l:
  M(l)  = MACs to run the layer on the request (active params x tokens for
          MoE: only top-k experts count, the paper's M is *executed* compute)
  C(l)  = parameter bytes that must be resident (MoE: ALL experts -- memory
          is where MoE partitioning bites, DESIGN §4)
  psi(l)= boundary transfer bytes if we cut after l:
            attention archs: hidden states (tokens x d_model)
            + any state the edge side needs (SSM state / window cache for
              hybrid archs -- constant in sequence length)
          psi is what the paper transmits in eq. (3).
"""
from __future__ import annotations

import numpy as np

from ..configs.base import ArchConfig
from .profiles import LayerProfile

_ACT_BYTES = 2  # bf16 activations on the wire


def _attn_macs(cfg: ArchConfig, s: int) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv
    proj = s * (d * h * hd + 2 * d * kv * hd + h * hd * d)
    scores = s * s * h * hd  # causal ~ /2; keep upper bound like ref [4]
    return float(proj + scores)


def _attn_params(cfg: ArchConfig) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return float(d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd
                 + cfg.n_heads * hd * d)


def _ffn_macs(cfg: ArchConfig, s: int, d_ff: int) -> float:
    mult = 3 if cfg.gated_ffn else 2
    return float(s * mult * cfg.d_model * d_ff)


def _ffn_params(cfg: ArchConfig, d_ff: int) -> float:
    mult = 3 if cfg.gated_ffn else 2
    return float(mult * cfg.d_model * d_ff)


def _layer_costs(cfg: ArchConfig, kind: str, s: int) -> tuple[float, float, float]:
    """(macs, param_bytes, extra_psi_bytes) for one layer of ``kind``."""
    d = cfg.d_model
    pbytes = 2.0  # bf16 params
    extra_psi = 0.0
    if kind == "s":
        d_in = cfg.ssm_expand * d
        n, g = cfg.ssm_state, 1
        h = d_in // cfg.ssm_headdim
        proj = 2 * d_in + 2 * g * n + h
        macs = s * (d * proj + d_in * d) + s * d_in * n * 2   # proj + scan
        params = d * proj + d_in * d
        extra_psi = h * cfg.ssm_headdim * n * 4               # fp32 SSD state
        return float(macs), params * pbytes, extra_psi
    if kind == "r":
        r = cfg.resolved_rnn_width
        macs = s * (2 * d * r + 2 * r * r + r * d) + _ffn_macs(cfg, s, cfg.d_ff)
        params = (2 * d * r + 2 * r * r + r * d
                  + _ffn_params(cfg, cfg.d_ff))
        extra_psi = r * 4 + (cfg.conv_width - 1) * r * 2      # h state + conv
        return float(macs), params * pbytes, extra_psi
    if kind == "m":
        active_ff = cfg.top_k * cfg.resolved_moe_dff
        if cfg.shared_expert:
            active_ff += cfg.resolved_moe_dff
        macs = _attn_macs(cfg, s) + _ffn_macs(cfg, s, active_ff) \
            + s * d * cfg.n_experts
        n_ff = cfg.n_experts + (1 if cfg.shared_expert else 0)
        params = (_attn_params(cfg) + n_ff * _ffn_params(cfg, cfg.resolved_moe_dff)
                  + d * cfg.n_experts)
        return float(macs), params * pbytes, 0.0
    if kind == "x":
        macs = _attn_macs(cfg, s) + _ffn_macs(cfg, s, cfg.d_ff)
        params = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        # cutting before a cross layer means shipping the image/frame context
        extra_psi = cfg.n_frontend_tokens * d * _ACT_BYTES
        return float(macs), params * pbytes, extra_psi
    if kind == "d":
        macs = 2 * _attn_macs(cfg, s) + _ffn_macs(cfg, s, cfg.d_ff)
        params = 2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        extra_psi = 0.0   # encoder memory accounted at the encoder boundary
        return float(macs), params * pbytes, extra_psi
    if kind == "l":
        w = min(cfg.window or s, s)
        proj = s * (_attn_params(cfg))
        scores = s * w * cfg.n_heads * cfg.resolved_head_dim
        macs = proj + scores + _ffn_macs(cfg, s, cfg.d_ff)
        params = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
        extra_psi = min(w, s) * cfg.n_kv * cfg.resolved_head_dim * 2 * _ACT_BYTES
        return float(macs), params * pbytes, extra_psi
    # "g" / "e"
    macs = _attn_macs(cfg, s) + _ffn_macs(cfg, s, cfg.d_ff)
    params = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
    # cutting after a global layer ships its KV prefix for the edge to reuse?
    # No: layers after the cut run entirely on the edge; only hidden states
    # cross the boundary.  KV of *local* (already-run) layers stays local.
    return float(macs), params * pbytes, 0.0


def lm_profile(cfg: ArchConfig, prompt_tokens: int = 128) -> LayerProfile:
    """Build the paper's (M, C, psi) arrays for an assigned architecture."""
    s = prompt_tokens
    d = cfg.d_model
    kinds: list[str] = []
    if cfg.enc_layers:
        kinds.extend(["e"] * cfg.enc_layers)
    kinds.extend(list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern))

    names = ["input"]
    macs, params_b, acts = [0.0], [0.0], [float(s * 4)]  # raw token ids (int32)
    if cfg.frontend == "vision":
        acts[0] += cfg.n_frontend_tokens * d * _ACT_BYTES
    if cfg.frontend == "audio":
        acts[0] += s * d * _ACT_BYTES                    # frame embeddings

    # embedding logical layer
    names.append("embed")
    macs.append(0.0)
    params_b.append(float(cfg.vocab * d * 2))
    acts.append(float(s * d * _ACT_BYTES))

    hidden = float(s * d * _ACT_BYTES)
    for i, kind in enumerate(kinds):
        m, p, extra = _layer_costs(cfg, kind, s)
        names.append(f"{kind}{i}")
        macs.append(m)
        params_b.append(p)
        acts.append(hidden + extra)

    # lm head (decode next token: 1 x d x vocab; tied weights add no memory)
    names.append("head")
    macs.append(float(d * cfg.vocab))
    params_b.append(0.0 if cfg.tie_embeddings else float(d * cfg.vocab * 2))
    acts.append(float(cfg.vocab * 2))   # final logits (never shipped: last)

    return LayerProfile(name=cfg.name, macs=np.array(macs),
                        param_bytes=np.array(params_b),
                        act_bytes=np.array(acts), layer_names=tuple(names))


def all_lm_profiles(prompt_tokens: int = 128) -> dict[str, LayerProfile]:
    from ..configs.base import load_all
    return {name: lm_profile(cfg, prompt_tokens)
            for name, cfg in load_all().items()}
