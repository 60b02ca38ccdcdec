"""Roofline-term estimators, with the constants of one NVIDIA H100 SXM.

A copy of ``repro/profiling/roofline.py``: the analytic counts
(``param_count``, ``fwd_flops``, ``step_flops``, ``_cache_bytes``,
``step_hbm_bytes``, ``RooflineTerms``, ``terms_for``) are the reference's,
unchanged, since they depend on the architecture alone; the port keeps its
own copy so that it imports nothing of the reference package.  Three terms
per (arch x shape x devices), all in seconds per step:

  compute    = executed_FLOPs / (chips * PEAK_FLOPS)
  memory     = HBM_bytes      / (chips * HBM_BW)
  collective = wire_bytes_per_device / LINK_BW

``executed_FLOPs`` and ``HBM_bytes`` are analytic, derived from the
architecture configs.

Hardware constants: NVIDIA's H100 SXM5 data sheet (dense rates, no
sparsity), at the card's full 700 W.  ``chip_smoke.py`` takes its bounds
from them, so the port has one source for these numbers.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig

PEAK_FLOPS = 989e12        # bf16 / fp16 tensor-core FLOP/s, dense
PEAK_F32_FLOPS = 67e12     # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 450e9            # NVLink 4 bytes/s per direction per GPU (18
                           # links; the data sheet's 900 GB/s is both ways)

# ring-cost weights applied to per-device HLO result bytes
COLLECTIVE_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}


# ---------------------------------------------------------------------------
# parameter / per-token-FLOP accounting
# ---------------------------------------------------------------------------

def _kinds(cfg: ArchConfig):
    kinds = list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)
    if cfg.enc_layers:
        kinds = ["e"] * cfg.enc_layers + kinds
    return kinds


def _attn_params(cfg):
    if not cfg.n_heads:
        return 0
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd
            + cfg.n_heads * hd * d)


def _ffn_params(cfg, d_ff):
    return (3 if cfg.gated_ffn else 2) * cfg.d_model * d_ff


def _layer_params(cfg, kind, active_only: bool):
    d = cfg.d_model
    if kind == "s":
        d_in = cfg.ssm_expand * d
        n = cfg.ssm_state
        h = d_in // cfg.ssm_headdim
        return d * (2 * d_in + 2 * n + h) + d_in * d
    if kind == "r":
        r = cfg.resolved_rnn_width
        return 2 * d * r + 2 * r * r + r * d + _ffn_params(cfg, cfg.d_ff)
    if kind == "m":
        n_e = (cfg.top_k + (1 if cfg.shared_expert else 0)) if active_only \
            else (cfg.n_experts + (1 if cfg.shared_expert else 0))
        return (_attn_params(cfg) + n_e * _ffn_params(cfg, cfg.resolved_moe_dff)
                + d * cfg.n_experts)
    if kind == "d":
        return 2 * _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)
    return _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff)


def param_count(cfg: ArchConfig, active_only: bool = False) -> float:
    total = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    for kind in _kinds(cfg):
        total += _layer_params(cfg, kind, active_only)
    return float(total)


def _attn_flops_per_seq(cfg, kind, s, decode_cache=0):
    """Score+AV FLOPs for one sequence (TPU kernel path: causal skip)."""
    if kind in ("s", "r") or not cfg.n_heads:
        return 0.0
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    if decode_cache:                       # one token vs cache
        span = min(cfg.window, decode_cache) if kind == "l" and cfg.window \
            else decode_cache
        return 4.0 * span * h * hd
    if kind == "l" and cfg.window:
        span = min(cfg.window, s)
        return 4.0 * s * span * h * hd
    if kind in ("e",):                     # bidirectional full
        return 4.0 * s * s * h * hd
    if kind == "x":
        return 4.0 * s * cfg.n_frontend_tokens * h * hd
    if kind == "d":                        # causal self + full cross(enc s)
        return 2.0 * s * s * h * hd + 4.0 * s * (4 * s) * h * hd
    return 2.0 * s * s * h * hd            # causal: s^2/2 pairs x 4


def fwd_flops(cfg: ArchConfig, batch: int, seq: int) -> float:
    """Forward FLOPs for a (batch, seq) step, kernel-executed counts."""
    dec_seq = seq // 4 if cfg.enc_layers else seq
    total = 0.0
    for kind in _kinds(cfg):
        s = seq if kind == "e" else dec_seq
        total += 2.0 * _layer_params(cfg, kind, active_only=True) * s
        total += _attn_flops_per_seq(cfg, kind, s)
    total += 2.0 * cfg.d_model * cfg.vocab * dec_seq   # lm head
    return total * batch


def step_flops(cfg: ArchConfig, shape, kind: str) -> dict:
    """Returns {"executed": F, "model": MODEL_FLOPS} for the cell."""
    n_active = param_count(cfg, active_only=True)
    if kind == "train":
        tokens = shape.batch * (shape.seq // 4 if cfg.enc_layers else shape.seq)
        fwd = fwd_flops(cfg, shape.batch, shape.seq)
        mult = 3.0 + (1.0 if cfg.remat else 0.0)
        return {"executed": mult * fwd, "model": 6.0 * n_active * tokens}
    if kind == "prefill":
        tokens = shape.batch * (shape.seq // 4 if cfg.enc_layers else shape.seq)
        return {"executed": fwd_flops(cfg, shape.batch, shape.seq),
                "model": 2.0 * n_active * tokens}
    # decode: one token against a shape.seq cache
    per_tok = 0.0
    for k in _kinds(cfg):
        if k == "e":
            continue
        per_tok += 2.0 * _layer_params(cfg, k, active_only=True)
        per_tok += _attn_flops_per_seq(cfg, k, 1, decode_cache=shape.seq)
    per_tok += 2.0 * cfg.d_model * cfg.vocab
    return {"executed": per_tok * shape.batch,
            "model": 2.0 * n_active * shape.batch}


# ---------------------------------------------------------------------------
# HBM traffic
# ---------------------------------------------------------------------------

def _cache_bytes(cfg: ArchConfig, batch: int, seq: int) -> float:
    """Serving-cache footprint for a seq-length context."""
    total = 0.0
    hd = cfg.resolved_head_dim
    for kind in _kinds(cfg):
        if kind in ("g", "m"):
            total += 2 * seq * cfg.n_kv * hd * 2
        elif kind == "d":
            total += 2 * seq * cfg.n_kv * hd * 2       # self cache
            total += 2 * (4 * seq) * cfg.n_kv * hd * 2  # enc memory
        elif kind == "x":
            total += 2 * cfg.n_frontend_tokens * cfg.n_kv * hd * 2
        elif kind == "l":
            total += 2 * min(cfg.window or seq, seq) * cfg.n_kv * hd * 2
        elif kind == "r":
            r = cfg.resolved_rnn_width
            total += r * 4 + (cfg.conv_width - 1) * r * 2
        elif kind == "s":
            d_in = cfg.ssm_expand * cfg.d_model
            h = d_in // cfg.ssm_headdim
            total += h * cfg.ssm_state * cfg.ssm_headdim * 4
            total += (cfg.conv_width - 1) * (d_in + 2 * cfg.ssm_state) * 2
    return total * batch


def step_hbm_bytes(cfg: ArchConfig, shape, kind: str,
                   microbatches: int = 1) -> float:
    """Whole-step HBM traffic (GLOBAL, divide by chips for per-chip)."""
    p_total = param_count(cfg)
    p_bytes = p_total * 2                     # bf16 resident params
    opt_bytes = p_total * (2 if cfg.opt_state_dtype == "bfloat16" else 4) * 2
    d = cfg.d_model
    dec_seq = shape.seq // 4 if cfg.enc_layers else shape.seq
    tokens = shape.batch * dec_seq
    act_rw = 8.0                              # r/w passes per layer activation
    if kind == "train":
        acts = len(_kinds(cfg)) * tokens * d * 2 * act_rw
        # params re-read fwd+bwd(+remat) per microbatch; grads + opt once
        reads = (2 + (1 if cfg.remat else 0)) * microbatches
        return p_bytes * reads + p_bytes + opt_bytes + acts
    if kind == "prefill":
        acts = len(_kinds(cfg)) * tokens * d * 2 * 2
        return p_bytes + acts + _cache_bytes(cfg, shape.batch, shape.seq)
    # decode: params once + full cache read + tiny writes
    return (p_bytes + _cache_bytes(cfg, shape.batch, shape.seq)
            + len(_kinds(cfg)) * shape.batch * d * 2 * 4)


# ---------------------------------------------------------------------------
# term assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    executed_flops: float
    model_flops: float
    hbm_bytes: float
    wire_bytes_per_dev: float
    chips: int = 256

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three (perfect overlap bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / max(self.executed_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-achieving fraction of peak at the roofline bound
        (a.k.a. the best MFU this program shape can reach)."""
        return (self.model_flops / self.step_time_s) / (PEAK_FLOPS * self.chips) \
            if self.step_time_s > 0 else 0.0


def terms_for(cfg, shape, kind, collectives_by_kind: dict, chips: int,
              microbatches: int = 1) -> RooflineTerms:
    fl = step_flops(cfg, shape, kind)
    hbm = step_hbm_bytes(cfg, shape, kind, microbatches)
    wire = sum(COLLECTIVE_WEIGHT.get(k, 1.0) * v
               for k, v in collectives_by_kind.items())
    return RooflineTerms(
        compute_s=fl["executed"] / (chips * PEAK_FLOPS),
        memory_s=hbm / (chips * HBM_BW),
        collective_s=wire / LINK_BW,
        executed_flops=fl["executed"],
        model_flops=fl["model"],
        hbm_bytes=hbm,
        wire_bytes_per_dev=wire,
        chips=chips,
    )
