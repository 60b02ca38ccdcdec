"""Channel mixers: the dense (optionally gated) FFN and the GShard-style
MoE of kind "m".

Port of ``repro/models/ffn.py``.  The MoE groups tokens into dispatch
groups of ``MOE_GROUP``, routes each token to its top-k experts in a
float32 router under a per-expert capacity, runs the expert FFNs batched
over the expert axis (``torch.bmm``: the reference's einsums, outside any
kernel) and returns the load-balance aux loss beside the output.

Under tensor parallelism (``cfg`` a ``shardctx.RankConfig``) the dense FFN
is column-parallel in ``w1``/``w3`` and row-parallel in ``w2``, its partial
sum all-reduced over "model" ("ffn", or "shared" for the MoE's shared
expert); the MoE routes every token on every rank, runs the rank's own
experts (``local_experts`` from ``expert_offset``) and all-reduces the
combine's partial sum ("moe").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import shardctx
from .common import dense_init, dtype_of

MOE_GROUP = 1024          # tokens per dispatch group
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


def _ffn_block(p, cfg, x, part, reduce):
    if reduce:
        x = shardctx.enter(cfg, part, x)
    h = x @ p["w1"]
    if cfg.gated_ffn:
        h = F.silu(h) * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    y = h @ p["w2"]
    return shardctx.reduce(cfg, part, y) if reduce else y


def apply_ffn(p, cfg, x, part: str = "ffn", reduce: bool = True):
    """Dense FFN; sequences of at least FFN_CHUNK_SEQ tokens (and a
    multiple of FFN_CHUNK) run in token chunks so the (tokens, d_ff) hidden
    never exists whole.  ``part`` names the block for ``cfg.split``; with
    ``reduce=False`` a split block returns its rank's partial sum, and
    its caller enters x into the split block (``shardctx.enter``)."""
    s = x.shape[-2]
    if s < FFN_CHUNK_SEQ or s % FFN_CHUNK != 0:
        return _ffn_block(p, cfg, x, part, reduce)
    return torch.cat([_ffn_block(p, cfg, xc, part, reduce)
                      for xc in torch.split(x, FFN_CHUNK, dim=-2)], dim=-2)


def init_moe(gen, cfg, device=None) -> dict:
    d, f, e = cfg.d_model, cfg.resolved_moe_dff, cfg.n_experts
    dt = dtype_of(cfg.param_dtype)
    p = {"router": dense_init(gen, (d, e), torch.float32, device=device),
         "wi": dense_init(gen, (e, d, f), dt, device=device),
         "wo": dense_init(gen, (e, f, d), dt, device=device)}
    if cfg.gated_ffn:
        p["wg"] = dense_init(gen, (e, d, f), dt, device=device)
    if cfg.shared_expert:
        p["shared"] = init_ffn(gen, cfg, d_ff=f, device=device)
    return p


def moe_capacity(cfg, gsize: int) -> int:
    """Tokens each expert takes from one group of ``gsize``, in Python ints
    as the reference computes it."""
    e, k = cfg.n_experts, cfg.top_k
    cap = int(max(1, -(-gsize * k // e)) * cfg.capacity_factor)
    return min(cap, gsize)


def route(router, cfg, xg):
    """Top-k routing of groups xg (G, S, D) under ``moe_capacity``.

    Returns (dispatch, combine, aux): dispatch (G, S, E, C) float32 one-hot
    of each kept (token, expert) pair's capacity slot, combine the same
    weighted by the gate, renormalised over the token's kept experts, and
    the load-balance loss.  Each of the k rounds takes the first-index
    argmax of the probabilities not yet chosen; a token's slot at an expert
    is the count of earlier tokens of the group routed there, in this round
    and the rounds before, and it is dropped where that reaches capacity.
    """
    g, gsize, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, gsize)
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)    # (G, S, E)

    density = probs.mean(dim=1)
    top1 = F.one_hot(probs.argmax(-1), e).float()
    usage = top1.mean(dim=1)
    aux = (density * usage).sum(-1).mean() * (e ** 2) / e

    slots = torch.arange(cap, device=xg.device, dtype=torch.float32)
    dispatch = xg.new_zeros((g, gsize, e, cap), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    used = probs.new_zeros((g, e))
    gate_sum = probs.new_zeros((g, gsize))
    masked = probs
    for _ in range(k):
        onehot = F.one_hot(masked.argmax(-1), e).float()          # (G, S, E)
        gate = (probs * onehot).sum(-1)                          # (G, S)
        pos = torch.cumsum(onehot, dim=1) - onehot + used[:, None, :]
        keep = (pos < cap).float() * onehot
        pos_tok = (pos * onehot).sum(-1)                          # (G, S)
        # one_hot of the slot; a slot at or past capacity has none
        cap_oh = (pos_tok[..., None] == slots).float()            # (G, S, C)
        d_k = keep[..., None] * cap_oh[:, :, None, :]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[:, :, None, None]
        gate_sum = gate_sum + gate * keep.sum(-1)
        used = used + keep.sum(dim=1)
        masked = masked * (1.0 - onehot)
    combine = combine / torch.clamp(gate_sum, min=1e-9)[:, :, None, None]
    return dispatch, combine, aux


def apply_moe(p, cfg, x):
    """x (..., S, D) -> (y, aux).  The tokens are flattened into groups of
    ``MOE_GROUP`` (all of them where fewer), the last group padded with zero
    tokens after the real ones; the dispatch and combine products and the
    experts run in the compute dtype, and the shared expert acts on the
    padded groups."""
    orig_shape = x.shape
    d = orig_shape[-1]
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gsize = min(MOE_GROUP, t)
    pad = (-t) % gsize
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))])
    g = tokens.shape[0] // gsize
    xg = tokens.reshape(g, gsize, d)
    dispatch, combine, aux = route(p["router"], cfg, xg)
    xg_whole = xg           # what a shared expert held whole reads
    if shardctx.split(cfg, "moe"):
        # the router runs whole on every rank; its outputs enter the
        # rank's experts, so their gradients are summed over "model"
        xg = shardctx.enter(cfg, "moe", xg)
        combine = shardctx.enter(cfg, "moe", combine)
        mine = slice(cfg.expert_offset, cfg.expert_offset + cfg.local_experts)
        dispatch, combine = dispatch[:, :, mine], combine[:, :, mine]

    cdt = dtype_of(cfg.compute_dtype)
    e, cap = dispatch.shape[2], dispatch.shape[3]
    # (G, E*C, D): each expert slot's token, then (E, G*C, D) for the bmm
    xe = torch.bmm(dispatch.to(cdt).reshape(g, gsize, e * cap).transpose(1, 2),
                   xg)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = torch.bmm(xe, p["wi"])
    if "wg" in p:
        h = F.silu(h) * torch.bmm(xe, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    ye = torch.bmm(h, p["wo"])                                   # (E, G*C, D)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    y = torch.bmm(combine.to(cdt).reshape(g, gsize, e * cap), ye)

    if "shared" not in p:
        y = shardctx.reduce(cfg, "moe", y)
    elif shardctx.split(cfg, "moe") and shardctx.split(cfg, "shared"):
        # both partial sums: one all-reduce
        y = shardctx.model_all_reduce(
            y + apply_ffn(p["shared"], cfg, xg, "shared", reduce=False))
    else:   # a whole shared expert ("moe-only") must not read the xg
        # that entered the split experts: every rank's gradient of it is
        # the whole one, and "model" would sum it M times
        y = (shardctx.reduce(cfg, "moe", y)
             + apply_ffn(p["shared"], cfg, xg_whole, "shared"))
    y = y.reshape(-1, d)
    if pad:
        y = y[:t]
    return y.reshape(orig_shape), aux
