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
experts (``local_experts`` from ``expert_offset``), or its F columns of
every expert (``expert_mesh="data"``), and all-reduces the combine's
partial sum ("moe").  Over the data axes of a train step the dispatch
groups are the reference's, formed over the whole microbatch
(``stream``), and the layout's expert leaves split over "data"
(``RankConfig.moe_data``) take their tokens by the collectives of
``_experts``.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class Stream:
    """Where one rank's ``tokens`` lie in the dispatch groups of a token
    stream of ``ranks`` equal shares, the rank's at ``rank`` (the data
    ranks' shares of a microbatch, in rank order; one share outside a
    train step's data axes).  The stream is cut into ``groups`` groups of
    ``gsize`` (``MOE_GROUP``, or the whole stream where shorter), the last
    padded with ``pad`` zero tokens, which the last rank holds and routes.
    The rank lays its tokens out as ``local`` groups, the first being
    group ``first``, its tokens (and pad) from flat position ``lead`` on;
    the other positions are empty and route nothing.  ``local`` is the
    most groups any rank touches, so every rank's slots have one shape."""
    tokens: int
    rank: int
    ranks: int
    gsize: int
    groups: int
    pad: int
    first: int
    local: int
    lead: int

    @property
    def held(self) -> int:
        """The rank's positions that route: its tokens, and the pad on the
        last rank."""
        return self.tokens + (self.pad if self.rank == self.ranks - 1 else 0)

    @property
    def whole(self) -> bool:
        """Whether every local position is the rank's (one share)."""
        return self.lead == 0 and self.held == self.local * self.gsize


def stream(tokens: int, rank: int = 0, ranks: int = 1) -> Stream:
    """The ``Stream`` of a rank's ``tokens`` at ``rank`` of ``ranks``."""
    total = ranks * tokens
    gsize = min(MOE_GROUP, total)
    pad = (-total) % gsize

    def span(r):
        start = r * tokens
        stop = start + tokens + (pad if r == ranks - 1 else 0)
        return start // gsize, (stop - 1) // gsize

    first = span(rank)[0]
    return Stream(tokens=tokens, rank=rank, ranks=ranks, gsize=gsize,
                  groups=(total + pad) // gsize, pad=pad, first=first,
                  local=max(b - a + 1 for a, b in map(span, range(ranks))),
                  lead=rank * tokens - first * gsize)


def _frame(st: Stream, x):
    """``x`` (local groups, ...) placed at its groups in a (groups +
    local, ...) frame of the whole stream's, zeros elsewhere."""
    out = x.new_zeros((st.groups + st.local, *x.shape[1:]))
    return out.index_copy(0, torch.arange(st.first, st.first + st.local,
                                          device=x.device), x)


def route(router, cfg, xg, st: Stream | None = None):
    """Top-k routing of groups xg (G, S, D) under ``moe_capacity``: a
    rank's local groups of ``st`` (by default, xg is the whole stream).

    Returns (dispatch, gates, aux): dispatch (G, S, E, C) float32 one-hot
    of each kept (token, expert) pair's capacity slot, gates (G, S, E) each
    kept pair's gate renormalised over the token's kept experts (zero
    elsewhere: the combine weights are ``dispatch * gates[..., None]``),
    and the load-balance loss.  Each of the k rounds takes the first-index
    argmax of the probabilities not yet chosen; a token's slot at an expert
    is the count of earlier tokens of the group routed there, in this round
    and the rounds before, and it is dropped where that reaches capacity.
    Where the stream has several shares (``shardctx.dp_rows``), the
    earlier tokens of a group on the ranks before this one come from each
    round's all-gathered per-(group, expert) counts, and the aux loss's
    means are over each whole group (``shardctx.dp_sum``).
    """
    g, gsize, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    if st is None:      # xg is the whole stream's groups
        st = Stream(tokens=g * gsize, rank=0, ranks=1, gsize=gsize,
                    groups=g, pad=0, first=0, local=g, lead=0)
    cap = moe_capacity(cfg, gsize)
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)    # (G, S, E)
    top1 = F.one_hot(probs.argmax(-1), e).float()
    shared = st.ranks > 1
    mask = None
    if not st.whole:
        at = torch.arange(g * gsize, device=xg.device).view(g, gsize, 1)
        mask = ((at >= st.lead) & (at < st.lead + st.held)).float()

    def held(v):
        """``v`` (G, S, ...) at the rank's routed positions, zero
        elsewhere."""
        return v if mask is None else v * mask

    sums = torch.stack([held(probs).sum(dim=1), held(top1).sum(dim=1)])
    if shared:      # each group's sums over every rank's tokens
        sums = shardctx.dp_sum(torch.stack([_frame(st, x) for x in sums])
                               )[:, :st.groups]
    density, usage = sums / gsize                                # (G, E)
    aux = (density * usage).sum(-1).mean() * (e ** 2) / e

    used = probs.new_zeros((g, e))
    gate_sum = probs.new_zeros((g, gsize))
    kept = torch.zeros_like(probs)        # each pair is chosen once at most
    slot = torch.zeros_like(probs)
    masked = probs
    for _ in range(k):
        onehot = held(F.one_hot(masked.argmax(-1), e).float())   # (G, S, E)
        gate = (probs * onehot).sum(-1)                          # (G, S)
        base = used
        total = onehot.sum(dim=1)
        if shared:    # the group's tokens routed here on earlier ranks
            counts = shardctx.dp_gather_counts(_frame(st, total))
            window = slice(st.first, st.first + st.local)
            base = used + counts[:st.rank].sum(0)[window]
            total = counts.sum(0)[window]
        pos = torch.cumsum(onehot, dim=1) - onehot + base[:, None, :]
        keep = (pos < cap).float() * onehot
        kept = kept + keep
        slot = slot + pos * keep
        gate_sum = gate_sum + gate * keep.sum(-1)
        # the group's kept count: its routed tokens, up to capacity
        used = torch.clamp(used + total, max=float(cap))
        masked = masked * (1.0 - onehot)
    slots = torch.arange(cap, device=xg.device, dtype=torch.float32)
    dispatch = kept[..., None] * (slot[..., None] == slots).float()
    gates = probs * kept / torch.clamp(gate_sum, min=1e-9)[:, :, None]
    return dispatch, gates, aux


def _expert_ffn(p, xe):
    """The experts' FFNs on their slots: xe (E, N, D) -> (E, N, D)."""
    h = torch.bmm(xe, p["wi"])
    if "wg" in p:
        h = F.silu(h) * torch.bmm(xe, p["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["wo"])


def _experts(p, cfg, xe):
    """The experts' outputs on the rank's slots xe (E, N, D), by where the
    layout puts the experts over "data" (``RankConfig.moe_data``): each
    F split over "data" runs on every data rank's slots (all-gathered) and
    its partial sums are reduce-scattered back; experts split over
    "data" get their slots by an all-to-all and send the outputs back by
    its reverse; experts the data ranks hold whole run the rank's own
    slots, or every data rank's where ``moe_dp_groups=False``
    (``shardctx.gathers_experts``), the rank keeping its block."""
    how = getattr(cfg, "moe_data", "")
    if how == "experts":
        n = shardctx.data_size()
        e, slots, d = xe.shape
        mine = shardctx.data_all_to_all(xe.reshape(n, e // n, slots, d))
        ye = _expert_ffn(p, mine.transpose(0, 1).reshape(e // n, n * slots,
                                                          d))
        ye = ye.reshape(e // n, n, slots, d).transpose(0, 1).contiguous()
        return shardctx.data_all_to_all(ye).reshape(e, slots, d)
    if how == "dff" or shardctx.gathers_experts():
        ye = _expert_ffn(p, shardctx.data_all_gather(xe, 1))
        if how == "dff":
            return shardctx.data_reduce_scatter(ye, 1)
        at = shardctx.axes_coord(("data",)) * xe.shape[1]
        return ye.narrow(1, at, xe.shape[1])
    return _expert_ffn(p, xe)


def _seq_out(p, cfg, xg, y, st: Stream, shape):
    """Under sequence parallelism: the rank's block of the MoE's output
    (B, S / M, D) from the combine's ``y`` (groups) and the shared
    expert's output on ``xg``: the partial sums (of split experts, of a
    split shared expert) reduce-scattered over the sequence in one
    collective, a whole output's block kept."""
    d = shape[-1]
    unflat = lambda v: v.reshape(-1, d)[st.lead:st.lead + st.tokens] \
        .reshape(shape)
    outs = [(y, shardctx.split(cfg, "moe"))]
    if "shared" in p:
        outs.append((apply_ffn(p["shared"], cfg, xg, "shared", reduce=False),
                     shardctx.split(cfg, "shared")))
    partial = [v for v, part in outs if part]
    whole = [v for v, part in outs if not part]
    out = None
    if partial:
        out = shardctx.model_reduce_scatter(unflat(sum(partial)), 1)
    if whole:
        mine = shardctx.own_block(unflat(sum(whole)))
        out = mine if out is None else out + mine
    return out


def apply_moe(p, cfg, x):
    """x (..., S, D) -> (y, aux).  The tokens are flattened into groups of
    ``MOE_GROUP`` (all of them where fewer), the last group padded with zero
    tokens after the real ones; the dispatch and combine products and the
    experts run in the compute dtype, and the shared expert acts on the
    padded groups.  Where x is the rank's share of a train step's
    microbatch (``shardctx.dp_rows``), the groups are the whole
    microbatch's (``stream``): the rank lays its tokens out at their
    places in the groups it touches, routes them with the earlier ranks'
    counts, and runs its own slots.  Under sequence parallelism x is the
    rank's block of the sequence: the whole sequence is gathered first,
    so the groups are the reference's, and the rank returns its block."""
    seq = shardctx.seq_block(cfg)
    x_route = x
    if seq:     # the whole sequence: for the experts, and for the router
        x, x_route = shardctx.seq_gather_pair(x)
    orig_shape = x.shape
    d = orig_shape[-1]
    st = stream(x.reshape(-1, d).shape[0], *shardctx.dp_rows())
    t = st.tokens
    after = st.local * st.gsize - st.lead - t
    g, gsize = st.local, st.gsize

    def groups(v):
        v = v.reshape(-1, d)
        if st.lead or after:
            v = torch.cat([v.new_zeros((st.lead, d)), v,
                           v.new_zeros((after, d))])
        return v.reshape(g, gsize, d)

    xg = groups(x)
    dispatch, gates, aux = route(p["router"], cfg,
                                 groups(x_route) if seq else xg, st)
    xg_whole = xg           # what a shared expert held whole reads
    if seq:
        # every rank routes the whole sequence alike; the combine reads
        # the gates for the rank's experts, or for its block's rows
        gates = shardctx.sum_grad(gates)
    if shardctx.split(cfg, "moe"):
        # the router runs whole on every rank; its outputs enter the
        # rank's experts (or its F columns of every expert), so their
        # gradients are summed over "model"
        if not seq:
            xg = shardctx.enter(cfg, "moe", xg)
            gates = shardctx.enter(cfg, "moe", gates)     # before the slice
        if cfg.expert_mesh == "model":
            mine = slice(cfg.expert_offset,
                         cfg.expert_offset + cfg.local_experts)
            dispatch, gates = dispatch[:, :, mine], gates[:, :, mine]
    combine = dispatch * gates[..., None]

    cdt = dtype_of(cfg.compute_dtype)
    e, cap = dispatch.shape[2], dispatch.shape[3]
    # (G, E*C, D): each expert slot's token, then (E, G*C, D) for the bmm
    xe = torch.bmm(dispatch.to(cdt).reshape(g, gsize, e * cap).transpose(1, 2),
                   xg)
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    ye = _experts(p, cfg, xe)                                    # (E, G*C, D)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    y = torch.bmm(combine.to(cdt).reshape(g, gsize, e * cap), ye)

    if seq:
        return _seq_out(p, cfg, xg, y, st, orig_shape), aux
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
    y = y.reshape(-1, d)[st.lead:st.lead + t]
    return y.reshape(orig_shape), aux
