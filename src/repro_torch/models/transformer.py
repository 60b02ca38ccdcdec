"""Layer-stack entry points of the port.

Port of ``repro/models/transformer.py`` for every layer kind of the
registry: "g" (global attention), "l" (sliding-window attention on a ring
cache), "m" (global attention and the MoE mixer), "x" (cross-attention to
a context, dense FFN), "r" (RG-LRU recurrent block), "s" (Mamba2 SSD
block), "e" (the encoder's bidirectional self-attention) and "d" (the
enc-dec decoder layer: causal self-attention, then cross-attention), as
repetitions of ``cfg.block_pattern`` plus a ``cfg.tail_pattern``.  The
context of "x" and "d" layers is ``batch["image_embeds"]`` (a vision
frontend) or the encoder stack's output over ``batch["src_embeds"]``
(``cfg.enc_layers`` layers of "e").

Parameters are plain dicts of tensors with the reference's structure:
``{"embed", "units": {"slot{i}": {...}}, "tail": [{...}], "final_norm",
["head"], ["encoder": {"units": {"slot0": {...}}, "final_norm"}]}``, where
every leaf under a ``units`` has a leading layer axis (``n_units``, or
``enc_layers`` in the encoder) and ``tail`` holds one dict per tail layer.
``params_from_reference`` carries the reference's parameters across.
Caches are dicts too: ``{"units": {"slot{i}": cache}, "tail": [cache],
"pos", ["pad"]}``, where a unit cache is the kind's cache with a leading
units axis: ``KVCache`` (U, B, S_max, KV, hd) for "g" and "m",
``RingCache`` (U, B, W, ...) for "l", ``RglruCache`` and ``SsmCache`` of
recurrent state for "r" and "s", ``{"ctx_kv": KVCache}`` of the context's
K/V (U, B, S_ctx, KV, hd) for "x", and ``{"self": KVCache, "ctx_kv":
KVCache}`` for "d".

Entry points: ``forward_train`` (teacher-forced logits and the summed MoE
aux loss), ``prefill`` (the serving cache and last-token logits; ``pad``
for left-padded rows), ``decode_step`` (one token against that cache),
``prefill_chunk`` (one chunk of a resumable prefill; g/l/r/s only) and
``decode_step_paged`` (one token per slot against the engine's pool; the
kinds ``serving.kvpool.check_pattern`` admits).  Caches are updated in
place.

Under tensor parallelism the entry points take a rank's shard of the
parameters and its ``shardctx.RankConfig`` (``launch.sharding.place_params``)
and run unchanged: each layer module calls its own collectives, and where
the config splits "vocab" the embedding is a masked lookup of the rank's
rows, all-reduced, and the logits of the rank's columns are all-gathered
before anyone takes an argmax, so ties break on the first index as they
do unsharded.  Under ``seq_shard`` (``shardctx.seq_parallel``) the
decoder stack of ``forward_train`` and ``prefill`` runs on each rank's
block of the sequence between sub-blocks: the embedding is
reduce-scattered over it, and the final norm's output all-gathered.  A
view whose kv heads the "model" axis does not divide keeps its dense and
ring caches split over the sequence (``attention.SeqKVCache``,
``SeqRingCache``); ``pool_layout`` gathers them into the paged pool's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import _tree, shardctx
from ..device import resolve_device
from . import attention as attn
from . import ffn as ffn_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import dtype_of, embed_init, rms_norm, dense_init

CHUNKED = ("g", "l", "r", "s")     # the kinds prefill_chunk runs


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg, kind, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    if kind == "s":
        return {"ssm": ssm_mod.init_ssm(gen, cfg, device=device)}
    norm = lambda: torch.zeros(d, dtype=dt, device=device)
    if kind == "r":
        mixer = {"rglru": rglru_mod.init_rglru(gen, cfg, device=device)}
    elif kind == "x":
        mixer = {"xattn": attn.init_attention(gen, cfg, cross=True,
                                              device=device)}
    elif kind == "d":
        mixer = {"attn": attn.init_attention(gen, cfg, device=device),
                 "norm_x": norm(),
                 "xattn": attn.init_attention(gen, cfg, cross=True,
                                              device=device)}
    else:                                   # "g" | "l" | "m" | "e"
        mixer = {"attn": attn.init_attention(gen, cfg, device=device)}
    channel = ({"moe": ffn_mod.init_moe(gen, cfg, device=device)}
               if kind == "m" else
               {"ffn": ffn_mod.init_ffn(gen, cfg, device=device)})
    return {"norm1": norm(), **mixer, "norm2": norm(), **channel}


def _keep_tree(keep, prefix: str, tree):
    """``tree`` (nested dicts and lists of tensors) with each leaf ``t`` at
    path ``prefix/...`` replaced by ``keep(path, t)``."""
    if isinstance(tree, torch.Tensor):
        return keep(prefix, tree)
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {k: _keep_tree(keep, f"{prefix}/{k}", v) for k, v in items}
    return out if isinstance(tree, dict) else list(out.values())


def _init_stack(gen, cfg, pattern, n: int, device, keep, prefix) -> dict:
    """{"slot{i}": the n layers of kind pattern[i], stacked}.  Each leaf is
    allocated stacked and filled one layer at a time, in the order the
    layers are drawn, so only one layer exists beside the stack."""
    out = {}
    for i, kind in enumerate(pattern):
        stacked = None
        for u in range(n):
            layer = _keep_tree(keep, f"{prefix}/slot{i}",
                               _init_layer(gen, cfg, kind, device))
            if stacked is None:
                stacked = _tree.map_tensors(
                    lambda t: t.new_empty((n, *t.shape)), layer)
            _tree.map_tensors(lambda dst, src: dst[u].copy_(src), stacked,
                              layer)
            del layer
        out[f"slot{i}"] = stacked
    return out


def init_params(seed, cfg, device=None, *, keep=None) -> dict:
    """Random parameters from ``seed`` (an int, or a ``torch.Generator`` on
    the target device).  Not the reference's numbers: parity tests use
    ``params_from_reference``.

    ``keep(path, t)``, where given, maps each leaf as it is drawn (a
    unit's one layer at a time, at its unstacked path such as
    "units/slot0/attn/wq") to what the tree holds instead: a rank's shard
    on another device (``launch.sharding.init_rank_params``).

    On the meta device nothing is drawn: the tree gives each leaf's shape
    and dtype (``launch.specs.params_specs``)."""
    device = resolve_device(device)
    if device.type == "meta" or isinstance(seed, torch.Generator):
        gen = seed if isinstance(seed, torch.Generator) else None
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
    keep = keep or (lambda path, t: t)
    dt = dtype_of(cfg.param_dtype)
    norm = lambda path: keep(path, torch.zeros(cfg.d_model, dtype=dt,
                                               device=device))
    params = {
        "embed": keep("embed", embed_init(gen, (cfg.vocab, cfg.d_model), dt,
                                          device=device)),
        "units": _init_stack(gen, cfg, cfg.block_pattern, cfg.n_units,
                             device, keep, "units"),
        "final_norm": norm("final_norm"),
    }
    if cfg.tail_pattern:
        params["tail"] = [_keep_tree(keep, f"tail/{j}",
                                     _init_layer(gen, cfg, kind, device))
                          for j, kind in enumerate(cfg.tail_pattern)]
    if not cfg.tie_embeddings:
        params["head"] = keep("head", dense_init(
            gen, (cfg.d_model, cfg.vocab), dt, device=device))
    if cfg.enc_layers:
        params["encoder"] = {
            "units": _init_stack(gen, cfg, ("e",), cfg.enc_layers, device,
                                 keep, "encoder/units"),
            "final_norm": norm("encoder/final_norm")}
    return params


def params_from_reference(tree, cfg, device=None) -> dict:
    """The reference's parameter pytree, as nested dicts and lists of numpy
    arrays (float32 or ml_dtypes bfloat16 leaves; ``units`` leaves stacked
    with a leading ``n_units`` axis, the encoder's with ``enc_layers``,
    ``tail`` a list of per-layer dicts), as the port's parameters on
    ``device``."""
    params = _tree.from_numpy(tree, resolve_device(device))
    stacks = [(params["units"], cfg.n_units, "n_units")]
    if cfg.enc_layers:
        stacks.append((params["encoder"]["units"], cfg.enc_layers,
                       "enc_layers"))
    for units, n, name in stacks:
        lead = {t.shape[0] for t in _leaves(units)}
        if lead != {n}:
            raise ValueError(f"units leaves lead with {sorted(lead)}, "
                             f"expected {name}={n}")
    if len(params.get("tail", [])) != len(cfg.tail_pattern):
        raise ValueError(f"{len(params.get('tail', []))} tail layers, "
                         f"expected {len(cfg.tail_pattern)}")
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def _unit(params, u: int) -> dict:
    return _tree.index(params["units"], u)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def new_cache(cfg, kind: str, lead, s_max: int, device, ctx_len: int = 0,
              *, seq: bool = True):
    """A zeroed cache of one layer of ``kind`` with leading dims ``lead``
    ((rows,) or (units, rows)), as ``prefill`` fills it; ``ctx_len`` sizes
    the context K/V of "x" and "d" layers.  Where ``cfg`` keeps its dense
    and ring caches split over the sequence (``shardctx.seq_caches``), the
    self-attention caches are the rank's blocks, unless ``seq`` is False
    (the paged pool's rings); the context K/V stays the rank's kv heads."""
    dt = dtype_of(cfg.compute_dtype)
    if kind == "s":
        return ssm_mod.init_ssm_cache(cfg, lead, dt, device)
    if kind == "r":
        return rglru_mod.init_rglru_cache(cfg, lead, dt, device)
    if kind == "l":
        return attn.init_ring_cache(cfg, lead, dt, device, seq=seq)
    kv = lambda n, split: attn.init_kv_cache(cfg, lead, n, dt, device,
                                             seq=split)
    if kind == "x":
        return {"ctx_kv": kv(ctx_len, False)}
    if kind == "d":
        return {"self": kv(s_max, seq), "ctx_kv": kv(ctx_len, False)}
    return kv(s_max, seq)


def _init_caches(cfg, batch: int, s_max: int, device, ctx_len: int = 0):
    return {"units": {f"slot{i}": new_cache(cfg, kind, (cfg.n_units, batch),
                                            s_max, device, ctx_len)
                      for i, kind in enumerate(cfg.block_pattern)},
            "tail": [new_cache(cfg, kind, (batch,), s_max, device, ctx_len)
                     for kind in cfg.tail_pattern]}


def _copy(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _fill(cfg, kind, cache, out) -> None:
    """Write one layer's prefill result ``out`` into its cache, in place:
    K/V at positions 0.. ("g", "m"), the last window of K/V at their ring
    slots ("l"), the context's K/V ("x"; with the self K/V, "d"), the
    recurrent state ("r", "s").  A sequence-split cache takes its block
    (``attention.fill_prefill``)."""
    if kind in ("g", "m", "l"):
        attn.fill_prefill(cfg, cache, *out)
    elif kind == "x":
        _copy(cache["ctx_kv"], out)
    elif kind == "d":
        attn.fill_prefill(cfg, cache["self"], *out[0])
        _copy(cache["ctx_kv"], out[1])
    else:
        _copy(cache, out)


def pool_layout(cfg, caches) -> dict:
    """``caches`` ({"units", "tail"}) with each sequence-split leaf in the
    paged pool's layout (``serving.kvpool``): the blocks all-gathered over
    "model" into the whole sequence, and of its kv heads the rank's run.
    One all-gather a dtype, outside autograd.  The caches themselves
    where nothing is split."""
    from ..launch.mesh import pack, unpack
    split = [c for c in [*caches["units"].values(), *caches["tail"]]
             if attn.is_seq_split(c)]
    if not split:
        return caches
    leaves = [t for c in split for t in c]
    buffers, layout = pack(leaves)
    rows = {dt: shardctx.model_gather_rows(b) for dt, b in buffers.items()}
    ranks = [unpack({dt: r[i] for dt, r in rows.items()}, layout)
             for i in range(cfg.model_size)]
    # the sequence dim: K/V (..., L, KV, hd), a ring's positions (..., L)
    whole = iter([torch.cat(parts, dim=parts[0].dim() - (
        3 if parts[0].dim() >= 4 else 1)) for parts in zip(*ranks)])
    run = slice(cfg.kv_offset, cfg.kv_offset + cfg.n_kv)

    def unsplit(c):
        if not attn.is_seq_split(c):
            return c
        k, v = next(whole)[..., run, :], next(whole)[..., run, :]
        if isinstance(c, attn.RingCache):
            return attn.RingCache(k, v, next(whole))
        return attn.KVCache(k, v)

    return {"units": {name: unsplit(c) for name, c in
                      caches["units"].items()},
            "tail": [unsplit(c) for c in caches["tail"]]}


# ---------------------------------------------------------------------------
# full sequences (train / prefill)
# ---------------------------------------------------------------------------

def _layer_full(p, cfg, kind, x, positions, pad_mask=None,
                want_cache: bool = False, ctx=None):
    """One layer over a full sequence: (x, aux, what its cache needs).

    ``aux`` is the MoE load-balance loss of an "m" layer, else None; the
    cache part is None where ``want_cache`` is False (the K/V of attention
    kinds is returned all the same).  ``ctx`` (B, S_ctx, D) is the context
    of "x" and "d" layers.  ``pad_mask`` (B, S) marks the valid
    (non-left-pad) positions, and every kind honours it: self-attention
    masks pad keys, the recurrent kinds zero pad inputs ahead of their convs
    and reset their scans, so a left-padded row equals its solo run;
    cross-attention sees the whole context."""
    if kind == "s":
        y = ssm_mod.apply_ssm(p["ssm"], cfg, x, want_cache, pad_mask)
        y, extra = y if want_cache else (y, None)
        return x + y, None, extra
    normed = rms_norm(x, p["norm1"])
    aux = None
    if kind == "r":
        h = rglru_mod.apply_rglru(p["rglru"], cfg, normed, want_cache,
                                  pad_mask)
        h, extra = h if want_cache else (h, None)
        x = x + h
    elif kind == "x":
        extra = attn.context_kv(p["xattn"], cfg, ctx)
        x = x + attn.cross_attention(p["xattn"], cfg, normed, extra)
    elif kind == "d":
        h, kv = attn.self_attention(p["attn"], cfg, normed, positions,
                                    kind="g", pad_mask=pad_mask)
        x = x + h
        ctx_kv = attn.context_kv(p["xattn"], cfg, ctx)
        x = x + attn.cross_attention(p["xattn"], cfg,
                                     rms_norm(x, p["norm_x"]), ctx_kv)
        extra = (kv, ctx_kv)
    else:                                   # "g" | "l" | "m" | "e"
        akind = kind if kind in ("l", "e") else "g"
        h, extra = attn.self_attention(p["attn"], cfg, normed, positions,
                                       kind=akind, pad_mask=pad_mask)
        x = x + h
    if kind == "m":
        y, aux = ffn_mod.apply_moe(p["moe"], cfg, rms_norm(x, p["norm2"]))
        x = x + y
    else:
        x = x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))
    return x, aux, extra


def _add(total, aux):
    """``total + aux`` where either may be None (no MoE layer yet)."""
    if aux is None:
        return total
    return aux if total is None else total + aux


def _unstack(units) -> list:
    """The units of a unit-stacked tree as one tree of views each, from one
    ``torch.unbind`` per leaf: under autograd each leaf then gets one
    stacked gradient, where indexing each unit out would materialise a
    zero tensor the size of the whole leaf per unit."""
    parts = [torch.unbind(t) for t in _tree.leaves(units)]
    return [_tree.unflatten(units, [p[u] for p in parts])
            for u in range(len(parts[0]))]


def _run_unit(unit_p, cfg, pattern, x, positions, pad_mask, ctx, caches, u,
              prefix="units"):
    """One unit's layers over x; with ``caches``, each layer's cache at unit
    ``u`` is filled in place.  Returns (x, the unit's MoE aux or None).
    The unit's ZeRO-3 leaves (``unit_p`` at ``prefix``) are gathered
    here, inside any remat region: the recompute gathers them again, and
    one unit is whole at a time."""
    unit_p = shardctx.gather_tree(cfg, prefix, unit_p)
    total = None
    for i, kind in enumerate(pattern):
        x, aux, out = _layer_full(unit_p[f"slot{i}"], cfg, kind, x,
                                  positions, pad_mask,
                                  want_cache=caches is not None, ctx=ctx)
        total = _add(total, aux)
        if caches is not None:
            _fill(cfg, kind, _tree.index(caches[f"slot{i}"], u), out)
    return x, total


def run_units(units, cfg, x, positions, caches=None, pad_mask=None,
              ctx=None, pattern=None, remat: bool = False,
              prefix: str = "units"):
    """Apply every unit of ``units`` (leaves stacked over units; each unit
    the layers of ``pattern``, by default ``cfg.block_pattern``) to x.
    With ``caches`` ({"slot{i}": unit-stacked cache}), each layer's cache
    is filled in place.  With ``remat``, where a gradient is wanted, each
    unit runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` per unit): only its input is kept, and its forward
    runs again in the backward; under ``shardctx.remat_offload_active()``
    that input (the carry, and nothing else the checkpoint saves) waits
    in host memory, pinned on CUDA.  ``prefix`` is the units' path in the
    parameters ("units", or "encoder/units"), for their ZeRO-3 leaves.
    Returns (x, the units' summed MoE aux loss, or None where the pattern
    has no "m")."""
    pattern = cfg.block_pattern if pattern is None else pattern
    unit_params = _unstack(units)
    remat = remat and caches is None and torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, *_tree.leaves(units)])
    offload = remat and shardctx.remat_offload_active()
    total = None
    for u, unit_p in enumerate(unit_params):
        args = (unit_p, cfg, pattern, x, positions, pad_mask, ctx, caches, u,
                prefix)
        if offload:
            with _offload_carry(x):
                x, unit_aux = torch.utils.checkpoint.checkpoint(
                    _run_unit, *args, use_reentrant=False)
        elif remat:
            x, unit_aux = torch.utils.checkpoint.checkpoint(
                _run_unit, *args, use_reentrant=False)
        else:
            x, unit_aux = _run_unit(*args)
        total = _add(total, unit_aux)
    return x, total


def _offload_carry(carry):
    """Saved-tensor hooks under which the checkpoint that takes ``carry``
    as its input keeps that input in host memory (pinned, where it is a
    CUDA tensor) until its recompute: the checkpoint saves every tensor
    argument, the unit's weights too, and only the carry is moved.  A
    meta tensor (``launch.dryrun``'s) has no data to move: the recompute
    gets a new one of its shape."""
    def pack(t):
        if t is not carry:
            return t
        if t.is_meta:
            return (t.device, (t.shape, t.dtype))
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        return (t.device, host)

    def unpack(saved):
        if isinstance(saved, tuple):
            device, host = saved
            if device.type == "meta":
                return torch.empty(host[0], dtype=host[1], device=device)
            return host.to(device, non_blocking=True)
        return saved

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def run_tail(tail, cfg, x, positions, caches=None, pad_mask=None, ctx=None):
    """Apply the tail layers, filling their caches in place if given.
    Returns (x, their summed MoE aux loss or None)."""
    total = None
    for j, (p, kind) in enumerate(zip(tail, cfg.tail_pattern)):
        p = shardctx.gather_tree(cfg, f"tail/{j}", p)
        x, aux, out = _layer_full(p, cfg, kind, x, positions, pad_mask,
                                  want_cache=caches is not None, ctx=ctx)
        total = _add(total, aux)
        if caches is not None:
            _fill(cfg, kind, caches[j], out)
    return x, total


def _encode(params, cfg, src_embeds):
    """The bidirectional encoder stack over frame embeddings (B, S, D)."""
    enc = params["encoder"]
    x = src_embeds.to(dtype_of(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = run_units(enc["units"], cfg, x, positions, pattern=("e",),
                     prefix="encoder/units")
    return rms_norm(x, enc["final_norm"])


def _context(params, cfg, batch):
    """The context of "x" / "d" layers: image embeddings (a vision
    frontend) or the encoder's output; None for other stacks."""
    if cfg.frontend == "vision":
        return batch["image_embeds"].to(dtype_of(cfg.compute_dtype))
    if cfg.enc_layers:
        return _encode(params, cfg, batch["src_embeds"])
    return None


def _head(params, cfg, x):
    """Float32 logits of the rank's vocabulary columns (all of them where
    the vocabulary is whole).  Under sequence parallelism the final norm
    runs on the rank's block, which is then all-gathered over the
    sequence: its gradient reduce-scattered back where each rank's
    columns give part of it, or sliced where every rank computes the
    whole loss."""
    x = rms_norm(x, params["final_norm"])
    if shardctx.seq_block(cfg):
        x = shardctx.seq_gather(x, backward="reduce_scatter"
                                if shardctx.split(cfg, "vocab") else "slice")
    else:
        x = shardctx.enter(cfg, "vocab", x)
    head = (shardctx.gather_tree(cfg, "embed", params["embed"]).T
            if cfg.tie_embeddings else
            shardctx.gather_tree(cfg, "head", params["head"]))
    return (x @ head).float()


def _logits(params, cfg, x):
    """Float32 logits; where the vocabulary is split, each rank's columns
    are all-gathered, and a caller that reads the whole row on every rank
    (a loss every rank repeats) takes its columns' gradient as it is."""
    logits = _head(params, cfg, x)
    if shardctx.split(cfg, "vocab"):
        logits = shardctx.model_all_gather(logits, -1, backward="slice")
    return logits


def _embed(params, cfg, tokens):
    """The tokens' embedding rows.  ``F.embedding``, not indexing: its
    backward sums a repeated token's rows in a fixed order (indexing's
    backward, ``index_put_`` with accumulation, adds them in a thread order
    on the CPU), so a training step gives the same bits every time.  Where
    the vocabulary is split, each rank looks up the tokens among its rows
    (zeros for the others') and the sum over "model" is the row: one
    nonzero term, so it is exact.  Under sequence parallelism the result
    is the rank's block of the sequence: the sum is reduce-scattered, or
    a whole lookup keeps its block (the table's gradient whole on every
    rank either way)."""
    seq = shardctx.seq_block(cfg)
    table = shardctx.gather_tree(cfg, "embed", params["embed"])
    if not shardctx.split(cfg, "vocab"):
        rows = F.embedding(tokens, table).to(dtype_of(cfg.compute_dtype))
        return shardctx.seq_split(rows) if seq else rows
    local = tokens - cfg.vocab_offset
    mine = (local >= 0) & (local < cfg.local_vocab)
    rows = F.embedding(torch.where(mine, local, 0), table)
    rows = rows * mine[..., None].to(rows.dtype)
    rows = (shardctx.model_reduce_scatter(rows, 1) if seq
            else shardctx.model_all_reduce(rows))
    return rows.to(dtype_of(cfg.compute_dtype))


def _run_stack(params, cfg, x, positions, ctx, caches=None, pad_mask=None,
               remat: bool = False):
    x, aux = run_units(params["units"], cfg, x, positions,
                       None if caches is None else caches["units"], pad_mask,
                       ctx, remat=remat)
    x, tail_aux = run_tail(params.get("tail", []), cfg, x, positions,
                           None if caches is None else caches["tail"],
                           pad_mask, ctx)
    return x, _add(aux, tail_aux)


def _sequence_parallel(cfg, s: int, ctx):
    """(the view the decoder stack runs under for ``s`` positions, its
    context): under ``seq_shard`` (``shardctx.seq_parallel``) each rank's
    decoder reads the context for its block's rows alone, so the
    context's gradient is summed over "model" as it enters."""
    run = shardctx.seq_parallel(cfg, s)
    if run is not cfg and ctx is not None:
        ctx = shardctx.sum_grad(ctx)
    return run, ctx


def forward_train(params, cfg, batch, *, local_logits: bool = False):
    """Teacher-forced logits.  batch: {"tokens": (B, S)} plus
    ``image_embeds`` (vision) or ``src_embeds`` (an encoder's frames),
    each (B, S_ctx, D).  Returns (logits (B, S, V) float32, the summed MoE
    aux loss, float32).  With ``cfg.remat``, where a gradient is wanted,
    each unit of the decoder stack is recomputed in the backward.
    ``local_logits``: where the vocabulary is split, the rank's columns
    alone, (B, S, cfg.local_vocab), for a vocabulary-parallel loss
    (``models.steps.cross_entropy(vocab_offset=)``)."""
    tokens = batch["tokens"]
    ctx = _context(params, cfg, batch)
    cfg, ctx = _sequence_parallel(cfg, tokens.shape[1], ctx)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, aux = _run_stack(params, cfg, x, positions, ctx, remat=cfg.remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    head = _head if local_logits else _logits
    return head(params, cfg, x), aux


def prefill(params, cfg, batch, s_max: int, pad=None):
    """Build the serving cache from a prompt (and the batch's context, as
    ``forward_train`` takes it).  Returns (last-token logits (B, V),
    caches); ``s_max`` sizes the global KV buffers, the context's length
    the context K/V.

    ``pad`` (B,) gives each row's LEFT-pad count: self-attention masks the
    pad keys and RoPE uses the per-row positions ``max(arange(S) - pad,
    0)``; recurrent layers zero pad inputs and reset their scans at the pad
    boundary.  A padded row's logits and cache equal its solo run.  The pad
    vector rides in the cache (``caches["pad"]``) so ``decode_step`` keeps
    masking.
    """
    tokens = batch["tokens"]
    device = tokens.device
    b, s = tokens.shape
    ctx = _context(params, cfg, batch)
    run, ctx = _sequence_parallel(cfg, s, ctx)
    x = _embed(params, run, tokens)
    if pad is None:
        positions = torch.arange(s, device=device)
        pad_mask = None
    else:
        pad = torch.as_tensor(pad, dtype=torch.int32, device=device)
        ar = torch.arange(s, device=device)[None, :]
        positions = torch.clamp(ar - pad[:, None], min=0)
        pad_mask = ar >= pad[:, None]
    caches = _init_caches(cfg, b, s_max, device,
                          0 if ctx is None else ctx.shape[1])
    x, _ = _run_stack(params, run, x, positions, ctx, caches, pad_mask)
    if shardctx.seq_block(run):
        x = shardctx.seq_gather(x, backward="slice")
    caches["pos"] = s
    if pad is not None:
        caches["pad"] = pad
    return _logits(params, cfg, x[:, -1:])[:, 0], caches


# -- decode -------------------------------------------------------------------

def _ffn_residual(p, cfg, x, h):
    x = x + h
    return x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))


def _channel_residual(p, cfg, kind, x, h):
    """x + h, then the layer's channel mixer: the MoE for "m" (its aux
    loss is dropped, as the reference drops it outside training), else the
    dense FFN."""
    if kind != "m":
        return _ffn_residual(p, cfg, x, h)
    x = x + h
    return x + ffn_mod.apply_moe(p["moe"], cfg, rms_norm(x, p["norm2"]))[0]


def _layer_decode(p, cfg, kind, x, cache, pos, pad=None):
    """One token through one layer, its cache stepped in place."""
    if kind == "s":
        return x + ssm_mod.apply_ssm_decode(p["ssm"], cfg, x, cache)[0]
    normed = rms_norm(x, p["norm1"])
    if kind == "r":
        h, _ = rglru_mod.apply_rglru_decode(p["rglru"], cfg, normed, cache)
    elif kind == "x":
        h = attn.decode_cross_attention(p["xattn"], cfg, normed,
                                        cache["ctx_kv"])
    elif kind == "d":
        h, _ = attn.decode_self_attention(p["attn"], cfg, normed,
                                          cache["self"], pos, kind="g",
                                          pad=pad)
        x = x + h
        h = attn.decode_cross_attention(p["xattn"], cfg,
                                        rms_norm(x, p["norm_x"]),
                                        cache["ctx_kv"])
    else:
        h, _ = attn.decode_self_attention(p["attn"], cfg, normed, cache, pos,
                                          kind="l" if kind == "l" else "g",
                                          pad=pad)
    return _channel_residual(p, cfg, kind, x, h)


def _each_layer(params, cfg, caches):
    """(layer params, kind, layer cache) over the units, then the tail;
    the caches are views of ``caches``' unit-stacked tensors."""
    for u in range(cfg.n_units):
        unit_p = shardctx.gather_tree(cfg, "units", _unit(params, u))
        for i, kind in enumerate(cfg.block_pattern):
            yield (unit_p[f"slot{i}"], kind,
                   _tree.index(caches["units"][f"slot{i}"], u))
    for j, (p, kind, c) in enumerate(zip(params.get("tail", []),
                                         cfg.tail_pattern, caches["tail"])):
        yield shardctx.gather_tree(cfg, f"tail/{j}", p), kind, c


def decode_step(params, cfg, caches, tokens):
    """One decode step: tokens (B,).  Steps every layer's cache at
    ``caches["pos"]`` in place and returns (logits (B, V), caches) with
    ``pos`` advanced by one."""
    pos = int(caches["pos"])
    pad = caches.get("pad")
    x = _embed(params, cfg, tokens)[:, None, :]
    for p, kind, c in _each_layer(params, cfg, caches):
        x = _layer_decode(p, cfg, kind, x, c, pos, pad)
    new = {"units": caches["units"], "tail": caches["tail"], "pos": pos + 1}
    if pad is not None:
        new["pad"] = pad
    return _logits(params, cfg, x)[:, 0], new


def _layer_chunk(p, cfg, kind, x, cache, start: int, positions,
                 n_valid: int):
    """One layer over a prefill chunk of batch 1: x (1, C, D) holds the
    tokens at ``positions = start + arange(C)``, real up to ``n_valid``.

    "g" runs chunk-parallel against the dense scratch cache.  The stateful
    kinds ("l", "r", "s") replay their single-token decode step over the
    chunk's real tokens, as the reference does; the right-pad rows of a
    final partial chunk take no step, so the state does not move past the
    prompt (their outputs are zeros and nothing reads them).  The other
    kinds are refused, as the reference refuses them: capacity routing
    couples every token of an "m" dispatch group, so a chunk-local pass
    cannot give the whole-prompt routing, and "x", "d" and "e" are not
    served by the engine at all."""
    if kind not in CHUNKED:
        raise NotImplementedError(
            f"chunked prefill does not serve kind {kind!r}")
    if kind == "g":
        normed = rms_norm(x, p["norm1"])
        out, _ = attn.chunk_self_attention(p["attn"], cfg, normed, cache,
                                           start, positions)
        return _ffn_residual(p, cfg, x, out)
    src = x if kind == "s" else rms_norm(x, p["norm1"])
    outs = torch.zeros_like(x)
    for t in range(n_valid):
        xt = src[:, t:t + 1]
        if kind == "s":
            y, _ = ssm_mod.apply_ssm_decode(p["ssm"], cfg, xt, cache)
        elif kind == "r":
            y, _ = rglru_mod.apply_rglru_decode(p["rglru"], cfg, xt, cache)
        else:
            y, _ = attn.decode_self_attention(p["attn"], cfg, xt, cache,
                                              start + t, kind="l")
        outs[:, t:t + 1] = y
    if kind == "s":
        return x + outs
    return _ffn_residual(p, cfg, x, outs)


def prefill_chunk(params, cfg, caches, tokens, start: int, n_valid: int):
    """Advance a resumable chunked prefill by one chunk.

    ``caches`` is the {"units", "tail"} core of a batch-1 ``prefill`` cache
    holding the first ``start`` prompt tokens; ``tokens`` (1, C) is the next
    chunk, right-padded past ``n_valid``.  Returns (logits (1, V) of token
    ``start + n_valid - 1``, caches): on the final chunk those are the
    whole-prompt prefill logits.
    """
    c = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    positions = start + torch.arange(c, device=tokens.device)
    for p, kind, cache in _each_layer(params, cfg, caches):
        x = _layer_chunk(p, cfg, kind, x, cache, start, positions, n_valid)
    last = x[:, n_valid - 1:n_valid]
    return _logits(params, cfg, last)[:, 0], {"units": caches["units"],
                                              "tail": caches["tail"]}


def _layer_decode_paged(p, cfg, kind, x, cache, block_table, seq_lens):
    """One token per slot through one layer.  The recurrent kinds keep
    O(1) state per row and need no position: they take the dense step."""
    if kind in ("s", "r"):
        return _layer_decode(p, cfg, kind, x, cache, None)
    out, _ = attn.decode_self_attention_paged(
        p["attn"], cfg, rms_norm(x, p["norm1"]), cache,
        kind="l" if kind == "l" else "g", block_table=block_table,
        seq_lens=seq_lens)
    return _channel_residual(p, cfg, kind, x, out)


def decode_step_paged(params, cfg, caches, tokens, block_table, seq_lens):
    """One continuous-batching decode step.  tokens (B,); ``caches`` is the
    pool state of ``serving.kvpool.init_decode_state`` (global KV paged,
    ring and recurrent state per slot); ``block_table`` (B, M) and
    ``seq_lens`` (B,) give each slot's blocks and cache length.  Writes
    into the pool in place; returns (logits (B, V), caches)."""
    x = _embed(params, cfg, tokens)[:, None, :]
    for p, kind, c in _each_layer(params, cfg, caches):
        x = _layer_decode_paged(p, cfg, kind, x, c, block_table, seq_lens)
    return _logits(params, cfg, x)[:, 0], caches
