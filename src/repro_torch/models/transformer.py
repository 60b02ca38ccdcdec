"""Decoder-stack entry points of the port.

Port of ``repro/models/transformer.py`` for the layer kinds the continuous
engine serves: "g" (global attention), "l" (sliding-window attention on a
ring cache), "r" (RG-LRU recurrent block) and "s" (Mamba2 SSD block), as
repetitions of ``cfg.block_pattern`` plus a ``cfg.tail_pattern``
(qwen3-0.6b, recurrentgemma-2b, mamba2-1.3b, gemma3-1b, ...).  The other
kinds raise ``NotImplementedError`` naming the slice that brings them.

Parameters are plain dicts of tensors with the reference's structure:
``{"embed", "units": {"slot{i}": {...}}, "tail": [{...}], "final_norm"}``,
where every leaf under ``units`` has a leading ``n_units`` axis and
``tail`` holds one dict per tail layer.  ``params_from_reference`` carries
the reference's parameters across.  Caches are dicts too:
``{"units": {"slot{i}": cache}, "tail": [cache], "pos", ["pad"]}``, where a
unit cache is the kind's cache with a leading units axis: ``KVCache``
(U, B, S_max, KV, hd) for "g", ``RingCache`` (U, B, W, ...) for "l",
``RglruCache`` and ``SsmCache`` of recurrent state for "r" and "s".

Entry points: ``forward_train`` (teacher-forced logits), ``prefill`` (the
serving cache and last-token logits; ``pad`` for left-padded rows),
``decode_step`` (one token against that cache), ``prefill_chunk`` (one
chunk of a resumable prefill) and ``decode_step_paged`` (one token per
slot against the engine's pool).  Caches are updated in place.
"""
from __future__ import annotations

import torch

from .. import _tree
from ..device import resolve_device
from . import attention as attn
from . import ffn as ffn_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import dtype_of, embed_init, rms_norm, dense_init

SERVED = ("g", "l", "r", "s")
_LATER = {
    "m": "a later slice (the MoE mixer)",
    "x": "a later slice (cross-attention and encoder kinds)",
    "e": "a later slice (cross-attention and encoder kinds)",
    "d": "a later slice (cross-attention and encoder kinds)",
}


def check_servable(cfg) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is of a
    kind the port serves (g, l, r, s: what the reference's continuous
    engine serves, less the MoE mixer) and it has no encoder."""
    for kind in (*cfg.block_pattern, *cfg.tail_pattern):
        if kind not in SERVED:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet; it "
                f"comes with {_LATER.get(kind, 'a later slice')}")
    if cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder stacks come with {_LATER['e']}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg, kind, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    if kind == "s":
        return {"ssm": ssm_mod.init_ssm(gen, cfg, device=device)}
    mixer = ({"rglru": rglru_mod.init_rglru(gen, cfg, device=device)}
             if kind == "r" else
             {"attn": attn.init_attention(gen, cfg, device=device)})
    return {"norm1": torch.zeros(d, dtype=dt, device=device), **mixer,
            "norm2": torch.zeros(d, dtype=dt, device=device),
            "ffn": ffn_mod.init_ffn(gen, cfg, device=device)}


def init_params(seed, cfg, device=None) -> dict:
    """Random parameters from ``seed`` (an int, or a ``torch.Generator`` on
    the target device).  Not the reference's numbers: parity tests use
    ``params_from_reference``."""
    check_servable(cfg)
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    dt = dtype_of(cfg.param_dtype)
    params = {
        "embed": embed_init(gen, (cfg.vocab, cfg.d_model), dt, device=device),
        "units": {f"slot{i}": _tree.stack([_init_layer(gen, cfg, kind, device)
                                           for _ in range(cfg.n_units)])
                  for i, kind in enumerate(cfg.block_pattern)},
        "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=device),
    }
    if cfg.tail_pattern:
        params["tail"] = [_init_layer(gen, cfg, kind, device)
                          for kind in cfg.tail_pattern]
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                    device=device)
    return params


def params_from_reference(tree, cfg, device=None) -> dict:
    """The reference's parameter pytree, as nested dicts and lists of numpy
    arrays (float32 or ml_dtypes bfloat16 leaves; ``units`` leaves stacked
    with a leading ``n_units`` axis, ``tail`` a list of per-layer dicts), as
    the port's parameters on ``device``."""
    check_servable(cfg)
    params = _tree.from_numpy(tree, resolve_device(device))
    lead = {t.shape[0] for t in _leaves(params["units"])}
    if lead != {cfg.n_units}:
        raise ValueError(f"units leaves lead with {sorted(lead)}, expected "
                         f"n_units={cfg.n_units}")
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

def new_cache(cfg, kind: str, lead, s_max: int, device):
    """A zeroed cache of one layer of ``kind`` with leading dims ``lead``
    ((rows,) or (units, rows)), as ``prefill`` fills it."""
    dt = dtype_of(cfg.compute_dtype)
    if kind == "s":
        return ssm_mod.init_ssm_cache(cfg, lead, dt, device)
    if kind == "r":
        return rglru_mod.init_rglru_cache(cfg, lead, dt, device)
    if kind == "l":
        return attn.init_ring_cache(cfg, lead, dt, device)
    shape = (*lead, s_max, cfg.n_kv, cfg.resolved_head_dim)
    return attn.KVCache(torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device))


def _init_caches(cfg, batch: int, s_max: int, device) -> dict:
    return {"units": {f"slot{i}": new_cache(cfg, kind, (cfg.n_units, batch),
                                            s_max, device)
                      for i, kind in enumerate(cfg.block_pattern)},
            "tail": [new_cache(cfg, kind, (batch,), s_max, device)
                     for kind in cfg.tail_pattern]}


def _fill(kind, cache, out) -> None:
    """Write one layer's prefill result ``out`` into its cache, in place:
    K/V at positions 0.. ("g"), the last window of K/V at their ring slots
    ("l"), the recurrent state ("r", "s")."""
    if kind == "g":
        attn.prefill_into_kv(cache, *out)
    elif kind == "l":
        k, v = out
        attn.prefill_into_ring(cache, k, v, k.shape[1])
    else:
        for dst, src in zip(cache, out):
            dst.copy_(src)


# ---------------------------------------------------------------------------
# full sequences (train / prefill)
# ---------------------------------------------------------------------------

def _layer_full(p, cfg, kind, x, positions, pad_mask=None,
                want_cache: bool = False):
    """One layer over a full sequence: (x, what its cache needs or None).

    ``pad_mask`` (B, S) marks the valid (non-left-pad) positions, and every
    kind honours it: attention masks pad keys, the recurrent kinds zero pad
    inputs ahead of their convs and reset their scans, so a left-padded row
    equals its solo run."""
    if kind == "s":
        y = ssm_mod.apply_ssm(p["ssm"], cfg, x, want_cache, pad_mask)
        y, extra = y if want_cache else (y, None)
        return x + y, extra
    normed = rms_norm(x, p["norm1"])
    if kind == "r":
        h = rglru_mod.apply_rglru(p["rglru"], cfg, normed, want_cache,
                                  pad_mask)
        h, extra = h if want_cache else (h, None)
    else:
        h, extra = attn.self_attention(p["attn"], cfg, normed, positions,
                                       kind=kind, pad_mask=pad_mask)
    x = x + h
    x = x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))
    return x, extra


def run_units(units, cfg, x, positions, caches=None, pad_mask=None):
    """Apply every unit of ``units`` (leaves stacked over units) to x.  With
    ``caches`` ({"slot{i}": unit-stacked cache}), each layer's cache is
    filled in place."""
    n = next(_leaves(units)).shape[0]
    for u in range(n):
        unit_p = _tree.index(units, u)
        for i, kind in enumerate(cfg.block_pattern):
            x, out = _layer_full(unit_p[f"slot{i}"], cfg, kind, x, positions,
                                 pad_mask, want_cache=caches is not None)
            if caches is not None:
                _fill(kind, _tree.index(caches[f"slot{i}"], u), out)
    return x


def run_tail(tail, cfg, x, positions, caches=None, pad_mask=None):
    """Apply the tail layers, filling their caches in place if given."""
    for j, (p, kind) in enumerate(zip(tail, cfg.tail_pattern)):
        x, out = _layer_full(p, cfg, kind, x, positions, pad_mask,
                             want_cache=caches is not None)
        if caches is not None:
            _fill(kind, caches[j], out)
    return x


def _logits(params, cfg, x):
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ head).float()


def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def forward_train(params, cfg, batch):
    """Teacher-forced logits.  batch: {"tokens": (B, S)}.  Returns
    (logits (B, S, V) float32, aux) with aux = 0 (no MoE here)."""
    check_servable(cfg)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = run_units(params["units"], cfg, x, positions)
    x = run_tail(params.get("tail", []), cfg, x, positions)
    return _logits(params, cfg, x), torch.zeros((), device=tokens.device)


def prefill(params, cfg, batch, s_max: int, pad=None):
    """Build the serving cache from a prompt.  Returns (last-token logits
    (B, V), caches); ``s_max`` sizes the global KV buffers.

    ``pad`` (B,) gives each row's LEFT-pad count: attention masks the pad
    keys and RoPE uses the per-row positions ``max(arange(S) - pad, 0)``;
    recurrent layers zero pad inputs and reset their scans at the pad
    boundary.  A padded row's logits and cache equal its solo run.  The pad
    vector rides in the cache (``caches["pad"]``) so ``decode_step`` keeps
    masking.
    """
    check_servable(cfg)
    tokens = batch["tokens"]
    device = tokens.device
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    if pad is None:
        positions = torch.arange(s, device=device)
        pad_mask = None
    else:
        pad = torch.as_tensor(pad, dtype=torch.int32, device=device)
        ar = torch.arange(s, device=device)[None, :]
        positions = torch.clamp(ar - pad[:, None], min=0)
        pad_mask = ar >= pad[:, None]
    caches = _init_caches(cfg, b, s_max, device)
    x = run_units(params["units"], cfg, x, positions, caches["units"],
                  pad_mask)
    x = run_tail(params.get("tail", []), cfg, x, positions, caches["tail"],
                 pad_mask)
    caches["pos"] = s
    if pad is not None:
        caches["pad"] = pad
    return _logits(params, cfg, x[:, -1:])[:, 0], caches


# -- decode -------------------------------------------------------------------

def _ffn_residual(p, cfg, x, h):
    x = x + h
    return x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))


def _layer_decode(p, cfg, kind, x, cache, pos, pad=None):
    """One token through one layer, its cache stepped in place."""
    if kind == "s":
        return x + ssm_mod.apply_ssm_decode(p["ssm"], cfg, x, cache)[0]
    normed = rms_norm(x, p["norm1"])
    if kind == "r":
        h, _ = rglru_mod.apply_rglru_decode(p["rglru"], cfg, normed, cache)
    else:
        h, _ = attn.decode_self_attention(p["attn"], cfg, normed, cache, pos,
                                          kind=kind, pad=pad)
    return _ffn_residual(p, cfg, x, h)


def _each_layer(params, cfg, caches):
    """(layer params, kind, layer cache) over the units, then the tail;
    the caches are views of ``caches``' unit-stacked tensors."""
    for u in range(cfg.n_units):
        unit_p = _unit(params, u)
        for i, kind in enumerate(cfg.block_pattern):
            yield (unit_p[f"slot{i}"], kind,
                   _tree.index(caches["units"][f"slot{i}"], u))
    for p, kind, c in zip(params.get("tail", []), cfg.tail_pattern,
                          caches["tail"]):
        yield p, kind, c


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
    prompt (their outputs are zeros and nothing reads them)."""
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
        p["attn"], cfg, rms_norm(x, p["norm1"]), cache, kind=kind,
        block_table=block_table, seq_lens=seq_lens)
    return _ffn_residual(p, cfg, x, out)


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
