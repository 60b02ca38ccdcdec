"""Decoder-stack entry points of the port.

Port of ``repro/models/transformer.py`` for stacks of global-attention
layers (kind "g", every layer of qwen3-0.6b, starcoder2-7b and
qwen1.5-110b).  The other kinds raise ``NotImplementedError`` naming the
slice that brings them.

Parameters are plain dicts of tensors with the reference's structure:
``{"embed", "units": {"slot0": {...}}, "final_norm"}``, where every leaf
under ``units`` has a leading ``n_units`` axis.  ``params_from_reference``
carries the reference's initialised parameters across.  Caches are dicts
too: ``{"units": {"slot0": KVCache}, "tail": [], "pos", ["pad"]}`` with
unit-stacked (U, B, S_max, KV, hd) K/V.

Entry points: ``forward_train`` (teacher-forced logits), ``prefill`` (the
serving cache and last-token logits; ``pad`` for left-padded rows),
``decode_step`` (one token against a dense cache), ``prefill_chunk`` (one
chunk of a resumable prefill) and ``decode_step_paged`` (one token per
slot against the paged pool).  Caches are updated in place.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _tree
from ..device import resolve_device
from . import attention as attn
from . import ffn as ffn_mod
from .common import dtype_of, embed_init, rms_norm, dense_init

HYBRID_SLICE = attn.RING_SLICE
_LATER = {
    "l": HYBRID_SLICE, "r": HYBRID_SLICE, "s": HYBRID_SLICE,
    "m": "a later slice (the MoE mixer)",
    "x": "a later slice (cross-attention and encoder kinds)",
    "e": "a later slice (cross-attention and encoder kinds)",
    "d": "a later slice (cross-attention and encoder kinds)",
}


def check_servable(cfg) -> None:
    """Raise ``NotImplementedError`` unless every layer of ``cfg`` is a
    global-attention layer, the one kind this slice ports."""
    for kind in (*cfg.block_pattern, *cfg.tail_pattern):
        if kind != "g":
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet; it "
                f"comes with {_LATER.get(kind, 'a later slice')}")
    if cfg.tail_pattern or cfg.enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: tail and encoder stacks come with a later slice")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    return {"norm1": torch.zeros(d, dtype=dt, device=device),
            "attn": attn.init_attention(gen, cfg, device=device),
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
        "units": {f"slot{i}": _tree.stack([_init_layer(gen, cfg, device)
                                           for _ in range(cfg.n_units)])
                  for i, _ in enumerate(cfg.block_pattern)},
        "final_norm": torch.zeros(cfg.d_model, dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                    device=device)
    return params


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes.bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    if a.dtype.kind == "f":
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(tree, cfg, device=None) -> dict:
    """The reference's parameter pytree, as nested dicts and lists of numpy
    arrays (float32 or ml_dtypes bfloat16 leaves; ``units`` leaves stacked
    with a leading ``n_units`` axis), as the port's parameters on
    ``device``."""
    check_servable(cfg)
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _leaf_from_numpy(node, device)

    params = conv(tree)
    lead = {t.shape[0] for t in _leaves(params["units"])}
    if lead != {cfg.n_units}:
        raise ValueError(f"units leaves lead with {sorted(lead)}, expected "
                         f"n_units={cfg.n_units}")
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
# full sequences (train / prefill)
# ---------------------------------------------------------------------------

def _layer_full(p, cfg, x, positions, pad_mask=None):
    """One global-attention layer over a full sequence: (x, (k, v))."""
    normed = rms_norm(x, p["norm1"])
    out, kv = attn.self_attention(p["attn"], cfg, normed, positions,
                                  kind="g", pad_mask=pad_mask)
    x = x + out
    x = x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))
    return x, kv


def run_units(units, cfg, x, positions, caches=None, pad_mask=None):
    """Apply every unit of ``units`` (leaves stacked over units) to x.  With
    ``caches`` ({"slot{i}": KVCache of (U, B, S_max, KV, hd)}), each layer's
    K/V is written at positions 0.. of its unit's cache."""
    n = next(_leaves(units)).shape[0]
    for u in range(n):
        unit_p = _tree.index(units, u)
        for i, _ in enumerate(cfg.block_pattern):
            x, (k, v) = _layer_full(unit_p[f"slot{i}"], cfg, x, positions,
                                    pad_mask)
            if caches is not None:
                c = caches[f"slot{i}"]
                attn.prefill_into_kv(attn.KVCache(c.k[u], c.v[u]), k, v)
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
    return _logits(params, cfg, x), torch.zeros((), device=tokens.device)


def _init_caches(cfg, batch: int, s_max: int, device) -> dict:
    """Zeroed unit-stacked KV caches, as ``prefill`` fills them."""
    dt = dtype_of(cfg.compute_dtype)
    shape = (cfg.n_units, batch, s_max, cfg.n_kv, cfg.resolved_head_dim)
    return {"units": {f"slot{i}": attn.KVCache(
                          torch.zeros(shape, dtype=dt, device=device),
                          torch.zeros(shape, dtype=dt, device=device))
                      for i, _ in enumerate(cfg.block_pattern)},
            "tail": []}


def prefill(params, cfg, batch, s_max: int, pad=None):
    """Build the serving cache from a prompt.  Returns (last-token logits
    (B, V), caches); ``s_max`` sizes the KV buffers.

    ``pad`` (B,) gives each row's LEFT-pad count: attention masks the pad
    keys and RoPE uses the per-row positions ``max(arange(S) - pad, 0)``,
    so a padded row's logits and cache equal its solo run.  The pad vector
    rides in the cache (``caches["pad"]``) so ``decode_step`` keeps masking.
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
    caches["pos"] = s
    if pad is not None:
        caches["pad"] = pad
    return _logits(params, cfg, x[:, -1:])[:, 0], caches


def decode_step(params, cfg, caches, tokens):
    """One decode step: tokens (B,).  Writes each layer's K/V at
    ``caches["pos"]`` in place and returns (logits (B, V), caches) with
    ``pos`` advanced by one."""
    pos = int(caches["pos"])
    pad = caches.get("pad")
    x = _embed(params, cfg, tokens)[:, None, :]
    units = caches["units"]
    for u in range(cfg.n_units):
        unit_p = _unit(params, u)
        for i, _ in enumerate(cfg.block_pattern):
            p = unit_p[f"slot{i}"]
            c = units[f"slot{i}"]
            out, _ = attn.decode_self_attention(
                p["attn"], cfg, rms_norm(x, p["norm1"]),
                attn.KVCache(c.k[u], c.v[u]), pos, kind="g", pad=pad)
            x = x + out
            x = x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))
    new = {"units": units, "tail": caches["tail"], "pos": pos + 1}
    if pad is not None:
        new["pad"] = pad
    return _logits(params, cfg, x)[:, 0], new


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
    units = caches["units"]
    for u in range(cfg.n_units):
        unit_p = _unit(params, u)
        for i, _ in enumerate(cfg.block_pattern):
            p = unit_p[f"slot{i}"]
            kc = units[f"slot{i}"]
            out, _ = attn.chunk_self_attention(
                p["attn"], cfg, rms_norm(x, p["norm1"]),
                attn.KVCache(kc.k[u], kc.v[u]), start, positions)
            x = x + out
            x = x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))
    last = x[:, n_valid - 1:n_valid]
    return _logits(params, cfg, last)[:, 0], {"units": units,
                                              "tail": caches["tail"]}


def decode_step_paged(params, cfg, caches, tokens, block_table, seq_lens):
    """One continuous-batching decode step.  tokens (B,); ``caches`` is the
    pool state of ``serving.kvpool.init_decode_state``; ``block_table``
    (B, M) and ``seq_lens`` (B,) give each slot's blocks and cache length.
    Writes into the pool in place; returns (logits (B, V), caches)."""
    x = _embed(params, cfg, tokens)[:, None, :]
    pools = caches["units"]
    for u in range(cfg.n_units):
        unit_p = _unit(params, u)
        for i, _ in enumerate(cfg.block_pattern):
            p = unit_p[f"slot{i}"]
            pool = pools[f"slot{i}"]
            out, _ = attn.decode_self_attention_paged(
                p["attn"], cfg, rms_norm(x, p["norm1"]),
                attn.KVCache(pool.k[u], pool.v[u]), kind="g",
                block_table=block_table, seq_lens=seq_lens)
            x = x + out
            x = x + ffn_mod.apply_ffn(p["ffn"], cfg, rms_norm(x, p["norm2"]))
    return _logits(params, cfg, x)[:, 0], caches
