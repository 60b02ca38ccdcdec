"""Rank bodies for the KV cache's sequence over "model"
(tests/test_torch_kv_seq.py): each runs inside a world that
``repro_torch.launch.mesh.run_world`` spawns (gloo, CPU) and returns numpy
results.  Imports no JAX: the reference's parameters arrive as numpy
arguments.  ``greedy`` and ``chunked`` are written against a transformer
module's entry points and an array maker, so that the test process runs
the reference's through them too.
"""
from __future__ import annotations

import numpy as np
import torch

import _model_axis as ma

# 3 prompts left-padded to 12, 14 new tokens: positions up to 25 wrap the
# reduced window of 8 more than twice; the dense caches hold 32
LENGTHS, NEW, S_MAX = (12, 7, 10), 14, 32
CHUNK, CHUNKED = 4, 11           # one prompt prefilled in chunks of 4
NAMES = {"gemma3": 2, "hybrid-grs": 4}      # stack -> its "model" axis


def config(name: str, get_config, reduced):
    """Reduced gemma3-1b (5 "l" and a "g" a unit, an (l, l) tail; 4 query
    heads over 1 kv head, window 8) or the g/r/s hybrid (4 over 2)."""
    if name == "gemma3":
        return reduced(get_config("gemma3-1b"))
    return ma.hybrid_grs(get_config, reduced)


def prompts(vocab: int) -> list:
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def greedy(tf, params, cfg, array, argmax) -> list:
    """The prompts as one left-padded batch through ``tf.prefill``, then
    NEW greedy ``tf.decode_step``s: each row's tokens."""
    ps = prompts(cfg.vocab)
    width = max(LENGTHS)
    toks = np.stack([np.pad(p, (width - len(p), 0)) for p in ps])
    pad = np.array([width - len(p) for p in ps], np.int32)
    logits, caches = tf.prefill(params, cfg, {"tokens": array(toks)},
                                s_max=S_MAX, pad=array(pad))
    out = []
    for _ in range(NEW):
        nxt = argmax(logits)
        out.append(nxt)
        logits, caches = tf.decode_step(params, cfg, caches, array(nxt))
    return np.stack(out, 1).tolist()


def chunked(tf, params, cfg, array, argmax) -> list:
    """A CHUNKED-token prompt: ``tf.prefill`` of its first CHUNK tokens,
    ``tf.prefill_chunk`` of the rest (the last chunk right-padded), then
    NEW greedy ``tf.decode_step``s from the chunks' cache."""
    p = np.random.default_rng(12).integers(0, cfg.vocab, CHUNKED) \
        .astype(np.int32)
    logits, caches = tf.prefill(params, cfg,
                                {"tokens": array(p[None, :CHUNK])},
                                s_max=S_MAX)
    core = {"units": caches["units"], "tail": caches["tail"]}
    for start in range(CHUNK, CHUNKED, CHUNK):
        n = min(CHUNK, CHUNKED - start)
        chunk = np.zeros((1, CHUNK), np.int32)
        chunk[0, :n] = p[start:start + n]
        logits, core = tf.prefill_chunk(params, cfg, core, array(chunk),
                                        start, n)
    caches = dict(core, pos=CHUNKED)
    out = []
    for _ in range(NEW):
        nxt = argmax(logits)
        out.append(int(nxt[0]))
        logits, caches = tf.decode_step(params, cfg, caches, array(nxt))
    return out


def _torch_array(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64 if a.dtype.kind == "i"
                                      else a.dtype))


def _argmax(logits) -> np.ndarray:
    return torch.argmax(logits, -1).numpy().astype(np.int32)


def world(name: str, ref_params) -> dict:
    """On ``make_cells_mesh(model=NAMES[name])``: ``greedy`` and
    ``chunked`` through the port's sharded entry points; the prefill
    cache's types and shapes; and ``transformer.pool_layout`` of it
    against the rank's kv heads of the one-rank prefill's cache."""
    from repro_torch import shardctx
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_cells_mesh
    from repro_torch.models import transformer

    cfg = config(name, get_config, reduced)
    mesh = make_cells_mesh(model=NAMES[name])
    whole = transformer.params_from_reference(ref_params, cfg, "cpu")
    local, view = sharding.place_params(mesh, cfg, whole)
    out = {"split": view.split, "seq_caches": shardctx.seq_caches(view),
           "n_kv": view.n_kv, "kv_offset": view.kv_offset}
    with shardctx.activation_sharding(mesh):
        out["greedy"] = greedy(transformer, local, view, _torch_array,
                               _argmax)
        out["chunked"] = chunked(transformer, local, view, _torch_array,
                                 _argmax)
        toks = _torch_array(np.stack([prompts(cfg.vocab)[0]]))
        _, caches = transformer.prefill(local, view, {"tokens": toks},
                                        s_max=S_MAX)
        core = {"units": caches["units"], "tail": caches["tail"]}
        out["types"] = sorted({type(c).__name__ for c in
                               [*core["units"].values(), *core["tail"]]})
        out["shapes"] = {path: tuple(t.shape) for path, t in
                         _paths(core).items()}
        pooled = transformer.pool_layout(view, core)
    _, one = transformer.prefill(whole, cfg, {"tokens": toks}, s_max=S_MAX)
    run = slice(view.kv_offset, view.kv_offset + view.n_kv)
    want = _paths({"units": one["units"], "tail": one["tail"]})
    # the attention caches' leaves: K/V of the rank's run, ring positions
    out["pool_err"] = {
        path: float((got.float() - (want[path][..., run, :] if got.dim() >= 4
                                    else want[path]).float()).abs().max())
        for path, got in _paths(pooled).items()
        if path.rsplit("/", 1)[-1] in ("k", "v", "pos")}
    out["pool_types"] = sorted({type(c).__name__ for c in
                                [*pooled["units"].values(), *pooled["tail"]]})
    return out


def _paths(core) -> dict:
    from repro_torch.launch import sharding
    out = {}
    sharding.map_with_paths(lambda p, t: out.__setitem__(p, t), core)
    return out
