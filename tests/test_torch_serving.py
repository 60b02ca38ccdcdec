"""Port parity: the paged KV pool, the continuous-batching engine and the
partitioned LM.

The reference engine (``repro.serving.engine.ServingEngine``, continuous
mode) and the port's run the same requests on the same weights (the
reference's, carried across with ``params_from_reference``) in float32 on
``reduced(get_config("qwen3-0.6b"), n_layers=4)``.  Per-request greedy
tokens must be identical, and so must the engine's schedule: ticks, decode
dispatches, preemptions and every recorder event.  Pool commits are held
against the reference on the same pool state at 1e-5, the float32 rounding
of K/V computed through four layers (every block but the dummy block 0,
which both sides fill with garbage); the partitioned forward pass
at every unit cut against the monolithic one at 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.base import get_config as r_get_config
from repro.configs.base import load_all as r_load_all
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.serving import engine as r_engine
from repro.serving import kvpool as r_kvpool
from repro.serving import partitioned as r_part
from repro_torch.configs import base as p_base
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as p_tf
from repro_torch.serving import engine as p_engine
from repro_torch.serving import kvpool as p_kvpool
from repro_torch.serving import partitioned as p_part

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def model():
    r_cfg = r_reduced(r_get_config("qwen3-0.6b"), n_layers=4)
    p_cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), n_layers=4)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


class Recorder:
    """Duck-typed traffic recorder: keeps every lifecycle event."""

    def __init__(self):
        self.events = []

    def record_submit(self, rid, t, ue=None):
        self.events.append(("submit", rid, t))

    def record_admit(self, rid, t):
        self.events.append(("admit", rid, t))

    def record_prefill_done(self, rid, t):
        self.events.append(("prefill_done", rid, t))

    def record_preempt(self, rid, t):
        self.events.append(("preempt", rid, t))

    def record_complete(self, rid, t):
        self.events.append(("complete", rid, t))


# (engine kwargs, [(prompt length, max_new)])
ENGINE_CASES = {
    # prompts past the 32-token chunk stream in chunks; short ones pad
    "mixed_chunked": (dict(slots=2, s_max=64),
                      [(5, 4), (40, 5), (9, 3), (50, 4), (12, 6), (33, 2)]),
    # 9 allocatable blocks of 4: the first request's growth evicts the
    # second while its 21-token prompt is mid-stream
    "preempt_mid_stream": (dict(slots=2, s_max=64, kv_block=4, kv_blocks=10,
                                prefill_chunk=8),
                           [(10, 20), (21, 4)]),
    # 3 slots need ~9 blocks of 4; the pool has 6
    "preempt_small_pool": (dict(slots=3, s_max=32, kv_block=4, kv_blocks=7),
                           [(9, 8), (10, 8), (12, 8)]),
    # budgets exhausted at admission complete without a slot
    "max_new_le_1": (dict(slots=2, s_max=32),
                     [(7, 0), (11, 1), (6, 3), (20, 1), (3, 2)]),
}


def _run(module, cfg, params, kwargs, spec, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in spec]
    rec = Recorder()
    eng = module.ServingEngine(cfg, params, recorder=rec, **kwargs)
    reqs = [module.Request(rid=i, prompt=p, max_new=m)
            for i, (p, (_, m)) in enumerate(zip(prompts, spec))]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    return eng, reqs, done, rec


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference_engine(model, case):
    r_cfg, p_cfg, r_params, p_params = model
    kwargs, spec = ENGINE_CASES[case]
    r_eng, r_reqs, r_done, r_rec = _run(r_engine, r_cfg, r_params, kwargs,
                                        spec, 7)
    p_eng, p_reqs, p_done, p_rec = _run(p_engine, p_cfg, p_params, kwargs,
                                        spec, 7)
    assert [r.out for r in p_reqs] == [r.out for r in r_reqs]
    assert [r.rid for r in p_done] == [r.rid for r in r_done]
    assert p_rec.events == r_rec.events
    for attr in ("clock", "decode_steps", "preemptions", "prefill_chunk",
                 "table_width", "prefill_buckets"):
        assert getattr(p_eng, attr) == getattr(r_eng, attr), attr
    assert p_eng._prefill_shapes == r_eng._prefill_shapes
    assert p_eng.allocator.n_free == p_eng.allocator.capacity
    if case.startswith("preempt"):
        assert p_eng.preemptions > 0
    if case == "mixed_chunked":
        assert p_eng.prefill_steps > len(spec)      # some prompts streamed
    for r, (_, m) in zip(p_reqs, spec):
        assert len(r.out) == m and r.done


def test_engine_matches_solo_runs(model):
    """The port's own contract: a request's engine tokens are its solo
    prefill + decode_step tokens."""
    _, p_cfg, _, p_params = model
    kwargs, spec = ENGINE_CASES["mixed_chunked"]
    _, reqs, _, _ = _run(p_engine, p_cfg, p_params, kwargs, spec, 11)
    for r in reqs:
        logits, cache = p_tf.prefill(
            p_params, p_cfg, {"tokens": torch.from_numpy(r.prompt[None]).long()},
            s_max=64)
        out = [int(torch.argmax(logits[0]))]
        while len(out) < r.max_new:
            logits, cache = p_tf.decode_step(p_params, p_cfg, cache,
                                             torch.tensor([out[-1]]))
            out.append(int(torch.argmax(logits[0])))
        assert r.out == out[:r.max_new], f"prompt len {len(r.prompt)}"


def _pool_states(r_cfg, p_cfg, r_params, p_params, n_blocks, bs, seed):
    """The same random pool contents in both packages' decode states."""
    r_state = r_kvpool.init_decode_state(r_cfg, r_params, 2, n_blocks, bs)
    rng = np.random.default_rng(seed)
    k = rng.standard_normal(r_state["units"]["slot0"].k.shape).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    r_state = {"units": {"slot0": r_state["units"]["slot0"]._replace(
        k=jnp.asarray(k), v=jnp.asarray(v))}, "tail": []}
    p_state = p_kvpool.init_decode_state(p_cfg, p_params, 2, n_blocks, bs)
    p_state["units"]["slot0"].k.copy_(torch.from_numpy(k))
    p_state["units"]["slot0"].v.copy_(torch.from_numpy(v))
    return r_state, p_state


def _assert_pools_equal(p_state, r_state):
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            _np(getattr(p_state["units"]["slot0"], leaf))[:, 1:],
            _np(getattr(r_state["units"]["slot0"], leaf))[:, 1:],
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,width,blocks", [(5, 8, [3, 6]), (13, 16, [2, 9, 4]),
                                            (16, 16, [5, 7, 1, 8])])
def test_commit_prefill_matches_reference(model, n, width, blocks):
    """A left-padded solo prefill committed into the pool: the pad rolled
    out, the real tokens in the slot's blocks, the rest untouched."""
    r_cfg, p_cfg, r_params, p_params = model
    bs, s_max = 4, 24
    r_state, p_state = _pool_states(r_cfg, p_cfg, r_params, p_params, 12, bs, n)
    prompt = np.random.default_rng(n).integers(0, r_cfg.vocab, n)
    toks = np.pad(prompt, (width - n, 0))[None].astype(np.int32)
    pad = width - n
    ids = np.zeros(-(-width // bs), np.int32)
    owned = blocks[:-(-n // bs)]
    ids[:len(owned)] = owned
    _, r_solo = r_tf.prefill(r_params, r_cfg, {"tokens": jnp.asarray(toks)},
                             s_max=s_max, pad=jnp.asarray([pad], jnp.int32))
    _, p_solo = p_tf.prefill(p_params, p_cfg,
                             {"tokens": torch.from_numpy(toks).long()},
                             s_max=s_max, pad=torch.tensor([pad]))
    r_state = r_kvpool.commit_prefill(
        r_state, {"units": r_solo["units"], "tail": []}, jnp.int32(pad),
        jnp.int32(1), jnp.asarray(ids), block_size=bs)
    p_kvpool.commit_prefill(p_state, {"units": p_solo["units"], "tail": []},
                            pad, 1, torch.from_numpy(ids).long(),
                            block_size=bs)
    _assert_pools_equal(p_state, r_state)


@pytest.mark.parametrize("n,chunk", [(21, 8), (16, 8), (11, 4)])
def test_commit_chunk_matches_reference(model, n, chunk):
    """A chunk stream committed chunk by chunk into the slot's full table
    row: every block but the dummy one as the reference has it."""
    r_cfg, p_cfg, r_params, p_params = model
    bs, s_max, width = 4, 32, 8
    r_state, p_state = _pool_states(r_cfg, p_cfg, r_params, p_params, 12, bs,
                                    n + chunk)
    prompt = np.random.default_rng(n).integers(0, r_cfg.vocab, n).astype(np.int32)
    ids = np.zeros(width, np.int32)
    ids[:-(-n // bs)] = [9, 2, 7, 11, 3, 5][:-(-n // bs)]
    r_ids, p_ids = jnp.asarray(ids), torch.from_numpy(ids).long()
    _, r_c = r_tf.prefill(r_params, r_cfg,
                          {"tokens": jnp.asarray(prompt[None, :chunk])},
                          s_max=s_max)
    _, p_c = p_tf.prefill(p_params, p_cfg,
                          {"tokens": torch.from_numpy(prompt[None, :chunk]).long()},
                          s_max=s_max)
    r_c = {"units": r_c["units"], "tail": []}
    p_c = {"units": p_c["units"], "tail": []}
    r_state = r_kvpool.commit_chunk(r_state, r_c, jnp.int32(0),
                                    jnp.int32(chunk), jnp.int32(1), r_ids,
                                    block_size=bs)
    p_kvpool.commit_chunk(p_state, p_c, 0, chunk, 1, p_ids, block_size=bs)
    _assert_pools_equal(p_state, r_state)
    for start in range(chunk, n, chunk):
        n_valid = min(chunk, n - start)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :n_valid] = prompt[start:start + n_valid]
        _, r_c = r_tf.prefill_chunk(r_params, r_cfg, r_c, jnp.asarray(toks),
                                    jnp.int32(start), jnp.int32(n_valid))
        _, p_c = p_tf.prefill_chunk(p_params, p_cfg, p_c,
                                    torch.from_numpy(toks).long(), start,
                                    n_valid)
        r_state = r_kvpool.commit_chunk(r_state, r_c, jnp.int32(start),
                                        jnp.int32(n_valid), jnp.int32(1),
                                        r_ids, block_size=bs)
        p_kvpool.commit_chunk(p_state, p_c, start, n_valid, 1, p_ids,
                              block_size=bs)
        _assert_pools_equal(p_state, r_state)


def test_paged_decode_idle_rows_write_only_the_dummy_block(model):
    """Idle rows (seq_len 0, zero table row) write into block 0 and nowhere
    else; a live row writes exactly one entry of its own block."""
    _, p_cfg, _, p_params = model
    state = p_kvpool.init_decode_state(p_cfg, p_params, 3, 9, 4)
    pool = state["units"]["slot0"]
    pool.k.normal_(generator=torch.Generator().manual_seed(0))
    before = pool.k.clone()
    table = torch.tensor([[0, 0], [5, 2], [0, 0]])
    seq_lens = torch.tensor([0, 6, 0])
    p_tf.decode_step_paged(p_params, p_cfg, state, torch.tensor([1, 2, 3]),
                           table, seq_lens)
    changed = (pool.k != before).flatten(3).any(-1)        # (U, blocks, offs)
    want = torch.zeros_like(changed)
    want[:, 0, 0] = True                                   # dummy block 0
    want[:, 2, 2] = True                                   # row 1: block 2, offset 2
    assert torch.equal(changed, want)


def test_partitioned_every_cut_matches_forward_train(model):
    r_cfg, p_cfg, r_params, p_params = model
    toks = np.random.default_rng(3).integers(0, r_cfg.vocab, (2, 10))
    want, _ = p_tf.forward_train(p_params, p_cfg,
                                 {"tokens": torch.from_numpy(toks).long()})
    r_want, _ = r_tf.forward_train(r_params, r_cfg,
                                   {"tokens": jnp.asarray(toks, jnp.int32)})
    for cut in range(p_cfg.n_units + 1):
        plm = p_part.PartitionedLM(p_cfg, p_params, cut)
        logits, boundary = plm.infer(torch.from_numpy(toks).long())
        np.testing.assert_allclose(_np(logits), _np(want), **LOGIT_TOL)
        np.testing.assert_allclose(_np(logits), _np(r_want), **LOGIT_TOL)
        r_plm = r_part.PartitionedLM(r_cfg, r_params, cut)
        _, r_boundary = r_plm.infer(jnp.asarray(toks, jnp.int32))
        assert tuple(boundary.shape) == tuple(r_boundary.shape)
        if cut:
            np.testing.assert_allclose(_np(boundary), _np(r_boundary),
                                       rtol=1e-5, atol=1e-5)
        for b, s in ((1, 7), (2, 10)):
            assert plm.boundary_bytes(b, s) == r_plm.boundary_bytes(b, s)


def test_split_params_and_layer_cut_mapping_match_reference(model):
    r_cfg, p_cfg, r_params, p_params = model
    for cut in (0, 1, 3, 4):
        r_ue, r_es = r_part.split_params(r_params, cut)
        p_ue, p_es = p_part.split_params(p_params, cut)
        assert sorted(p_ue) == sorted(r_ue) and sorted(p_es) == sorted(r_es)
        for p_half, r_half in ((p_ue, r_ue), (p_es, r_es)):
            for path, leaf in jax.tree_util.tree_leaves_with_path(r_half):
                node = p_half
                for key in path:
                    node = node[key.key]
                np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    for name, r_cfg_full in r_load_all().items():
        p_cfg_full = p_base.get_config(name)
        for layer_cut in range(r_cfg_full.n_layers + 4):
            assert p_part.layer_cut_to_unit(p_cfg_full, layer_cut) == \
                r_part.layer_cut_to_unit(r_cfg_full, layer_cut), (name, layer_cut)


def test_es_engine_full_offload_only(model):
    r_cfg, p_cfg, r_params, p_params = model
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, p_cfg.vocab, 9).astype(np.int32)
    eng = p_part.PartitionedLM(p_cfg, p_params, 0).es_engine(slots=1, s_max=64)
    req = p_engine.Request(rid=0, prompt=prompt, max_new=4)
    eng.submit(req)
    eng.run_until_idle()
    r_eng = r_part.PartitionedLM(r_cfg, r_params, 0).es_engine(slots=1,
                                                               s_max=64)
    r_req = r_engine.Request(rid=0, prompt=prompt, max_new=4)
    r_eng.submit(r_req)
    r_eng.run_until_idle()
    assert req.out == r_req.out
    with pytest.raises(ValueError, match="full-offload"):
        p_part.PartitionedLM(p_cfg, p_params, 2).es_engine(slots=1, s_max=64)
    mesh = make_host_mesh()               # 1 x 1: the same tokens
    try:
        eng = p_part.PartitionedLM(p_cfg, p_params, 0, mesh=mesh).es_engine(
            slots=1, s_max=64)
        assert eng.mesh is mesh
        req = p_engine.Request(rid=0, prompt=prompt, max_new=4)
        eng.submit(req)
        eng.run_until_idle()
    finally:
        dist.destroy_process_group()
    assert req.out == r_req.out


@pytest.mark.parametrize("option", [dict(sync_batching=True),
                                    dict(mesh=object()),
                                    dict(telemetry=object()),
                                    dict(sanitize=True)])
def test_unported_engine_options_raise(model, option):
    """Every engine option is ported now and builds: the sync mode,
    telemetry, the sanitizer and ``mesh=`` (here the 1 x 1 host mesh)."""
    _, p_cfg, _, p_params = model
    name = next(iter(option))
    if name == "mesh":
        mesh = make_host_mesh()
        try:
            eng = p_engine.ServingEngine(p_cfg, p_params, slots=1, s_max=32,
                                         mesh=mesh)
        finally:
            dist.destroy_process_group()
        assert eng.mesh is mesh and eng.cfg.model_size == 1
        return
    if name == "telemetry":
        from repro_torch.obs import Telemetry
        option = dict(telemetry=Telemetry())
    eng = p_engine.ServingEngine(p_cfg, p_params, slots=1, s_max=32, **option)
    assert (eng.sync_batching, eng.obs is not None, eng.sanitize) == (
        name == "sync_batching", name == "telemetry", name == "sanitize")


def test_engine_admission_rules_match_reference(model):
    r_cfg, p_cfg, r_params, p_params = model
    for s_max in (8, 30, 64, 512):
        assert p_engine._bucket_ladder(s_max) == r_engine._bucket_ladder(s_max)
    r_eng = r_engine.ServingEngine(r_cfg, r_params, slots=2, s_max=32)
    p_eng = p_engine.ServingEngine(p_cfg, p_params, slots=2, s_max=32)
    for width in range(1, 33):
        for max_new in (1, 4, 17, 32):
            try:
                want = r_eng._bucket_width(width, max_new)
            except ValueError:
                with pytest.raises(ValueError):
                    p_eng._bucket_width(width, max_new)
                continue
            assert p_eng._bucket_width(width, max_new) == want
    with pytest.raises(ValueError, match="exceeds s_max"):
        p_eng.submit(p_engine.Request(rid=0, prompt=np.zeros(30, np.int32),
                                      max_new=8))
    with pytest.raises(ValueError, match="ue must be >= 0"):
        p_eng.submit(p_engine.Request(rid=1, prompt=np.zeros(4, np.int32),
                                      ue=-1))
    assert not p_eng.queue
    for bad in (0, 33):
        with pytest.raises(ValueError, match="prefill_chunk"):
            p_engine.ServingEngine(p_cfg, p_params, slots=1, s_max=32,
                                   prefill_chunk=bad)
    tiny = p_engine.ServingEngine(p_cfg, p_params, slots=1, s_max=32,
                                  kv_block=4, kv_blocks=3)
    tiny.submit(p_engine.Request(rid=2, prompt=np.zeros(10, np.int32),
                                 max_new=4))
    with pytest.raises(ValueError, match="KV blocks"):
        tiny.step()
    with pytest.raises(RuntimeError, match="did not drain"):
        eng = p_engine.ServingEngine(p_cfg, p_params, slots=1, s_max=32)
        eng.submit(p_engine.Request(rid=3, prompt=np.zeros(4, np.int32),
                                    max_new=8))
        eng.run_until_idle(max_steps=2)


def test_block_allocator_and_pool_stats_match_reference():
    for module in (r_kvpool, p_kvpool):
        with pytest.raises(ValueError):
            module.BlockAllocator(1, 4)
    r_a, p_a = r_kvpool.BlockAllocator(9, 4), p_kvpool.BlockAllocator(9, 4)
    for n in (3, 0, 4, 2):
        assert p_a.alloc(n) == r_a.alloc(n)
    p_a.free([2, 5])
    r_a.free([2, 5])
    assert p_a.handed_out() == r_a.handed_out() and p_a.n_free == r_a.n_free
    for bad in ([2], [0], [9], [1, 1], [6, 5]):
        with pytest.raises(ValueError):
            p_a.free(bad)
        assert p_a.handed_out() == r_a.handed_out()        # left unchanged
    held = min(p_a.handed_out())
    p_a._free.appendleft(held)                     # corrupt the free list
    r_a._free.appendleft(held)
    with pytest.raises(ValueError, match="corrupted"):
        p_a.alloc(3)
    assert list(p_a._free) == list(r_a._free)
    owned = [[1, 3], [], [4]]
    seq = np.array([6, 0, 2])
    assert p_kvpool.pool_stats(p_a, seq, owned) == r_kvpool.pool_stats(
        r_a, seq, owned)
    for t in (0, 1, 4, 5, 17):
        assert p_kvpool.blocks_for(t, 4) == r_kvpool.blocks_for(t, 4)
