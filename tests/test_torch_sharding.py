"""The port's sharding policy, rank-local layout, mesh constructors and
``shardctx``, in this process.

Policy: ``launch.sharding``'s ``param_spec``, ``cache_spec``,
``batch_spec``, ``validate_spec`` and ``recommended_options``, and
``serving.kvpool.decode_state_specs``, held entry for entry against the
reference's on its ``analysis.contracts.ShapeOnlyMesh``: every leaf of
every registered architecture (the port's trees built on the meta device),
on ``(16, 16)`` ``("data", "model")``, ``(2, 16, 16)`` with "pod", and
``("cells", "model")`` at M = 1, 2 and 4.

Layout: one rank's view of an M-rank mesh (``FakeMesh``) is enough for
``place_params`` and ``place_decode_state``; the shards of every rank put
back together give the whole leaf, and each rank's pool is the one its
``RankConfig`` builds.  The collectives need a world:
tests/test_torch_model_axis*.py.  ``model=1`` is bitwise: the engine and
``PartitionedLM`` on a 1 x 1 host mesh equal them without a mesh, bit for
bit.
"""
import contextlib
import dataclasses
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _model_axis as ma
from repro.analysis.contracts import ShapeOnlyMesh, _params_struct
from repro.configs.base import load_all as r_load_all
from repro.launch import sharding as r_sh
from repro.serving import kvpool as r_kvpool
from repro_torch import shardctx
from repro_torch.configs import base as p_base
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import serve as p_serve
from repro_torch.launch import sharding as p_sh
from repro_torch.launch import train as p_train
from repro_torch.models import common, transformer
from repro_torch.serving import engine as p_engine
from repro_torch.serving import kvpool
from repro_torch.serving.partitioned import PartitionedLM

ARCHS = sorted(p_base.load_all())
MESHES = {
    "data16-model16": dict(data=16, model=16),
    "pod2-data16-model16": dict(pod=2, data=16, model=16),
    "cells4-model1": dict(cells=4, model=1),
    "cells2-model2": dict(cells=2, model=2),
    "cells1-model4": dict(cells=1, model=4),
}


class FakeMesh:
    """Rank ``rank`` of a mesh of ``axes`` (name -> size), as
    ``place_params`` reads a ``DeviceMesh``: its dim names and shape, and
    the rank's index on each axis (``rank`` on "model", 0 elsewhere)."""

    def __init__(self, rank: int = 0, **axes):
        self.mesh_dim_names = tuple(axes)
        self.mesh = torch.zeros(tuple(axes.values()))
        self._rank = rank

    def get_local_rank(self, name) -> int:
        return self._rank if name == "model" else 0


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture
def one_rank(tmp_path):
    pmesh.init_group("gloo", "cpu", rank=0, world_size=1,
                     init_method=f"file://{tmp_path}/store")
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the policy, against the reference's
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_draws():
    """Initialisers that draw nothing: every drawn leaf an empty tensor of
    its shape and dtype (the meta device's, where ``init_params`` is
    asked for it)."""
    empty = lambda gen, shape, dtype, *a, device=None, **k: torch.empty(
        shape, dtype=dtype, device=device)
    mods = ("attention", "ffn", "rglru", "ssm", "transformer")
    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(mock.patch(
                f"repro_torch.models.{m}.dense_init", empty))
        stack.enter_context(mock.patch(
            "repro_torch.models.transformer.embed_init", empty))
        yield


_trees: dict = {}


def port_leaves(name: str) -> dict:
    """{path: shape} of the port's parameters of ``name`` at full size
    (built on the meta device)."""
    if name not in _trees:
        cfg = p_base.get_config(name)
        with no_draws():
            params = transformer.init_params(torch.Generator(), cfg, "meta")
        out = {}
        p_sh.map_with_paths(lambda path, t: out.__setitem__(
            path, tuple(t.shape)), params)
        _trees[name] = out
    return _trees[name]


def ref_leaves(name: str) -> dict:
    tree = _params_struct(r_load_all()[name])
    return {r_sh._path_str(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def options(cfg) -> list:
    """BASELINE, the recommended options of each shape kind, and the two
    expert layouts."""
    return [p_sh.BASELINE,
            *(p_sh.recommended_options(cfg, k)
              for k in ("train", "prefill", "decode")),
            p_sh.ShardingOptions(expert_mesh="data"),
            p_sh.ShardingOptions(tp_mode="moe-only", expert_shard_dff=True)]


def same(port_spec, ref_spec) -> bool:
    return tuple(port_spec) == tuple(ref_spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_are_the_reference_trees(arch):
    assert port_leaves(arch) == ref_leaves(arch)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh_name):
    mesh = ShapeOnlyMesh(**MESHES[mesh_name])
    p_cfg, r_cfg = p_base.get_config(arch), r_load_all()[arch]
    leaves = port_leaves(arch)
    for opts in options(p_cfg):
        r_opts = r_sh.ShardingOptions(**dataclasses.asdict(opts))
        for path, shape in leaves.items():
            got = p_sh.param_spec(mesh, p_cfg, path, shape, opts)
            want = r_sh.param_spec(mesh, r_cfg, path, shape, r_opts)
            assert isinstance(got, p_sh.P)
            assert same(got, want), (path, opts, got, want)
            assert p_sh.validate_spec(mesh, shape, got) == \
                r_sh.validate_spec(mesh, shape, want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_recommended_options_equal_the_reference(arch):
    p_cfg, r_cfg = p_base.get_config(arch), r_load_all()[arch]
    for kind in ("train", "prefill", "decode"):
        assert dataclasses.asdict(p_sh.recommended_options(p_cfg, kind)) == \
            dataclasses.asdict(r_sh.recommended_options(r_cfg, kind)), kind


def _cache_leaves(cfg, batch: int) -> dict:
    ctx = 8 if (cfg.frontend or cfg.enc_layers) else 0
    caches = transformer._init_caches(cfg, batch, 32, "meta", ctx)
    out = {}
    p_sh.map_with_paths(lambda path, t: out.__setitem__(
        path, tuple(t.shape)), caches)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    """Every serving-cache leaf at a batch that divides the DP axes and one
    that does not; the reference reads the same shapes through its own
    paths (``DictKey`` per part)."""
    mesh = ShapeOnlyMesh(**MESHES[mesh_name])
    cfg = p_base.get_config(arch)
    for batch in (1, 32):
        for path, shape in _cache_leaves(cfg, batch).items():
            leaf = jax.ShapeDtypeStruct(shape, np.float32)
            r_path = tuple(jax.tree_util.DictKey(p) for p in path.split("/"))
            got = p_sh.cache_spec(mesh, path, np.empty(shape), batch)
            want = r_sh.cache_spec(mesh, r_path, leaf, batch)
            assert same(got, want), (path, batch, got, want)
            assert p_sh.validate_spec(mesh, shape, got) == \
                r_sh.validate_spec(mesh, shape, want)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh_name):
    mesh = ShapeOnlyMesh(**MESHES[mesh_name])
    for shape in [(), (1, 8), (16, 8), (32, 8, 4), (48,), (512, 3)]:
        for shard_batch in (True, False):
            got = p_sh.batch_spec(mesh, np.empty(shape),
                                  shard_batch=shard_batch)
            want = r_sh.batch_spec(mesh, jax.ShapeDtypeStruct(
                shape, np.int32), shard_batch=shard_batch)
            assert same(got, want), (shape, shard_batch)


def test_validate_spec_refusals_equal_the_reference():
    mesh = ShapeOnlyMesh(pod=2, data=16, model=16)
    cases = [((32, 64), ("data", "model")), ((32, 64), ("nope", None)),
             ((32, 64), ("model", "model")), ((30, 64), (("pod", "data"),)),
             ((32,), ("data", None)), ((8, 48), (None, "model")),
             ((64, 64), (("data", "model"), "pod")), ((4,), ())]
    for shape, entries in cases:
        got = p_sh.validate_spec(mesh, shape, p_sh.P(*entries))
        want = r_sh.validate_spec(mesh, shape,
                                  jax.sharding.PartitionSpec(*entries))
        assert got == want, (shape, entries)
    assert p_sh.validate_spec(mesh, (30, 64), p_sh.P(("pod", "data")))


SERVED = [a for a in ARCHS if not set("xde") & (
    set(p_base.get_config(a).block_pattern)
    | set(p_base.get_config(a).tail_pattern))
    and not p_base.get_config(a).enc_layers]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVED)
def test_decode_state_specs_equal_the_reference(arch, mesh_name):
    mesh = ShapeOnlyMesh(**MESHES[mesh_name])
    p_cfg, r_cfg = p_base.get_config(arch), r_load_all()[arch]
    meta = {"embed": torch.empty(0, device="meta")}
    got = kvpool.decode_state_specs(
        mesh, kvpool.init_decode_state(p_cfg, meta, 2, 9, 16))
    r_state = jax.eval_shape(lambda p: r_kvpool.init_decode_state(
        r_cfg, p, 2, 9, 16), _params_struct(r_cfg))
    want = r_kvpool.decode_state_specs(mesh, r_state)
    assert {p: (s, tuple(spec)) for p, s, spec in got} == \
        {p: (s, tuple(spec)) for p, s, spec in want}


# ---------------------------------------------------------------------------
# the rank-local layout
# ---------------------------------------------------------------------------

LAYOUTS = [(name, m) for name in sorted(ma.STACKS) for m in (2, 4)]


@pytest.mark.parametrize("name,m", LAYOUTS)
def test_rank_shards_put_together_give_each_leaf(name, m):
    """Every leaf a rank holds is the whole leaf or one of M equal parts
    of it along one dim, in rank order; the SSD's in_proj and conv keep
    their heads' columns of z, x (and dt) and all of B and C; where the kv
    heads do not divide M, ``wk``/``wv`` keep the columns of the kv heads
    the rank's query heads read.  The view's local counts are the shards'
    widths."""
    cfg = ma.port_cfg(name)
    params = transformer.init_params(0, cfg, "cpu")
    shards = [p_sh.place_params(FakeMesh(r, cells=1, model=m), cfg, params)
              for r in range(m)]
    views = [v for _, v in shards]
    full = {}
    p_sh.map_with_paths(lambda path, t: full.__setitem__(path, t), params)
    parts = {path: [] for path in full}
    for local, _ in shards:
        p_sh.map_with_paths(lambda path, t: parts[path].append(t), local)
    for path, whole in full.items():
        got = parts[path]
        if all(g is whole for g in got):
            continue
        if cfg.n_kv % m and path.endswith(("attn/wk", "attn/wv")):
            hd = cfg.resolved_head_dim
            for v, g in zip(views, got):
                need = {(v.model_rank * v.n_heads + j)
                        // (cfg.n_heads // cfg.n_kv) for j in range(v.n_heads)}
                assert need == set(range(v.kv_offset, v.kv_offset + v.n_kv))
                assert torch.equal(g, whole[..., v.kv_offset * hd:
                                            (v.kv_offset + v.n_kv) * hd])
            continue
        if path.endswith(("ssm/in_proj", "ssm/conv")):
            cols = [p_sh._ssm_columns(cfg, r, m, path.endswith("conv"))
                    for r in range(m)]
            for r, g in enumerate(got):
                assert torch.equal(g, whole[..., cols[r]])
            assert set().union(*map(set, cols)) == set(range(whole.shape[-1]))
            continue
        dims = [d for d in range(-whole.dim(), 0)
                if got[0].shape[d] * m == whole.shape[d]]
        assert len(dims) == 1, path
        assert torch.equal(torch.cat(got, dims[0]), whole), path
    for r, v in enumerate(views):
        assert v.model_rank == r and v.model_size == m
    v = views[0]
    if "attn" in v.split:
        assert v.n_heads == cfg.n_heads // m
        if cfg.n_kv % m == 0:
            assert v.n_kv == cfg.n_kv // m
        else:
            assert v.n_kv <= -(-v.n_heads // (cfg.n_heads // cfg.n_kv)) + 1
    if "vocab" in v.split:
        assert v.local_vocab * m == cfg.vocab == v.vocab


@pytest.mark.parametrize("name,m", LAYOUTS)
def test_place_decode_state_is_the_rank_pool(name, m):
    """Cutting the whole decode state by the layout gives each rank the
    pool its ``RankConfig`` builds (kv heads split where they divide M,
    the ones its query heads read where they do not)."""
    cfg = ma.port_cfg(name)
    params = transformer.init_params(0, cfg, "cpu")
    whole = kvpool.init_decode_state(cfg, params, 3, 9, 4)
    for r in range(m):
        mesh = FakeMesh(r, cells=1, model=m)
        local, view = p_sh.place_params(mesh, cfg, params)
        mine = kvpool.init_decode_state(view, local, 3, 9, 4)
        cut = kvpool.place_decode_state(mesh, whole, cfg)
        assert [x.shape for x in _leaves(cut)] == \
            [x.shape for x in _leaves(mine)]


def test_shardings_keep_each_ranks_block_by_their_spec():
    """``cache_shardings``, ``batch_shardings`` and ``replicated`` carry the
    policy's specs, and ``local`` cuts a leaf to this rank's block: a
    rank of a 2-way model axis keeps its half of the kv heads."""
    cfg = ma.port_cfg("qwen3")
    caches = transformer._init_caches(cfg, 2, 16, "cpu")
    caches["units"]["slot0"].k.normal_()
    for r in range(2):
        mesh = FakeMesh(r, cells=1, model=2)
        sh = p_sh.cache_shardings(mesh, cfg, caches, 2)
        k, sk = caches["units"]["slot0"].k, sh["units"]["slot0"].k
        assert tuple(sk.spec) == (None, None, None, "model", None)
        kv = cfg.n_kv // 2
        assert torch.equal(sk.local(k), k[..., r * kv:(r + 1) * kv, :])
        tok = torch.arange(8).reshape(2, 4)
        # no DP axis on a ("cells", "model") mesh: the batch stays whole
        assert p_sh.batch_shardings(mesh, cfg, {"t": tok})["t"].spec == \
            p_sh.P(None, None)
        assert torch.equal(p_sh.replicated(mesh, [tok])[0].local(tok), tok)


def test_place_params_passes_placed_params_through():
    cfg = ma.port_cfg("qwen3")
    params = transformer.init_params(0, cfg, "cpu")
    mesh = FakeMesh(1, cells=1, model=2)
    local, view = p_sh.place_params(mesh, cfg, params)
    again, view2 = p_sh.place_params(mesh, view, local)
    assert again is local and view2 is view
    with pytest.raises(ValueError, match="model axis"):
        p_sh.place_params(FakeMesh(0, cells=1, model=4), view, local)
    one, view1 = p_sh.place_params(FakeMesh(0, cells=2, model=1), cfg, params)
    assert view1.split == () and all(
        a is b for a, b in zip(_leaves(one), _leaves(params)))


def _leaves(tree):
    from repro_torch import _tree
    return _tree.leaves(tree)


@pytest.mark.parametrize("h,kv,m", [
    (10, 1, 2),            # recurrentgemma: one kv head under 5 a rank
    (4, 2, 4),             # hybrid-grs: a kv head on two ranks
    (6, 3, 2),             # uneven groups: kv heads (0, 0, 1), (1, 2, 2)
    (12, 3, 2),            # uneven groups of 4: (0,0,0,0,1,1), (1,1,2,...)
    (64, 8, 16),           # qwen1.5-110b on the production model axis
    (16, 8, 2),            # kv heads that divide the axis
])
def test_kv_for_q_gives_each_query_head_its_kv_head(h, kv, m):
    """Each rank holds the kv heads its query heads read and no other;
    under GQA's mapping (local query head j of H reads kv head
    j // (H / KV)) the kv heads ``_kv_for_q`` returns give each local
    query head the kv head of its global group.  Where the groups are even
    it returns the rank's own k and v, with no copy."""
    from repro_torch.models import attention
    cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), n_heads=h,
                         n_kv=kv)
    k = torch.randn(2, 5, kv, 4)
    v = torch.randn(2, 5, kv, 4)
    group = h // kv
    for r in range(m):
        view = p_sh.rank_config(FakeMesh(r, cells=1, model=m), cfg)
        mine = range(r * (h // m), (r + 1) * (h // m))
        need = sorted({q // group for q in mine})
        assert list(range(view.kv_offset, view.kv_offset + view.n_kv)) \
            == need
        kl = p_sh._kv_heads(view, k, -2)
        vl = p_sh._kv_heads(view, v, -2)
        ks, vs = attention._kv_for_q(view, kl, vl)
        if not view.q_kv:
            assert ks is kl and vs is vl
        per = view.n_heads // ks.shape[-2]
        assert per * ks.shape[-2] == view.n_heads
        for j, q in enumerate(mine):
            assert torch.equal(ks[..., j // per, :], k[..., q // group, :])
            assert torch.equal(vs[..., j // per, :], v[..., q // group, :])
        if (h, kv, m) == (64, 8, 16):
            assert view.n_kv == 1 and not view.q_kv


def test_sharded_layers_need_their_group():
    """A rank's shard run outside any mesh context raises at the first
    collective instead of computing partial sums."""
    cfg = ma.port_cfg("qwen3")
    params = transformer.init_params(0, cfg, "cpu")
    local, view = p_sh.place_params(FakeMesh(0, cells=1, model=2), cfg,
                                    params)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="sub-group"):
        transformer.prefill(local, view, {"tokens": toks}, s_max=8)


def test_activation_sharding_records_the_axes():
    """The context holds the "model" axis's size (what the SSD's split
    norm divides by) and restores the one around it on exit."""
    assert shardctx.model_size() == 1
    with shardctx.activation_sharding(ShapeOnlyMesh(pod=2, data=16,
                                                    model=16)):
        assert shardctx.model_size() == 16
        with shardctx.mesh_context(ShapeOnlyMesh(cells=2, model=1)):
            assert shardctx.model_size() == 1
        with shardctx.mesh_context(None):
            assert shardctx.model_size() == 16
        assert shardctx.model_size() == 16
    assert not shardctx._CTX["active"] and shardctx.model_size() == 1


@pytest.mark.parametrize("name,m", [("qwen3", 2), ("hybrid-grs", 4),
                                    ("moonshot", 2)])
def test_init_rank_params_is_the_rank_shard_of_the_whole_init(name, m):
    """``init_rank_params`` draws on the host what ``init_params`` draws,
    one layer at a time, and keeps each leaf's shard: it equals
    ``place_params`` of the whole tree, and the host cuts the units' leaves
    one layer at a time, never a whole stack."""
    cfg = ma.port_cfg(name)
    whole = transformer.init_params(3, cfg, "cpu")
    stacked = {}
    p_sh.map_with_paths(lambda path, t: stacked.__setitem__(
        path, tuple(t.shape)), whole["units"])
    cut = p_sh._local_leaf
    for r in range(m):
        mesh = FakeMesh(r, cells=1, model=m)
        want, view = p_sh.place_params(mesh, cfg, whole)
        seen = []
        with mock.patch.object(p_sh, "_local_leaf", side_effect=lambda lay,
                               path, t: seen.append((path, t.shape))
                               or cut(lay, path, t)):
            got, got_view = p_sh.init_rank_params(3, mesh, cfg, "cpu")
        units = [(p, s) for p, s in seen if p.startswith("units/")]
        assert len(units) == cfg.n_units * len(stacked)
        assert all(tuple(s) == stacked[p[len("units/"):]][1:]
                   for p, s in units)
        assert got_view == view
        a, b = _leaves(got), _leaves(want)
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))


def test_split_rms_norm_without_a_split_is_the_norm():
    x = torch.randn(3, 8)
    scale = torch.randn(8)
    assert torch.equal(common.rms_norm(x, scale), common.rms_norm(
        x, scale, split=False))


# ---------------------------------------------------------------------------
# model = 1 is bitwise; the meshes and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3", "hybrid-grs"])
def test_model_one_is_bitwise(name):
    """On a 1 x 1 host mesh no contraction is split: the engine's tokens
    and ``PartitionedLM``'s logits equal the unmeshed ones bit for bit."""
    cfg = ma.port_cfg(name)
    params = transformer.init_params(0, cfg, "cpu")
    toks = torch.as_tensor(ma.plm_tokens(cfg), dtype=torch.int64)
    want = [PartitionedLM(cfg, params, cut).infer(toks)[0]
            for cut in ma.PLM_CUTS]
    want_eng = ma.run_engine(p_engine, cfg, params, "chunked")
    mesh = pmesh.make_host_mesh()
    try:
        assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == \
            {"data": 1, "model": 1}
        for cut, w in zip(ma.PLM_CUTS, want):
            assert torch.equal(PartitionedLM(cfg, params, cut, mesh=mesh)
                               .infer(toks)[0], w)
        assert ma.run_engine(p_engine, cfg, params, "chunked", mesh) \
            == want_eng
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("meshed", [False, True])
def test_serving_objects_free_without_the_cycle_collector(meshed):
    """A ``PartitionedLM`` and its ES engine hold no reference cycle, so
    their weights go with their last reference: the smoke's phase 11
    builds a 56 GB model again right after dropping one."""
    import gc
    import weakref
    cfg = ma.port_cfg("qwen3")
    params = transformer.init_params(0, cfg, "cpu")
    mesh = pmesh.make_host_mesh() if meshed else None
    gc.disable()
    try:
        plm = PartitionedLM(cfg, params, 0, mesh=mesh)
        eng = plm.es_engine(slots=1, s_max=16)
        refs = [weakref.ref(plm), weakref.ref(eng)]
        del plm, eng
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
        if meshed:
            dist.destroy_process_group()


def test_production_mesh_refuses_other_worlds(one_rank):
    for multi_pod, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {need} ranks"):
            pmesh.make_production_mesh(multi_pod=multi_pod)


def test_production_mesh_refuses_without_a_group():
    with pytest.raises(ValueError, match="none is initialized"):
        pmesh.make_production_mesh(multi_pod=True)


def test_host_and_elastic_meshes(one_rank):
    host = pmesh.make_host_mesh()            # reuses the one-rank group
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.mesh.shape) == (1, 1)
    el = pmesh.elastic_mesh(16)
    assert el.mesh_dim_names == ("data", "model")
    assert tuple(el.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="target_model"):
        pmesh.elastic_mesh(0)


def test_elastic_mesh_refuses_without_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.elastic_mesh()


def test_multi_pod_launchers_refuse_a_small_world(tmp_path):
    with pytest.raises(ValueError, match="needs 512 ranks"):
        p_serve.main(["--arch", "qwen3-0.6b", "--multi-pod",
                      "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 512 ranks"):
        p_train.main(["--arch", "qwen3-0.6b", "--multi-pod",
                      "--device", "cpu", "--steps", "1"])


def test_serve_smoke_runs_on_the_host_mesh():
    """``--smoke`` serves under the host mesh (a one-rank group it joins
    and leaves) with the tokens of the engine without one."""
    rep = p_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "9",
                        "--max-new", "3"])
    cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"))
    params = transformer.init_params(p_serve.SEED, cfg, "cpu")
    eng = p_serve.make_engine(cfg, params, slots=2, prompt_len=9, max_new=3)
    rng = np.random.default_rng(p_serve.SEED)
    reqs = [p_engine.Request(rid=i, prompt=rng.integers(0, cfg.vocab, 9)
                             .astype(np.int32), max_new=3) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_idle()
    assert rep["out"] == {r.rid: r.out for r in reqs}
