"""The rank-local layout under ``ShardingOptions`` against the reference's
policy, in this process (no world).

* **Storage shapes.**  For every registered architecture, on shape-only
  (2, 2), (16, 16) and (2, 16, 16) meshes, under BASELINE, "vocab-only",
  "moe-only", ``fsdp_override`` True and False, ``expert_shard_dff``
  (under "full" and "moe-only") and ``expert_mesh="data"``, the shape a rank
  stores of each leaf (``place_params`` of the full-size tree on the meta
  device, through a stand-in mesh that answers as rank 0) equals the
  reference policy's per-device shape (``repro.launch.sharding.
  param_spec`` over its ``analysis.contracts.ShapeOnlyMesh``: each dim over
  the product of its axes), except for the departures the layout
  documents (``launch/sharding.py``'s docstring), listed here by name.
* **Splits.**  ``RankConfig.split`` is as ``tp_mode`` says.
* **The knobs of ROADMAP queue 1, item 7c, part 4** are taken:
  ``seq_shard`` (on "model" axes of 2, 4 and 16 it moves no weight, and
  marks the full-sequence calls whose length the axis divides) and the
  MoE knobs.
"""
import dataclasses

import pytest

from repro.analysis.contracts import ShapeOnlyMesh
from repro.launch import sharding as r_sh
from repro_torch import _tree, shardctx
from repro_torch.configs import base as p_base
from repro_torch.launch import dryrun, specs
from repro_torch.launch import sharding as p_sh

ARCHS = sorted(p_base.load_all())
MESHES = {"2x2": dict(data=2, model=2), "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}
OPTIONS = {
    "baseline": p_sh.BASELINE,
    "vocab-only": p_sh.ShardingOptions(tp_mode="vocab-only"),
    "moe-only": p_sh.ShardingOptions(tp_mode="moe-only"),
    "fsdp": p_sh.ShardingOptions(fsdp_override=True),
    "no-fsdp": p_sh.ShardingOptions(fsdp_override=False),
    "expert-dff": p_sh.ShardingOptions(expert_shard_dff=True),
    "moe-only-dff": p_sh.ShardingOptions(tp_mode="moe-only",
                                         expert_shard_dff=True),
    "expert-data": p_sh.ShardingOptions(expert_mesh="data"),
}


def _rank0(axes: dict):
    return dryrun._RankMesh(tuple(axes), tuple(axes.values()), {})


def _ref_shape(axes, cfg, path, shape, opts):
    mesh = ShapeOnlyMesh(**axes)
    spec = r_sh.param_spec(mesh, cfg, path, shape, r_sh.ShardingOptions(
        **dataclasses.asdict(opts)))
    out = list(shape)
    for dim, entry in enumerate(tuple(spec)):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in names:
            out[dim] //= axes[a]
    return tuple(out)


def _departure(cfg, view, path, opts) -> str | None:
    """The documented departure that explains a leaf's shape, or None."""
    parts = path.split("/")
    name, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if parent == "ssm" and name in ("in_proj", "conv", "gate_norm") \
            and "ssm" in view.split:
        return "the SSD's fused columns by head"
    if parent in ("attn", "xattn") and name in ("wk", "wv", "bk", "bv") \
            and "attn" in view.split and cfg.n_kv % view.model_size:
        return "the kv heads a rank's query heads read"
    if parent == "moe" and name in ("wi", "wg", "wo") \
            and "moe" in view.split and opts.tp_mode == "moe-only":
        return "experts under moe-only with ZeRO-3: d_model over data"
    return None


@pytest.mark.parametrize("arch", ARCHS)
def test_stored_shapes_equal_the_reference_policy(arch):
    cfg = p_base.get_config(arch)
    leaves = p_sh._leaf_shapes(cfg)
    whole = specs.params_specs(cfg)
    for mesh_name, axes in MESHES.items():
        for opt_name, opts in OPTIONS.items():
            mesh = _rank0(axes)
            placed, view = p_sh.place_params(mesh, cfg, whole, opts)
            got = {}
            p_sh.map_with_paths(
                lambda path, t: got.__setitem__(path, tuple(t.shape)),
                placed)
            assert set(got) == {p for p, _ in leaves}
            for path, shape in leaves:
                want = _ref_shape(axes, _ref_config(arch), path, shape, opts)
                if got[path] == want:
                    continue
                why = _departure(cfg, view, path, opts)
                assert why is not None, (
                    f"{mesh_name} {opt_name} {path}: stored {got[path]}, "
                    f"the policy's per-device {want}")


_refs: dict = {}


def _ref_config(arch):
    if arch not in _refs:
        from repro.configs.base import get_config
        _refs[arch] = get_config(arch)
    return _refs[arch]


def test_departures_are_exercised():
    """Each documented departure shows on some registered architecture:
    mamba2's SSD columns, qwen1.5-110b's 8 kv heads on a 16-way axis,
    moonshot's experts under moe-only with ZeRO-3."""
    cases = [("mamba2-1.3b", "units/slot0/ssm/in_proj", p_sh.BASELINE),
             ("qwen1.5-110b", "units/slot0/attn/wk", p_sh.BASELINE),
             ("moonshot-v1-16b-a3b", "units/slot0/moe/wi",
              p_sh.ShardingOptions(tp_mode="moe-only"))]
    axes = MESHES["16x16"]
    for arch, path, opts in cases:
        cfg = p_base.get_config(arch)
        placed, view = p_sh.place_params(_rank0(axes), cfg,
                                         specs.params_specs(cfg), opts)
        got = {}
        p_sh.map_with_paths(
            lambda p, t: got.__setitem__(p, tuple(t.shape)), placed)
        shape = dict(p_sh._leaf_shapes(cfg))[path]
        want = _ref_shape(axes, _ref_config(arch), path, shape, opts)
        assert got[path] != want, (arch, path)
        assert _departure(cfg, view, path, opts) is not None


SPLITS = {
    ("moonshot-v1-16b-a3b", "full"): ("attn", "moe", "shared", "vocab"),
    ("moonshot-v1-16b-a3b", "vocab-only"): ("vocab",),
    ("moonshot-v1-16b-a3b", "moe-only"): ("moe", "vocab"),
    ("qwen3-0.6b", "full"): ("attn", "ffn", "vocab"),
    ("qwen3-0.6b", "vocab-only"): ("vocab",),
    ("qwen3-0.6b", "moe-only"): ("vocab",),
    ("mamba2-1.3b", "full"): ("ssm", "vocab"),
    ("mamba2-1.3b", "vocab-only"): ("vocab",),
}


@pytest.mark.parametrize("case", sorted(SPLITS), ids="-".join)
def test_split_follows_tp_mode(case):
    arch, mode = case
    cfg = p_base.get_config(arch)
    opts = p_sh.ShardingOptions(tp_mode=mode)
    view = p_sh.rank_config(_rank0(MESHES["2x2"]), cfg, opts)
    assert view.split == SPLITS[case]
    whole_layers = "attn" not in view.split
    assert (view.n_heads == cfg.n_heads) == whole_layers


def test_zero_storage_follows_fsdp():
    """ZeRO-3 leaves: qwen1.5-110b (``cfg.fsdp``) stores over "data" under
    BASELINE, and not with ``fsdp_override=False``; qwen3-0.6b under its
    recommended training options over ("data", "model"); the serving
    layout stores nothing."""
    mesh = _rank0(MESHES["16x16"])
    big = p_base.get_config("qwen1.5-110b")
    zero = p_sh.rank_config(mesh, big, p_sh.BASELINE).zero
    assert zero and all(axes == ("data",) for _, _, axes in zero)
    assert not p_sh.rank_config(mesh, big, OPTIONS["no-fsdp"]).zero
    assert not p_sh.rank_config(mesh, big, p_sh.SERVING).zero
    small = p_base.get_config("qwen3-0.6b")
    rec = p_sh.recommended_options(small, "train")
    zero = dict((p, a) for p, _, a in p_sh.rank_config(mesh, small, rec).zero)
    assert zero["units/slot0/attn/wq"] == ("data", "model")
    assert zero["embed"] == ("data",)       # its vocab dim is on "model"


def test_refusals_name_part_4():
    """Every knob of ROADMAP queue 1, item 7c, part 4 is taken.
    ``seq_shard`` on "model" axes of 2, 4 and 16: ``place_params`` holds
    the baseline's shards and view (sequence parallelism moves no
    weight), and under ``activation_sharding(seq_shard=True)`` a
    full-sequence call whose length the axis divides runs on the rank's
    block (``seq_parallel`` marks its view), one it does not divide (a
    decode step at S = 1) on the plain path.  The MoE knobs:
    ``moe_dp_groups=False`` and ``expert_axis="data"`` in the context,
    ``expert_shard_dff`` and ``expert_mesh="data"`` (and so llama4's
    recommended training and prefill options) in the layout."""
    mesh = _rank0(MESHES["2x2"])
    cfg = p_base.get_config("llama4-maverick-400b-a17b")
    whole = specs.params_specs(cfg)
    seq = p_sh.ShardingOptions(seq_shard=True)
    for axes in (MESHES["2x2"], dict(data=1, model=4), MESHES["16x16"]):
        m = axes["model"]
        placed, view = p_sh.place_params(_rank0(axes), cfg, whole, seq)
        base, base_view = p_sh.place_params(_rank0(axes), cfg, whole)
        assert view == base_view and view.model_size == m
        assert [t.shape for t in _tree.leaves(placed)] == \
            [t.shape for t in _tree.leaves(base)]
        assert shardctx.seq_parallel(view, 4 * m) is view    # no context
        with shardctx.activation_sharding(_rank0(axes), seq_shard=True):
            run = shardctx.seq_parallel(view, 4 * m)
            assert shardctx.seq_block(run) and run.model_size == m
            assert shardctx.seq_parallel(view, 1) is view
            assert shardctx.seq_parallel(view, 4 * m + 1) is view
            assert shardctx.seq_parallel(run, 4 * m) is run
        with shardctx.activation_sharding(_rank0(axes)):
            assert shardctx.seq_parallel(view, 4 * m) is view
    with shardctx.activation_sharding(mesh, moe_dp_groups=False,
                                      expert_axis="data"):
        assert shardctx.gathers_experts()
    with shardctx.activation_sharding(mesh):
        assert not shardctx.gathers_experts()
    for opts, how in ((p_sh.ShardingOptions(expert_shard_dff=True), "dff"),
                      (p_sh.ShardingOptions(expert_mesh="data"), "experts"),
                      (p_sh.recommended_options(cfg, "train"), "dff"),
                      (p_sh.recommended_options(cfg, "prefill"), "dff")):
        _, view = p_sh.place_params(mesh, cfg, whole, opts)
        assert view.moe_data == how, opts
    # at a size of 1 seq_shard shards nothing and is taken
    one = _rank0(dict(data=1, model=1))
    with shardctx.activation_sharding(one, seq_shard=True,
                                      moe_dp_groups=False):
        assert not shardctx.remat_offload_active()
    with shardctx.activation_sharding(one, remat_offload=True):
        assert shardctx.remat_offload_active()
    with pytest.raises(ValueError):
        p_sh.place_params(mesh, cfg, {}, p_sh.ShardingOptions(tp_mode="x"))
    with pytest.raises(ValueError):
        p_sh.place_params(mesh, cfg, {},
                          p_sh.ShardingOptions(expert_mesh="pod"))
