"""``launch.dryrun`` and ``launch.mesh.fake_world``.

* **Argument bytes.**  On reduced qwen3 in a ``fake_world(4)`` (data 2,
  model 2) under its recommended options, ``run_cell``'s
  ``argument_bytes`` equal the bytes of ``place_params`` of real weights
  under the same mesh and options (with Adam's moments and the rank's
  rows for train, the rank's rows for prefill, the rank's cache and
  tokens for decode).
* **The ledger.**  The fake world's collectives for one train step equal,
  kind for kind, count for count and byte for byte, those that a real
  (data 2, model 2) gloo world records for the same step
  (``tests/_zero_train.py::ledger_world``).
* **Flops.**  Summed over the 4 ranks, within [0.8, 1.3] of
  ``roofline.step_flops(...)["executed"]`` for train and prefill (the
  plain program's dense causal attention computes the masked half too).
* **A production cell.**  qwen3-0.6b's full-width ``decode_32k`` on the
  256-rank mesh through ``main``, which writes the reference's keys,
  skips records that exist, writes ``skipped`` for ``long_500k`` and an
  ``error`` naming ROADMAP queue 1, item 7c, part 4 for ``--seq-shard``.
* **The MoE knobs.**  llama4-maverick's ``--recommended`` train_4k cell
  (``expert_shard_dff`` under "moe-only") and its ``--expert-mesh data``
  cell, full width at 2 layers on a (data 2, model 2) fake world, give
  ``ok`` records whose ledgers hold the data axis's token collectives:
  the dispatched slots all-gathered and the partial outputs
  reduce-scattered, or both moved by all-to-alls, at the sizes the
  dispatch groups give.
* **qwen1.5-110b's train_4k arguments** on the 256-rank mesh (ZeRO-3 over
  "data") equal the reference policy's per-device bytes less the
  documented departure (a rank holds the one kv head its query heads
  read, where the policy keeps all 8), which the record names.
* **The world.**  ``fake_world`` refuses a second default group and
  leaves none behind.
* **The consumer.**  ``roofline.terms_for`` takes a record's
  ``bytes_by_kind``.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _model_axis_train as mt
import _zero_train as zt
from repro.analysis.contracts import ShapeOnlyMesh
from repro.configs.base import get_config as r_get_config
from repro.launch import sharding as r_sh
from repro.launch import specs as r_specs
from repro_torch import _tree
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun, sharding, specs
from repro_torch.launch import mesh as pmesh
from repro_torch.models import steps, transformer
from repro_torch.profiling import roofline

MESH = (2, 2)
CELL = {"train": ("train_4k", mt.B, mt.S), "prefill": ("prefill_32k", 4, 64),
        "decode": ("decode_32k", 4, 64)}


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


def _cell(kind, opts=None, cfg=None):
    name, b, s = CELL[kind]
    cfg = zt.STACKS["g"]() if cfg is None else cfg
    shape = dataclasses.replace(specs.SHAPES[name], batch=b, seq=s)
    opts = sharding.recommended_options(cfg, shape.kind) if opts is None \
        else opts
    return cfg, shape, opts, dryrun.run_cell(
        "qwen3-0.6b", name, False, opts, cfg=cfg, shape=shape,
        mesh_shape=MESH)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_equal_place_params(kind):
    cfg, shape, opts, rec = _cell(kind)
    assert rec["status"] == "ok" and rec["devices"] == 4
    mesh = dryrun._RankMesh(("data", "model"), MESH,
                            {"model": rec["rank"] % MESH[1]})
    params = transformer.init_params(0, cfg, "cpu")
    placed, view = sharding.place_params(mesh, cfg, params, opts)
    rows = shape.batch // MESH[0]
    want = _nbytes(placed)
    if kind == "train":
        want += _nbytes(steps.make_train_step(view)[0](placed))
        want += 2 * rows * shape.seq * 4                 # tokens, targets
        assert rec["split"] == ["vocab"] and rec["zero_leaves"] > 0
    elif kind == "prefill":
        want += rows * shape.seq * 4
    else:
        want += _nbytes(transformer._init_caches(
            view, rows, shape.seq + specs.DECODE_MARGIN, "cpu"))
        want += 4 + rows * 4                # the cache's pos, the tokens
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["temp_bytes"] > 0 and rec["flops"] > 0
    assert rec["bytes_accessed"] > rec["memory"]["argument_bytes"]


def test_fake_world_ledger_equals_the_gloo_world():
    real = pmesh.run_world(zt.ledger_world, 4, deadline_s=200)
    cfg, shape, opts, rec = _cell("train", zt.options("g", "rec", 2))
    fake = [tuple(e) for e in rec["ledger"]]
    kinds = {k for k, _, _ in fake}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    for r, ledger in enumerate(real):
        assert [tuple(e) for e in ledger] == fake, r
    totals = rec["collectives"]
    assert totals["total_bytes"] == sum(b for _, b, _ in fake)
    assert sum(totals["ops_by_kind"].values()) == len(fake)
    assert totals["bf16_wire_corrected_bytes"] == totals["total_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_flops_over_ranks_match_the_roofline(kind):
    cfg = zt.STACKS["g"]()
    name, b, s = CELL[kind]
    shape = dataclasses.replace(specs.SHAPES[name], batch=4, seq=64)
    rec = dryrun.run_cell("qwen3-0.6b", name, False, sharding.BASELINE,
                          cfg=cfg, shape=shape, mesh_shape=MESH)
    executed = roofline.step_flops(cfg, shape, kind)["executed"]
    assert 0.8 <= rec["flops"] * rec["devices"] / executed <= 1.3


def test_main_on_the_production_mesh(tmp_path):
    out = str(tmp_path)
    argv = ["--arch", "qwen3-0.6b", "--mesh", "single", "--out", out]
    dryrun.main(argv + ["--shape", "decode_32k"])
    path = os.path.join(out, "qwen3-0.6b__decode_32k__single.json")
    rec = json.load(open(path))
    for key in ("arch", "shape", "mesh", "devices", "status", "lower_s",
                "compile_s", "memory", "flops", "bytes_accessed",
                "cost_raw", "collectives"):
        assert key in rec, key
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert set(rec["collectives"]) == {
        "bytes_by_kind", "ops_by_kind", "total_bytes", "f32_bytes",
        "bf16_wire_corrected_bytes"}
    # full width on the 16-way model axis: the rank's cache is the
    # policy's, its sequence over "model" (the 8 kv heads do not divide
    # it): K and V of 28 layers, 8 rows, all 8 kv heads of 32,896 / 16
    # positions, bf16; and the int32 pos
    assert rec["memory"]["alias_bytes"] == \
        28 * 2 * 8 * (32896 // 16) * 8 * 128 * 2 + 4
    assert not [p for p in rec["departure_bytes"] if p.startswith("1/")]
    os.utime(path, (0, 0))
    dryrun.main(argv + ["--shape", "decode_32k"])
    assert os.stat(path).st_mtime == 0                  # skipped, untouched
    dryrun.main(argv + ["--shape", "long_500k"])
    skipped = json.load(open(os.path.join(
        out, "qwen3-0.6b__long_500k__single.json")))
    assert skipped["status"] == "skipped" and "sub-quadratic" in \
        skipped["reason"]
    dryrun.main(argv + ["--shape", "train_4k", "--seq-shard", "--tag", "e"])
    seq = json.load(open(os.path.join(
        out, "qwen3-0.6b__train_4k__single__e.json")))
    assert seq["status"] == "ok" and seq["options"]["seq_shard"]
    # sequence parallelism: the sub-blocks' partial sums are
    # reduce-scattered over the sequence where they were all-reduced
    assert seq["collectives"]["ops_by_kind"]["reduce-scatter"] > 0


def test_qwen1_5_arguments_equal_the_policy_less_the_kv_departure():
    """The rank's train_4k arguments (pick_rank, what run_cell records)
    beside the reference policy's per-device bytes: parameters, Adam's
    moments and step, the batch rows."""
    arch, shape = "qwen1.5-110b", specs.SHAPES["train_4k"]
    cfg = get_config(arch)
    names, sizes = ("data", "model"), (16, 16)
    args = dryrun.build_args(cfg, shape, specs.params_specs(cfg))
    rank, got = dryrun.pick_rank(cfg, shape, sharding.BASELINE, names,
                                 sizes, args)
    # the reference policy, per device
    r_cfg = r_get_config(arch)
    mesh = ShapeOnlyMesh(data=16, model=16)
    want_in = r_specs.input_specs(r_cfg, "train_4k")

    def per_device(spec, leaf):
        n = int(np.prod(leaf.shape))
        for entry in tuple(spec):
            for a in (() if entry is None else (entry,) if isinstance(
                    entry, str) else entry):
                n //= mesh.shape[a]
        return n * np.dtype(leaf.dtype).itemsize

    policy = 0
    for tree in (want_in["params"], want_in["opt_state"].mu,
                 want_in["opt_state"].nu):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            policy += per_device(r_sh.param_spec(
                mesh, r_cfg, r_sh._path_str(path), leaf.shape), leaf)
    policy += 4                                            # Adam's step
    for leaf in want_in["batch"].values():
        policy += per_device(r_sh.batch_spec(mesh, leaf), leaf)
    # the departure: 8 kv heads in the policy's wk / wv / bk / bv, the
    # one its query heads read on the rank (64 / 16 = 4 query heads, all
    # of kv head r // 2); the parameters bf16, the moments bf16
    hd, d, kv = cfg.resolved_head_dim, cfg.d_model, cfg.n_kv
    per_layer = 2 * (d // 16) * (kv - 1) * hd + 2 * (kv - 1) * hd
    departure = cfg.n_layers * per_layer * (2 + 2 + 2)
    assert got == policy - departure
    # the record names the same departure, leaf by leaf
    local, _ = dryrun.rank_args(
        dryrun._RankMesh(names, sizes, {"model": rank}), cfg, shape, args,
        sharding.BASELINE)
    total, diff = dryrun.policy_bytes(names, sizes, cfg, shape, args, local,
                                      sharding.BASELINE)
    assert total == policy and sum(diff.values()) == departure
    assert {p.rsplit("/", 1)[-1] for p in diff} == {"wk", "wv", "bk", "bv"}


def test_fake_world_refuses_a_second_group_and_cleans_up():
    with pmesh.fake_world(8, 3):
        assert dist.get_world_size() == 8 and dist.get_rank() == 3
        with pytest.raises(RuntimeError):
            with pmesh.fake_world(2):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with pmesh.fake_world(4):
            pmesh.make_production_mesh()        # needs 256 ranks
    assert not dist.is_initialized()


def test_terms_for_takes_a_records_bytes_by_kind():
    cfg, shape, opts, rec = _cell("train", zt.options("g", "rec", 2))
    by_kind = rec["collectives"]["bytes_by_kind"]
    terms = roofline.terms_for(cfg, shape, "train", by_kind,
                               chips=rec["devices"], microbatches=2)
    want = sum(roofline.COLLECTIVE_WEIGHT[k] * v for k, v in by_kind.items())
    assert terms.wire_bytes_per_dev == want > 0
    assert terms.collective_s == want / roofline.LINK_BW
    assert torch.isfinite(torch.tensor(terms.compute_s))


LLAMA4_CELL = ["--arch", "llama4-maverick-400b-a17b", "--shape", "train_4k",
               "--mesh-shape", "2x2", "--layers", "2", "--batch", "8",
               "--seq", "256"]


@pytest.mark.parametrize("knob", ["recommended", "expert-mesh-data"])
def test_llama4_moe_knob_cells_record_the_data_axis_collectives(tmp_path,
                                                                knob):
    from repro_torch.models import ffn
    extra = (["--recommended"] if knob == "recommended"
             else ["--expert-mesh", "data", "--tag", "ed"])
    dryrun.main(LLAMA4_CELL + extra + ["--out", str(tmp_path)])
    name = "llama4-maverick-400b-a17b__train_4k__2x2" + (
        "" if knob == "recommended" else "__ed")
    rec = json.load(open(tmp_path / f"{name}.json"))
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["departure_bytes"] == {}
    cfg = get_config("llama4-maverick-400b-a17b")
    # 4 rows a rank, microbatches of one row: a 512-token stream of one
    # group over the two data ranks, C slots an expert
    st = ffn.stream(256, 0, 2)
    cap = ffn.moe_capacity(cfg, st.gsize)
    slots = st.local * cap * cfg.d_model * 2                  # bf16
    seen = {}
    for kind, nbytes, dtype in rec["ledger"]:
        seen.setdefault((kind, nbytes, dtype), 0)
        seen[(kind, nbytes, dtype)] += 1
    if knob == "recommended":
        assert rec["split"] == ["moe", "vocab"]
        local = cfg.n_experts // 2          # the experts over "model"
        # every data rank's slots gathered, the partial sums scattered back
        assert seen.get(("all-gather", 2 * local * slots, "bfloat16"), 0) > 0
        assert seen.get(("reduce-scatter", local * slots, "bfloat16"), 0) > 0
        assert rec["collectives"]["ops_by_kind"]["all-to-all"] == 0
    else:
        # every expert's slots out, and back, each a forward and backward
        assert seen.get(("all-to-all", cfg.n_experts * slots, "bfloat16"),
                        0) >= 4
