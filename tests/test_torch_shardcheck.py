"""Port parity: shardcheck (``repro_torch.analysis.shardcheck``).

The port walks the policy's specs (spec, kv-heads, batch, cache, pool,
consistency) and the dtypes over the registry on meta tensors, as the
reference does on ``jax.eval_shape`` structs: its covered, skipped and
failure sets equal ``repro.analysis.shardcheck.run_shardcheck()``'s, plus
the port's own ``rank-layout`` legs (every rank's shard under each
sharding option at "model" degrees 1-8 and, where an option reads "data",
data degrees 1 and 2) and the skips of the options that act on nothing.
Seeded faults flag the same (arch, check, leaf) set in both packages; a
layout that cuts a part too narrow or gives a rank the wrong kv heads
fails ``rank-layout``; a float64 leaf fails ``dtype``; a tick that moves a
pool leaf to new storage fails ``donation``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.analysis import shardcheck as r_shardcheck
from repro.launch import sharding as r_sharding
from repro_torch.analysis import shardcheck as p_shardcheck
from repro_torch.configs import base as p_base
from repro_torch.launch import sharding as p_sharding
from repro_torch.models import transformer
from repro_torch.serving import kvpool

ARCHS = sorted(p_base.load_all())


@pytest.fixture(scope="module")
def reports():
    return (p_shardcheck.run_shardcheck(device="cpu"),
            r_shardcheck.run_shardcheck())


def _layout_legs():
    legs = set()
    for arch in ARCHS:
        cfg = p_base.get_config(arch)
        for name, opts in p_shardcheck.LAYOUT_OPTIONS.items():
            if p_shardcheck._layout_skip(cfg, name):
                continue
            data = (1, 2) if p_shardcheck._reads_data(cfg, opts) else (1,)
            legs |= {(arch, f"rank-layout[{name} model={m} data={d}]")
                     for m in (1, 2, 4, 8) for d in data}
    return legs


def test_covered_legs_are_the_references_and_the_layouts(reports):
    port, ref = reports
    assert len(ref.covered) == 58
    assert set(port.covered) == set(ref.covered) | _layout_legs()
    assert len(port.covered) == len(set(port.covered))
    assert port.ok and ref.ok, [f.render() for f in port.failures]


def test_skips_are_the_references_and_the_empty_options(reports):
    port, ref = reports
    assert len(ref.skipped) == 2
    extra = set(port.skipped) - set(ref.skipped)
    assert set(ref.skipped) <= set(port.skipped)
    assert extra == {
        (arch, f"rank-layout[{name}]",
         "no experts: the expert layouts act on nothing")
        for arch in ARCHS if not p_base.get_config(arch).n_experts
        for name in ("expert_shard_dff", "expert_mesh=data")}


def test_shardcheck_stays_cheap(reports):
    assert reports[0].elapsed_s < 60


def _leaves_hit(failures):
    """(arch, check, leaf) of each failure: the leaf is the message's
    path, after its "model=M" prefix."""
    return {(f.arch, f.check, f.message.split(" ")[1].rstrip(":"))
            for f in failures}


def _seed(monkeypatch, rule):
    """``rule(pstr, shape)`` -> a spec's entries or None, over both
    packages' ``param_spec``."""
    for module, make in ((p_sharding, p_sharding.P),
                         (r_sharding, PartitionSpec)):
        real = module.param_spec

        def param_spec(mesh, cfg, pstr, shape, *opts, real=real, make=make):
            entries = rule(pstr, shape)
            if entries is None:
                return real(mesh, cfg, pstr, shape, *opts)
            return make(*entries)

        monkeypatch.setattr(module, "param_spec", param_spec)


def _both(arch, m):
    port = p_shardcheck.run_shardcheck([arch], model_degrees=(m,),
                                       donation=False, rank_layout=False)
    ref = r_shardcheck.run_shardcheck([arch], model_degrees=(m,),
                                      donation=False)
    return port, ref


def test_seeded_duplicate_axis_fails_as_in_the_reference(monkeypatch):
    _seed(monkeypatch, lambda pstr, shape: ("model", "model")
          if len(shape) == 2 else None)
    port, ref = _both("qwen3-0.6b", 2)
    assert _leaves_hit(port.failures) == _leaves_hit(ref.failures)
    assert any(f.check == "spec" and "consumed twice" in f.message
               for f in port.failures)


@pytest.mark.parametrize("m,hit", [(16, True), (8, False)])
def test_seeded_kv_head_missplit_fails_as_in_the_reference(monkeypatch, m,
                                                           hit):
    """A kv projection split on its flat dim (qwen3: 1024 divides 16, its
    8 kv heads do not); 8 ways is the near miss."""
    _seed(monkeypatch, lambda pstr, shape: (*[None] * (len(shape) - 1),
                                            "model")
          if pstr.rsplit("/", 1)[-1] in ("wk", "wv") and len(shape) >= 2
          else None)
    port, ref = _both("qwen3-0.6b", m)
    assert _leaves_hit(port.failures) == _leaves_hit(ref.failures)
    assert any(f.check == "kv-heads" for f in port.failures) == hit


def test_seeded_narrow_part_fails_the_rank_layout(monkeypatch):
    real = p_sharding._part
    monkeypatch.setattr(p_sharding, "_part", lambda t, dim, r, m: real(
        t, dim, 0, 2 * m) if r == 0 else real(t, dim, r, m))
    rep = p_shardcheck.run_shardcheck(["qwen3-0.6b"], model_degrees=(2,),
                                      donation=False)
    bad = {f.message.split(" ")[3] for f in rep.failures
           if f.check == "rank-layout"}
    assert "units/slot0/attn/wq:" in bad and "embed:" in bad, \
        [f.render() for f in rep.failures]


def test_seeded_wrong_kv_heads_fail_the_rank_layout(monkeypatch):
    real = p_sharding.rank_view

    def shifted(cfg, m, r, opts=p_sharding.BASELINE):
        view = real(cfg, m, r, opts)
        if "attn" not in view.split or r:
            return view
        return dataclasses.replace(view, kv_offset=view.kv_offset + 1)

    monkeypatch.setattr(p_sharding, "rank_view", shifted)
    rep = p_shardcheck.run_shardcheck(["qwen3-0.6b"], model_degrees=(2,),
                                      donation=False)
    assert any(f.check == "rank-layout" and "its query heads read"
               in f.message for f in rep.failures), \
        [f.render() for f in rep.failures]


def test_dtype_failures_flag_64_bit_floats_as_the_reference():
    tree = {"w": torch.empty(2, dtype=torch.float64, device="meta"),
            "z": torch.empty(2, dtype=torch.complex128, device="meta"),
            "a": torch.empty(2, dtype=torch.float32, device="meta"),
            "i": torch.empty(2, dtype=torch.int32, device="meta")}
    got = p_shardcheck.dtype_failures(tree, arch="fx", what="t")
    want = r_shardcheck.dtype_failures(
        {k: jax.ShapeDtypeStruct(tuple(v.shape), np.dtype(
            str(v.dtype).removeprefix("torch."))) for k, v in tree.items()},
        arch="fx", what="t")
    assert [f.render() for f in got] == [f.render() for f in want]
    assert len(got) == 2
    assert p_shardcheck.dtype_failures({"a": tree["a"]}, arch="fx",
                                       what="t") == []


def test_mec_params_hold_no_64_bit_floats():
    assert p_shardcheck.mec_params_dtype_failures() == []


def test_donation_probe_fails_on_a_cloned_pool_leaf(monkeypatch):
    """The probe passes on the engine as it is; a tick that rebinds one
    pool leaf to a clone, and a commit that does, each fail it."""
    assert p_shardcheck.donation_probe("cpu")[0] == []
    real_tick = transformer.decode_step_paged

    def cloning_tick(*args):
        logits, state = real_tick(*args)
        slot = state["units"]["slot0"]
        state["units"]["slot0"] = slot._replace(k=slot.k.clone())
        return logits, state

    monkeypatch.setattr(transformer, "decode_step_paged", cloning_tick)
    fails, figures = p_shardcheck.donation_probe("cpu")
    assert [f.message.split(":")[0] for f in fails] == \
        ["decode_step_paged tick"] * 2          # the warm tick and the next
    assert "1 of 2 pool leaves moved" in fails[0].message
    assert figures == {"pool_bytes": 40960}
    monkeypatch.setattr(transformer, "decode_step_paged", real_tick)
    real_commit = kvpool.commit_prefill
    monkeypatch.setattr(kvpool, "commit_prefill", lambda state, *a, **k: {
        **real_commit(state, *a, **k),
        "units": {n: c._replace(v=c.v.clone())
                  for n, c in state["units"].items()}})
    fails, _ = p_shardcheck.donation_probe("cpu")
    assert [f.message.split(":")[0] for f in fails] == \
        ["commit_prefill admission bridge"]
