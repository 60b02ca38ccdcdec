"""Port parity: the contract sweep (``repro_torch.analysis.contracts``).

The port runs every registered architecture at full width and depth
through prefill, decode, ragged prefill + decode, the paged tick with the
admission commit, and the chunked prefill with its commit, on meta tensors,
and the ``param_spec`` divisibility sweep over "model" degrees 1-8.  Its
covered (arch, path) legs, its skips and their reasons equal
``repro.analysis.contracts.run_contracts()``'s, with no failure in
either.  The memo that answers repeated meta ops gives what the meta
kernels give; a seeded fault in a path or in the policy fails the
matching leg, in both packages alike.
"""
import dataclasses

import pytest
import torch
from jax.sharding import PartitionSpec

from repro.analysis import contracts as r_contracts
from repro.launch import sharding as r_sharding
from repro_torch import _tree
from repro_torch.analysis import contracts as p_contracts
from repro_torch.configs.base import get_config
from repro_torch.launch import sharding as p_sharding
from repro_torch.models import transformer


@pytest.fixture(scope="module")
def reports():
    return p_contracts.run_contracts(), r_contracts.run_contracts()


def test_covered_legs_equal_the_reference(reports):
    port, ref = reports
    assert sorted(port.covered) == sorted(ref.covered)
    assert len(port.covered) == 54
    assert port.ok and ref.ok, [f.render() for f in port.failures]


def test_skips_and_reasons_equal_the_reference(reports):
    port, ref = reports
    assert sorted(port.skipped) == sorted(ref.skipped)
    assert {(a, p) for a, p, _ in port.skipped} == {
        ("llama-3.2-vision-90b", "paged"), ("llama-3.2-vision-90b", "chunked"),
        ("seamless-m4t-large-v2", "paged"),
        ("seamless-m4t-large-v2", "chunked"),
        ("llama4-maverick-400b-a17b", "chunked"),
        ("moonshot-v1-16b-a3b", "chunked")}


def test_sweep_stays_cheap(reports):
    port, _ = reports
    assert port.elapsed_s < 60


def _meta(tree):
    return [(tuple(t.shape), t.stride(), t.dtype)
            for t in _tree.leaves(tree)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_meta_memo_gives_what_the_meta_kernels_give(arch):
    """The dense prefill and a paged tick with and without the memo: the
    same shapes, strides and dtypes of every output, leaf for leaf."""
    cfg = get_config(arch)
    plain = p_contracts.traced(cfg)
    with p_contracts.MetaMemo():
        memo = p_contracts.traced(cfg)
    for field in ("prefill_logits", "cache", "state", "paged_logits",
                  "paged_state"):
        assert _meta(getattr(memo, field)) == _meta(getattr(plain, field))
    assert memo.state_structure == plain.state_structure


def test_structure_tells_trees_apart():
    from repro_torch.models.attention import KVCache, RingCache
    t = torch.empty(2, device="meta")
    a = {"units": {"slot0": KVCache(t, t)}, "tail": []}
    assert p_contracts.structure(a) == p_contracts.structure(
        {"tail": [], "units": {"slot0": KVCache(t, t)}})
    assert p_contracts.structure(a) != p_contracts.structure(
        {"units": {"slot0": RingCache(t, t, t)}, "tail": []})
    assert p_contracts.structure(a) != p_contracts.structure(
        {"units": {"slot0": KVCache(t, t)}, "tail": [KVCache(t, t)]})


def test_seeded_path_faults_fail_their_legs(monkeypatch):
    """A paged tick whose logits leave float32, and a commit that drops
    the pool's tail, each fail their leg."""
    real_tick = transformer.decode_step_paged

    def bf16_tick(*args):
        logits, state = real_tick(*args)
        return logits.to(torch.bfloat16), state

    monkeypatch.setattr(transformer, "decode_step_paged", bf16_tick)
    from repro_torch.serving import kvpool
    real_commit = kvpool.commit_chunk
    monkeypatch.setattr(kvpool, "commit_chunk", lambda state, *a, **k: {
        "units": real_commit(state, *a, **k)["units"]})
    rep = p_contracts.run_contracts(["qwen3-0.6b"])
    assert sorted((f.path, f.message.split(" ")[0]) for f in rep.failures) \
        == [("chunked", "commit_chunk"), ("paged", "logits")]


def _seeded(real, spec):
    """``real`` (a ``param_spec``) with ``spec`` on every 2-D leaf."""
    def param_spec(mesh, cfg, pstr, shape, *opts):
        if len(shape) == 2:
            return spec
        return real(mesh, cfg, pstr, shape, *opts)
    return param_spec


def test_seeded_pspec_fault_fails_as_in_the_reference(monkeypatch):
    """A policy that puts "model" on every 2-D leaf's first dim: the same
    pspec failures in both packages (qwen3-0.6b's norms, stacked over its
    28 units, do not divide 8; its embedding does)."""
    for module, spec in ((p_sharding, p_sharding.P("model", None)),
                         (r_sharding, PartitionSpec("model", None))):
        monkeypatch.setattr(module, "param_spec",
                            _seeded(module.param_spec, spec))
    port = p_contracts.run_contracts(["qwen3-0.6b"])
    ref = r_contracts.run_contracts(["qwen3-0.6b"])
    assert {f.render() for f in port.failures} == \
        {f.render() for f in ref.failures}
    assert port.failures and all(f.path == "pspec" and "model=8" in
                                 f.message for f in port.failures)


def test_shape_only_mesh_reads_as_the_references():
    from repro_torch import shardctx
    for axes in (dict(cells=1, model=4), dict(data=16, model=16)):
        assert shardctx.mesh_axes(p_contracts.ShapeOnlyMesh(**axes)) == \
            shardctx.mesh_axes(r_contracts.ShapeOnlyMesh(**axes)) == axes
    assert [f.name for f in dataclasses.fields(p_contracts.ContractReport)] \
        == [f.name for f in dataclasses.fields(r_contracts.ContractReport)]
