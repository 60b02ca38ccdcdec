"""Port parity: the KV-pool sanitizer and the engine's dispatch guards.

The ten sanitizer cases of ``tests/test_analysis.py`` run against the
port's ``KVSanitizer`` (nine over a fake paged engine, one on a real
engine whose pool is corrupted mid-flight).  Each of the port's two
dispatch guards, which stand in for the reference's ``checkify``, fires at
its dispatch: an out-of-range block-table entry before the paged decode,
and an injected NaN after a prefill.  ``run_sanitize`` is clean with
preemptions > 0 and drives the same schedule as the reference's (ticks,
requests, preemptions and block events equal); the CLI runs on the CPU.
"""
import types

import numpy as np
import pytest
import torch

from repro.analysis import sanitize as r_sanitize
from repro_torch.analysis import sanitize as p_sanitize
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.sanitize import (GuardError, KVSanitizer,
                                           SanitizerError, run_sanitize)
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kvpool import BlockAllocator


def _fake_paged_engine(slots=2, n_blocks=9, kv_block=8, table_w=4):
    eng = types.SimpleNamespace(
        owned=[[] for _ in range(slots)],
        block_tables=np.zeros((slots, table_w), np.int32),
        active=[None] * slots,
        seq_lens=np.zeros(slots, np.int32),
        kv_block=kv_block,
        allocator=BlockAllocator(n_blocks, kv_block))
    return eng, KVSanitizer(eng)


def _hand(eng, san, slot, n, seq_len):
    got = eng.allocator.alloc(n)
    san.on_alloc(slot, got)
    eng.owned[slot] = list(got)
    eng.block_tables[slot, :len(got)] = got
    eng.active[slot] = object()
    eng.seq_lens[slot] = seq_len
    return got


def test_sanitizer_clean_lifecycle():
    eng, san = _fake_paged_engine()
    got = _hand(eng, san, 0, 2, seq_len=10)
    san.check_tick()
    san.on_free(0, got)
    eng.allocator.free(got)
    eng.owned[0] = []
    eng.block_tables[0, :] = 0
    eng.seq_lens[0] = 0
    eng.active[0] = None
    san.check_tick()
    san.check_drain()
    assert san.events == 4


def test_sanitizer_catches_double_free():
    eng, san = _fake_paged_engine()
    got = _hand(eng, san, 0, 1, seq_len=4)
    san.on_free(0, got)
    with pytest.raises(SanitizerError, match="double free"):
        san.on_free(0, got)


def test_sanitizer_catches_cross_slot_aliasing_on_alloc():
    eng, san = _fake_paged_engine()
    got = _hand(eng, san, 0, 1, seq_len=4)
    with pytest.raises(SanitizerError, match="aliasing"):
        san.on_alloc(1, [got[0]])


def test_sanitizer_catches_dummy_block_handout():
    _, san = _fake_paged_engine()
    with pytest.raises(SanitizerError, match="dummy block 0"):
        san.on_alloc(0, [0])


def test_sanitizer_tick_catches_aliased_owned_lists():
    eng, san = _fake_paged_engine()
    got = _hand(eng, san, 0, 1, seq_len=4)
    eng.owned[1] = [got[0]]
    eng.block_tables[1, 0] = got[0]
    eng.active[1] = object()
    with pytest.raises(SanitizerError, match="aliased"):
        san.check_tick()


def test_sanitizer_tick_catches_stale_table_entry():
    eng, san = _fake_paged_engine()
    _hand(eng, san, 0, 2, seq_len=10)
    eng.block_tables[0, 3] = 5          # past the 2 owned blocks
    with pytest.raises(SanitizerError, match="stale"):
        san.check_tick()


def test_sanitizer_tick_catches_dummy_write():
    eng, san = _fake_paged_engine()
    _hand(eng, san, 0, 1, seq_len=9)    # 9 > 1 block x 8 tokens
    with pytest.raises(SanitizerError, match="dummy block 0"):
        san.check_tick()


def test_sanitizer_tick_catches_free_owned_overlap():
    eng, san = _fake_paged_engine()
    eng.owned[0] = [3]                  # never handed out: still free
    san.owner[3] = 0
    eng.block_tables[0, 0] = 3
    eng.active[0] = object()
    eng.seq_lens[0] = 4
    with pytest.raises(SanitizerError, match="free and slot-owned"):
        san.check_tick()


def test_sanitizer_drain_catches_leak():
    eng, san = _fake_paged_engine()
    _hand(eng, san, 0, 1, seq_len=4)
    eng.active[0] = None                # "completed", blocks kept
    with pytest.raises(SanitizerError, match="leak at drain"):
        san.check_drain()


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=1)
    return cfg, transformer.init_params(0, cfg, "cpu")


def _one_request(model, **kw):
    cfg, params = model
    eng = ServingEngine(cfg, params, slots=2, s_max=32, sanitize=True, **kw)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new=8))
    return eng


def test_sanitized_engine_catches_injected_aliasing(model):
    eng = _one_request(model)
    assert eng.step()                   # admit + first decode tick, clean
    (slot,) = [i for i, r in enumerate(eng.active) if r is not None]
    other = 1 - slot
    eng.owned[other] = [eng.owned[slot][0]]
    eng.block_tables[other, 0] = eng.owned[slot][0]
    with pytest.raises(SanitizerError, match="aliased"):
        eng.step()


def test_guard_refuses_an_out_of_range_table_entry_before_decode(model):
    """On the card this id would reach the paged decode kernel as an
    illegal address; the guard raises before the dispatch."""
    eng = _one_request(model)
    assert eng.step()
    (slot,) = [i for i, r in enumerate(eng.active) if r is not None]
    eng.block_tables[slot, 0] = eng.allocator.n_blocks + 3
    steps = eng.decode_steps
    with pytest.raises(GuardError, match="decode_step_paged: block id"):
        eng.step()
    assert eng.decode_steps == steps    # nothing was dispatched


def test_guard_refuses_a_write_past_the_table(model):
    eng = _one_request(model)
    assert eng.step()
    (slot,) = [i for i, r in enumerate(eng.active) if r is not None]
    eng.seq_lens[slot] = -1
    with pytest.raises(GuardError, match="write position"):
        eng.step()
    with pytest.raises(GuardError, match="commit_chunk: block id"):
        p_sanitize.guard_blocks(eng, "commit_chunk", [0, -1])
    with pytest.raises(GuardError, match="write position"):
        p_sanitize.guard_blocks(eng, "commit_chunk", [1],
                                [eng.table_width * eng.kv_block])
    p_sanitize.guard_blocks(eng, "commit_chunk", [0, 1],
                            [eng.table_width * eng.kv_block - 1])


@pytest.mark.parametrize("sync", [False, True], ids=["continuous", "sync"])
def test_guard_catches_an_injected_nan(model, sync):
    cfg, params = model
    bad = {**params, "final_norm": params["final_norm"].clone()}
    bad["final_norm"][3] = float("nan")
    eng = ServingEngine(cfg, bad, slots=2, s_max=32, sanitize=True,
                        sync_batching=sync)
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new=4))
    with pytest.raises(GuardError, match="prefill: NaN"):
        eng.step()
    # the same weights unsanitized: NaN logits flow on unchecked
    plain = ServingEngine(cfg, bad, slots=2, s_max=32, sync_batching=sync)
    plain.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=4))
    plain.run_until_idle()
    assert torch.isnan(bad["final_norm"]).any()


def test_sanitize_off_costs_nothing_but_the_checks(model):
    cfg, params = model
    eng = ServingEngine(cfg, params, slots=2, s_max=32)
    assert eng._san is None and eng._guards is None and eng.obs is None


def test_run_sanitize_clean_on_the_engine():
    """The flash-crowd run passes clean and exercises the dry-pool path;
    its schedule is the reference's (the reference's run_sanitize drives
    the same lengths and budgets: the tick, preemption and block-event
    counts depend on nothing else)."""
    rep = run_sanitize(device="cpu")
    assert rep.ok, "\n".join(f.render() for f in rep.failures)
    assert rep.requests == 10 and rep.preemptions > 0
    assert rep.block_churn > rep.requests
    want = r_sanitize.run_sanitize()
    assert (rep.ticks, rep.requests, rep.preemptions, rep.block_churn) == (
        want.ticks, want.requests, want.preemptions, want.block_churn)


def test_run_sanitize_reports_a_guard_failure_as_guards(model):
    cfg, params = model
    bad = {**params, "final_norm": params["final_norm"].clone()}
    bad["final_norm"][0] = float("nan")
    rep = run_sanitize(cfg=cfg, params=bad)
    assert [f.check for f in rep.failures] == ["guards"]
    assert "NaN" in rep.failures[0].message


def test_run_sanitize_reports_another_dispatch_error_as_dispatch(model):
    """A dispatch that fails without a guard firing (here a final norm of
    the wrong width) is not filed under "guards"."""
    cfg, params = model
    bad = {**params, "final_norm": params["final_norm"][:-1].clone()}
    rep = run_sanitize(cfg=cfg, params=bad)
    assert [f.check for f in rep.failures] == ["dispatch"]
    assert "RuntimeError" in rep.failures[0].message


def test_flash_crowd_schedule_matches_reference():
    got = p_sanitize._flash_crowd_schedule(256, 0, 10)
    want = r_sanitize._flash_crowd_schedule(256, 0, 10)
    assert sorted(got) == sorted(want)
    for tick in want:
        for a, b in zip(got[tick], want[tick]):
            assert (a.rid, a.max_new, a.ue) == (b.rid, b.max_new, b.ue)
            np.testing.assert_array_equal(a.prompt, b.prompt)


def test_analysis_cli(capsys):
    assert analysis_main(["--sanitize", "--device", "cpu"]) == 0
    assert "0 failure(s)" in capsys.readouterr().out
    # the lint layer runs too: the port's tree is clean against its baseline
    assert analysis_main(["--lint", "--device", "cpu"]) == 0
    assert "reprolint: 0 finding(s)" in capsys.readouterr().out
