"""Port parity: the traffic recorder and the serving -> trace -> MEC loop.

The same event streams go into both packages' ``TrafficRecorder``s: first
a hand-written stream (re-admissions, chunked prefill-done ticks, a UE
declared late, requests without a UE, requests still in flight), then the
streams that the two engines make serving the same submit schedule on the
same weights, in both modes, with preemption and chunked prefill.
Per-rid events, ``to_trace`` (bit-equal rates and equal metadata),
``delay_breakdowns`` and ``latency_stats`` must equal the reference's.
``traffic_demo.main`` runs on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.serving import engine as r_engine
from repro.traffic import TrafficRecorder as RRecorder
from repro_torch import traffic_demo
from repro_torch.configs import base as p_base
from repro_torch.models import transformer as p_tf
from repro_torch.serving import engine as p_engine
from repro_torch.traffic import Trace, TrafficRecorder

# (method, rid, tick[, ue]) in call order
EVENTS = [
    ("record_submit", 0, 0, 2), ("record_submit", 1, 0, None),
    ("record_submit", 2, 1, 7), ("record_admit", 0, 1),
    ("record_prefill_done", 0, 1), ("record_admit", 1, 1),
    ("record_submit", 3, 2, None), ("record_preempt", 1, 3),
    ("record_admit", 2, 4), ("record_complete", 0, 5),
    ("record_prefill_done", 2, 6), ("record_admit", 1, 6),
    ("record_prefill_done", 1, 6), ("record_submit", 3, 6, 1),
    ("record_complete", 2, 9), ("record_complete", 1, 11),
    ("record_submit", 4, 12, None),
]


def _feed(rec):
    for name, rid, t, *ue in EVENTS:
        if ue:
            getattr(rec, name)(rid, t, ue=ue[0])
        else:
            getattr(rec, name)(rid, t)
    return rec


def _held_to_reference(p_rec, r_rec, n_ue=3):
    assert sorted(p_rec.events) == sorted(r_rec.events)
    for rid, ev in r_rec.events.items():
        assert dataclasses.asdict(p_rec.events[rid]) == \
            dataclasses.asdict(ev), rid
        assert (p_rec.events[rid].admit, p_rec.events[rid].queueing_ticks,
                p_rec.events[rid].service_ticks) == (
            ev.admit, ev.queueing_ticks, ev.service_ticks)
    for which in ("submit", "admit", "complete"):
        assert p_rec.timestamps(which) == r_rec.timestamps(which)
        for kw in (dict(), dict(bin_ticks=3, slot_s=0.5),
                   dict(bin_ticks=2, horizon=4)):
            if not r_rec.timestamps(which) and "horizon" not in kw:
                continue
            got = p_rec.to_trace(n_ue, which=which, **kw)
            want = r_rec.to_trace(n_ue, which=which, **kw)
            assert isinstance(got, Trace)
            assert got.rates.dtype == want.rates.dtype == np.float32
            np.testing.assert_array_equal(got.rates, np.asarray(want.rates))
            assert got.meta == want.meta and got.slot_s == want.slot_s
    np.testing.assert_array_equal(p_rec.latencies(), r_rec.latencies())
    np.testing.assert_array_equal(p_rec.latencies("admit", "complete"),
                                  r_rec.latencies("admit", "complete"))
    assert p_rec.latency_stats() == r_rec.latency_stats()
    p_bds, r_bds = p_rec.delay_breakdowns(), r_rec.delay_breakdowns()
    assert {k: b.as_dict() for k, b in p_bds.items()} == \
        {k: b.as_dict() for k, b in r_bds.items()}
    return p_bds


def test_recorder_matches_reference_on_a_hand_written_stream():
    bds = _held_to_reference(_feed(TrafficRecorder()), _feed(RRecorder()))
    assert sorted(bds) == [0, 1, 2]            # 3 and 4 are in flight
    assert bds[1].n_preempts == 1 and bds[2].prefill > 1


def test_recorder_refusals_match_reference():
    for rec in (TrafficRecorder(), RRecorder()):
        with pytest.raises(ValueError, match="ue must be >= 0"):
            rec.record_submit(0, 0, ue=-1)
        with pytest.raises(ValueError, match="unknown event"):
            rec.timestamps("preempt")
        with pytest.raises(ValueError, match="no 'submit' events"):
            rec.to_trace(2)
        with pytest.raises(ValueError, match="bin_ticks"):
            rec.to_trace(2, bin_ticks=0, horizon=3)
        assert rec.latency_stats() == {"n": 0}


@pytest.fixture(scope="module")
def model():
    r_cfg = r_reduced(r_get_config("qwen3-0.6b"), n_layers=2)
    p_cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), n_layers=2)
    r_params = r_tf.init_params(jax.random.PRNGKey(1), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


# engine kwargs: both modes; a pool that preempts; chunks of 8
ENGINE_RECORDER_CASES = {
    "sync": dict(slots=2, s_max=48, sync_batching=True),
    "continuous": dict(slots=2, s_max=48),
    "preempt_and_chunk": dict(slots=3, s_max=48, kv_block=4, kv_blocks=10,
                              prefill_chunk=8),
}


def _serve(module, rec_cls, cfg, params, kwargs):
    """Bursty submits over 12 ticks (prompts of 3-30 tokens, 2-9 new,
    UEs 0-4 or none), then drain."""
    rng = np.random.default_rng(17)
    rec = rec_cls()
    eng = module.ServingEngine(cfg, params, recorder=rec, **kwargs)
    rid = 0
    for tick in range(12):
        for _ in range(int(rng.poisson(1.6 if tick < 4 else 0.4))):
            ue = int(rng.integers(0, 6))
            eng.submit(module.Request(
                rid=rid, prompt=rng.integers(0, cfg.vocab, int(
                    rng.integers(3, 31))).astype(np.int32),
                max_new=int(rng.integers(2, 10)), ue=None if ue == 5 else ue))
            rid += 1
        eng.step()
    eng.run_until_idle()
    return eng, rec


@pytest.mark.parametrize("case", sorted(ENGINE_RECORDER_CASES))
def test_recorder_on_the_engines_matches_reference(model, case):
    r_cfg, p_cfg, r_params, p_params = model
    kwargs = ENGINE_RECORDER_CASES[case]
    r_eng, r_rec = _serve(r_engine, RRecorder, r_cfg, r_params, kwargs)
    p_eng, p_rec = _serve(p_engine, TrafficRecorder, p_cfg, p_params, kwargs)
    assert p_eng.clock == r_eng.clock
    bds = _held_to_reference(p_rec, r_rec, n_ue=4)
    assert len(bds) == len(p_rec.events) >= 6
    for rid, b in bds.items():
        ev = p_rec.events[rid]
        assert b.e2e == ev.complete - ev.submit
    if case == "preempt_and_chunk":
        assert p_eng.preemptions > 0 and p_eng.chunk_steps > 0
        assert any(b.n_preempts for b in bds.values())


def test_traffic_demo_main_on_cpu(tmp_path, capsys):
    path = tmp_path / "serving_trace.npz"
    rep = traffic_demo.main(["--device", "cpu", "--layers", "2", "--ticks",
                             "30", "--cells", "4", "--steps", "6",
                             "--trace-out", str(path)])
    out = capsys.readouterr().out
    assert "== replay: 4-cell batched grid" in out
    eng, reqs, trace = rep["engine"], rep["requests"], rep["trace"]
    assert reqs and all(r.done and len(r.out) == 2 for r in reqs)
    assert trace.rates.shape == (15, 4)
    assert float(trace.rates.sum()) == len(reqs)
    loaded = rep["loaded"]
    np.testing.assert_array_equal(loaded.rates, trace.rates)
    assert loaded.meta == trace.meta
    assert rep["stages"]["e2e"]["n"] == len(reqs)
    assert tuple(rep["results"].reward.shape) == (6, 4)
    assert np.isfinite(rep["metrics"]["delay"]).all()
    snap = eng.obs.metrics.snapshot()
    assert snap['serving_completed_total{engine="continuous"}'] == len(reqs)
    from repro_torch.traffic.__main__ import main as traffic_cli
    assert traffic_cli(["--show", str(path)]) == 0
    assert "T=15 slots x N=4 UEs" in capsys.readouterr().out
    assert traffic_cli(["--list"]) == 0
    assert "trace_replay:" in capsys.readouterr().out
