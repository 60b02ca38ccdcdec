"""Port parity: the metrics registry, the span tracer, the delay breakdown
and the engine's telemetry.

The metric, tracer and breakdown cases of ``tests/test_obs.py`` run
against the port's modules, and the same observations must give the
reference's Prometheus text byte for byte.  The engines of both packages
serve the same schedule on the same weights (the reference's, carried
across) with ``Telemetry(sample_every=1)``: in both modes the metric
snapshots must be equal, except the two wall-time ``_seconds`` histograms,
whose counts must be equal; the tracer's events must be equal but for
their timestamps.  ``python -m repro_torch.obs`` runs on the CPU.
"""
import json

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.obs import Telemetry as RTelemetry
from repro.obs import breakdown as r_breakdown
from repro.obs import metrics as r_metrics
from repro.serving import engine as r_engine
from repro.traffic import TrafficRecorder as RRecorder
from repro_torch.configs import base as p_base
from repro_torch.models import transformer as p_tf
from repro_torch.obs import STAGES, Telemetry
from repro_torch.obs import metrics as p_metrics
from repro_torch.obs.breakdown import DelayBreakdown, from_events, stage_summary
from repro_torch.obs.metrics import (Counter, Histogram, MetricsRegistry,
                                     log_buckets)
from repro_torch.obs.tracer import SpanTracer
from repro_torch.serving import engine as p_engine
from repro_torch.traffic import TrafficRecorder

SECONDS = ("serving_prefill_seconds", "serving_decode_tick_seconds")


@pytest.fixture(scope="module")
def model():
    r_cfg = r_reduced(r_get_config("qwen3-0.6b"), n_layers=2)
    p_cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"), n_layers=2)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


# -- metrics registry ----------------------------------------------------------

def test_log_buckets():
    assert log_buckets(1.0, 8.0, base=2.0) == (1.0, 2.0, 4.0, 8.0)
    assert log_buckets(1.0, 9.0, base=2.0)[-1] >= 9.0
    for args in ((1e-4, 1.6, 2.0), (1.0, 4096.0, 2.0), (0.5, 3.0, 1.5)):
        assert log_buckets(*args) == r_metrics.log_buckets(*args)
    with pytest.raises(ValueError):
        log_buckets(0.0, 1.0)


def test_counter_semantics():
    c = Counter("x", "")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_histogram_bucket_boundaries():
    h = Histogram("x", "", buckets=[1, 2, 4, 8])
    for v in (2.0, 2.5, 9.0, 0.5):
        h.observe(v)
    cum = dict(h.cumulative())
    assert (cum["1"], cum["2"], cum["4"], cum["8"], cum["+Inf"]) == (1, 2, 3,
                                                                     3, 4)
    assert h.count == 4 and h.sum == pytest.approx(14.0)


def test_registry_get_or_create_and_kind_mismatch():
    m = MetricsRegistry()
    a = m.counter("reqs_total", "", engine="x")
    assert m.counter("reqs_total", engine="x") is a
    assert m.counter("reqs_total", engine="y") is not a
    with pytest.raises(ValueError):
        m.gauge("reqs_total", engine="x")


def _observe(module):
    """The same observations into a fresh registry of ``module``."""
    m = module.MetricsRegistry()
    m.counter("reqs_total", "requests", engine="c").inc(3)
    m.counter("reqs_total", "requests", engine="s").inc(0.5)
    m.gauge("depth", "queue depth").set(2)
    m.gauge("util", "").set(0.375)
    h = m.histogram("lat", "latency", buckets=[1, 2], engine="c")
    for v in (1.5, 0.25, 7.0, 2.0):
        h.observe(v)
    m.histogram("secs", "wall", buckets=module.log_buckets(1e-4, 1.6)
                ).observe(3e-3)
    return m


def test_prometheus_exposition_is_the_references_byte_for_byte():
    m = _observe(p_metrics)
    text = m.to_prometheus()
    assert text == _observe(r_metrics).to_prometheus()
    assert m.snapshot() == _observe(r_metrics).snapshot()
    assert 'lat_bucket{engine="c",le="+Inf"} 4' in text
    assert text.count("# TYPE reqs_total") == 1
    assert MetricsRegistry().to_prometheus() == ""


# -- span tracer ---------------------------------------------------------------

def test_tracer_chrome_roundtrip(tmp_path):
    tr = SpanTracer(capacity=16)
    tr.instant("submit", cat="lifecycle", rid=1)
    t0 = tr.now_us()
    tr.complete("decode_tick", t0, t0 + 100.0, live=2)
    tr.counter("queue_depth", 3)
    path = tmp_path / "trace.json"
    tr.export_chrome(path)
    doc = json.loads(path.read_text())
    assert doc["traceEvents"] == tr.to_chrome()["traceEvents"]
    assert SpanTracer.load_chrome(path) == doc["traceEvents"]
    assert [e["ph"] for e in doc["traceEvents"]] == ["i", "X", "C"]
    assert doc["traceEvents"][1]["dur"] == pytest.approx(100.0)
    bad = tmp_path / "bad.json"
    bad.write_text("[]")
    with pytest.raises(ValueError, match="not a Chrome trace"):
        SpanTracer.load_chrome(bad)


def test_tracer_jsonl_roundtrip(tmp_path):
    tr = SpanTracer(capacity=16)
    tr.instant("a")
    tr.instant("b", rid=7)
    path = tmp_path / "spans.jsonl"
    tr.export_jsonl(path)
    assert SpanTracer.load_jsonl(path) == tr.to_chrome()["traceEvents"]


def test_tracer_ring_buffer_bounded():
    tr = SpanTracer(capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    evs = tr.events()
    assert len(evs) == 4 and evs[-1]["name"] == "e9"
    with pytest.raises(ValueError):
        SpanTracer(capacity=0)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_tracer_span_contextmanager(device):
    """``device=True`` enters ``torch.profiler.record_function``: a torch
    profile taken around it shows the span's name."""
    import torch
    tr = SpanTracer(capacity=4)
    with torch.profiler.profile() as prof:
        with tr.span("work_span", device=device, tag="x"):
            torch.ones(4).sum()
    (ev,) = tr.events()
    assert ev["name"] == "work_span" and ev["ph"] == "X"
    assert ev["args"]["tag"] == "x" and ev["dur"] >= 0
    names = {e.key for e in prof.key_averages()}
    assert ("work_span" in names) == device


# -- delay breakdown algebra ---------------------------------------------------

BREAKDOWN_CASES = [
    dict(submit=0, admits=[3], preempts=[], complete=7),
    dict(submit=0, admits=[1], preempts=[], complete=1),
    dict(submit=0, admits=[2, 6], preempts=[5], complete=9),
    dict(submit=0, admits=[2], preempts=[], complete=9, prefill_dones=[5]),
    dict(submit=0, admits=[2, 6], preempts=[4], complete=9,
         prefill_dones=[8]),
    dict(submit=0, admits=[2, 6, 11], preempts=[5, 9], complete=15,
         prefill_dones=[3, 12]),
    dict(submit=0, admits=[2], preempts=[], complete=None),
]


@pytest.mark.parametrize("case", range(len(BREAKDOWN_CASES)))
def test_breakdown_matches_reference(case):
    kw = BREAKDOWN_CASES[case]
    got = from_events(1, **kw)
    want = r_breakdown.from_events(1, **kw)
    if want is None:
        assert got is None
        return
    assert got.as_dict() == want.as_dict()
    assert got.e2e == kw["complete"] - kw["submit"]


@pytest.mark.parametrize("kw,match", [
    (dict(submit=0, admits=[2], preempts=[], complete=9, prefill_dones=[1]),
     "outside"),
    (dict(submit=0, admits=[2, 4], preempts=[], complete=9), "admissions"),
    (dict(submit=5, admits=[2], preempts=[], complete=9), "non-causal"),
])
def test_breakdown_rejects_what_the_reference_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        from_events(1, **kw)
    with pytest.raises(ValueError, match=match):
        r_breakdown.from_events(1, **kw)


def test_stage_summary_matches_reference():
    assert stage_summary({})[STAGES[0]] == {"n": 0}
    bds = [DelayBreakdown(rid=i, queue_wait=i % 3, prefill=1 + i % 2,
                          decode=2 * i, preempted=i % 4, n_admits=1,
                          n_preempts=0) for i in range(9)]
    r_bds = [r_breakdown.DelayBreakdown(**{k: v for k, v in b.as_dict().items()
                                           if k != "e2e"}) for b in bds]
    assert stage_summary(bds) == r_breakdown.stage_summary(r_bds)
    assert set(stage_summary(bds)) == set(STAGES)


# -- engine telemetry, against the reference engine ----------------------------

def _drive(module, telemetry, recorder, cfg, params, *, sync, **engine_kw):
    """test_obs.py's bursty replay at stride 1."""
    rng = np.random.default_rng(3)
    eng = module.ServingEngine(cfg, params, slots=2, s_max=32,
                               recorder=recorder, sync_batching=sync,
                               telemetry=telemetry, **engine_kw)
    sched = sorted((int(rng.integers(0, 6)), i,
                    rng.integers(0, cfg.vocab, int(rng.integers(4, 11)))
                    .astype(np.int32), int(rng.integers(2, 7)))
                   for i in range(8))
    i = 0
    for _ in range(500):
        while i < len(sched) and sched[i][0] <= eng.clock:
            _, rid, p, m = sched[i]
            eng.submit(module.Request(rid=rid, prompt=p, max_new=m))
            i += 1
        busy = eng.step()
        if i == len(sched) and not busy:
            break
    return eng


def _untimed(events):
    """Tracer events without their timestamps and durations."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def _held_to_reference(p_tel, r_tel):
    p_snap, r_snap = p_tel.metrics.snapshot(), r_tel.metrics.snapshot()
    assert sorted(p_snap) == sorted(r_snap)
    for key, want in r_snap.items():
        if key.split("{")[0] in SECONDS:
            assert p_snap[key]["count"] == want["count"], key
        else:
            assert p_snap[key] == want, key
    assert _untimed(p_tel.tracer.events()) == _untimed(r_tel.tracer.events())
    return p_snap


ENGINE_TELEMETRY = {
    "continuous": dict(sync=False),
    "sync": dict(sync=True),
    "preempt": dict(sync=False, kv_block=4, kv_blocks=5),
    "chunked": dict(sync=False, prefill_chunk=4),
}


@pytest.mark.parametrize("case", sorted(ENGINE_TELEMETRY))
def test_engine_telemetry_matches_reference_engine(model, case):
    r_cfg, p_cfg, r_params, p_params = model
    kw = ENGINE_TELEMETRY[case]
    r_tel, p_tel = RTelemetry(sample_every=1), Telemetry(sample_every=1)
    r_rec, p_rec = RRecorder(), TrafficRecorder()
    r_eng = _drive(r_engine, r_tel, r_rec, r_cfg, r_params, **kw)
    p_eng = _drive(p_engine, p_tel, p_rec, p_cfg, p_params, **kw)
    assert p_eng.clock == r_eng.clock
    snap = _held_to_reference(p_tel, r_tel)
    mode = "sync" if kw["sync"] else "continuous"
    assert snap[f'serving_completed_total{{engine="{mode}"}}'] == 8
    assert snap[f'serving_decode_steps_total{{engine="{mode}"}}'] \
        == p_eng.decode_steps
    assert snap[f'serving_decode_compiles{{engine="{mode}"}}'] \
        == len(p_eng._decode_shapes) >= 1
    bds = p_rec.delay_breakdowns()
    assert len(bds) == 8
    assert all(b.e2e == p_rec.events[rid].complete - p_rec.events[rid].submit
               for rid, b in bds.items())
    if case == "preempt":
        assert p_eng.preemptions > 0
        assert snap['kvpool_block_grows_total{engine="continuous"}'] > 0
    if case == "chunked":
        assert snap['serving_prefill_chunks_total{engine="continuous"}'] > 0
    if not kw["sync"]:
        assert snap['kvpool_blocks_free{engine="continuous"}'] \
            == p_eng.allocator.capacity


def test_engine_telemetry_at_the_default_stride_matches_reference(model):
    """Gauges sampled every 16 ticks; counters exact after the drain."""
    r_cfg, p_cfg, r_params, p_params = model
    r_tel, p_tel = RTelemetry(), Telemetry()
    _drive(r_engine, r_tel, RRecorder(), r_cfg, r_params, sync=False)
    _drive(p_engine, p_tel, TrafficRecorder(), p_cfg, p_params, sync=False)
    _held_to_reference(p_tel, r_tel)


def test_grid_rollout_telemetry(model):
    from repro_torch.core.scenarios import ScenarioGrid, multicell_grid
    tel = Telemetry()
    grid = ScenarioGrid(multicell_grid(cells=3, ues=2, seed=0), device="cpu")
    _, _, summary = grid.rollout("local", steps=3, seed=0, telemetry=tel)
    assert summary["reward"].shape == (3,)
    snap = tel.metrics.snapshot()
    assert snap["grid_rollouts_total"] == 1
    assert snap["grid_slots_per_s"] > 0 and snap["grid_cells_per_s"] > 0
    (ev,) = tel.tracer.events()
    assert ev["name"] == "grid_rollout" and ev["args"] == {"cells": 3,
                                                           "steps": 3}


# -- CLI -----------------------------------------------------------------------

@pytest.mark.parametrize("sync", [False, True], ids=["continuous", "sync"])
def test_cli_smoke(tmp_path, capsys, sync):
    from repro_torch.obs.__main__ import main
    prom = tmp_path / "metrics.prom"
    trace = tmp_path / "trace.json"
    jsonl = tmp_path / "spans.jsonl"
    rc = main(["--device", "cpu", "--layers", "1", "--requests", "6",
               "--slots", "2", "--prom", str(prom), "--trace", str(trace),
               "--jsonl", str(jsonl), "--grid"] + (["--sync"] if sync else []))
    assert rc == 0
    out = capsys.readouterr().out
    assert "exactness: stage sums == recorded E2E for 6/6 requests OK" in out
    assert "grid_slots_per_s" in out
    text = prom.read_text()
    assert "# TYPE serving_e2e_ticks histogram" in text
    names = [line.split()[2] for line in text.splitlines()
             if line.startswith("# TYPE")]
    assert len(names) == len(set(names))
    assert SpanTracer.load_chrome(trace) == SpanTracer.load_jsonl(jsonl)


def test_cli_overhead_gate_runs(capsys):
    from repro_torch.obs.__main__ import main
    rc = main(["--device", "cpu", "--layers", "1", "--overhead",
               "--repeats", "2", "--gate", "10.0"])
    assert rc == 0
    assert "overhead gate: per-tick p50" in capsys.readouterr().out


def test_cli_overhead_gate_times_the_hooks(capsys):
    """The gate reads the time spent inside the hook calls: a gate of 0
    fails, since the hooks cost something, and the report names the
    hooks' share and the A/A delta of the two disabled pools."""
    from repro_torch.obs.__main__ import main
    rc = main(["--device", "cpu", "--layers", "1", "--overhead",
               "--repeats", "3", "--gate", "0"])
    out = capsys.readouterr().out
    assert rc == 1 and out.rstrip().endswith("FAIL")
    assert "A/A between the disabled pools" in out
    assert "% of the disabled p50" in out
