"""Engine-facing telemetry hooks: metric handles + lifecycle callbacks.

Port of ``repro/obs/enginehooks.py``, with the same metric names, help
strings, labels and buckets.  One :class:`EngineHooks` instance per
:class:`ServingEngine` (built when the engine is handed a ``telemetry=``
object; ``engine.obs is None`` otherwise, so the disabled path costs one
attribute check per call site).

Every callback reads ONLY host-side state the engine already holds -- its
numpy arrays (``seq_lens``, ``remaining``), Python containers (``queue``,
``owned``), the allocator free list, and the already-synced int token ids.
Telemetry never adds a device->host round trip to the tick path.

The reference reads its jit caches for the compile gauges.  The port has
no jit: ``serving_prefill_compiles`` reads the engine's set of prefill
shapes and ``serving_decode_compiles`` its set of decode signatures
(``engine._decode_shapes``), the programs the reference would compile --
one decode signature in steady state, as there.
"""
from __future__ import annotations

from .metrics import log_buckets

# tick-latency histograms: 1..4096 ticks, x2 resolution
TICK_BUCKETS = log_buckets(1.0, 4096.0, base=2.0)
# wall-seconds histograms: 100us..~1.6s, x2 resolution
SECONDS_BUCKETS = log_buckets(1e-4, 1.6, base=2.0)


class EngineHooks:
    """Metric handles + per-edge callbacks for one engine instance."""

    def __init__(self, telemetry, engine):
        self.tracer = telemetry.tracer
        m = telemetry.metrics
        self.metrics = m
        mode = "sync" if engine.sync_batching else "continuous"
        lbl = {"engine": mode}
        self.submitted = m.counter(
            "serving_submitted_total", "requests entering the queue", **lbl)
        self.admitted = m.counter(
            "serving_admitted_total",
            "admissions (one bucketed prefill each; re-admissions after "
            "preemption count again)", **lbl)
        self.completed = m.counter(
            "serving_completed_total", "requests finished decoding", **lbl)
        self.preempted = m.counter(
            "serving_preemptions_total",
            "youngest-request evictions back to the queue head", **lbl)
        self.decode_ticks = m.counter(
            "serving_decode_steps_total", "jitted decode dispatches", **lbl)
        self.tokens = m.counter(
            "serving_tokens_total", "tokens delivered by completed requests",
            **lbl)
        self.chunk_steps = m.counter(
            "serving_prefill_chunks_total",
            "chunked-prefill chunk dispatches (whole-prompt prefills do "
            "not count here)", **lbl)
        self.block_grows = m.counter(
            "kvpool_block_grows_total",
            "KV blocks appended to active slots mid-decode", **lbl)
        self.queue_depth = m.gauge(
            "serving_queue_depth", "requests waiting in the queue", **lbl)
        self.active_slots = m.gauge(
            "serving_active_slots", "decode slots holding a request", **lbl)
        self.prefill_compiles = m.gauge(
            "serving_prefill_compiles",
            "distinct prefill signatures traced (== jit compilations)",
            **lbl)
        self.decode_compiles = m.gauge(
            "serving_decode_compiles",
            "decode jit cache entries (steady state: 1)", **lbl)
        self.pool_free = m.gauge(
            "kvpool_blocks_free", "allocatable KV blocks", **lbl)
        self.pool_util = m.gauge(
            "kvpool_utilization", "allocated / capacity blocks", **lbl)
        self.pool_frag = m.gauge(
            "kvpool_fragmentation",
            "wasted token slots in allocated blocks / allocated token "
            "capacity (internal fragmentation)", **lbl)
        self.e2e_hist = m.histogram(
            "serving_e2e_ticks", "submit->complete latency",
            buckets=TICK_BUCKETS, **lbl)
        self.wait_hist = m.histogram(
            "serving_queue_wait_ticks",
            "queued ticks before each admission (excluding the admit tick)",
            buckets=TICK_BUCKETS, **lbl)
        self.prefill_hist = m.histogram(
            "serving_prefill_seconds", "wall time of one bucketed prefill "
            "dispatch (incl. its sanctioned sync)",
            buckets=SECONDS_BUCKETS, **lbl)
        self.tick_hist = m.histogram(
            "serving_decode_tick_seconds", "wall time of one decode "
            "dispatch (incl. its sanctioned sync)",
            buckets=SECONDS_BUCKETS, **lbl)
        # rid -> tick of first submit / latest enqueue (submit or preempt)
        self._submit_tick: dict[int, int] = {}
        self._enqueue_tick: dict[int, int] = {}
        # per-tick sampling stride, read by the engine's step functions as
        # an inline `clock % sample_every` check (even an early-returning
        # method call costs us-scale on the cold post-dispatch path);
        # lifecycle-edge callbacks fire on every edge regardless
        self.sample_every = max(1, int(getattr(telemetry,
                                               "sample_every", 16)))
        self._last_steps = engine.decode_steps
        self._engine = engine

    def now(self) -> float:
        """Tracer-clock stamp (us); pass back into on_prefill/on_decode_tick
        as the region start."""
        return self.tracer.now_us()

    # -- lifecycle edges -----------------------------------------------------

    def on_submit(self, req, tick: int) -> None:
        self.submitted.inc()
        self._submit_tick.setdefault(req.rid, tick)
        self._enqueue_tick[req.rid] = tick
        self.tracer.instant("submit", cat="lifecycle", rid=req.rid)

    def on_admit(self, req, tick: int) -> None:
        self.admitted.inc()
        enq = self._enqueue_tick.get(req.rid, tick)
        self.wait_hist.observe(max(tick - enq - 1, 0))
        self.tracer.instant("admit", cat="lifecycle", rid=req.rid)

    def on_prefill_done(self, rid: int, tick: int) -> None:
        """Prompt fully prefilled, first token sampled.  Same tick as the
        admit for whole-prompt prefill; the close of the multi-tick
        admit..done window for chunked prefill (breakdown.py's prefill
        stage)."""
        self.tracer.instant("prefill_done", cat="lifecycle", rid=rid)

    def on_preempt(self, req, tick: int) -> None:
        self.preempted.inc()
        self._enqueue_tick[req.rid] = tick
        self.tracer.instant("preempt", cat="lifecycle", rid=req.rid)

    def on_block_grow(self, n: int = 1) -> None:
        self.block_grows.inc(n)

    def on_complete(self, req, tick: int) -> None:
        self.completed.inc()
        self.tokens.inc(len(req.out))
        # completions are rare: flush the sampled decode-step delta here so
        # the counter is exact once a batch drains, not sample_every behind
        self.decode_ticks.inc(self._engine.decode_steps - self._last_steps)
        self._last_steps = self._engine.decode_steps
        sub = self._submit_tick.pop(req.rid, tick)
        self._enqueue_tick.pop(req.rid, None)
        self.e2e_hist.observe(tick - sub)
        self.tracer.instant("complete", cat="lifecycle", rid=req.rid,
                            e2e_ticks=tick - sub)

    # -- per-tick sampling ------------------------------------------------------

    def on_prefill(self, engine, t0_us: float, *, batch: int,
                   width: int, chunked: bool = False) -> None:
        """After a prefill dispatch + its sanctioned int sync: span + wall
        histogram + compile-count gauge (the engine's prefill shapes).
        ``chunked=True`` marks one chunk dispatch of a streaming prefill
        (width == the chunk size, not the prompt)."""
        t1 = self.tracer.now_us()
        self.prefill_hist.observe((t1 - t0_us) / 1e6)
        self.prefill_compiles.set(engine.prefill_compiles)
        if chunked:
            self.chunk_steps.inc()
        self.tracer.complete("prefill", t0_us, t1, batch=batch, width=width,
                             chunked=chunked)

    def on_decode_tick(self, engine, t0_us: float, live: int) -> None:
        """After a decode dispatch + its sanctioned (slots,) int sync.

        The engine calls this on SAMPLED ticks only (clock stride
        ``sample_every``): the wall-time histogram takes an exemplar
        observation, the tracer records a ``decode_tick`` span, and
        ``serving_decode_steps_total`` catches up exactly by delta against
        ``engine.decode_steps`` (the engine's own dispatch counter,
        incremented before this hook) -- exact at every sampled tick and
        at every completion (``on_complete`` flushes) despite the stride.
        ``Telemetry(sample_every=1)`` makes every tick a sampled tick.
        """
        t1 = self.tracer.now_us()
        self.decode_ticks.inc(engine.decode_steps - self._last_steps)
        self._last_steps = engine.decode_steps
        self.tick_hist.observe((t1 - t0_us) / 1e6)
        self.tracer.complete("decode_tick", t0_us, t1, live=live)

    def sample(self, engine) -> None:
        """Point-in-time gauges from state the engine already holds on
        host; the engine calls this on sampled ticks only (clock stride
        ``sample_every``, default 16).  Gauges are point-in-time reads --
        decimating them loses nothing the histograms/counters don't keep
        -- and even pure host reads cost real per-tick wall time when the
        decode step is a few hundred us (cold caches after each device
        dispatch), so the stride is what keeps the enabled-mode p50
        inside the overhead gate."""
        depth = len(engine.queue)
        busy = sum(1 for r in engine.active if r is not None)
        self.queue_depth.set(depth)
        self.active_slots.set(busy)
        self.tracer.counter("queue_depth", depth)
        if not engine.sync_batching:
            from ..serving.kvpool import pool_stats
            st = pool_stats(engine.allocator, engine.seq_lens, engine.owned)
            self.pool_free.set(st["n_free"])
            self.pool_util.set(st["utilization"])
            self.pool_frag.set(st["fragmentation"])
        if engine._decode_shapes:
            self.decode_compiles.set(len(engine._decode_shapes))
