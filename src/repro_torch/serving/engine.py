"""Serving engine for the edge tier: continuous batching over a paged KV
cache, with the synchronized-batch engine kept as a compat mode.

Port of ``repro/serving/engine.py``.  Requests arrive
continuously (the paper's serial queuing model), so the default engine
admits per tick: a queued request prefills SOLO into a free decode slot
(batch 1, left-padded to its bucket width) while the other slots keep
decoding, and its KV lands in blocks handed out by
``kvpool.BlockAllocator``.  Each slot carries its own cache length, and one
``transformer.decode_step_paged`` call advances every active slot.  When a
slot outgrows its blocks and the pool is dry, the youngest admitted request
is preempted back to the front of the queue; greedy decode is
deterministic, so re-admission gives the same tokens.

``sync_batching=True`` is the old engine: admission waits for ALL slots to
drain, the next wave of prompts prefills as one left-padded batch whose pad
vector rides in a dense (slots, s_max) cache, and ``transformer.
decode_step`` advances the wave.  Kept for A/B latency baselines.

Prompts longer than ``prefill_chunk`` ("auto": 32 when ``s_max > 32``)
stream through ``transformer.prefill_chunk`` one chunk per tick, each chunk
committed into the slot's blocks (``kvpool.commit_chunk``), so a long prompt
never stalls the decoding slots for more than a chunk.  Stacks with MoE
("m") layers prefill whole prompts: capacity routing couples the tokens of
a dispatch group.  Both modes serve g/l/m/r/s stacks (``kvpool.
check_pattern``): requests carry tokens, not the context of "x"/"d".

Sliding-window ("l") and recurrent ("r", "s") layers keep one row of ring
or state per slot: every decode tick steps all rows, so an idle or
mid-stream slot's rows fill with garbage, which the commit that admits a
request there (or its stream's next chunk) overwrites whole.

There is no jit and no donation: the pool is updated in place.  Greedy
argmax runs on the device, so only the (B,) token ids reach the host each
tick.  A recorder (duck-typed, like ``repro_torch.traffic.recorder``) sees
submit / admit / prefill-done / preempt / complete in ticks of the step
clock.  ``telemetry=`` (a :class:`repro_torch.obs.Telemetry`) adds metrics
and spans at every lifecycle edge and per-tick gauges; ``sanitize=True``
adds the KV-pool shadow ownership checks and the dispatch guards of
``repro_torch.analysis.sanitize``.  Off, each costs one ``is None`` check
per site.

``mesh=`` (a mesh with a "model" axis: ``launch.mesh.make_cells_mesh(
model=M)``, ``make_host_mesh``, ``make_production_mesh``,
``elastic_mesh``) turns on tensor parallelism: every rank of the mesh runs
the same engine on the same requests, holding its shard of the weights
(``launch.sharding.place_params`` of the whole tree, or, for a model
larger than one card, the shard ``init_rank_params`` or a ``restore``
with ``params_shardings`` gives, passed with its ``RankConfig``) and of
the KV pool (the kv heads its query heads read), and
each tick runs under the mesh's activation-sharding context, where the
layers' collectives find the "model" sub-group.  The logits are gathered
whole before the argmax, so every rank takes the same tokens and the same
host decisions (admission, blocks, preemption), and the greedy tokens are
the unsharded engine's.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from .. import shardctx
from ..models import transformer
from . import kvpool


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    ue: int | None = None       # originating UE (traffic-trace binning)
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket_ladder(s_max: int, lo: int = 8) -> tuple[int, ...]:
    """Power-of-two prompt-width buckets up to s_max (always includes s_max)."""
    buckets = []
    w = lo
    while w < s_max:
        buckets.append(w)
        w *= 2
    buckets.append(s_max)
    return tuple(buckets)


class ServingEngine:
    """``sync_batching=False`` (default): continuous batching -- per-tick
    admission into free slots, paged KV (``kv_block`` tokens per block,
    ``kv_blocks`` pool blocks, by default enough for every slot to reach
    ``s_max``), youngest-request preemption when the pool runs dry, chunked
    prefill of long prompts.  ``sync_batching=True``: the synchronized-batch
    compat engine.  Runs on the device that holds ``params``.

    ``sanitize=True`` (debug; ``python -m repro_torch.analysis --sanitize``)
    shadows every block handoff with an ``analysis.sanitize.KVSanitizer``
    and guards every dispatch: block ids, commit ids and ``seq_lens`` are
    checked on the host before a dispatch that reads or writes the pool (an
    out-of-range block id would reach the paged decode kernel as an illegal
    address), and the logits are checked for NaN after each dispatch (one
    sync each).  Either guard raises ``SanitizerError`` at the dispatch.
    """

    def __init__(self, cfg, params, *, slots: int = 4, s_max: int = 128,
                 prefill_buckets=None, recorder=None, mesh=None,
                 sync_batching: bool = False, kv_block: int = 16,
                 kv_blocks: int | None = None, telemetry=None,
                 sanitize: bool = False, prefill_chunk="auto"):
        self.mesh = mesh
        if mesh is not None:
            from ..launch.sharding import SERVING, place_params
            params, cfg = place_params(mesh, cfg, params, SERVING)
        # token requests carry no context: both modes serve g/l/m/r/s only
        kvpool.check_pattern(cfg, sync=sync_batching)
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.slots = slots
        self.s_max = s_max
        self.sync_batching = sync_batching
        self.prefill_buckets = tuple(sorted(
            _bucket_ladder(s_max) if prefill_buckets is None
            else prefill_buckets))
        if not self.prefill_buckets or self.prefill_buckets[-1] > s_max:
            raise ValueError(f"prefill buckets {self.prefill_buckets} must be "
                             f"non-empty and <= s_max={s_max}")
        if prefill_chunk == "auto":
            prefill_chunk = 32 if s_max > 32 else None
        if prefill_chunk is not None and not 0 < int(prefill_chunk) <= s_max:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be in "
                             f"[1, s_max={s_max}], None, or 'auto'")
        if "m" in (*cfg.block_pattern, *cfg.tail_pattern):
            # capacity routing couples every token of a dispatch group, so a
            # chunk-local pass cannot give the whole-prompt routing: MoE
            # stacks keep whole-prompt prefill (transformer._layer_chunk)
            prefill_chunk = None
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        self.recorder = recorder
        self.clock = 0                       # engine ticks (step() calls)
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self._completed: list[Request] = []
        self.remaining = np.zeros(slots, np.int32)
        self.decode_steps = 0                # decode dispatches
        self.prefill_steps = 0               # prefills (solo or wave), chunks
        self.chunk_steps = 0                 # chunks after a stream's first
        self.chunk_tokens = 0                # prompt tokens of those chunks
        self.preemptions = 0                 # continuous mode only
        self.cache = None                    # sync mode's dense cache
        # (batch, width, ragged?) prefill shapes and the decode signatures
        # run so far: the reference compiles one program for each
        self._prefill_shapes: set[tuple] = set()
        self._decode_shapes: set[tuple] = set()
        self.obs = None
        if telemetry is not None:
            from ..obs.enginehooks import EngineHooks
            self.obs = EngineHooks(telemetry, self)
        self.sanitize = sanitize
        self._san = None                     # KVSanitizer (continuous mode)
        self._guards = None                  # the dispatch guards' module
        if sanitize:
            from ..analysis import sanitize as guards
            self._guards = guards
        if sync_batching:
            return

        self.kv_block = kv_block
        self.table_width = -(-s_max // kv_block)            # blocks per slot
        if kv_blocks is None:
            kv_blocks = slots * self.table_width + 1        # + the dummy
        self.allocator = kvpool.BlockAllocator(kv_blocks, kv_block)
        self._pool_state = kvpool.init_decode_state(cfg, params, slots,
                                                    kv_blocks, kv_block)
        self.block_tables = np.zeros((slots, self.table_width), np.int32)
        self.seq_lens = np.zeros(slots, np.int32)
        self.last_tokens = np.zeros(slots, np.int32)
        self.owned: list[list[int]] = [[] for _ in range(slots)]
        self._admit_seq = np.full(slots, -1, np.int64)      # admission order
        self._admit_counter = 0
        # chunked-prefill stream: at most ONE request mid-prefill
        self._stream_req: Request | None = None
        self._stream_slot = -1
        self._stream_cache = None            # device {units, tail} scratch
        self._stream_done = 0                # prompt tokens advanced so far
        self._stream_ids = None              # device (table_width,) block row
        if sanitize:
            self._san = self._guards.KVSanitizer(self)

    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill signatures run so far: one per (batch, bucket
        width, ragged-or-not) combination, the reference's compilations."""
        return len(self._prefill_shapes)

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def submit(self, req: Request):
        if req.ue is not None and req.ue < 0:
            raise ValueError(f"request {req.rid}: ue must be >= 0, got "
                             f"{req.ue}")
        n = len(req.prompt)
        if n + max(req.max_new, 1) - 1 > self.s_max:
            raise ValueError(
                f"request {req.rid}: prompt width {n} + decode budget "
                f"{req.max_new} exceeds s_max={self.s_max}")
        self.queue.append(req)
        if self.recorder is not None:
            self.recorder.record_submit(req.rid, self.clock, ue=req.ue)
        if self.obs is not None:
            self.obs.on_submit(req, self.clock)

    def _bucket_width(self, width: int, max_new: int) -> int:
        """Smallest bucket >= width that still leaves ``max_new`` tokens;
        the exact width where no bucket fits."""
        limit = self.s_max - max_new + 1
        if width > limit:
            raise ValueError(
                f"prompt width {width} + decode budget {max_new} exceeds "
                f"s_max={self.s_max}")
        for b in self.prefill_buckets:
            if b >= width and b <= limit:
                return b
        return width

    # -- lifecycle ------------------------------------------------------------

    def _complete(self, req: Request):
        req.done = True
        self._completed.append(req)
        if self.recorder is not None:
            self.recorder.record_complete(req.rid, self.clock)
        if self.obs is not None:
            self.obs.on_complete(req, self.clock)

    def _record_prefill_done(self, rid: int):
        rec = getattr(self.recorder, "record_prefill_done", None)
        if rec is not None:
            rec(rid, self.clock)
        if self.obs is not None:
            self.obs.on_prefill_done(rid, self.clock)

    def _complete_at_admission(self, req: Request):
        """max_new <= 1: the one token (if any) came from the prefill, so
        the request completes at its admission tick without a slot."""
        self._record_admit(req)
        self._record_prefill_done(req.rid)
        self._complete(req)

    def _record_admit(self, req: Request):
        if self.recorder is not None:
            self.recorder.record_admit(req.rid, self.clock)
        if self.obs is not None:
            self.obs.on_admit(req, self.clock)

    def _finite(self, what: str, logits):
        """Sanitize mode's NaN guard on a dispatch's logits."""
        if self._guards is not None:
            self._guards.guard_finite(what, logits)

    def _solo_prefill(self, req: Request):
        """Batch-1 bucketed prefill.  Returns (next token, cache, pad)."""
        n = len(req.prompt)
        width = self._bucket_width(n, max(req.max_new, 1))
        toks = np.pad(np.asarray(req.prompt), (width - n, 0))[None]
        pad = width - n
        pad_arg = self._tensor([pad], torch.int32) if pad else None
        self._prefill_shapes.add((1, width, pad_arg is not None))
        t0 = self.obs.now() if self.obs is not None else 0.0
        logits, cache = transformer.prefill(
            self.params, self.cfg, {"tokens": self._tensor(toks)},
            s_max=self.s_max, pad=pad_arg)
        self.prefill_steps += 1
        self._finite("prefill", logits)
        # admission's one sync: a single token id
        nxt = int(torch.argmax(logits[0], -1))  # reprolint: ignore[host-sync]
        if self.obs is not None:
            self.obs.on_prefill(self, t0, batch=1, width=width)
        # a sequence-split cache goes into the pool's layout: one
        # all-gather an admission (``transformer.pool_layout``)
        return nxt, transformer.pool_layout(
            self.cfg, {"units": cache["units"], "tail": cache["tail"]}), pad

    def _admit_continuous(self):
        """Admit from the queue head into free slots, one solo prefill per
        request, until slots or blocks run out (strict FIFO).  While a
        chunked prefill streams, this tick's admission work is its next
        chunk and nothing else."""
        if self._stream_req is not None:
            self._advance_stream()
            return
        while self.queue:
            req = self.queue[0]
            n = len(req.prompt)
            if req.max_new <= 0:
                self.queue.popleft()
                self._complete_at_admission(req)
                continue
            if req.max_new == 1:
                self.queue.popleft()
                nxt, _, _ = self._solo_prefill(req)
                req.out.append(nxt)
                self._complete_at_admission(req)
                continue
            free = [i for i, r in enumerate(self.active) if r is None]
            if not free:
                return
            total = kvpool.blocks_for(n + req.max_new - 1, self.kv_block)
            if total > self.allocator.capacity:
                raise ValueError(
                    f"request {req.rid} needs {total} KV blocks "
                    f"({n} prompt + {req.max_new} decode tokens) but the "
                    f"pool holds {self.allocator.capacity}")
            blocks = self.allocator.alloc(kvpool.blocks_for(n, self.kv_block))
            if blocks is None:
                return                       # pool full: wait for completions
            self.queue.popleft()
            slot = free[0]
            try:
                if self.prefill_chunk is not None and n > self.prefill_chunk:
                    self._start_stream(req, slot, blocks)
                    return               # one chunk of prefill work per tick
                nxt, cache, pad = self._solo_prefill(req)
            except Exception:
                self.allocator.free(blocks)
                self.queue.appendleft(req)
                raise
            width = n + pad
            ids = np.zeros(-(-width // self.kv_block), np.int64)
            ids[:len(blocks)] = blocks       # slack blocks -> dummy block 0
            if self._guards is not None:
                self._guards.guard_blocks(self, "commit_prefill", ids)
            kvpool.commit_prefill(self._pool_state, cache, pad, slot,
                                  self._tensor(ids), block_size=self.kv_block)
            req.out.append(nxt)
            self._occupy(slot, req, blocks, seq_len=n, last=nxt)
            self._record_admit(req)
            self._record_prefill_done(req.rid)

    def _occupy(self, slot: int, req: Request, blocks, *, seq_len: int,
                last: int):
        self.active[slot] = req
        self.owned[slot] = list(blocks)
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :len(blocks)] = blocks
        self.seq_lens[slot] = seq_len
        self.last_tokens[slot] = last
        self.remaining[slot] = req.max_new - 1
        self._admit_seq[slot] = self._admit_counter
        self._admit_counter += 1
        if self._san is not None:
            self._san.on_alloc(slot, blocks)

    def _start_stream(self, req: Request, slot: int, blocks):
        """Begin a chunked prefill: chunk 1 is a plain batch-1 prefill at the
        chunk width (its KV scratch is ``s_max`` long, so it is the stream's
        resumable cache), committed into the slot's blocks.  The slot stays
        out of the decode dispatch (seq_len 0, a dummy table row) until the
        last chunk lands."""
        c = self.prefill_chunk
        toks = np.asarray(req.prompt, np.int32)[None, :c]
        self._prefill_shapes.add((1, c, False))
        t0 = self.obs.now() if self.obs is not None else 0.0
        logits, cache = transformer.prefill(self.params, self.cfg,
                                            {"tokens": self._tensor(toks)},
                                            s_max=self.s_max)
        self.prefill_steps += 1
        self._finite("prefill", logits)
        cache = {"units": cache["units"], "tail": cache["tail"]}
        if self.obs is not None:
            self.obs.on_prefill(self, t0, batch=1, width=c, chunked=True)
        ids = np.zeros(self.table_width, np.int64)
        ids[:len(blocks)] = blocks
        if self._guards is not None:
            self._guards.guard_blocks(self, "commit_chunk", ids, [c - 1])
        self._stream_ids = self._tensor(ids)
        kvpool.commit_chunk(self._pool_state,
                            transformer.pool_layout(self.cfg, cache), 0, c,
                            slot, self._stream_ids, block_size=self.kv_block)
        self._stream_req, self._stream_slot = req, slot
        self._stream_cache, self._stream_done = cache, c
        self._occupy(slot, req, blocks, seq_len=0, last=0)
        self._record_admit(req)

    def _advance_stream(self):
        """One chunk of the streaming request's prefill; the last chunk's
        logits are the whole-prompt logits, so its argmax is the first
        token and the slot joins this tick's decode dispatch."""
        req, slot, c = self._stream_req, self._stream_slot, self.prefill_chunk
        n = len(req.prompt)
        start = self._stream_done
        n_valid = min(c, n - start)
        chunk = np.zeros((1, c), np.int64)
        chunk[0, :n_valid] = req.prompt[start:start + n_valid]
        t0 = self.obs.now() if self.obs is not None else 0.0
        logits, cache = transformer.prefill_chunk(
            self.params, self.cfg, self._stream_cache, self._tensor(chunk),
            start, n_valid)
        self.prefill_steps += 1
        self.chunk_steps += 1
        self.chunk_tokens += n_valid
        self._finite("prefill_chunk", logits)
        if self._guards is not None:
            self._guards.guard_blocks(self, "commit_chunk", self._stream_ids,
                                      [start + n_valid - 1])
        kvpool.commit_chunk(self._pool_state,
                            transformer.pool_layout(self.cfg, cache), start,
                            n_valid, slot, self._stream_ids,
                            block_size=self.kv_block)
        if self.obs is not None:
            self.obs.on_prefill(self, t0, batch=1, width=c, chunked=True)
        self._stream_cache = cache
        self._stream_done = start + n_valid
        if self._stream_done < n:
            return
        nxt = int(torch.argmax(logits[0], -1))   # the stream's one sync
        req.out.append(nxt)
        self.seq_lens[slot] = n
        self.last_tokens[slot] = nxt
        self._end_stream()
        self._record_prefill_done(req.rid)

    def _end_stream(self):
        self._stream_req, self._stream_slot = None, -1
        self._stream_cache, self._stream_done = None, 0
        self._stream_ids = None

    def _release_slot(self, slot: int):
        if self._san is not None:
            self._san.on_free(slot, self.owned[slot])
        self.allocator.free(self.owned[slot])
        self.owned[slot] = []
        self.block_tables[slot, :] = 0
        self.seq_lens[slot] = 0
        self.last_tokens[slot] = 0
        self.remaining[slot] = 0
        self._admit_seq[slot] = -1
        self.active[slot] = None

    def _preempt(self, slot: int):
        """Evict the request in ``slot`` to the FRONT of the queue,
        discarding its output and KV (recompute-style preemption)."""
        req = self.active[slot]
        if slot == self._stream_slot:
            self._end_stream()           # the stream restarts from chunk 1
        req.out.clear()
        self._release_slot(slot)
        self.queue.appendleft(req)
        self.preemptions += 1
        rec_preempt = getattr(self.recorder, "record_preempt", None)
        if rec_preempt is not None:
            rec_preempt(req.rid, self.clock)
        if self.obs is not None:
            self.obs.on_preempt(req, self.clock)

    def _grow_blocks(self):
        """Before a decode tick, give every active slot the block its next
        KV write lands in; oldest first, preempting the youngest when the
        pool is dry."""
        order = sorted((i for i, r in enumerate(self.active) if r is not None),
                       key=lambda i: self._admit_seq[i])
        for slot in order:
            if self.active[slot] is None:    # preempted below, mid-loop
                continue
            bidx = int(self.seq_lens[slot]) // self.kv_block
            if bidx < len(self.owned[slot]):
                continue
            while True:
                got = self.allocator.alloc(1)
                if got is not None:
                    self.owned[slot].append(got[0])
                    self.block_tables[slot, bidx] = got[0]
                    if self._san is not None:
                        self._san.on_alloc(slot, got)
                    if self.obs is not None:
                        self.obs.on_block_grow()
                    break
                victim = max(
                    (j for j, r in enumerate(self.active) if r is not None),
                    key=lambda j: self._admit_seq[j])
                self._preempt(victim)
                if victim == slot:
                    break                    # this slot went back to queue

    def _step_continuous(self) -> bool:
        self._admit_continuous()
        self._grow_blocks()
        live = [i for i, r in enumerate(self.active)
                if r is not None and i != self._stream_slot]
        # per-tick telemetry is sampled by clock stride, inline, so that
        # ticks off the stride make no call at all
        obs = self.obs
        sampled = obs is not None and self.clock % obs.sample_every == 0
        if sampled:                      # host-state gauges (queue, KV pool)
            obs.sample(self)
        if not live:
            return self._stream_req is not None or bool(self.queue)
        t0 = obs.now() if sampled else 0.0
        table = self.block_tables
        if self._stream_req is not None:
            # the mid-prefill slot rides the dispatch as an idle row whose
            # zeroed table row sends its writes to the dummy block 0
            table = table.copy()
            table[self._stream_slot] = 0
        if self._guards is not None:
            self._guards.guard_blocks(self, "decode_step_paged", table,
                                      self.seq_lens)
        self._decode_shapes.add(table.shape)
        logits, self._pool_state = transformer.decode_step_paged(
            self.params, self.cfg, self._pool_state,
            self._tensor(self.last_tokens), self._tensor(table),
            self._tensor(self.seq_lens))
        self.decode_steps += 1
        self._finite("decode_step_paged", logits)
        # the tick's one sync: (slots,) token ids
        nxt = torch.argmax(logits, -1).cpu().numpy()  # reprolint: ignore[host-sync]
        if sampled:
            obs.on_decode_tick(self, t0, len(live))
        for i in live:
            req = self.active[i]
            self.seq_lens[i] += 1
            self.last_tokens[i] = nxt[i]
            req.out.append(int(nxt[i]))
            self.remaining[i] -= 1
            if self.remaining[i] <= 0:
                self._release_slot(i)
                self._complete(req)
        if self._san is not None:
            self._san.check_tick()
        return True

    # -- synchronized-batch compat mode ---------------------------------------

    def _admit_sync(self):
        """Compat-mode admission: wait until ALL slots are free, then
        prefill the next wave as one left-padded batch (the pad vector
        rides in the cache, so decode keeps masking it)."""
        if any(r is not None for r in self.active) or not self.queue:
            return
        # Greedy wave build under PER-REQUEST budgets: the shared width w
        # must cover every prompt and leave each member its decode room
        # (w + max_new - 1 <= s_max); a request joins the wave only while
        # such a width exists, and otherwise starts the next wave.
        batch = []
        need, cap = 0, self.s_max + 1
        while self.queue and len(batch) < self.slots:
            r = self.queue[0]
            r_need = max(need, len(r.prompt))
            r_cap = min(cap, self.s_max + 1 - max(r.max_new, 1))
            if batch and r_need > r_cap:
                break                        # r starts the next wave
            batch.append(self.queue.popleft())
            need, cap = r_need, r_cap
        while len(batch) < self.slots:       # pad with a copy (masked out)
            batch.append(Request(rid=-1, prompt=batch[0].prompt, max_new=0))
        width = self._bucket_width(need, self.s_max + 1 - cap)
        toks = np.stack([np.pad(np.asarray(r.prompt), (width - len(r.prompt), 0))
                         for r in batch])    # left-pad to the bucket width
        pad = np.asarray([width - len(r.prompt) for r in batch], np.int32)
        # a pad-free wave takes no mask, and its cache carries no "pad"
        pad_arg = self._tensor(pad, torch.int32) if pad.any() else None
        self._prefill_shapes.add(toks.shape + (pad_arg is not None,))
        t0 = self.obs.now() if self.obs is not None else 0.0
        logits, self.cache = transformer.prefill(
            self.params, self.cfg, {"tokens": self._tensor(toks)},
            s_max=self.s_max, pad=pad_arg)
        self.prefill_steps += 1
        self._finite("prefill", logits)
        # admission's one sync: (slots,) token ids
        nxt = torch.argmax(logits, -1).cpu().numpy()  # reprolint: ignore[host-sync]
        if self.obs is not None:
            self.obs.on_prefill(self, t0, batch=len(batch), width=width)
        for i, r in enumerate(batch):
            self.active[i] = r if r.rid >= 0 else None
            self.remaining[i] = r.max_new
            if r.rid < 0:
                continue
            self._record_admit(r)
            self._record_prefill_done(r.rid)
            if r.max_new > 0:
                r.out.append(int(nxt[i]))
                self.remaining[i] -= 1
            if self.remaining[i] <= 0:
                # budget used up by the prefill logits alone: complete at
                # the admission tick, without a decode step
                self.active[i] = None
                self._complete(r)
        self._last = nxt

    def _step_sync(self) -> bool:
        self._admit_sync()
        obs = self.obs                   # sampled, as in _step_continuous
        sampled = obs is not None and self.clock % obs.sample_every == 0
        if sampled:
            obs.sample(self)
        if self.cache is None or all(r is None for r in self.active):
            self.cache = None
            return bool(self.queue)
        live = sum(1 for r in self.active if r is not None)
        t0 = obs.now() if sampled else 0.0
        self._decode_shapes.add((self.slots, "pad" in self.cache))
        logits, self.cache = transformer.decode_step(
            self.params, self.cfg, self.cache, self._tensor(self._last))
        self.decode_steps += 1
        self._finite("decode_step", logits)
        # the tick's one sync: (slots,) token ids
        nxt = torch.argmax(logits, -1).cpu().numpy()  # reprolint: ignore[host-sync]
        if sampled:
            obs.on_decode_tick(self, t0, live)
        self._last = nxt
        alive = False
        for i, r in enumerate(self.active):
            if r is None:
                continue
            if self.remaining[i] > 0:
                r.out.append(int(nxt[i]))
                self.remaining[i] -= 1
            if self.remaining[i] <= 0:
                self.active[i] = None
                self._complete(r)
            else:
                alive = True
        if not alive and not self.queue:
            self.cache = None
        return True

    # -- stepping the engine --------------------------------------------------

    def step(self) -> bool:
        """One engine tick.  Returns False when idle.  The clock advances on
        every call, idle ticks included."""
        self.clock += 1
        with shardctx.mesh_context(self.mesh):
            if self.sync_batching:
                return self._step_sync()
            alive = self._step_continuous()
        if self._san is not None and not alive:
            self._san.check_drain()         # idle engine: pool fully drained
        return alive

    def pop_completed(self) -> list[Request]:
        """Drain and return the requests finished since the last drain."""
        finished, self._completed = self._completed, []
        return finished

    def run_until_idle(self, max_steps: int = 10_000) -> list[Request]:
        """Step until the queue and all slots drain; return every request
        completed since the last drain.  Raises RuntimeError when
        ``max_steps`` ticks pass with work pending."""
        for _ in range(max_steps):
            if not self.step():
                return self.pop_completed()
        raise RuntimeError(
            f"engine did not drain within max_steps={max_steps}: "
            f"{len(self.queue)} request(s) still queued, "
            f"{sum(r is not None for r in self.active)} slot(s) active")
