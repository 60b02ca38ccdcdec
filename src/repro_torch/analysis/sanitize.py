"""The sanitizer runtime: KV-pool memory safety and dispatch guards for
the serving engine.

Port of ``repro/analysis/sanitize.py``.

Static checks (layers 1-4) cannot see *scheduler interleavings*: a block
handed to two slots, a free of a block another request still decodes
from, or a live slot whose next KV write lands in the reserved dummy
block 0 only happen at runtime, under a particular admission/preemption
order.  ``ServingEngine(sanitize=True)`` turns on two guards:

* :class:`KVSanitizer` -- a shadow block-ownership map updated at every
  allocator handoff.  It raises :class:`SanitizerError` on double frees,
  frees of blocks the freeing slot does not own, cross-slot block
  aliasing, block-table rows that disagree with the ownership record,
  live slots whose ``seq_len`` outruns their owned blocks (the write
  would silently corrupt dummy block 0), and blocks still owned when the
  engine drains (leaks).  Every check is host-side integer bookkeeping
  over state the engine already holds -- no device syncs.

* dispatch guards, in place of the reference's ``checkify`` (which has
  no torch meaning): before every dispatch that reads or writes the pool,
  :func:`guard_blocks` checks on the host that each block-table entry,
  commit id and ``seq_lens`` value is in range -- on the card an
  out-of-range block id reaching the paged decode kernel is an illegal
  address, not an ``IndexError`` -- and after each dispatch
  :func:`guard_finite` checks the logits for NaN (one sync per dispatch).
  Both raise :class:`GuardError` at the dispatch site.

Both are DEBUG machinery: ``sanitize=False`` (the default) costs one
``is None`` check per lifecycle edge.

:func:`run_sanitize` is the CLI entry (``python -m repro_torch.analysis
--sanitize``): it drives a sanitized engine through a short flash-crowd
schedule sized to force block growth AND preemption, so the allocator
churns through every code path while the guards watch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


class SanitizerError(RuntimeError):
    """A KV-pool memory-safety invariant was violated."""


class GuardError(SanitizerError):
    """A dispatch guard fired: an index out of range before a dispatch, or
    a NaN in its logits after it."""


@dataclasses.dataclass(frozen=True)
class SanitizeFailure:
    check: str
    message: str

    def render(self) -> str:
        return f"sanitize [{self.check}]: {self.message}"


@dataclasses.dataclass(frozen=True)
class SanitizeReport:
    failures: tuple
    ticks: int
    requests: int
    preemptions: int
    block_churn: int          # total alloc+free events observed
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return not self.failures


class KVSanitizer:
    """Shadow ownership tracking for the paged KV pool.

    The engine calls :meth:`on_alloc` / :meth:`on_free` at every block
    handoff and :meth:`check_tick` / :meth:`check_drain` at tick/drain
    boundaries; any inconsistency between the shadow map, the engine's
    per-slot ``owned`` lists + block tables, and the allocator's own
    free/handed sets raises :class:`SanitizerError` immediately (fail
    fast: the corrupted state is the evidence).
    """

    def __init__(self, engine):
        self.eng = engine
        self.owner: dict[int, int] = {}          # block id -> owning slot
        self.events = 0                           # alloc/free churn counter

    # -- handoff hooks (called by the engine) -------------------------------

    def on_alloc(self, slot: int, blocks) -> None:
        self.events += len(blocks)
        for b in blocks:
            if b == 0:
                raise SanitizerError(
                    f"allocator handed out reserved dummy block 0 "
                    f"(slot {slot})")
            if b in self.owner:
                raise SanitizerError(
                    f"block {b} handed to slot {slot} while still owned by "
                    f"slot {self.owner[b]} (cross-slot aliasing)")
            self.owner[b] = slot

    def on_free(self, slot: int, blocks) -> None:
        self.events += len(blocks)
        for b in blocks:
            got = self.owner.get(b)
            if got is None:
                raise SanitizerError(
                    f"slot {slot} freed block {b} that no slot owns "
                    f"(double free or free-of-unowned)")
            if got != slot:
                raise SanitizerError(
                    f"slot {slot} freed block {b} owned by slot {got}")
            del self.owner[b]

    # -- boundary invariants ------------------------------------------------

    def check_tick(self) -> None:
        """Full cross-check at the end of one engine tick: engine block
        tables vs ``owned`` lists vs the shadow map vs the allocator."""
        eng = self.eng
        seen: dict[int, int] = {}
        for slot, blocks in enumerate(eng.owned):
            for b in blocks:
                if b in seen:
                    raise SanitizerError(
                        f"block {b} aliased: owned by slots {seen[b]} "
                        f"and {slot}")
                seen[b] = slot
                if self.owner.get(b) != slot:
                    raise SanitizerError(
                        f"shadow ownership of block {b} "
                        f"({self.owner.get(b)}) disagrees with engine slot "
                        f"{slot}")
            row = eng.block_tables[slot]
            if list(row[:len(blocks)]) != list(blocks):
                raise SanitizerError(
                    f"slot {slot} block table {row[:len(blocks)].tolist()} "
                    f"disagrees with owned blocks {blocks}")
            if np.any(row[len(blocks):]):
                raise SanitizerError(
                    f"slot {slot} table references block(s) "
                    f"{row[len(blocks):][row[len(blocks):] != 0].tolist()} "
                    f"past its {len(blocks)} owned blocks (stale entries)")
            if (eng.active[slot] is not None
                    and int(eng.seq_lens[slot]) > len(blocks) * eng.kv_block):
                raise SanitizerError(
                    f"slot {slot} seq_len {int(eng.seq_lens[slot])} outruns "
                    f"its {len(blocks)} owned blocks "
                    f"(x{eng.kv_block} tokens): next KV write lands in "
                    f"reserved dummy block 0")
        extra = set(self.owner) - set(seen)
        if extra:
            raise SanitizerError(
                f"blocks {sorted(extra)} in the shadow map but owned by no "
                f"slot (lost handoff)")
        al = eng.allocator
        free = set(al._free)
        both = free & set(seen)
        if both:
            raise SanitizerError(
                f"blocks {sorted(both)} simultaneously free and slot-owned")
        handed = al.handed_out()
        if handed != set(seen):
            raise SanitizerError(
                f"allocator handed-out set {sorted(handed)} disagrees with "
                f"slot ownership {sorted(seen)} (leak or lost handoff)")

    def check_drain(self) -> None:
        """An idle engine (no active slots, empty queue) must hold zero
        allocated blocks: anything still owned leaked."""
        if any(r is not None for r in self.eng.active):
            return
        if self.owner:
            raise SanitizerError(
                f"leak at drain: blocks {sorted(self.owner)} still owned "
                f"after all requests completed")
        al = self.eng.allocator
        if al.n_free != al.capacity:
            raise SanitizerError(
                f"leak at drain: allocator reports {al.n_free} free of "
                f"{al.capacity} capacity with no active requests")


def guard_blocks(eng, what: str, ids, positions=None) -> None:
    """Before a dispatch that reads or writes the pool: every block id in
    ``ids`` (a block table, or a commit's id row) must name a pool block,
    and every write position in ``positions`` (``seq_lens``, or a chunk's
    last position) must fall inside a slot's table."""
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else \
        np.asarray(ids)
    n = eng.allocator.n_blocks
    bad = ids[(ids < 0) | (ids >= n)]
    if bad.size:
        raise GuardError(f"{what}: block id(s) {sorted(set(bad.tolist()))} "
                         f"outside the pool's {n} blocks")
    if positions is not None:
        pos = np.asarray(positions)
        top = eng.table_width * eng.kv_block
        bad = pos[(pos < 0) | (pos >= top)]
        if bad.size:
            raise GuardError(f"{what}: write position(s) {bad.tolist()} "
                             f"outside a slot's {top} table tokens")


def guard_finite(what: str, logits: torch.Tensor) -> None:
    """After a dispatch: its logits hold no NaN (a host sync; debug only).
    NaN only, as the reference checks: masked lanes may hold -inf."""
    if bool(torch.isnan(logits).any()):
        raise GuardError(f"{what}: NaN in the logits")


# ---------------------------------------------------------------------------
# the --sanitize schedule
# ---------------------------------------------------------------------------

def _flash_crowd_schedule(vocab: int, seed: int, n_requests: int):
    """(tick -> [Request]) map: an opening burst that over-subscribes the
    slots, then a second wave mid-decode -- the interleaving that forces
    block growth, pool exhaustion, and youngest-request preemption."""
    from ..serving.engine import Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 20, n_requests)
    news = rng.integers(4, 16, n_requests)
    sched: dict[int, list] = {}
    for i in range(n_requests):
        tick = 0 if i < (2 * n_requests) // 3 else 6
        sched.setdefault(tick, []).append(Request(
            rid=i, prompt=rng.integers(0, vocab, int(lens[i])).astype(np.int32),
            max_new=int(news[i]), ue=i % 4))
    return sched


# the pool of run_sanitize: big enough for the worst single request (the
# admission fit check), far too small for 3 slots at full stretch -- growth
# hits the dry pool and preemption must fire
POOL = dict(slots=3, s_max=64, kv_block=8, kv_blocks=7)


def run_sanitize(arch: str = "qwen3-0.6b", *, n_requests: int = 10,
                 seed: int = 0, n_layers: int = 2,
                 max_steps: int = 2_000, device=None, head_dim=None,
                 cfg=None, params=None) -> SanitizeReport:
    """Drive a sanitized continuous engine through a flash-crowd schedule.

    The pool is deliberately undersized (every slot can NOT reach
    ``s_max`` simultaneously) so growth hits the dry-pool path and
    preemption fires; the sanitizer and the dispatch guards watch every
    tick.  The model is ``reduced(arch)`` at ``n_layers`` from ``seed`` on
    ``device`` (CUDA unless ``"cpu"``) with ``head_dim`` (None: the
    reduced config's), or ``cfg`` / ``params`` where given.  Returns a
    report whose ``failures`` is empty iff the engine is memory- and
    NaN-clean under this interleaving.
    """
    from ..configs.base import get_config, reduced
    from ..device import resolve_device
    from ..models import transformer
    from ..serving.engine import ServingEngine

    t0 = time.perf_counter()
    if params is None:
        device = resolve_device(device)
        cfg = reduced(get_config(arch), n_layers=n_layers,
                      **({} if head_dim is None else {"head_dim": head_dim}))
        params = transformer.init_params(seed, cfg, device)
    eng = ServingEngine(cfg, params, sanitize=True, **POOL)
    sched = _flash_crowd_schedule(cfg.vocab, seed, n_requests)
    failures: list[SanitizeFailure] = []
    ticks = 0
    try:
        for tick in range(max_steps):
            for req in sched.pop(tick, ()):
                eng.submit(req)
            alive = eng.step()
            ticks += 1
            if not alive and not sched:
                break
        else:
            failures.append(SanitizeFailure(
                "schedule", f"engine did not drain in {max_steps} ticks"))
    except GuardError as e:
        failures.append(SanitizeFailure("guards", str(e)))
    except SanitizerError as e:
        failures.append(SanitizeFailure("kv-pool", str(e)))
    except Exception as e:        # a dispatch that failed in another way
        failures.append(SanitizeFailure("dispatch", repr(e)))
    done = eng.pop_completed()
    if not failures and len(done) != n_requests:
        failures.append(SanitizeFailure(
            "schedule", f"{len(done)}/{n_requests} requests completed"))
    if not failures and eng.preemptions == 0:
        failures.append(SanitizeFailure(
            "schedule", "schedule exercised no preemption: the dry-pool "
                        "path went unchecked (shrink kv_blocks)"))
    churn = eng._san.events if eng._san is not None else 0
    return SanitizeReport(
        failures=tuple(failures), ticks=ticks, requests=len(done),
        preemptions=int(eng.preemptions), block_churn=churn,
        elapsed_s=time.perf_counter() - t0)
