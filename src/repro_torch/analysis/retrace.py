"""Retrace counter for the port: bound what the port builds in a steady
state.

Port of ``repro/analysis/retrace.py``.  The reference counts the programs
``jax.jit`` compiles; the port compiles nothing at run time, so its twin
bounds what it does build, on smoke-size configs (cheap on the CPU):

* **Serving**: a continuous-batching ``ServingEngine`` on reduced
  qwen3-0.6b (slots 2, s_max 64) through the reference's two waves of
  mixed-length prompts.  ``ServingEngine.prefill_compiles`` (one per
  (batch, bucket width, ragged) prefill signature, the reference's
  compilations) is at most 3 after wave one (3 buckets) and flat over wave
  two; the paged decode runs one signature.

* **Chunked prefill**: the same engine with ``prefill_chunk=16`` and
  prompts long enough to stream.  ``prefill_compiles`` stays flat over
  wave two, and every call of ``transformer.prefill_chunk`` sees one input
  signature (the chunk's shape and dtype and the stream cache's leaves),
  recorded by a wrapper of the module's function inside the probe: the
  chunk's index and length are host ints, data and not shape.

* **Rollouts**: three Oracle rollouts of a 3-cell ``fixed_rate`` grid with
  three seeds.  Each CUDA library the process uses is built and loaded
  once (``kernels._build.Library.builds`` / ``loads``): nothing is built
  or loaded again after the first rollout.  On the CPU nothing is loaded
  at all.

Each probe takes ``device`` and defaults to the card, as the port's entry
points do; the reduced configs take ``launch.serve.kernel_head_dim`` (or
``head_dim``, to serve the card's model on the CPU).  A probe returns a
:class:`Probe`: its failures and what it saw (the prefill signatures after
each wave and every request's greedy tokens), so the card's run can be
held to the CPU's.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

SERVING_WAVES = ([5, 9, 17, 12, 3], [6, 11, 20, 4, 13])
CHUNKED_WAVES = ([40, 20, 7], [45, 18, 6])


@dataclasses.dataclass(frozen=True)
class RetraceFailure:
    probe: str
    message: str

    def render(self) -> str:
        return f"{self.probe}: {self.message}"


@dataclasses.dataclass
class Probe:
    name: str
    failures: list
    prefill_compiles: list = dataclasses.field(default_factory=list)
    tokens: dict = dataclasses.field(default_factory=dict)   # rid -> out
    chunk_signatures: set = dataclasses.field(default_factory=set)
    libraries: dict = dataclasses.field(default_factory=dict)
    steps: dict = dataclasses.field(default_factory=dict)    # the engine's


def _engine(arch: str, device, head_dim=None, **kw):
    """The probes' engine: ``arch`` reduced (with the attention kernels'
    head dim on CUDA, or ``head_dim``), its weights drawn on the host from
    seed 0, so the same probe on two devices serves the same model."""
    from .. import _tree
    from ..configs.base import get_config, reduced
    from ..device import resolve_device
    from ..launch.serve import kernel_head_dim
    from ..models import transformer
    from ..serving.engine import ServingEngine
    device = resolve_device(device)
    wide = kernel_head_dim(device) if head_dim is None else \
        {"head_dim": head_dim}
    cfg = reduced(get_config(arch), **wide)
    params = _tree.to_device(transformer.init_params(0, cfg, "cpu"), device)
    return cfg, ServingEngine(cfg, params, slots=2, s_max=64, **kw)


def _waves(probe: Probe, cfg, eng, waves, seed: int):
    from ..serving.engine import Request
    rng = np.random.default_rng(seed)
    for w, lengths in enumerate(waves):
        for i, n in enumerate(lengths):
            eng.submit(Request(
                rid=100 * w + i,
                prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=4))
        for req in eng.run_until_idle():
            probe.tokens[req.rid] = list(req.out)
        probe.prefill_compiles.append(eng.prefill_compiles)
    probe.steps = {k: getattr(eng, k) for k in (
        "prefill_steps", "chunk_steps", "chunk_tokens", "decode_steps")}


def serving_probe(arch: str = "qwen3-0.6b", device=None,
                  head_dim=None) -> Probe:
    probe = Probe("serving", [])
    cfg, eng = _engine(arch, device, head_dim)
    _waves(probe, cfg, eng, SERVING_WAVES, 0)
    first, second = probe.prefill_compiles
    buckets_touched = 3                  # buckets 8, 16, 32 (all ragged)
    if first > buckets_touched:
        probe.failures.append(RetraceFailure(
            "serving", f"wave 1 ran {first} prefill signatures for "
                       f"{buckets_touched} buckets"))
    if second != first:
        probe.failures.append(RetraceFailure(
            "serving", f"steady state added prefill signatures: {first} -> "
                       f"{second} on identical buckets"))
    if len(eng._decode_shapes) != 1:
        probe.failures.append(RetraceFailure(
            "serving", f"paged decode ran {len(eng._decode_shapes)} "
                       f"signatures; steady state runs exactly 1"))
    return probe


@contextlib.contextmanager
def _chunk_signatures(seen: set):
    """Within: every ``transformer.prefill_chunk`` call adds its input
    signature to ``seen``."""
    from .. import _tree
    from ..models import transformer
    real = transformer.prefill_chunk

    def recording(params, cfg, caches, tokens, start, n_valid):
        seen.add((tuple(tokens.shape), tokens.dtype,
                  tuple((tuple(t.shape), t.dtype)
                        for t in _tree.leaves(caches))))
        return real(params, cfg, caches, tokens, start, n_valid)

    transformer.prefill_chunk = recording
    try:
        yield
    finally:
        transformer.prefill_chunk = real


def chunked_probe(arch: str = "qwen3-0.6b", device=None,
                  head_dim=None) -> Probe:
    probe = Probe("chunked", [])
    cfg, eng = _engine(arch, device, head_dim, prefill_chunk=16)
    with _chunk_signatures(probe.chunk_signatures):
        # 40 and 20 stream; 7 prefills whole; then new lengths
        _waves(probe, cfg, eng, CHUNKED_WAVES, 1)
    first, second = probe.prefill_compiles
    if second != first:
        probe.failures.append(RetraceFailure(
            "chunked", f"steady state added prefill signatures: {first} -> "
                       f"{second} on identical chunk/bucket shapes"))
    n = len(probe.chunk_signatures)
    if n != 1:
        probe.failures.append(RetraceFailure(
            "chunked", f"prefill_chunk saw {n} input signatures; the chunk "
                       f"cursor is data, so it must see exactly 1"))
    return probe


def _library_counts() -> dict:
    from ..kernels.ops import all_libraries
    return {lib.name: (lib.builds, lib.loads) for lib in all_libraries()}


def rollout_probe(device=None) -> Probe:
    from ..core.scenarios import grid_from_names
    from ..device import resolve_device

    device = resolve_device(device)
    probe = Probe("rollout", [])
    start = _library_counts()
    grid = grid_from_names([("fixed_rate", {"rate": 0.5}),
                            ("fixed_rate", {"rate": 1.0}),
                            ("fixed_rate", {"rate": 2.5})], device=device)
    fn = grid.make_rollout("oracle", steps=4)
    after = []
    for seed in range(3):
        fn(seed)
        after.append(_library_counts())
    probe.libraries = {name: {"builds": b - start[name][0],
                              "loads": lo - start[name][1], "total_loads": lo}
                       for name, (b, lo) in after[-1].items()}
    if after[1:] != after[:1] * 2:
        probe.failures.append(RetraceFailure(
            "rollout", f"kernel libraries built or loaded again after the "
                       f"first rollout: {after}"))
    for name, (builds, loads) in after[-1].items():
        if loads > 1:
            probe.failures.append(RetraceFailure(
                "rollout", f"library {name} loaded {loads} times in this "
                           f"process; once is the most"))
        if device.type != "cuda" and (builds or loads):
            probe.failures.append(RetraceFailure(
                "rollout", f"library {name} built {builds} / loaded {loads} "
                           f"times on {device}: the CPU runs no kernel "
                           f"library"))
    return probe


def serving_retraces(arch: str = "qwen3-0.6b", device=None):
    return serving_probe(arch, device).failures


def chunked_retraces(arch: str = "qwen3-0.6b", device=None):
    return chunked_probe(arch, device).failures


def rollout_retraces(device=None):
    return rollout_probe(device).failures


def run_retrace(device=None) -> list[RetraceFailure]:
    return (serving_retraces(device=device) + chunked_retraces(device=device)
            + rollout_retraces(device=device))
