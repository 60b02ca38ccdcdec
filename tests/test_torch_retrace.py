"""Port parity: the retrace probes (``repro_torch.analysis.retrace``) and
the whole CLI.

The serving and chunked probes drive reduced qwen3-0.6b through the
reference's two waves; the port's ``prefill_compiles`` after each wave
equals the reference engine's on the same prompts (the reference counts
its jit compilations so), and every ``prefill_chunk`` call sees one input
signature.  Three Oracle rollouts load no kernel library on the CPU.  A
seeded fault fails each probe.  No flag of the reference's CLI raises.
"""
import contextlib

import jax
import numpy as np
import pytest

from repro.analysis import retrace as r_retrace
from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_transformer
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine
from repro_torch.analysis import retrace as p_retrace
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.serving.engine import ServingEngine


def _reference_compiles(waves, seed, **kw):
    """The reference engine's ``prefill_compiles`` after each wave, its
    prompts drawn as the probes draw them."""
    cfg = r_reduced(r_get_config("qwen3-0.6b"))
    params = r_transformer.init_params(jax.random.PRNGKey(0), cfg)
    eng = RServingEngine(cfg, params, slots=2, s_max=64, **kw)
    rng = np.random.default_rng(seed)
    out = []
    for w, lengths in enumerate(waves):
        for i, n in enumerate(lengths):
            eng.submit(RRequest(
                rid=100 * w + i,
                prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                max_new=4))
        eng.run_until_idle()
        out.append(eng.prefill_compiles)
    return out


def test_waves_are_the_references():
    import inspect
    src = inspect.getsource(r_retrace)
    for waves in (p_retrace.SERVING_WAVES, p_retrace.CHUNKED_WAVES):
        for wave in waves:
            assert str(wave) in src


def test_serving_probe_compiles_as_the_reference():
    probe = p_retrace.serving_probe(device="cpu")
    assert probe.failures == []
    assert probe.prefill_compiles == _reference_compiles(
        p_retrace.SERVING_WAVES, 0) == [3, 3]
    assert sorted(probe.tokens) == [0, 1, 2, 3, 4, 100, 101, 102, 103, 104]
    assert all(len(t) == 4 for t in probe.tokens.values())


def test_chunked_probe_compiles_as_the_reference():
    probe = p_retrace.chunked_probe(device="cpu")
    assert probe.failures == []
    assert probe.prefill_compiles == _reference_compiles(
        p_retrace.CHUNKED_WAVES, 1, prefill_chunk=16)
    assert len(probe.chunk_signatures) == 1
    assert len(probe.tokens) == 6


def test_rollout_probe_loads_nothing_on_the_cpu():
    probe = p_retrace.rollout_probe(device="cpu")
    assert probe.failures == []
    assert probe.libraries and all(
        v == {"builds": 0, "loads": 0, "total_loads": 0}
        for v in probe.libraries.values())


def test_seeded_faults_fail_the_probes(monkeypatch):
    """Prefills at their exact widths (no buckets) add signatures in the
    second wave; chunks at their real lengths give prefill_chunk several
    signatures; a library that loads again fails the rollout probe."""
    monkeypatch.setattr(ServingEngine, "_bucket_width",
                        lambda self, width, max_new: width)
    assert [f.probe for f in p_retrace.serving_retraces(device="cpu")] == \
        ["serving", "serving"]
    monkeypatch.undo()

    real = p_retrace._chunk_signatures

    @contextlib.contextmanager
    def ragged_chunks(seen):
        """The engine's chunks cut to their real tokens before the probe's
        recorder sees them."""
        from repro_torch.models import transformer
        with real(seen):
            recorder = transformer.prefill_chunk
            transformer.prefill_chunk = lambda p, c, ca, t, s, n: recorder(
                p, c, ca, t[:, :n], s, n)
            yield

    monkeypatch.setattr(p_retrace, "_chunk_signatures", ragged_chunks)
    fails = p_retrace.chunked_retraces(device="cpu")
    assert [f.probe for f in fails] == ["chunked"]
    assert "input signatures" in fails[0].message
    monkeypatch.undo()

    class Reloading:
        name, builds = "fake", 0

        def __init__(self):
            self.n = 0

        @property
        def loads(self):
            self.n += 1
            return self.n

    lib = Reloading()
    monkeypatch.setattr("repro_torch.kernels.ops.all_libraries",
                        lambda: [lib])
    fails = p_retrace.rollout_retraces(device="cpu")
    assert {f.message.split(" ")[0] for f in fails} == \
        {"kernel", "library"}


def test_reference_probe_names_and_render():
    f = p_retrace.RetraceFailure("serving", "m")
    assert f.render() == r_retrace.RetraceFailure("serving", "m").render()


@pytest.mark.parametrize("flag", ["--contracts", "--shardcheck",
                                  "--retrace", "--sanitize", "--lint"])
def test_cli_flags_are_ported(flag, monkeypatch):
    """No flag of the reference's CLI raises: each runs its layer (here
    stubbed to a clean report, the layers' own tests run them)."""
    from repro_torch.analysis import contracts, retrace, sanitize, shardcheck
    clean = type("R", (), dict(covered=(), skipped=(), failures=(),
                               elapsed_s=0.0, ticks=0, requests=0,
                               preemptions=0, block_churn=0))()
    monkeypatch.setattr(contracts, "run_contracts", lambda **k: clean)
    monkeypatch.setattr(shardcheck, "run_shardcheck", lambda **k: clean)
    monkeypatch.setattr(retrace, "run_retrace", lambda **k: [])
    monkeypatch.setattr(sanitize, "run_sanitize", lambda **k: clean)
    assert cli_main([flag, "--device", "cpu", "--verbose"]) == 0
