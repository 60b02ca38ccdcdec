"""Port parity: the continuous engine, the partitioned model and the
serving launcher on the ring and recurrent stacks.

The reference engine and the port's serve the same requests on the same
weights (the reference's, carried across) in float32 on the three reduced
stacks of ``tests/test_torch_hybrid.py`` (recurrentgemma-2b, mamba2-1.3b,
hybrid-grs), under the schedules of ``tests/test_torch_serving.py``:
chunked prefill, preemption mid-stream and a pool small enough to preempt.
Greedy tokens, the recorder's events and the engine's counters must be
identical.  ``launch.serve.main`` runs on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.serving import engine as r_engine
from repro_torch.configs import base as p_base
from repro_torch.launch import serve as p_serve
from repro_torch.models import transformer as p_tf
from repro_torch.serving import engine as p_engine
from repro_torch.serving import partitioned as p_part
from test_torch_hybrid import STACKS
from test_torch_serving import ENGINE_CASES, _run

CASES = ("mixed_chunked", "preempt_mid_stream", "preempt_small_pool")


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    make = STACKS[request.param]
    r_cfg = make(r_get_config, r_reduced)
    p_cfg = make(p_base.get_config, p_base.reduced)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


@pytest.mark.parametrize("case", CASES)
def test_engine_matches_reference_engine(stack, case):
    r_cfg, p_cfg, r_params, p_params = stack
    kwargs, spec = ENGINE_CASES[case]
    r_eng, r_reqs, r_done, r_rec = _run(r_engine, r_cfg, r_params, kwargs,
                                        spec, 7)
    p_eng, p_reqs, p_done, p_rec = _run(p_engine, p_cfg, p_params, kwargs,
                                        spec, 7)
    assert [r.out for r in p_reqs] == [r.out for r in r_reqs]
    assert [r.rid for r in p_done] == [r.rid for r in r_done]
    assert p_rec.events == r_rec.events
    for attr in ("clock", "decode_steps", "preemptions", "prefill_chunk"):
        assert getattr(p_eng, attr) == getattr(r_eng, attr), attr
    assert p_eng.allocator.n_free == p_eng.allocator.capacity
    if case.startswith("preempt"):
        assert p_eng.preemptions > 0
    if case == "mixed_chunked":
        assert p_eng.chunk_steps > 0 and p_eng.chunk_tokens > 0


def test_engine_chunk_counters_count_the_replayed_tokens(stack):
    """``chunk_steps`` counts the chunks after a stream's first and
    ``chunk_tokens`` their real prompt tokens: a 50-token prompt in chunks
    of 16 is one prefill and 3 chunks of 16, 16 and 2 tokens."""
    _, p_cfg, _, p_params = stack
    eng = p_engine.ServingEngine(p_cfg, p_params, slots=1, s_max=64,
                                 prefill_chunk=16)
    rng = np.random.default_rng(0)
    eng.submit(p_engine.Request(rid=0, prompt=rng.integers(
        0, p_cfg.vocab, 50).astype(np.int32), max_new=2))
    eng.run_until_idle()
    assert (eng.prefill_steps, eng.chunk_steps, eng.chunk_tokens) == (4, 3, 34)


def test_partitioned_lm_takes_plain_stacks_only(stack):
    """Every unit cut of a tail-free stack equals the monolithic pass; a
    stack with tail layers is refused, as the reference refuses it."""
    _, p_cfg, _, p_params = stack
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, p_cfg.vocab, (2, 9)))
    want, _ = p_tf.forward_train(p_params, p_cfg, {"tokens": toks})
    if p_cfg.tail_pattern:
        with pytest.raises(ValueError, match="tail"):
            p_part.PartitionedLM(p_cfg, p_params, 0)
        return
    for cut in range(p_cfg.n_units + 1):
        got, _ = p_part.PartitionedLM(p_cfg, p_params, cut).infer(toks)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_launch_serve_main_on_cpu():
    rep = p_serve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                        "cpu", "--requests", "3", "--prompt-len", "12",
                        "--max-new", "5"])
    assert (rep["arch"], rep["device"], rep["dtype"]) == (
        "recurrentgemma-2b-smoke", "cpu", "float32")
    assert rep["layers"] == 8 and rep["params"] > 0
    assert sorted(rep["out"]) == [0, 1, 2]
    assert all(len(o) == 5 for o in rep["out"].values())
    assert rep["prefill_steps"] == 3 and rep["chunk_steps"] == 0
    assert rep["decode_steps"] >= 4 and rep["ticks"] >= rep["decode_steps"]
    assert all(ms > 0 for ms in rep["latency_ms"].values())


def test_launch_serve_engine_and_refusals():
    cfg = p_base.reduced(p_base.get_config("mamba2-1.3b"))
    params = p_tf.init_params(0, cfg, "cpu")
    eng = p_serve.make_engine(cfg, params, slots=3, prompt_len=40, max_new=6)
    assert (eng.slots, eng.s_max, eng.prefill_chunk) == (3, 54, 32)
    with pytest.raises(ValueError, match="needs 512 ranks"):
        p_serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                      "--multi-pod"])
    sync = p_serve.make_engine(cfg, params, slots=3, prompt_len=40,
                               max_new=6, sync_batching=True)
    assert sync.sync_batching and sync.s_max == 54
    with pytest.raises(SystemExit):
        p_serve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                      "--device", "cpu"])


def test_smoke_configs_widen_heads_only_for_the_kernels(capsys):
    """The reduced configs keep the reference's 16-wide heads on the CPU;
    on CUDA the CLIs widen them to the attention kernels' smallest head
    dim, and say so."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert p_serve.kernel_head_dim(torch.device("cpu")) == {}
    assert capsys.readouterr().out == ""
    assert p_serve.kernel_head_dim("cuda") == {"head_dim": min(HEAD_DIMS)}
    assert f"from 16 to {min(HEAD_DIMS)}" in capsys.readouterr().out
    cfg = p_base.reduced(p_base.get_config("qwen3-0.6b"))
    assert cfg.head_dim == r_reduced(r_get_config("qwen3-0.6b")).head_dim
