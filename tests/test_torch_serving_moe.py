"""Port parity: the engine, the partitioned server and the launcher on the
MoE stacks, and the engine's refusal of the cross-attention and encoder
stacks.

The reference engine and the port's serve the same requests on the same
weights (the reference's, carried across) in float32 on reduced
moonshot-v1-16b-a3b ("m" only, top-6) and reduced llama4-maverick-400b-a17b
(g, m; top-1) at the configs' capacity factor of 1.25, so tokens drop where
the groups overfill; both engines route the same groups (a solo prefill's
left pad, a decode tick's idle slots and a sync wave's pads take part), so
greedy tokens, the recorder's events and the counters must be identical, in
the continuous mode (with preemption) and the sync mode.  Chunked prefill
is off for any stack with "m".  At capacity factor 8 nothing drops and each
engine token equals the request's solo run.  ``launch.serve.main`` runs
moonshot on the CPU (``serve_partitioned.main`` runs it in
``tests/test_torch_serve_partitioned.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.configs.base import reduced as r_reduced
from repro.models import transformer as r_tf
from repro.profiling.lmprofiles import lm_profile as r_lm_profile
from repro.serving import engine as r_engine
from repro.serving import kvpool as r_kvpool
from repro_torch.configs import base as p_base
from repro_torch.launch import serve as p_serve
from repro_torch.models import transformer as p_tf
from repro_torch.profiling.lmprofiles import lm_profile as p_lm_profile
from repro_torch.serving import engine as p_engine
from repro_torch.serving import kvpool as p_kvpool
from repro_torch.serving import partitioned as p_part
from test_torch_serving import ENGINE_CASES, _run
from test_torch_sync import SYNC_CASES
from test_torch_sync import _run as _run_sync

MOE = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
CASES = ("preempt_mid_stream", "preempt_small_pool")


@pytest.fixture(scope="module", params=MOE)
def stack(request):
    r_cfg = r_reduced(r_get_config(request.param))
    p_cfg = p_base.reduced(p_base.get_config(request.param))
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
    assert p_eng._prefill_shapes == r_eng._prefill_shapes
    assert p_eng.prefill_chunk is None and p_eng.chunk_steps == 0
    assert p_eng.prefill_steps == len(spec) + p_eng.preemptions
    assert p_eng.allocator.n_free == p_eng.allocator.capacity
    if case.startswith("preempt"):
        assert p_eng.preemptions > 0
    for r, (_, m) in zip(p_reqs, spec):
        assert len(r.out) == m and r.done


@pytest.mark.parametrize("case", ["mixed_budgets", "pad_free"])
def test_sync_engine_matches_reference_sync_engine(stack, case):
    r_cfg, p_cfg, r_params, p_params = stack
    kwargs, spec = SYNC_CASES[case]
    r_eng, r_reqs, r_done, r_rec = _run_sync(r_engine, r_cfg, r_params,
                                             kwargs, spec, 5)
    p_eng, p_reqs, p_done, p_rec = _run_sync(p_engine, p_cfg, p_params,
                                             kwargs, spec, 5)
    assert [r.out for r in p_reqs] == [r.out for r in r_reqs]
    assert [r.rid for r in p_done] == [r.rid for r in r_done]
    assert p_rec.events == r_rec.events
    for attr in ("clock", "decode_steps"):
        assert getattr(p_eng, attr) == getattr(r_eng, attr), attr
    assert p_eng._prefill_shapes == r_eng._prefill_shapes


def test_engine_tokens_equal_solo_runs_without_drops(stack):
    """At capacity factor 8 every group keeps every token, so a request's
    engine tokens are its solo prefill + decode_step tokens, in both
    modes, through preemption."""
    _, p_cfg, _, p_params = stack
    cfg = dataclasses.replace(p_cfg, capacity_factor=8.0)
    for sync, case in ((False, "preempt_small_pool"), (True, "mixed_budgets")):
        kwargs, spec = (SYNC_CASES if sync else ENGINE_CASES)[case]
        run = _run_sync if sync else _run
        eng, reqs, _, _ = run(p_engine, cfg, p_params, kwargs, spec, 3)
        assert sync or eng.preemptions > 0
        for r in reqs:
            lg, cache = p_tf.prefill(
                p_params, cfg,
                {"tokens": torch.from_numpy(r.prompt[None]).long()},
                s_max=kwargs["s_max"])
            out = [int(torch.argmax(lg[0]))]
            while len(out) < r.max_new:
                lg, cache = p_tf.decode_step(p_params, cfg, cache,
                                             torch.tensor([out[-1]]))
                out.append(int(torch.argmax(lg[0])))
            assert r.out == out[:r.max_new], (sync, r.rid)


def test_moe_stacks_prefill_whole_prompts(stack):
    _, p_cfg, _, p_params = stack
    for chunk in ("auto", 8, None):
        eng = p_engine.ServingEngine(p_cfg, p_params, slots=2, s_max=64,
                                     prefill_chunk=chunk)
        assert eng.prefill_chunk is None
    toks = torch.zeros((1, 4), dtype=torch.long)
    _, cache = p_tf.prefill(p_params, p_cfg, {"tokens": toks}, s_max=16)
    with pytest.raises(NotImplementedError, match="kind 'm'"):
        p_tf.prefill_chunk(p_params, p_cfg, cache, toks, 4, 4)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_cross_attention_and_encoder_stacks_are_refused(arch):
    """Both engine modes refuse "x", "d" and encoder stacks with the
    reference's ValueError; the reference's sync engine fails on them too
    (it passes tokens only), so no servable path is lost."""
    r_cfg = r_reduced(r_get_config(arch))
    p_cfg = p_base.reduced(p_base.get_config(arch))
    with pytest.raises(ValueError) as r_err:
        r_kvpool._check_pattern(r_cfg)
    with pytest.raises(ValueError) as p_err:
        p_kvpool.check_pattern(p_cfg)
    assert str(p_err.value) == str(r_err.value)
    params = p_tf.init_params(0, p_cfg, "cpu")
    for sync in (False, True):
        with pytest.raises(ValueError, match="plain decoder stacks"):
            p_engine.ServingEngine(p_cfg, params, slots=2, s_max=32,
                                   sync_batching=sync)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    r_eng = r_engine.ServingEngine(r_cfg, r_params, slots=2, s_max=32,
                                   sync_batching=True)
    r_eng.submit(r_engine.Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                  max_new=2))
    with pytest.raises(KeyError, match="embeds"):
        r_eng.run_until_idle()
    with pytest.raises(ValueError, match="encoder" if p_cfg.enc_layers
                       else "partitioned model takes"):
        p_part.PartitionedLM(p_cfg, params, 0)
    if arch.startswith("llama"):
        with pytest.raises(ValueError, match="plain decoder stacks"):
            p_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    else:
        with pytest.raises(SystemExit):
            p_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_lm_profiles_of_the_four_kinds_match_reference():
    for arch in (*MOE, "llama-3.2-vision-90b", "seamless-m4t-large-v2"):
        r = r_lm_profile(r_get_config(arch), prompt_tokens=64)
        p = p_lm_profile(p_base.get_config(arch), prompt_tokens=64)
        assert p.layer_names == r.layer_names
        for field in ("macs", "param_bytes", "act_bytes"):
            np.testing.assert_array_equal(getattr(p, field),
                                          getattr(r, field), err_msg=arch)


@pytest.mark.parametrize("sync", [False, True])
def test_launch_serve_main_serves_moonshot_on_cpu(sync):
    rep = p_serve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                        "--device", "cpu", "--requests", "3",
                        "--prompt-len", "40", "--max-new", "4"]
                       + (["--sync-batching"] if sync else []))
    assert rep["arch"] == "moonshot-v1-16b-a3b-smoke"
    assert rep["mode"] == ("sync" if sync else "continuous")
    assert all(len(o) == 4 for o in rep["out"].values())
    assert rep["chunk_steps"] == 0
    if not sync:       # 40-token prompts prefill whole: no chunks
        assert rep["prefill_steps"] == 3
