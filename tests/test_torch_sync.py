"""Port parity: the synchronized-batch engine (``sync_batching=True``).

The reference's sync engine and the port's serve the same requests on the
same weights (the reference's, carried across) in float32 on reduced
qwen3-0.6b (4 layers), recurrentgemma-2b and mamba2-1.3b.  Greedy tokens,
completion order, the recorder's events, the clock, the decode dispatches
and the prefill shapes must be identical: waves under mixed budgets (a
long prompt with a short budget and a short prompt with a long one cannot
share a width), budgets used up at admission (``max_new`` 0 and 1), a
pad-free wave (no mask, no "pad" in the cache) and ragged left-padded
waves.  Each request's tokens are also its solo prefill + decode_step
tokens.  ``launch.serve.main(["--sync-batching", ...])`` runs on the CPU.
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
from test_torch_hybrid import STACKS
from test_torch_serving import Recorder

MODELS = {"qwen3": lambda g, r: r(g("qwen3-0.6b"), n_layers=4),
          "recurrentgemma": STACKS["recurrentgemma"],
          "mamba2": STACKS["mamba2"]}

# (engine kwargs, [(prompt length, max_new)])
SYNC_CASES = {
    # (25, 3) and (4, 10) cannot share a width in s_max 32: the wave splits
    "mixed_budgets": (dict(slots=3, s_max=32),
                      [(5, 4), (25, 3), (4, 10), (12, 6), (7, 5), (9, 2)]),
    # budgets used up by the prefill logits complete at admission
    "complete_at_admission": (dict(slots=2, s_max=32),
                              [(7, 0), (11, 1), (6, 3), (20, 1), (3, 2)]),
    # every prompt exactly the 8-wide bucket: no pad mask, no "pad" entry
    "pad_free": (dict(slots=2, s_max=32), [(8, 3), (8, 5), (8, 2)]),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def stack(request):
    make = MODELS[request.param]
    r_cfg = make(r_get_config, r_reduced)
    p_cfg = make(p_base.get_config, p_base.reduced)
    r_params = r_tf.init_params(jax.random.PRNGKey(0), r_cfg)
    p_params = p_tf.params_from_reference(jax.tree.map(np.asarray, r_params),
                                          p_cfg, "cpu")
    return r_cfg, p_cfg, r_params, p_params


def _run(module, cfg, params, kwargs, spec, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in spec]
    rec = Recorder()
    eng = module.ServingEngine(cfg, params, recorder=rec, sync_batching=True,
                               **kwargs)
    reqs = [module.Request(rid=i, prompt=p, max_new=m)
            for i, (p, (_, m)) in enumerate(zip(prompts, spec))]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    return eng, reqs, done, rec


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_sync_engine_matches_reference_sync_engine(stack, case):
    r_cfg, p_cfg, r_params, p_params = stack
    kwargs, spec = SYNC_CASES[case]
    r_eng, r_reqs, r_done, r_rec = _run(r_engine, r_cfg, r_params, kwargs,
                                        spec, 5)
    p_eng, p_reqs, p_done, p_rec = _run(p_engine, p_cfg, p_params, kwargs,
                                        spec, 5)
    assert [r.out for r in p_reqs] == [r.out for r in r_reqs]
    assert [r.rid for r in p_done] == [r.rid for r in r_done]
    assert p_rec.events == r_rec.events
    for attr in ("clock", "decode_steps", "preemptions", "prefill_compiles"):
        assert getattr(p_eng, attr) == getattr(r_eng, attr), attr
    assert p_eng._prefill_shapes == r_eng._prefill_shapes
    assert p_eng.cache is None and not any(p_eng.active)
    for r, (_, m) in zip(p_reqs, spec):
        assert len(r.out) == m and r.done
    waves = {"mixed_budgets": 3, "complete_at_admission": 3, "pad_free": 2}
    assert p_eng.prefill_steps == waves[case]
    if case == "pad_free":
        assert all(not ragged for *_, ragged in p_eng._prefill_shapes)
        assert p_eng._decode_shapes == {(2, False)}
    if case == "mixed_budgets":
        # (4, 10) could not join (25, 3)'s wave: it starts the second one
        adm = {rid: t for ev, rid, t in p_rec.events if ev == "admit"}
        assert adm[0] == adm[1] < adm[2] == adm[3] == adm[4] < adm[5]
    if case == "complete_at_admission":
        # rids 0 (no token) and 1 (one token) finish at their admission
        adm = {rid: t for ev, rid, t in p_rec.events if ev == "admit"}
        end = {rid: t for ev, rid, t in p_rec.events if ev == "complete"}
        assert end[0] == adm[0] and end[1] == adm[1]


def test_sync_engine_matches_solo_runs(stack):
    """The port's own contract: a request's sync-engine tokens are its solo
    prefill + decode_step tokens."""
    _, p_cfg, _, p_params = stack
    kwargs, spec = SYNC_CASES["mixed_budgets"]
    _, reqs, _, _ = _run(p_engine, p_cfg, p_params, kwargs, spec, 11)
    for r in reqs:
        logits, cache = p_tf.prefill(
            p_params, p_cfg,
            {"tokens": torch.from_numpy(r.prompt[None]).long()}, s_max=32)
        out = [int(torch.argmax(logits[0]))]
        while len(out) < r.max_new:
            logits, cache = p_tf.decode_step(p_params, p_cfg, cache,
                                             torch.tensor([out[-1]]))
            out.append(int(torch.argmax(logits[0])))
        assert r.out == out[:r.max_new], f"prompt len {len(r.prompt)}"


def test_sync_engine_waits_for_the_whole_wave(stack):
    """A request submitted while a wave decodes waits for every slot to
    drain, then starts a wave of its own."""
    _, p_cfg, _, p_params = stack
    eng = p_engine.ServingEngine(p_cfg, p_params, slots=2, s_max=32,
                                 sync_batching=True)
    rng = np.random.default_rng(2)
    first = [p_engine.Request(rid=i, prompt=rng.integers(0, p_cfg.vocab, 5)
                              .astype(np.int32), max_new=4) for i in range(2)]
    for r in first:
        eng.submit(r)
    eng.step()
    late = p_engine.Request(rid=2, prompt=first[0].prompt, max_new=2)
    eng.submit(late)
    while not all(r.done for r in first):
        assert late.out == [] and eng.prefill_steps == 1
        eng.step()
    eng.run_until_idle()
    assert eng.prefill_steps == 2 and late.out == first[0].out[:2]


def test_launch_serve_sync_batching_on_cpu():
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
            "--requests", "3", "--prompt-len", "12", "--max-new", "5"]
    rep = p_serve.main(argv + ["--sync-batching"])
    assert rep["mode"] == "sync" and rep["preemptions"] == 0
    assert sorted(rep["out"]) == [0, 1, 2]
    assert all(len(o) == 5 for o in rep["out"].values())
    # waves of 2 and 1 requests, each 4 decode steps past its prefill
    assert rep["prefill_steps"] == 2 and rep["decode_steps"] == 8
    assert rep["prefill_shapes"] == [(2, 16, True)]
    cont = p_serve.main(argv)
    assert cont["mode"] == "continuous" and cont["out"] == rep["out"]
