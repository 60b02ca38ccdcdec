"""Port parity: slot physics (queueing, energy/memory, Lyapunov) and the
arrival processes / trace format, against the JAX reference.

Inputs are drawn once with numpy and fed to both packages; the port runs
on the CPU and results are compared in float32.  Tolerance: rtol 1e-6 --
the port repeats the reference's operations in the same order, so only
libm differences (log2, exp, sin) remain.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import traffic as r_traffic
from repro.core import energymem as r_em
from repro.core import lyapunov as r_lyap
from repro.core import queueing as r_q
from repro_torch import traffic as p_traffic
from repro_torch.core import energymem as p_em
from repro_torch.core import lyapunov as p_lyap
from repro_torch.core import queueing as p_q

RTOL = 1e-6


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    d_ue = rng.uniform(0, 4e8, n)
    d_ue[::7] = 0.0                              # full-offload UEs
    lam = rng.uniform(0.2, 2.5, n)
    return dict(
        lam=f32(lam),
        f_ue=f32(d_ue * lam * rng.uniform(1.01, 5.0, n) + 1.0),
        f_es=f32(rng.uniform(1e8, 5e9, n)),
        d_ue=f32(d_ue),
        d_es=f32(np.where(np.arange(n) % 5 == 0, 0.0,
                          rng.uniform(1e7, 5e8, n))),
        psi=f32(np.where(np.arange(n) % 6 == 0, 0.0,
                         rng.uniform(1e4, 1e6, n))),
        alpha=f32(np.where(np.arange(n) % 9 == 0, 0.0,
                           rng.uniform(1e-3, 1.0, n))),
        gain=f32(rng.exponential(1.0, n) * 1.58e-11),
        rho_ue=f32(rng.uniform(0.0, 0.99, n)),
    )


def _both(x):
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.mark.parametrize("edge_queueing", [False, True])
def test_e2e_delay_matches_reference(edge_queueing):
    x = _inputs()
    consts = dict(w_hz=5e6, p_tx=0.1, n0=10 ** (-17.4) / 1000.0)
    args = ("lam", "f_ue", "f_es", "d_ue", "d_es", "psi", "alpha")
    want, want_parts = r_q.e2e_delay(
        *(jnp.asarray(x[a]) for a in args), consts["w_hz"], consts["p_tx"],
        jnp.asarray(x["gain"]), consts["n0"], edge_queueing=edge_queueing)
    got, got_parts = p_q.e2e_delay(
        *(torch.as_tensor(x[a]) for a in args), consts["w_hz"], consts["p_tx"],
        torch.as_tensor(x["gain"]), consts["n0"], edge_queueing=edge_queueing)
    _close(got, want)
    for g, w in zip(got_parts, want_parts):
        _close(g, w)


def test_queueing_pieces_match_reference():
    x = _inputs(seed=1)
    mu = x["f_ue"] / np.maximum(x["d_ue"], 1.0)
    pairs = [
        (r_q.md1_sojourn, p_q.md1_sojourn, (x["lam"], mu + x["lam"])),
        (r_q.ue_sojourn, p_q.ue_sojourn, (x["lam"], x["f_ue"], x["d_ue"])),
        (r_q.es_sojourn, p_q.es_sojourn, (x["f_es"], x["d_es"])),
        (r_q.es_sojourn_gd1, p_q.es_sojourn_gd1,
         (x["lam"], x["f_es"], x["d_es"], x["rho_ue"])),
    ]
    for r_fn, p_fn, args in pairs:
        _close(p_fn(*(torch.as_tensor(a) for a in args)),
               r_fn(*(jnp.asarray(a) for a in args)))
    rate_args = (5e6, 0.1, None, 10 ** (-17.4) / 1000.0)
    r_rate = r_q.shannon_rate(jnp.asarray(x["alpha"]), rate_args[0], rate_args[1],
                              jnp.asarray(x["gain"]), rate_args[3])
    p_rate = p_q.shannon_rate(torch.as_tensor(x["alpha"]), rate_args[0],
                              rate_args[1], torch.as_tensor(x["gain"]),
                              rate_args[3])
    _close(p_rate, r_rate)


def test_energy_and_memory_match_reference():
    x = _inputs(seed=2)
    rng = np.random.default_rng(3)
    t_tx = np.asarray(rng.uniform(0, 0.5, 64), np.float32)
    _close(p_em.ue_energy(*(torch.as_tensor(v) for v in
                            (x["f_ue"], x["d_ue"], x["lam"])), 1e-28, 0.1,
                          torch.as_tensor(t_tx)),
           r_em.ue_energy(*(jnp.asarray(v) for v in
                            (x["f_ue"], x["d_ue"], x["lam"])), 1e-28, 0.1,
                          jnp.asarray(t_tx)))
    tabs = [np.asarray(rng.uniform(0, 2e8, 64), np.float32) for _ in range(4)]
    _close(p_em.memory_cost(*(torch.as_tensor(t) for t in tabs), 0.2, 0.8),
           r_em.memory_cost(*(jnp.asarray(t) for t in tabs), 0.2, 0.8))


def test_lyapunov_matches_reference_per_cell():
    """(B, N) queues: every sum is per cell, over the UE axis only."""
    rng = np.random.default_rng(4)
    shape = (3, 5)
    q_e, q_m, energy, mem, delay, e_b, c_b = (
        np.asarray(rng.uniform(0, 50, shape), np.float32) for _ in range(7))
    v = 10.0
    r_q0 = r_lyap.VirtualQueues(jnp.asarray(q_e), jnp.asarray(q_m))
    p_q0 = p_lyap.VirtualQueues(torch.as_tensor(q_e), torch.as_tensor(q_m))
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.as_tensor(a)
    r_upd = r_lyap.update_queues(r_q0, j(energy), j(mem), j(e_b), j(c_b),
                                 100.0, 10.0)
    p_upd = p_lyap.update_queues(p_q0, t(energy), t(mem), t(e_b), t(c_b),
                                 100.0, 10.0)
    _close(p_upd.energy, r_upd.energy)
    _close(p_upd.memory, r_upd.memory)
    want_rew = jax.vmap(lambda a, b, c, d, e: r_lyap.reward(
        r_lyap.VirtualQueues(a, b), c, d, e, v))(
        j(q_e), j(q_m), j(energy), j(mem), j(delay))
    got_rew = p_lyap.reward(p_q0, t(energy), t(mem), t(delay), v)
    assert got_rew.shape == (3,)
    _close(got_rew, want_rew)
    want_l = jax.vmap(lambda a, b: r_lyap.lyapunov_function(
        r_lyap.VirtualQueues(a, b)))(j(q_e), j(q_m))
    _close(p_lyap.lyapunov_function(p_q0), want_l)


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------

def _process_pairs(n=5):
    rng = np.random.default_rng(5)
    base = np.asarray(rng.uniform(0.5, 2.5, n), np.float32)
    amp = np.asarray(rng.uniform(0.1, 1.0, n), np.float32)
    return [
        (r_traffic.FixedRate(lam=jnp.asarray(base)),
         p_traffic.FixedRate(lam=torch.as_tensor(base))),
        (r_traffic.PeakWindow(base=jnp.asarray(base), boost=jnp.float32(1.5),
                              start=jnp.int32(3), stop=jnp.int32(9)),
         p_traffic.PeakWindow(base=torch.as_tensor(base),
                              boost=torch.tensor(1.5), start=torch.tensor(3),
                              stop=torch.tensor(9))),
        (r_traffic.Diurnal(base=jnp.asarray(base), amp=jnp.asarray(amp),
                           period=jnp.float32(17.0), phase=jnp.float32(2.5)),
         p_traffic.Diurnal(base=torch.as_tensor(base), amp=torch.as_tensor(amp),
                           period=torch.tensor(17.0), phase=torch.tensor(2.5))),
        (r_traffic.FlashCrowd(base=jnp.asarray(base), spike=jnp.float32(2.5),
                              t0=jnp.int32(4), decay=jnp.float32(3.0)),
         p_traffic.FlashCrowd(base=torch.as_tensor(base),
                              spike=torch.tensor(2.5), t0=torch.tensor(4),
                              decay=torch.tensor(3.0))),
        (r_traffic.make_mmpp(n, seed=3, horizon=13),
         p_traffic.make_mmpp(n, seed=3, horizon=13)),
        (r_traffic.TraceArrivals(rates=jnp.asarray(
            rng.uniform(0, 3, (11, n)).astype(np.float32))), None),
    ]


@pytest.mark.parametrize("kind", ["fixed", "peak_window", "diurnal",
                                  "flash_crowd", "mmpp", "trace"])
def test_deterministic_process_matches_reference_each_slot(kind):
    pairs = {r.kind: (r, p) for r, p in _process_pairs()}
    ref, port = pairs[kind]
    if port is None:
        port = p_traffic.TraceArrivals(rates=torch.as_tensor(np.array(ref.rates)))
    key = jax.random.PRNGKey(0)
    for t in range(30):
        _close(port(None, t), ref(key, jnp.int32(t)))
        _close(port(None, torch.tensor(t)), ref(key, jnp.int32(t)))


@pytest.mark.parametrize("kind", ["peak_window", "diurnal", "flash_crowd",
                                  "mmpp", "trace"])
def test_stacked_process_is_per_cell(kind):
    """Three cells stacked along a leading axis, called with a (B,) slot
    vector, equal each cell called on its own."""
    from repro_torch import _tree
    cells = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        base = torch.as_tensor(rng.uniform(0.5, 2.5, 4).astype(np.float32))
        cells.append({
            "peak_window": p_traffic.PeakWindow(
                base=base, boost=torch.tensor(1.0 + seed),
                start=torch.tensor(2 + seed), stop=torch.tensor(6 + seed)),
            "diurnal": p_traffic.Diurnal(
                base=base, amp=base / 2, period=torch.tensor(10.0 + seed),
                phase=torch.tensor(float(seed))),
            "flash_crowd": p_traffic.FlashCrowd(
                base=base, spike=torch.tensor(2.0), t0=torch.tensor(seed + 1),
                decay=torch.tensor(2.0 + seed)),
            "mmpp": p_traffic.make_mmpp(4, seed=seed, horizon=7),
            "trace": p_traffic.TraceArrivals(rates=torch.as_tensor(
                rng.uniform(0, 3, (9, 4)).astype(np.float32))),
        }[kind])
    stacked = _tree.stack(cells)
    for t in range(12):
        ts = torch.tensor([t, t + 1, t + 2])
        got = stacked(None, ts)
        for b, cell in enumerate(cells):
            _close(got[b], cell(None, t + b), rtol=0.0)


def test_iid_uniform_matches_reference_on_same_noise():
    """Fed the reference's own U(0, 1) draws, the port gives its rates."""
    low = np.asarray([0.5, 1.0, 0.2], np.float32)
    high = np.asarray([2.5, 1.5, 3.0], np.float32)
    ref = r_traffic.IidUniform(low=jnp.asarray(low), high=jnp.asarray(high))
    port = p_traffic.IidUniform(low=torch.as_tensor(low),
                                high=torch.as_tensor(high))
    for t in range(10):
        key = jax.random.PRNGKey(t)
        u = np.asarray(jax.random.uniform(key, (3,), jnp.float32))
        _close(port(torch.as_tensor(u), t), ref(key, t))
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([port(gen, t) for t in range(500)])
    assert ((draws >= torch.as_tensor(low)) & (draws <= torch.as_tensor(high))).all()
    np.testing.assert_allclose(draws.mean(0).numpy(), (low + high) / 2, atol=0.1)


def test_poisson_draws_counts():
    lam = np.array([0.8, 2.0, 4.0], np.float32)
    p = p_traffic.PoissonArrivals(lam=torch.as_tensor(lam),
                                  slot_s=torch.tensor(1.0))
    rates = p_traffic.materialize(p, 2000)
    np.testing.assert_array_equal(rates, np.round(rates))
    np.testing.assert_allclose(rates.mean(0), lam, rtol=0.1)
    with pytest.raises(TypeError):
        p(torch.zeros(3), 0)


def test_make_mmpp_same_regimes_as_reference():
    ref = r_traffic.make_mmpp(6, seed=11, rates=(0.5, 1.5, 3.0), horizon=50)
    port = p_traffic.make_mmpp(6, seed=11, rates=(0.5, 1.5, 3.0), horizon=50)
    np.testing.assert_array_equal(port.regimes.numpy(), np.asarray(ref.regimes))
    _close(port.rates, ref.rates, rtol=0.0)
    assert port.regimes.dtype == torch.int64
    with pytest.raises(ValueError):
        p_traffic.make_mmpp(2, rates=(1.0, 2.0), trans=np.ones((2, 2)))


def test_materialize_and_trace_roundtrip_across_packages(tmp_path):
    """A deterministic process materializes to the same trace in both
    packages, and the .npz format loads bit-exactly in either direction."""
    ref_proc = r_traffic.make_mmpp(4, seed=0, horizon=64)
    port_proc = p_traffic.make_mmpp(4, seed=0, horizon=64)
    ref_trace = r_traffic.from_process(ref_proc, 64)
    port_trace = p_traffic.from_process(port_proc, 64)
    np.testing.assert_array_equal(port_trace.rates, ref_trace.rates)
    assert port_trace.meta == ref_trace.meta

    a = tmp_path / "port.npz"
    port_trace.shifted(5).save(a)
    back = r_traffic.Trace.load(a)
    np.testing.assert_array_equal(back.rates, port_trace.shifted(5).rates)
    assert back.meta == port_trace.shifted(5).meta
    b = tmp_path / "ref.npz"
    ref_trace.save(b)
    again = p_traffic.Trace.load(b)
    assert again.rates.dtype == np.float32
    np.testing.assert_array_equal(again.rates, ref_trace.rates)
    assert dataclasses.asdict(again)["slot_s"] == ref_trace.slot_s
    proc = again.process()
    _close(proc(None, 70), ref_trace.process()(None, 70), rtol=0.0)


def test_process_registry_matches_reference():
    assert sorted(p_traffic.PROCESSES) == sorted(r_traffic.PROCESSES)
    for kind, cls in p_traffic.PROCESSES.items():
        assert cls.kind == kind
    with pytest.raises(ValueError, match="already registered"):
        p_traffic.arrival_process("fixed")(type("Dup", (), {}))
