"""Card-only tests of the port (``-m gpu``): the CUDA partition sweep
against its plain PyTorch version, and the grid's Oracle path launching it.

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside its body whether there is a card and skips where
there is none.  Tolerance: rtol 1e-4 / atol 1e-3 on feasible cells and the
same infeasible set (the reference's sweep tolerance); argmins must agree
wherever the plain table's best and second best are further apart than
that, and elsewhere the kernel's pick must score within it of the best.
"""
import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.core import scenarios as p_sc
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import partition_sweep as p_ps
from repro_torch.kernels import ref as p_ref

BIG = 1e29
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def random_sweep_inputs(lead, c, device, seed=0):
    """Raw per-layer tables (lead..., C) zero-padded past each row's L, and
    per-row vectors, as the grid feeds the kernel."""
    rng = np.random.default_rng(seed)
    L = rng.integers(max(1, c // 3), c, lead)
    L.reshape(-1)[0] = c - 1
    live = np.arange(c) <= L[..., None]
    macs = rng.uniform(1e6, 5e7, lead + (c,)) * live
    params_b = rng.uniform(1e3, 5e6, lead + (c,)) * live
    macs[..., 0] = params_b[..., 0] = 0.0
    acts = rng.uniform(1e4, 2e6, lead + (c,)) * live
    psi = np.where(np.arange(c) < L[..., None], acts, 0.0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    args = [f32(macs), f32(params_b), f32(acts), f32(psi),
            torch.as_tensor(L, device=device),
            f32(rng.uniform(0.5, 2.5, lead)),
            f32(rng.exponential(1.0, lead) * 1.6e-11),
            f32(rng.uniform(0, 50, lead)), f32(rng.uniform(0, 50, lead))]
    scalars = dict(rho=0.12, kappa=1e-28, p_tx=0.1, w_hz=5e6,
                   n0=10 ** (-17.4) / 1000, f_max_ue=1.5e9, f_max_es=15e9,
                   v=10.0, gamma_ue=0.2, gamma_es=0.8, stability_margin=1e-3)
    return args, scalars


@pytest.mark.gpu
@pytest.mark.parametrize("lead,c", [((4096, 8), 11), ((1, 256), 103),
                                    ((1, 37), 11), ((2, 3), 70)])
def test_cuda_kernel_matches_plain(lead, c):
    """On the card: the CUDA sweep (through the batched entry point) against
    the plain version on the same inputs, with ragged row counts and C past
    one warp's width; one launch per call."""
    _need_card()
    args, scalars = random_sweep_inputs(lead, c, "cuda", seed=c)
    row = p_ref.pack_scalars(scalars, "cuda")
    before = p_ps.partition_sweep_cuda.launches
    got = p_ops.partition_sweep_batched(*args, row)
    torch.cuda.synchronize()
    assert p_ps.partition_sweep_cuda.launches == before + 1
    want = p_ref.partition_sweep_batched_ref(*args, row)
    g, w = _np(got), _np(want)
    feasible = w < BIG
    np.testing.assert_allclose(g[feasible], w[feasible], rtol=1e-4, atol=1e-3)
    assert ((g > BIG) == ~feasible).all()
    # argmin: equal wherever the plain best and second best are apart
    srt = np.sort(w, -1)
    gap = srt[..., 1] - srt[..., 0] > 1e-3 + 1e-4 * np.abs(srt[..., 0])
    assert (np.argmin(g, -1)[gap] == np.argmin(w, -1)[gap]).all()
    picked = np.take_along_axis(w, np.argmin(g, -1)[..., None], -1)[..., 0]
    assert (picked <= srt[..., 0] + 1e-3 + 1e-4 * np.abs(srt[..., 0])).all()


@pytest.mark.gpu
def test_cuda_kernel_rejects_non_contiguous():
    _need_card()
    args, scalars = random_sweep_inputs((1, 16), 11, "cuda")
    flat = [a[0] for a in args]
    flat[0] = flat[0].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        p_ps.partition_sweep_cuda(*flat, p_ref.pack_scalars(scalars, "cuda")[None])


@pytest.mark.gpu
def test_grid_on_card_launches_kernel_once_per_oracle_slot():
    _need_card()
    grid = p_sc.ScenarioGrid(p_sc.multicell_grid(64, 8))
    before = p_ps.partition_sweep_cuda.launches
    states, res, summary = grid.rollout("oracle", steps=3)
    torch.cuda.synchronize()
    assert p_ps.partition_sweep_cuda.launches == before + 3
    assert res.delay.is_cuda and torch.isfinite(res.delay).all()
    cpu = p_sc.ScenarioGrid(p_sc.multicell_grid(64, 8), device="cpu")
    st = cpu.reset(cpu.generator(0))
    st_gpu = _tree.to_device(st, "cuda")
    got = _np(grid.objective_tables(st_gpu))
    want = _np(cpu.objective_tables(st))
    feasible = want < 1e29
    np.testing.assert_allclose(got[feasible], want[feasible],
                               rtol=SWEEP_RTOL, atol=SWEEP_ATOL)


@pytest.mark.gpu
def test_grid_with_per_cell_constants_runs_the_kernel_on_card():
    """Cells with their own Lyapunov weight V share one launch per Oracle
    slot, and the table matches the CPU path's plain version."""
    _need_card()
    cells = p_sc.multicell_grid(16, 8, uniform_scalars=False)
    grid = p_sc.ScenarioGrid(cells)
    v = _np(grid.sweep_scalars)[:, p_ref.SCALAR_NAMES.index("v")]
    assert len(set(v.tolist())) == 16
    before = p_ps.partition_sweep_cuda.launches
    grid.rollout("oracle", steps=2)
    torch.cuda.synchronize()
    assert p_ps.partition_sweep_cuda.launches == before + 2
    cpu = p_sc.ScenarioGrid(cells, device="cpu")
    st = cpu.reset(cpu.generator(1))
    got = _np(grid.objective_tables(_tree.to_device(st, "cuda")))
    want = _np(cpu.objective_tables(st))
    feasible = want < BIG
    np.testing.assert_allclose(got[feasible], want[feasible],
                               rtol=SWEEP_RTOL, atol=SWEEP_ATOL)
    assert ((got > BIG) == ~feasible).all()
