"""Port parity: the partition sweep.

The port's plain sweep (``repro_torch.kernels.ref``) is held against both
the reference's Pallas kernel in interpret mode and its jnp reference, with
the tolerance tests/test_kernels.py uses for the sweep: rtol 1e-4 and atol
1e-3 on feasible cells, the same infeasible set and the same argmin.  The
CUDA kernel itself runs only on the card (tests/test_torch_gpu.py); here
its wrapper's checks, build keying and constants are tested.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as r_sc
from repro.kernels import ref as r_ref
from repro.kernels.partition_sweep import _RHI, _RLO, partition_sweep_batched
from repro_torch.kernels import _build as p_build
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import partition_sweep as p_ps
from repro_torch.kernels import ref as p_ref
from test_torch_gpu import random_sweep_inputs

BIG = 1e29


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_sweep_close(got, want):
    got, want = _np(got), _np(want)
    feasible = want < BIG
    np.testing.assert_allclose(got[feasible], want[feasible],
                               rtol=1e-4, atol=1e-3)
    assert ((got > BIG) == ~feasible).all()
    assert (np.argmin(got, -1) == np.argmin(want, -1)).all()


def _to_torch(args):
    out = []
    for a in args:
        a = np.asarray(a)
        out.append(torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i"
                                   else a.astype(np.float32)))
    return out


def _grid_args(cells=3, ues=5, seed=0, q_off=5.0):
    grid = r_sc.ScenarioGrid(r_sc.multicell_grid(cells, ues))
    st = grid.reset(jax.random.PRNGKey(seed))
    p = grid.params
    rng = np.random.default_rng(seed)
    qe = np.asarray(st.queues.energy) + q_off * rng.uniform(0, 2, (cells, ues))
    qm = np.asarray(st.queues.memory) + q_off * rng.uniform(0, 2, (cells, ues))
    args = (p.macs, p.param_bytes, p.act_bytes, p.psi, p.L, st.lam, st.gain,
            qe.astype(np.float32), qm.astype(np.float32))
    return [np.asarray(a) for a in args], grid.sweep_scalars


@pytest.mark.parametrize("seed,q_off", [(0, 5.0), (7, 0.0), (11, 120.0)])
def test_plain_sweep_matches_pallas_and_reference(seed, q_off):
    args, scalars = _grid_args(seed=seed, q_off=q_off)
    jargs = [jnp.asarray(a) for a in args]
    want_pallas = partition_sweep_batched(*jargs, scalars, interpret=True)
    want_ref = r_ref.partition_sweep_batched_ref(*jargs, scalars)
    row = p_ref.pack_scalars(scalars)
    got = p_ref.partition_sweep_batched_ref(*_to_torch(args), row)
    assert got.shape == (3, 5, 11) and got.dtype == torch.float32
    assert_sweep_close(got, want_pallas)
    assert_sweep_close(got, want_ref)
    # one row per cell gives the same table as one row for every cell
    assert torch.equal(p_ref.partition_sweep_batched_ref(
        *_to_torch(args), row.expand(3, -1)), got)
    # the CPU dispatch of the kernel entry points is the plain version
    same = p_ops.partition_sweep_batched(*_to_torch(args), row)
    assert torch.equal(same, got)
    cell = [t[1] for t in _to_torch(args)]
    assert torch.equal(p_ops.partition_sweep(*cell, row),
                       p_ref.partition_sweep_ref(*cell, row))
    assert_sweep_close(p_ops.partition_sweep(*cell, row), want_ref[1])


def test_plain_sweep_per_cell_scalars_match_reference_per_cell():
    """Cells with their own MEC constants in one batched call: each cell's
    table equals the reference's single-cell sweep under that cell's
    constants."""
    args, base = _grid_args(seed=3)
    per_cell = [dict(base, v=v, kappa=base["kappa"] * k, f_max_es=f)
                for v, k, f in ((5.0, 1.0, base["f_max_es"]),
                                (10.0, 2.0, 0.5 * base["f_max_es"]),
                                (20.0, 0.5, 2.0 * base["f_max_es"]))]
    rows = torch.stack([p_ref.pack_scalars(d) for d in per_cell])
    got = p_ops.partition_sweep_batched(*_to_torch(args), rows)
    for b, scalars in enumerate(per_cell):
        want = r_ref.partition_sweep_ref(*[jnp.asarray(a[b]) for a in args],
                                         scalars)
        assert_sweep_close(got[b], want)


def _lm_fleet(n=256, seed=0):
    from repro.profiling.lmprofiles import all_lm_profiles
    from repro.profiling.profiles import ProfileBatch
    profs = list(all_lm_profiles().values())
    batch = ProfileBatch([profs[i % len(profs)] for i in range(n)])
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    args = [f32(batch.macs), f32(batch.param_bytes), f32(batch.act_bytes),
            f32(batch.psi), batch.L.astype(np.int32),
            f32(rng.uniform(0.5, 2.5, n)),
            f32(rng.exponential(1.0, n) * 1.6e-11),
            f32(rng.uniform(0, 50, n)), f32(rng.uniform(0, 50, n))]
    scalars = dict(rho=0.12, kappa=1e-28, p_tx=0.1, w_hz=5e6,
                   n0=10 ** (-17.4) / 1000, f_max_ue=5e9, f_max_es=200e9,
                   v=10.0, gamma_ue=0.2, gamma_es=0.8, stability_margin=1e-3)
    return args, scalars


def test_plain_sweep_lm_fleet_c103():
    """The 256-UE LM-profile fleet of benchmarks/kernels_micro.py (C = 103):
    against the jnp reference on all rows, the Pallas kernel on 16 rows."""
    args, scalars = _lm_fleet()
    assert args[0].shape == (256, 103)
    got = p_ref.partition_sweep_ref(*_to_torch(args), p_ref.pack_scalars(scalars))
    assert_sweep_close(got, r_ref.partition_sweep_ref(
        *[jnp.asarray(a) for a in args], scalars))
    from repro.kernels.partition_sweep import partition_sweep_pallas
    sub = [a[:16] for a in args]
    # the first 16 rows, with the fleet's even split (n_total = 256)
    want = partition_sweep_pallas(*[jnp.asarray(a) for a in sub], scalars,
                                  interpret=True, n_total=256)
    assert_sweep_close(_np(got)[:16], want)


def test_kernel_ratio_literals_match_reference():
    src = p_ps.LIBRARY.source.read_text()
    blocks = re.findall(r"kRatio(Lo|Hi)\[kFibIters\] = \{(.*?)\};", src, re.S)
    got = {name: np.asarray([float(x.rstrip("f")) for x in
                             body.replace("\n", " ").split(",") if x.strip()],
                            np.float32) for name, body in blocks}
    np.testing.assert_array_equal(got["Lo"], _RLO)
    np.testing.assert_array_equal(got["Hi"], _RHI)
    # and the operation counts of the roofline bound are the ones the kernel
    # source states
    assert p_ps.OPS_PER_FEASIBLE_CUT == 1188 and "1,188" in src
    assert f"takes {p_ps.OPS_PER_CUT} operations" in src
    assert f"({p_ps.OPS_PER_ROW} operations)" in src
    assert p_ps.op_count(2, 3, 4) == 2 * 13 + 6 * 9 + 4 * 1188


def test_kernel_wrapper_rejects_cpu_and_bad_inputs():
    args, scalars = _grid_args()
    flat = [t.reshape((15,) + tuple(t.shape[2:])) for t in _to_torch(args)]
    rows = p_ref.pack_scalars(scalars).expand(3, -1).contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        p_ps.partition_sweep_cuda(*flat, rows, n_total=5)
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        p_ps.partition_sweep_cuda(*_to_torch(args), rows)
    # one scalar row per cell of n_total rows, and n_total divides the rows
    with pytest.raises(ValueError, match="scalars must be"):
        p_ps.partition_sweep_cuda(*flat, rows[:1], n_total=5)
    with pytest.raises(ValueError, match="divide"):
        p_ps.partition_sweep_cuda(*flat, rows, n_total=4)


def test_build_is_keyed_to_the_source(monkeypatch, tmp_path):
    """The shared build helper names each library by a hash of its source
    and flags, and says so when there is no nvcc."""
    path = p_ps.LIBRARY.path()
    assert path.parent.name == "build" and path.suffix == ".so"
    assert "-fmad=false" in p_ps.LIBRARY.flags
    src = tmp_path / "k.cu"
    src.write_text(p_ps.LIBRARY.source.read_text() + "\n// edited\n")
    edited = p_build.Library("partition_sweep", src, lambda lib: None,
                             extra_flags=("-fmad=false",))
    assert edited.path() != path
    assert p_build.Library("partition_sweep", p_ps.LIBRARY.source,
                           lambda lib: None).path() != path
    monkeypatch.setattr(p_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        p_build.nvcc()


def test_random_sweep_inputs_plain_matches_reference():
    """The generator the card test uses, checked here on the CPU against the
    jnp reference (so the card test compares against a checked plain)."""
    args, scalars = random_sweep_inputs((3, 8), 70, "cpu")
    want = r_ref.partition_sweep_batched_ref(
        *[jnp.asarray(_np(a)) for a in args], scalars)
    assert_sweep_close(p_ref.partition_sweep_batched_ref(
        *args, p_ref.pack_scalars(scalars)), want)


@pytest.mark.parametrize("c", [1, 8, 16, 17, 32, 33])
def test_plain_sweep_at_every_row_packing_matches_reference(c):
    """The widths the kernel packs 32, 4, 2, 1, 1 and 1 rows to a warp:
    the port's plain sweep against the jnp reference on the card test's
    inputs (C = 1 is one cut, L = 0, for every row)."""
    args, scalars = random_sweep_inputs((3, 5), c, "cpu", seed=c)
    want = r_ref.partition_sweep_batched_ref(
        *[jnp.asarray(_np(a)) for a in args], scalars)
    got = p_ref.partition_sweep_batched_ref(*args, p_ref.pack_scalars(scalars))
    assert got.shape == (3, 5, c)
    assert_sweep_close(got, want)


def test_sweep_lanes_per_row_and_rows_per_block():
    """A row takes the least power of two >= C lanes, at most 32; a block of
    8 warps holds 32 / lanes rows a warp; the launch picks the same."""
    want = {1: (1, 256), 2: (2, 128), 3: (4, 64), 8: (8, 32), 11: (16, 16),
            16: (16, 16), 17: (32, 8), 32: (32, 8), 33: (32, 8),
            103: (32, 8)}
    for c in range(1, 104):
        lanes = p_ps.lanes_per_row(c)
        assert lanes >= min(c, 32) and lanes & (lanes - 1) == 0
        assert lanes == 1 or lanes // 2 < c
        assert p_ps.rows_per_block(c) * lanes == 8 * 32
        if c in want:
            assert (lanes, p_ps.rows_per_block(c)) == want[c]
    src = " ".join(p_ps.LIBRARY.source.read_text().split())
    for lanes in (1, 2, 4, 8, 16):
        assert f"C <= {lanes} ? launch_rows<{lanes}>" in src
    assert ": launch_rows<32>;" in src


def test_rows_above_the_kernel_clock_limit_are_refused_for_the_card_only():
    """A cell with f_max_ue = 5e12 Hz, above ``F_MAX_UE_LIMIT``: the check
    the CUDA-path builder (``core.sweep.scalar_rows_p`` on CUDA tensors)
    runs refuses its rows, naming the field and the limit; on the CPU the
    grid builds them unchecked and the plain sweep scores the cell as the
    reference's plain sweep does (the reference has no limit)."""
    from repro.core import env as r_env
    from repro_torch.core import env as p_env
    from repro_torch.core import scenarios as p_sc
    grid = p_sc.ScenarioGrid(
        [p_sc.paper_table1(cfg=p_env.MecConfig(f_max_ue=5e12))], device="cpu")
    f_col = p_ref.SCALAR_NAMES.index("f_max_ue")
    assert float(grid.sweep_scalars[0, f_col]) == pytest.approx(5e12)
    with pytest.raises(ValueError, match=r"f_max_ue .* F_MAX_UE_LIMIT = 1e\+12"):
        p_ps.check_scalar_rows(grid.sweep_scalars)
    p_ps.check_scalar_rows(p_sc.ScenarioGrid(
        [p_sc.paper_table1()], device="cpu").sweep_scalars)

    ref_grid = r_sc.ScenarioGrid(
        [r_sc.paper_table1(cfg=r_env.MecConfig(f_max_ue=5e12))])
    st = ref_grid.reset(jax.random.PRNGKey(0))
    p = ref_grid.params
    args = [np.asarray(a) for a in (p.macs, p.param_bytes, p.act_bytes,
                                    p.psi, p.L, st.lam, st.gain,
                                    st.queues.energy, st.queues.memory)]
    want = r_ref.partition_sweep_batched_ref(
        *[jnp.asarray(a) for a in args], ref_grid.sweep_scalars)
    got = p_ops.partition_sweep_batched(*_to_torch(args), grid.sweep_scalars)
    assert_sweep_close(got, want)
