"""Port parity: the SSD and RG-LRU scans.

``kernels.ops.ssd_scan`` / ``rglru_scan`` on CPU tensors (the plain
versions in ``kernels.ref``) against the reference's plain versions
(``repro.kernels.ref``) and its Pallas kernels in interpret mode, on the
same inputs drawn with numpy, at the reference's scan tolerance (1e-4).
The cases are the reference's own (``tests/test_kernels.py``): resets mid-
chunk, on a chunk boundary and per row, odd lengths, G > 1.  The kernels'
bytes and operations, which ``chip_smoke.py`` turns into bounds, are held
to the figures worked out by hand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import common as r_common
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rglru_scan as p_rg
from repro_torch.kernels import ssd_scan as p_ssd
from repro_torch.models import common as p_common

TOL = dict(rtol=1e-4, atol=1e-4)
# the reference's dispatchers, compiled once per shape (eager JAX would
# trace the scans op by op)
r_ssd_scan = jax.jit(r_ops.ssd_scan, static_argnames="chunk")
r_rglru_scan = jax.jit(r_ops.rglru_scan)


def ssd_inputs(b, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.standard_normal((b, s, h, p))),
            f(np.log1p(np.exp(rng.standard_normal((b, s, h))))),
            f(np.log(np.linspace(1.0, 8.0, h))),
            f(rng.standard_normal((b, s, g, n)) * 0.5),
            f(rng.standard_normal((b, s, g, n)) * 0.5),
            f(np.linspace(0.5, 1.5, h)))


def resets(b, s, at):
    r = np.zeros((b, s), bool)
    for row, t in at:
        r[row, t] = True
    return r


def both(arrays, reset):
    """The same numpy inputs as jax and torch arguments."""
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(a) for a in arrays]
    if reset is None:
        return j, t, None, None
    return j, t, jnp.asarray(reset), torch.from_numpy(reset)


SSD_CASES = {
    # (b, s, h, p, g, n, chunk, resets, through the Pallas kernel too)
    "test_kernels_1": (2, 64, 4, 16, 2, 8, 16, None, False),
    "test_kernels_2": (1, 128, 2, 32, 1, 16, 32, None, False),
    "g3": (2, 96, 3, 16, 3, 8, 24, None, False),
    "resets": (2, 64, 3, 8, 1, 4, 16, ((0, 5), (0, 16), (1, 37)), True),
    "odd_length": (1, 13, 2, 8, 1, 4, 8, None, False),
    "odd_length_resets_g2": (2, 37, 4, 8, 2, 4, 16, ((0, 3), (1, 16)),
                             False),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_scan_matches_reference(case):
    b, s, h, p, g, n, chunk, at, pallas = SSD_CASES[case]
    arrays = ssd_inputs(b, s, h, p, g, n)
    reset = None if at is None else resets(b, s, at)
    j, t, jr, tr = both(arrays, reset)
    y, st = p_ops.ssd_scan(*t, chunk=chunk, reset=tr)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, n, p)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    y_r, st_r = r_ssd_scan(*j, chunk=chunk, reset=jr)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), **TOL)
    if pallas:
        y_p, st_p = ssd_scan_pallas(*j, chunk=chunk, reset=jr, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_p), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_p), **TOL)
    if at is not None:
        y_plain, _ = p_ops.ssd_scan(*t, chunk=chunk)
        assert not np.allclose(y.numpy(), y_plain.numpy()), \
            "the reset must change the output"


def test_ssd_plain_and_step_match_reference():
    """``ref.ssd_scan_ref`` and ``ref.ssd_step_ref`` against the
    reference's, and a loop of steps against the scan."""
    b, s, h, p, g, n = 1, 32, 2, 8, 1, 4
    arrays = ssd_inputs(b, s, h, p, g, n, seed=1)
    j, t, _, _ = both(arrays, None)
    y, st = p_ref.ssd_scan_ref(*t, chunk=8)
    y_r, st_r = r_ref.ssd_scan_ref(*j, chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), **TOL)
    x, dt, a_log, bm, cm, d = t
    state = torch.zeros(b, h, n, p)
    r_state = jnp.zeros((b, h, n, p))
    for i in range(s):
        y_t, state = p_ref.ssd_step_ref(state, x[:, i], dt[:, i], a_log,
                                        bm[:, i], cm[:, i], d)
        y_rt, r_state = r_ref.ssd_step_ref(r_state, j[0][:, i], j[1][:, i],
                                           j[2], j[3][:, i], j[4][:, i], j[5])
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_rt), **TOL)
        np.testing.assert_allclose(y_t.numpy(), y[:, i].numpy(), **TOL)
    np.testing.assert_allclose(state.numpy(), st.numpy(), **TOL)


def test_ssd_plain_holds_mamba2_decays_against_float64():
    """At mamba2's decays (A = -1 .. -16, dt ~ softplus of a normal) over a
    256-step chunk, the float32 plain scan (float64 prefix sums) is within
    the reference's 1e-4 of the same scan evaluated in float64."""
    b, s, h, p, n = 1, 512, 16, 16, 32
    x, dt, _, bm, cm, d = [torch.from_numpy(a) for a in
                           ssd_inputs(b, s, h, p, 1, n, seed=4)]
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    args = (x, dt, a_log, bm, cm, d)
    y, st = p_ref.ssd_scan_ref(*args, chunk=256)
    y64, st64 = p_ref.ssd_scan_ref(*[t.double() for t in args], chunk=256)
    assert y64.dtype == st64.dtype == torch.float64
    share = ((y.double() - y64).abs() / (1e-4 + 1e-4 * y64.abs())).max()
    assert float(share) < 1.0, float(share)
    np.testing.assert_allclose(st.numpy(), st64.numpy(), **TOL)


def test_ssd_plain_keeps_input_dtype_and_chunk_rule():
    arrays = ssd_inputs(1, 16, 2, 8, 1, 4, seed=2)
    x, dt, a_log, bm, cm, d = [torch.from_numpy(a) for a in arrays]
    y, st = p_ref.ssd_scan_ref(x.bfloat16(), dt, a_log, bm.bfloat16(),
                               cm.bfloat16(), d, chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of chunk"):
        p_ref.ssd_scan_ref(x, dt, a_log, bm, cm, d, chunk=5)


RGLRU_CASES = {
    # (b, s, r, resets, through the Pallas kernel too)
    "test_kernels_1": (2, 128, 64, None, False),
    "test_kernels_2": (1, 64, 128, None, False),
    "test_kernels_3": (3, 256, 32, None, False),
    "resets": (2, 64, 16, ((0, 5), (0, 16), (1, 37)), True),
    "odd_length": (2, 37, 16, None, True),
    "odd_length_resets": (2, 37, 16, ((0, 20), (1, 20)), True),
}


def rglru_inputs(b, s, r, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, r)) * 0.3).astype(np.float32)
    a = (1.0 / (1.0 + np.exp(-(rng.standard_normal((b, s, r)) + 2.0)))
         ).astype(np.float32)
    return x, a


@pytest.mark.parametrize("case", sorted(RGLRU_CASES))
def test_rglru_scan_matches_reference(case):
    b, s, r, at, pallas = RGLRU_CASES[case]
    arrays = rglru_inputs(b, s, r)
    reset = None if at is None else resets(b, s, at)
    j, t, jr, tr = both(arrays, reset)
    got = p_ops.rglru_scan(*t, tr)
    assert got.shape == (b, s, r) and got.dtype == torch.float32
    want = r_rglru_scan(*j, reset=jr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if pallas:
        pal = rglru_scan_pallas(*j, reset=jr, chunk=16, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


def test_rglru_plain_is_the_sequential_recurrence():
    """The doubling scan against a plain loop, with state zeroed at the
    resets; and a bf16 input comes back in bf16."""
    x, a = rglru_inputs(2, 50, 8, seed=3)
    reset = resets(2, 50, ((0, 0), (0, 31), (1, 17)))
    h = np.zeros((2, 8))
    want = []
    for t in range(50):
        h = np.where(reset[:, t, None], 0.0, a[:, t] * h) + x[:, t]
        want.append(h.copy())
    got = p_ref.rglru_scan_ref(torch.from_numpy(x), torch.from_numpy(a),
                               torch.from_numpy(reset))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-5,
                               atol=1e-5)
    out = p_ref.rglru_scan_ref(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(a).bfloat16())
    assert out.dtype == torch.bfloat16


def test_pad_reset_matches_reference():
    valid = np.arange(9)[None, :] >= np.array([0, 1, 4, 9])[:, None]
    got = p_common.pad_reset(torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        r_common.pad_reset(jnp.asarray(valid))))
    assert got[2].tolist() == [True] * 5 + [False] * 4


def test_scan_ops_run_the_plain_versions_on_cpu():
    """CPU tensors never reach the kernels' wrappers: the launch counts
    stay where they were."""
    before = (p_ssd.ssd_scan_cuda.launches, p_rg.rglru_scan_cuda.launches)
    arrays = ssd_inputs(1, 8, 2, 8, 1, 4)
    p_ops.ssd_scan(*[torch.from_numpy(a) for a in arrays], chunk=8)
    p_ops.rglru_scan(*[torch.from_numpy(a) for a in rglru_inputs(1, 8, 4)])
    assert (p_ssd.ssd_scan_cuda.launches,
            p_rg.rglru_scan_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        p_ssd.ssd_scan_cuda(*[torch.from_numpy(a) for a in arrays])
    with pytest.raises(ValueError, match="CUDA"):
        p_rg.rglru_scan_cuda(*[torch.from_numpy(a)
                               for a in rglru_inputs(1, 8, 4)])


def test_scan_bounds_at_the_split_shape():
    """The bytes and operations behind the bounds at B 2, S 512:
    mamba2's H 64, P 64, N 128 in bf16 (about 21.8 MB, 3 GFLOP at the
    kernel's 64-step tile) and recurrentgemma's R 2560 in float32 (about
    31.5 MB)."""
    assert p_ssd.byte_count(2, 512, 64, 64, 1, 128, 2, False) == 21_758_464
    ops = p_ssd.op_count(2, 512, 64, 64, 128)
    assert 2.9e9 < ops < 3.1e9
    # one step's recurrence costs 4 N P: the chunked form is within 2x
    assert ops < 2 * 2 * 512 * 64 * 4 * 128 * 64
    assert p_rg.byte_count(2, 512, 2560, 4, False) == 31_457_280
    assert p_rg.op_count(2, 512, 2560) == 2 * 2 * 512 * 2560
    assert p_ssd.shared_bytes(128, 64) <= p_ssd.MAX_SHARED
    assert p_ssd.shared_bytes(256, 256) > p_ssd.MAX_SHARED
