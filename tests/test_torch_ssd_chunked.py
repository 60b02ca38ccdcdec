"""Port parity: the SSD kernel's chunk-parallel decomposition, off the card.

``kernels.ssd_scan.ssd_scan_chunked`` mirrors in plain torch the three
passes the CUDA kernel runs: (a) each chunk's own state, carry factor and
inter factors, (b) the serial pass over chunks that turns the chunks'
states into the state entering each chunk, (c) y from the chunk's own
term and the entering state.  No path uses it; here it is held against
the reference's plain SSD scan (``repro.kernels.ref.ssd_scan_ref``, at one
chunk the length of the sequence) and its Pallas kernel in interpret mode,
on the same numpy inputs, at the reference's 1e-4 in float32: resets at
step 0, on chunk boundaries, on a chunk's last step and twice in one
chunk, odd lengths and G = 2 and 3.  That is the reset algebra pass (b)
relies on (a chunk that holds a reset carries nothing).  The launch plan,
the shared-memory mirror of the kernel's layout and the bounds' counts are
checked too.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as r_ref
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro_torch.kernels import ssd_scan as p_ssd
from test_torch_scans import both, resets, ssd_inputs

TOL = dict(rtol=1e-4, atol=1e-4)
r_ssd_ref = jax.jit(r_ref.ssd_scan_ref, static_argnames="chunk")

CASES = {
    # (b, s, h, p, g, n, mirror chunk, resets, Pallas chunk or None)
    "one_chunk_odd": (1, 13, 2, 8, 1, 4, 16, None, None),
    "reset_at_step_0": (2, 48, 3, 8, 1, 4, 16, ((0, 0), (1, 0)), 16),
    "resets_on_boundaries": (2, 48, 3, 8, 1, 4, 16,
                             ((0, 16), (0, 32), (1, 47)), 16),
    "twice_in_a_chunk_odd": (1, 40, 2, 8, 1, 4, 16,
                             ((0, 3), (0, 9), (0, 20)), None),
    "last_step_and_boundary": (2, 33, 2, 8, 1, 4, 8,
                               ((0, 32), (1, 8), (1, 15)), None),
    "g2_odd": (2, 37, 4, 8, 2, 4, 8, ((0, 8), (1, 3)), None),
    "g3_across_boundary": (1, 48, 3, 8, 3, 8, 16, ((0, 15), (0, 16)), 16),
    "default_chunk": (1, 150, 2, 8, 1, 4, p_ssd.CHUNK, ((0, 64), (0, 100)),
                      None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_pass_mirror_matches_reference(case):
    b, s, h, p, g, n, chunk, at, pallas_chunk = CASES[case]
    arrays = ssd_inputs(b, s, h, p, g, n, seed=3)
    reset = None if at is None else resets(b, s, at)
    j, t, jr, tr = both(arrays, reset)
    y, st = p_ssd.ssd_scan_chunked(*t, reset=tr, chunk=chunk)
    assert y.shape == (b, s, h, p) and st.shape == (b, h, n, p)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    y_r, st_r = r_ssd_ref(*j, chunk=s, reset=jr)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_r), **TOL)
    if pallas_chunk:
        y_p, st_p = ssd_scan_pallas(*j, chunk=pallas_chunk, reset=jr,
                                    interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_p), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_p), **TOL)


def test_mirror_holds_mamba2_decays_over_chunks():
    """At mamba2's decays (A = -1 .. -16) over 64-step chunks, the mirror is
    within 1e-4 of the plain scan evaluated in float64."""
    b, s, h, p, n = 1, 200, 8, 8, 16
    x, dt, _, bm, cm, d = [torch.from_numpy(a) for a in
                           ssd_inputs(b, s, h, p, 1, n, seed=4)]
    a_log = torch.log(torch.linspace(1.0, 16.0, h))
    reset = torch.zeros(b, s, dtype=torch.bool)
    reset[0, 128] = True
    y, st = p_ssd.ssd_scan_chunked(x, dt, a_log, bm, cm, d, reset=reset)
    from repro_torch.kernels import ref as p_ref
    y64, st64 = p_ref.ssd_scan_ref(*[v.double() for v in
                                     (x, dt, a_log, bm, cm, d)],
                                   chunk=s, reset=reset)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st64.numpy(), **TOL)


def test_mirror_keeps_bf16_output_type():
    arrays = ssd_inputs(1, 70, 2, 8, 1, 4, seed=5)
    x, dt, a_log, bm, cm, d = [torch.from_numpy(a) for a in arrays]
    y, st = p_ssd.ssd_scan_chunked(x.bfloat16(), dt, a_log, bm.bfloat16(),
                                   cm.bfloat16(), d)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


@pytest.mark.parametrize("shape,want", [
    ((1, 32, 64, 64), (1, 4)),     # mamba2 solo prefill: 256 blocks
    ((2, 32, 64, 64), (1, 2)),     # two solo prefills: 256 blocks
    ((2, 512, 64, 64), (8, 1)),    # the split check: 1,024 blocks
    ((1, 65, 64, 64), (2, 2)),     # one step past a chunk
    ((1, 64, 2, 32), (1, 2)),      # groups keep 16 columns
    ((1, 13, 2, 8), (1, 1)),       # P 8 is not split
])
def test_plan_splits_the_sequence_and_the_columns(shape, want):
    b, s, h, p = shape
    chunks, groups = p_ssd.plan(b, s, h, p)
    assert (chunks, groups) == want
    assert chunks == -(-s // p_ssd.CHUNK)
    assert p % groups == 0 and (groups == 1 or (p // groups) % 16 == 0)
    assert p_ssd.kernels_per_call(s) == (1 if s <= p_ssd.CHUNK else 3)


def test_split_shape_launches_eight_times_the_blocks():
    """The one-block-per-(head, batch row) kernel launched 128 blocks at
    B 2, S 512, H 64; the chunk passes launch 8x that."""
    chunks, groups = p_ssd.plan(2, 512, 64, 64)
    assert chunks * groups * 64 * 2 >= 8 * 128
    assert p_ssd.plan(1, 32, 64, 64)[1] * 64 == p_ssd.TARGET_BLOCKS


@pytest.mark.parametrize("itemsize", [2, 4])
def test_shared_bytes_fit_at_mamba2_widths(itemsize):
    """Every mode fits a Hopper block at mamba2's N 128, P 64, and at the
    one-chunk path's 16-column groups; the figures are the kernel layout's
    (bf16: the output pass, with the entering state's hi and lo parts, is
    the largest; float32: the same pass with the decay weights)."""
    for mode in p_ssd.MODES:
        for width in (16, 32, 64):
            assert p_ssd.shared_bytes(128, width, itemsize, mode) <= p_ssd.MAX_SHARED
    assert p_ssd.shared_bytes(128, 64, 2) == 65_024
    assert p_ssd.shared_bytes(128, 64, 2, "state") == 46_592
    assert p_ssd.shared_bytes(128, 64, 4) == 135_680
    assert p_ssd.shared_bytes(128, 64) == p_ssd.shared_bytes(128, 64, 4)
    assert p_ssd.shared_bytes(256, 256, itemsize) > p_ssd.MAX_SHARED


def test_bounds_count_the_function_not_the_passes():
    """op_count and byte_count read the same work whatever implements it:
    the split shape as before, and the engine's B 1, S 32 bound (2.65 MB,
    2.1 MB of it the float32 state; 0.79 us at 3.35 TB/s)."""
    assert p_ssd.byte_count(2, 512, 64, 64, 1, 128, 2, False) == 21_758_464
    assert p_ssd.op_count(2, 512, 64, 64, 128) == p_ssd.op_count(
        2, 512, 64, 64, 128, tile=64)
    engine = p_ssd.byte_count(1, 32, 64, 64, 1, 128, 2, True)
    assert engine == 2_646_560
    assert 64 * 128 * 64 * 4 == 2_097_152
    assert abs(engine / 3.35e12 * 1e3 - 0.00079) < 1e-5
    assert p_ssd.op_count(1, 32, 64, 64, 128) == 64 * (
        2 * (32 * 33 // 2) * (128 + 64) + 4 * 32 * 128 * 64 + 2 * 32 * 64)
