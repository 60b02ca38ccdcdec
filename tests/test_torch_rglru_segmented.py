"""Port parity: the RG-LRU kernel's segmented scan, off the card.

``kernels.rglru_scan.rglru_scan_segmented`` mirrors in plain torch what the
CUDA kernel does in each tile of S: every segment's composite pair (A =
prod a, X = its scan from 0, a = 0 at a reset), the serial scan over the
segments that gives the h entering each, and the replay from it, with h
carried from tile to tile.  No path uses it; here it is held against the
reference's dispatcher (``repro.kernels.ops.rglru_scan``) and its Pallas
kernel in interpret mode, on the same numpy inputs, at the reference's
1e-4 in float32 and 2e-2 in bf16: resets at step 0, on a segment's first
and last step, on a tile boundary and twice in one segment, S = 1, odd S,
S not a multiple of a tile, R not a multiple of the kernel's channel tile.
The launch plan is checked too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro_torch.kernels import rglru_scan as p_rg
from test_torch_scans import both, resets, rglru_inputs

TOL = dict(rtol=1e-4, atol=1e-4)
r_rglru_scan = jax.jit(r_ops.rglru_scan)

CASES = {
    # (b, s, r, segments, steps, resets, Pallas chunk or None)
    "reset_at_step_0": (2, 48, 16, 4, 4, ((0, 0), (1, 0)), 16),
    "segment_first_and_last_step": (2, 32, 16, 4, 4,
                                    ((0, 4), (0, 7), (1, 11), (1, 12)), 16),
    "tile_boundary": (2, 48, 16, 4, 4, ((0, 16), (1, 15), (1, 32)), 16),
    "twice_in_a_segment": (1, 40, 16, 2, 8, ((0, 9), (0, 13), (0, 16)), 8),
    "s_1": (2, 1, 16, 1, 4, ((1, 0),), None),
    "odd_s_37": (2, 37, 16, 4, 4, ((0, 20), (1, 36)), None),
    "odd_s_197_r_37": (1, 197, 37, 16, 8, ((0, 8), (0, 64), (0, 128)), 32),
    "s_not_a_tile_multiple": (2, 100, 16, 3, 8, ((0, 24), (1, 47)), None),
    "no_resets_long": (2, 256, 16, 16, 8, None, None),
    # the kernel's own plans (plan(b, s, r)): a recurrentgemma solo prefill
    # with a left pad of 3, and a split-shaped length
    "plan_engine_pad_3": (1, 32, 16, 8, 4, ((0, 0), (0, 1), (0, 2)), None),
    "plan_split": (2, 512, 16, 16, 8, ((1, 0), (1, 127), (1, 128)), None),
}


def _both(case, seed=3):
    b, s, r, segments, steps, at, pallas = CASES[case]
    arrays = rglru_inputs(b, s, r, seed=seed)
    reset = None if at is None else resets(b, s, at)
    return both(arrays, reset)


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmented_mirror_matches_reference(case):
    b, s, r, segments, steps, at, pallas = CASES[case]
    j, t, jr, tr = _both(case)
    got = p_rg.rglru_scan_segmented(*t, tr, segments=segments, steps=steps)
    assert got.shape == (b, s, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(r_rglru_scan(
        *j, reset=jr)), **TOL)
    if pallas:
        pal = rglru_scan_pallas(*j, reset=jr, chunk=pallas, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


@pytest.mark.parametrize("case", ["segment_first_and_last_step",
                                  "odd_s_197_r_37", "plan_engine_pad_3"])
def test_segmented_mirror_in_bf16(case):
    """bf16 x and a come back in bf16 within the reference's 2e-2 of its
    dispatcher on the same bf16 inputs."""
    b, s, r, segments, steps, at, _ = CASES[case]
    j, t, jr, tr = _both(case, seed=5)
    got = p_rg.rglru_scan_segmented(*[v.bfloat16() for v in t], tr,
                                    segments=segments, steps=steps)
    assert got.dtype == torch.bfloat16
    want = r_rglru_scan(*[v.astype(jnp.bfloat16) for v in j], reset=jr)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_segmented_mirror_is_exact_where_a_reset_cuts_the_carry():
    """A reset on a tile boundary leaves nothing of the earlier tiles:
    the steps after it equal a scan started there."""
    b, s, r, segments, steps, at, _ = CASES["tile_boundary"]
    _, t, _, tr = _both("tile_boundary")
    whole = p_rg.rglru_scan_segmented(*t, tr, segments=segments, steps=steps)
    tail = p_rg.rglru_scan_segmented(t[0][:1, 16:], t[1][:1, 16:],
                                     segments=segments, steps=steps)
    torch.testing.assert_close(whole[:1, 16:32], tail[:, :16], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shape,want", [
    ((1, 32, 2560), (16, 8, 4)),     # recurrentgemma solo prefill: one tile
    ((1, 8, 2560), (16, 2, 4)),
    ((2, 512, 2560), (16, 16, 8)),   # the split shape: four tiles of 128
    ((4, 512, 2560), (32, 8, 8)),    # enough blocks at 32 channels
    ((1, 1, 16), (16, 1, 4)),
    ((2, 197, 37), (16, 16, 8)),
    ((1, 65, 16), (16, 9, 8)),
])
def test_plan(shape, want):
    b, s, r = shape
    channels, segments, steps = p_rg.plan(b, s, r)
    assert (channels, segments, steps) == want
    assert channels * segments <= p_rg.MAX_THREADS
    # one tile covers S wherever the block's threads allow it
    assert segments * steps >= s or channels * segments == p_rg.MAX_THREADS
    assert p_rg.blocks(b, s, r) == -(-r // channels) * b


def test_plan_fills_the_card_at_the_engine_shape():
    """The one-thread-a-channel kernel launched 40 blocks of 64 threads at
    B1 S32 R2560; the segmented one launches at least one block an SM
    there and at the split shape."""
    assert p_rg.blocks(1, 32, 2560) == 160 >= p_rg.SMS
    assert p_rg.blocks(2, 512, 2560) == 320
    assert p_rg.plan(2, 512, 2560)[1] * p_rg.plan(2, 512, 2560)[2] == 128


def test_source_mirrors_the_plan():
    """csrc make_plan computes what ``plan`` does."""
    src = " ".join(p_rg.LIBRARY.source.read_text().split())
    assert f"constexpr int kMaxThreads = {p_rg.MAX_THREADS};" in src
    assert f"constexpr int kSMs = {p_rg.SMS};" in src
    assert ("p.channels = batch * ((width + 31) / 32) >= 2 * kSMs ? 32 : 16;"
            in src)
    assert "p.steps = s_len <= 4 * (kMaxThreads / p.channels) ? 4 : 8;" in src
