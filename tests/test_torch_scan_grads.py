"""Port parity: the scans' backward algebra, off the card.

``kernels.ssd_scan.ssd_scan_backward_chunked`` mirrors in plain torch the
passes of the SSD backward kernel (the entering states recomputed, each
chunk's U, the adjoint pass over the chunks from the final state's
cotangent, then each chunk's dx, ddt, db, dc and the gradient of the
float64 prefix sums reverse-summed); ``kernels.rglru_scan.
rglru_scan_backward_segmented`` mirrors the RG-LRU backward kernel (the
forward's composites run from the end of the sequence over dh and a
shifted by one step, da fused into the replay).  No path uses them; here
each is held against ``jax.vjp`` of the reference's plain scans (the
dispatcher's non-Pallas arm, ``repro.kernels.ref.ssd_scan_ref`` /
``rglru_scan_ref``, jitted on the CPU) and against torch autograd through
the port's plain versions, on inputs and cotangents drawn once with numpy,
within 1e-4 of each gradient's max |g| (2e-2 where the inputs are bf16):
resets at step 0, on a chunk (segment, tile) boundary and twice in one
chunk, S not a multiple of the chunk, G = 1 and 2, a final-state
cotangent that is nonzero, zero or absent.  The SSD mirror with
``split=True`` rehearses the bf16 kernel's rounding of its float32
operands (hi + lo bf16 parts) at mamba2's widths.  The backward's
shared-memory mirror and the bounds' counts are checked too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rglru_scan as p_rg
from repro_torch.kernels import ssd_scan as p_ssd
from test_torch_scans import resets, rglru_inputs, ssd_inputs

TOL = 1e-4                # x each gradient's max |g|
TOL_BF16 = 2e-2
SSD_NAMES = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")

SSD_CASES = {
    # (b, s, h, p, g, n, chunk, resets, final state's cotangent)
    "reset_at_step_0": (2, 48, 3, 8, 1, 4, 16, ((0, 0), (1, 0)), "random"),
    "resets_on_boundaries": (2, 48, 3, 8, 1, 4, 16,
                             ((0, 16), (0, 32), (1, 47)), "random"),
    "twice_in_a_chunk_odd": (1, 40, 2, 8, 1, 4, 16,
                             ((0, 3), (0, 9), (0, 20)), None),
    "g2_not_a_chunk_multiple": (2, 37, 4, 8, 2, 4, 8, ((0, 8), (1, 3)),
                                "random"),
    "one_chunk_odd": (1, 13, 2, 8, 1, 4, 16, None, "random"),
    "g2_no_resets": (2, 64, 4, 16, 2, 8, 16, None, None),
    "default_chunk_mamba2_decays": (1, 150, 2, 8, 1, 4, p_ssd.CHUNK,
                                    ((0, 64), (0, 100)), "random"),
    "zero_final_cotangent": (2, 33, 2, 8, 1, 4, 8, ((0, 32), (1, 8)),
                             "zero"),
}

RGLRU_CASES = {
    # (b, s, r, segments, steps, resets)
    "reset_at_step_0": (2, 48, 16, 4, 4, ((0, 0), (1, 0))),
    "segment_first_and_last_step": (2, 32, 16, 4, 4,
                                    ((0, 4), (0, 7), (1, 11), (1, 12))),
    "tile_boundary": (2, 48, 16, 4, 4, ((0, 16), (1, 15), (1, 32))),
    "twice_in_a_segment": (1, 40, 16, 2, 8, ((0, 9), (0, 13), (0, 16))),
    "s_1": (2, 1, 16, 1, 4, ((1, 0),)),
    "odd_s_197_r_37": (1, 197, 37, 16, 8, ((0, 8), (0, 64), (0, 128))),
    "s_not_a_tile_multiple": (2, 100, 16, 3, 8, None),
    "plan_split": (2, 512, 16, 16, 8, ((1, 0), (1, 127), (1, 128))),
}


def _ssd_case(case, seed=3):
    """numpy inputs, y's cotangent and the final state's (None, zeros or
    drawn), and the reset mask."""
    b, s, h, p, g, n, chunk, at, final = SSD_CASES[case]
    arrays = ssd_inputs(b, s, h, p, g, n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = (None if final is None else np.zeros((b, h, n, p), np.float32)
              if final == "zero" else
              rng.standard_normal((b, h, n, p)).astype(np.float32))
    reset = None if at is None else resets(b, s, at)
    return arrays, dy, dstate, reset, chunk


def _ssd_vjp(arrays, dy, dstate, reset, chunk, dtype=jnp.float32):
    """``jax.vjp`` of the reference's dispatcher (its non-Pallas arm, the
    plain chunked scan, S padded to the chunk) at ``chunk``."""
    r = None if reset is None else jnp.asarray(reset)
    fn = jax.jit(lambda *a: r_ops.ssd_scan(*a, chunk=chunk, reset=r))
    args = [jnp.asarray(a) for a in arrays]
    args = [a.astype(dtype) if i in (0, 3, 4) else a
            for i, a in enumerate(args)]
    (y, state), vjp = jax.vjp(fn, *args)
    cot_state = (jnp.zeros_like(state) if dstate is None
                 else jnp.asarray(dstate))
    return vjp((jnp.asarray(dy).astype(dtype), cot_state))


def _mirror_ssd(arrays, dy, dstate, reset, chunk, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in arrays]
    t = [v.to(dtype) if i in (0, 3, 4) else v for i, v in enumerate(t)]
    return p_ssd.ssd_scan_backward_chunked(
        *t, torch.from_numpy(dy).to(dtype),
        None if dstate is None else torch.from_numpy(dstate),
        reset=None if reset is None else torch.from_numpy(reset),
        chunk=chunk)


def _assert_grads(got, want, names, tol):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_mirror_matches_reference_vjp(case):
    arrays, dy, dstate, reset, chunk = _ssd_case(case)
    got = _mirror_ssd(arrays, dy, dstate, reset, chunk)
    b, s, h, p, g, n = SSD_CASES[case][:6]
    assert [tuple(v.shape) for v in got] == [
        (b, s, h, p), (b, s, h), (h,), (b, s, g, n), (b, s, g, n), (h,)]
    assert all(v.dtype == torch.float32 for v in got)
    _assert_grads(got, _ssd_vjp(arrays, dy, dstate, reset, chunk),
                  SSD_NAMES, TOL)


@pytest.mark.parametrize("case", ["resets_on_boundaries",
                                  "g2_not_a_chunk_multiple",
                                  "default_chunk_mamba2_decays"])
def test_ssd_backward_mirror_matches_port_autograd(case):
    """Against torch autograd through the port's plain scan (the CPU arm
    of ``ops.ssd_scan``, at the same chunk)."""
    arrays, dy, dstate, reset, chunk = _ssd_case(case, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tr = None if reset is None else torch.from_numpy(reset)
    y, state = p_ops.ssd_scan(*leaves, chunk=chunk, reset=tr)
    want = torch.autograd.grad(
        [y, state], leaves,
        [torch.from_numpy(dy), torch.from_numpy(dstate)])
    _assert_grads(_mirror_ssd(arrays, dy, dstate, reset, chunk),
                  [w.numpy() for w in want], SSD_NAMES, TOL)


@pytest.mark.parametrize("case", ["twice_in_a_chunk_odd",
                                  "g2_not_a_chunk_multiple"])
def test_ssd_backward_mirror_in_bf16(case):
    """bf16 x, b, c and dy: dx, db, dc come back in bf16 within 2e-2 of
    the reference's vjp on the same bf16 inputs; ddt, da_log and dd_skip
    stay float32."""
    arrays, dy, dstate, reset, chunk = _ssd_case(case, seed=5)
    got = _mirror_ssd(arrays, dy, dstate, reset, chunk, torch.bfloat16)
    assert [v.dtype for v in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    want = _ssd_vjp(arrays, dy, dstate, reset, chunk, jnp.bfloat16)
    _assert_grads(got, [np.asarray(w.astype(jnp.float32)) for w in want],
                  SSD_NAMES, TOL_BF16)


def test_ssd_backward_mirror_absent_and_zero_final_cotangent_agree():
    """No final-state cotangent (training drops the state) and a zero one
    give the same gradients, bit for bit."""
    arrays, dy, _, reset, chunk = _ssd_case("resets_on_boundaries")
    b, s, h, p, g, n = SSD_CASES["resets_on_boundaries"][:6]
    none = _mirror_ssd(arrays, dy, None, reset, chunk)
    zero = _mirror_ssd(arrays, dy, np.zeros((b, h, n, p), np.float32),
                       reset, chunk)
    assert all(torch.equal(a, z) for a, z in zip(none, zero))


def test_ssd_backward_mirror_split_as_the_bf16_kernel():
    """A rehearsal of the bf16 kernel's numerics off the card: the mirror
    with its float32 operands (coef x, inter dy, W, dCB, D, M) entered as
    hi + lo bf16 parts (``split``), as the kernel's tensor cores take them,
    on bf16 inputs at mamba2's widths (H 64, P 64, N 128), B1 S130 with a
    reset on the chunk edge, against the reference's VJP on the same bf16
    values in float32, within the card tests' bands: 1e-4 of max(1, max
    |g|) for a float32 gradient, 2e-2 for one that comes out in bf16."""
    b, s, h, p, g, n = 1, 130, 64, 64, 1, 128
    arrays = list(ssd_inputs(b, s, h, p, g, n, seed=6))
    rng = np.random.default_rng(106)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, n, p)).astype(np.float32)
    reset = resets(b, s, ((0, 64),))
    bf16 = lambda a: torch.from_numpy(a).bfloat16()
    for i in (0, 3, 4):                 # x, b and c hold bf16 values
        arrays[i] = bf16(arrays[i]).float().numpy()
    dy = bf16(dy).float().numpy()
    want = _ssd_vjp(arrays, dy, dstate, reset, p_ssd.CHUNK)
    t = [bf16(a) if i in (0, 3, 4) else torch.from_numpy(a)
         for i, a in enumerate(arrays)]
    got = p_ssd.ssd_scan_backward_chunked(
        *t, bf16(dy), torch.from_numpy(dstate),
        reset=torch.from_numpy(reset), split=True)
    assert [v.dtype for v in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]
    for name, v, w in zip(SSD_NAMES, got, want):
        w = np.asarray(w, np.float32)
        tol = TOL_BF16 if v.dtype == torch.bfloat16 else TOL
        err = float(np.abs(v.float().numpy() - w).max())
        bound = tol * max(1.0, float(np.abs(w).max()))
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _rglru_case(case, seed=3):
    b, s, r, segments, steps, at = RGLRU_CASES[case]
    x, a = rglru_inputs(b, s, r, seed=seed)
    dh = np.random.default_rng(seed + 100).standard_normal(
        (b, s, r)).astype(np.float32)
    reset = None if at is None else resets(b, s, at)
    return x, a, dh, reset, segments, steps


def _rglru_vjp(x, a, dh, reset, dtype=jnp.float32):
    r = None if reset is None else jnp.asarray(reset)
    fn = jax.jit(lambda x, a: r_ref.rglru_scan_ref(x, a, reset=r))
    _, vjp = jax.vjp(fn, jnp.asarray(x).astype(dtype),
                     jnp.asarray(a).astype(dtype))
    return vjp(jnp.asarray(dh).astype(dtype))


def _mirror_rglru(x, a, dh, reset, segments, steps, dtype=torch.float32):
    xt, at = torch.from_numpy(x).to(dtype), torch.from_numpy(a).to(dtype)
    tr = None if reset is None else torch.from_numpy(reset)
    h = p_ref.rglru_scan_ref(xt, at, tr)
    return p_rg.rglru_scan_backward_segmented(
        torch.from_numpy(dh).to(dtype), at, h, tr, segments=segments,
        steps=steps)


@pytest.mark.parametrize("case", sorted(RGLRU_CASES))
def test_rglru_backward_mirror_matches_reference_vjp(case):
    x, a, dh, reset, segments, steps = _rglru_case(case)
    got = _mirror_rglru(x, a, dh, reset, segments, steps)
    assert all(v.shape == x.shape and v.dtype == torch.float32 for v in got)
    _assert_grads(got, _rglru_vjp(x, a, dh, reset), ("dx", "da"), TOL)
    if RGLRU_CASES[case][1] == 1:      # nothing precedes step 0
        assert not bool(got[1].any())


@pytest.mark.parametrize("case", ["segment_first_and_last_step",
                                  "odd_s_197_r_37", "plan_split"])
def test_rglru_backward_mirror_matches_port_autograd(case):
    x, a, dh, reset, segments, steps = _rglru_case(case, seed=4)
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in (x, a)]
    tr = None if reset is None else torch.from_numpy(reset)
    want = torch.autograd.grad(p_ops.rglru_scan(*leaves, tr), leaves,
                               torch.from_numpy(dh))
    _assert_grads(_mirror_rglru(x, a, dh, reset, segments, steps),
                  [w.numpy() for w in want], ("dx", "da"), TOL)


@pytest.mark.parametrize("case", ["tile_boundary", "odd_s_197_r_37"])
def test_rglru_backward_mirror_in_bf16(case):
    x, a, dh, reset, segments, steps = _rglru_case(case, seed=5)
    got = _mirror_rglru(x, a, dh, reset, segments, steps, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in got)
    want = _rglru_vjp(x, a, dh, reset, jnp.bfloat16)
    _assert_grads(got, [np.asarray(w.astype(jnp.float32)) for w in want],
                  ("dx", "da"), TOL_BF16)


def test_backward_shared_memory_and_counts():
    """The chunk-gradient block's shared memory (csrc ``bwd_layout`` for
    float32, ``bwd_tc_layout`` for bf16), U's block (the forward's state
    layout) and the bounds' counts, worked out by hand."""
    # float32: rows 512 + 6 x 256, four 64 x 16 partial arrays, 32 doubles;
    # C (64 x 132) and dY (64 x 68) float32; then X, B, M and D (128 x 64),
    # W, dCB
    assert p_ssd.backward_shared_bytes(128, 64) == 221_440
    assert p_ssd.backward_shared_bytes(128, 64) <= p_ssd.MAX_SHARED
    # bf16: rows 2,048; G's row and column partials 2 x 10 tiles x 16 x 4 =
    # 1,280; dcoef's and dinter's 2 x 8 warps x 64 x 4 = 4,096; 8 doubles
    # and the chunk's end, 64 + 16; C and B 2 x 64 x 136 x 2 = 34,816; X
    # and dY 2 x 64 x 72 x 2 = 18,432; W and dCB, hi and lo, 4 x 64 x 72 x
    # 2 = 36,864
    assert p_ssd.backward_shared_bytes(128, 64, 2) == 97_616
    # two blocks an SM: each with the 1 KB the card reserves, within 228 KB
    assert 2 * (p_ssd.backward_shared_bytes(128, 64, 2) + 1024) <= 228 * 1024
    # U (bf16): rows 512 + 4 x 256, dY 64 x 72, C 64 x 136, inter dY's hi
    # and lo 2 x 64 x 72, all 2-byte
    assert p_ssd.shared_bytes(128, 64, 2, "state") == 46_592
    # one 64-step chunk, P = N = 4: pairs 2,080 x (2 x 8 + 2 x 12)
    assert p_ssd.backward_op_count(1, 64, 1, 4, 4) == 83_200
    # two chunks: + the leaving adjoint's products in the first, the
    # entering state's in the second, and each chunk's recompute
    assert p_ssd.backward_op_count(1, 128, 1, 4, 4) == 178_688
    # S = 65: the first chunk as above, then one step (1 pair x 40, the
    # entering state's 64 and the recompute's 32)
    assert p_ssd.backward_op_count(1, 65, 1, 4, 4) == \
        83_200 + 4_096 + 2_048 + 40 + 64 + 32
    assert p_ssd.backward_byte_count(1, 64, 1, 4, 1, 4, 4, False) == 7_696
    assert p_rg.backward_op_count(2, 10, 3) == 180
    assert p_rg.backward_byte_count(2, 10, 3, 4, True) == 1_220
