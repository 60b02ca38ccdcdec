"""Port parity: the attention kernels' plain versions and the dispatch.

Inputs are drawn once with numpy from a seed and fed to the reference
(``repro.kernels.ref``, the Pallas kernels in interpret mode,
``repro.kernels.ops``) and to the port (``repro_torch.kernels.ref`` /
``ops``); outputs are compared in float32 at the reference's own attention
tolerance, 2e-5 (tests/test_kernels.py).  Query rows inside a left pad see
no key: there the flash kernel gives zeros and the dense path the uniform
average, so those rows are compared for being finite only.  The CUDA
kernels run on the card only (tests/test_torch_gpu.py); here their
wrappers' input checks are tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import decode_attention as p_da
from repro_torch.kernels import flash_attention as p_fa
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def reference_arm():
    """Run ``repro.kernels.ops`` on its non-Pallas arm, then restore."""
    saved = r_ops._IMPL, r_ops._INTERPRET
    r_ops.set_impl("reference")
    yield
    r_ops.set_impl(*saved)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(kw or TOL))


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 24),
                                         ("full", 0)])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd", [(2, 64, 64, 4, 2, 32),
                                             (1, 37, 75, 6, 2, 16),
                                             (2, 50, 50, 8, 1, 64)])
def test_attention_ref_matches_reference(kind, window, b, sq, sk, h, kv, hd):
    q, k, v = _draw(0, (b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))
    want = r_ref.attention_ref(*_j(q, k, v),
                               mask=r_ref.build_mask(kind, sq, sk, window))
    got = p_ref.attention_ref(*_t(q, k, v),
                              mask=p_ref.build_mask(kind, sq, sk, window))
    _close(got, want)
    if kind != "full":
        np.testing.assert_array_equal(
            p_ref.build_mask(kind, sq, sk, window).numpy(),
            np.asarray(r_ref.build_mask(kind, sq, sk, window)))


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 40),
                                         ("full", 0)])
def test_attention_blocked_matches_reference(kind, window):
    b, s, h, kv, hd = 2, 150, 4, 2, 32
    q, k, v = _draw(1, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    want = r_ref.attention_blocked(*_j(q, k, v), kind=kind, window=window,
                                   q_block=64)
    got = p_ref.attention_blocked(*_t(q, k, v), kind=kind, window=window,
                                  q_block=64)
    _close(got, want)
    _close(got, p_ref.attention_ref(*_t(q, k, v), mask=p_ref.build_mask(
        kind, s, s, window)))


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 24),
                                         ("full", 0)])
@pytest.mark.parametrize("s", [64, 50])
def test_flash_plain_matches_pallas_kernel(kind, window, s):
    """The flash kernel's plain twin against the TPU kernel (interpret
    mode) on a left-padded batch, real rows at 2e-5; pad rows finite."""
    b, h, kv, hd = 3, 4, 2, 32
    q, k, v = _draw(2, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    pad = np.array([0, 13, 40], np.int32)
    want = flash_attention_pallas(*_j(q, k, v), kind=kind, window=window,
                                  q_block=16, k_block=16,
                                  pad=jnp.asarray(pad), interpret=True)
    got = p_ref.flash_attention_ref(*_t(q, k, v), kind=kind, window=window,
                                    pad=torch.from_numpy(pad))
    assert torch.isfinite(got).all()
    for i in range(b):
        _close(got[i, pad[i]:], np.asarray(want)[i, pad[i]:])


def test_flash_plain_unpadded_matches_pallas_kernel():
    b, sq, sk, h, kv, hd = 2, 37, 75, 4, 2, 32
    q, k, v = _draw(3, (b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))
    want = flash_attention_pallas(*_j(q, k, v), kind="full", q_block=32,
                                  k_block=32, interpret=True)
    _close(p_ref.flash_attention_ref(*_t(q, k, v), kind="full"), want)


@pytest.mark.parametrize("s,h,kv,hd", [(10, 4, 2, 32), (33, 4, 2, 32),
                                       (128, 8, 4, 64)])
def test_decode_plain_matches_reference_and_pallas(s, h, kv, hd):
    b = 3
    q, k, v = _draw(4, (b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    lens = np.random.default_rng(5).integers(1, s + 1, b)
    valid = np.arange(s)[None, :] < lens[:, None]
    want = r_ref.decode_attention_ref(*_j(q, k, v),
                                      valid_mask=jnp.asarray(valid))
    got = p_ref.decode_attention_ref(*_t(q, k, v), torch.from_numpy(valid))
    _close(got, want)
    kernel = decode_attention_pallas(*_j(q, k, v),
                                     valid_mask=jnp.asarray(valid),
                                     k_block=16, interpret=True)
    _close(got, kernel)


def test_decode_plain_all_invalid_row_is_uniform_average():
    """A row with no valid key: the reference and the port both give the
    uniform average of the row's values (the kernel must too)."""
    b, s, h, kv, hd = 2, 24, 4, 2, 32
    q, k, v = _draw(6, (b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    valid = np.ones((b, s), bool)
    valid[1] = False
    want = r_ref.decode_attention_ref(*_j(q, k, v),
                                      valid_mask=jnp.asarray(valid))
    got = p_ref.decode_attention_ref(*_t(q, k, v), torch.from_numpy(valid))
    _close(got, want)
    mean = v[1].mean(axis=0)                         # (KV, hd)
    _close(got[1, 0].reshape(kv, h // kv, hd),
           np.repeat(mean[:, None], h // kv, axis=1))


@pytest.mark.parametrize("sq", [48, 2100])
def test_ops_flash_dense_and_blocked_arms_match_reference(sq, reference_arm):
    """``ops.flash_attention`` on the CPU: dense below the blocked
    threshold, blocked above (2100^2 > 2048^2), as the reference's
    non-Pallas arm."""
    b, h, kv, hd = 1, 2, 1, 16
    q, k, v = _draw(7, (b, sq, h, hd), (b, sq, kv, hd), (b, sq, kv, hd))
    want = r_ops.flash_attention(*_j(q, k, v), kind="causal")
    _close(p_ops.flash_attention(*_t(q, k, v), kind="causal"), want)


@pytest.mark.parametrize("kind,window", [("causal", 0), ("local", 8),
                                         ("full", 0)])
def test_ops_flash_pad_mask_arm_matches_reference(kind, window, reference_arm):
    b, s, h, kv, hd = 3, 20, 4, 2, 16
    q, k, v = _draw(8, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    pad = np.array([0, 5, 19])
    pad_mask = np.arange(s)[None, :] >= pad[:, None]
    want = r_ops.flash_attention(*_j(q, k, v), kind=kind, window=window,
                                 pad_mask=jnp.asarray(pad_mask))
    got = p_ops.flash_attention(*_t(q, k, v), kind=kind, window=window,
                                pad_mask=torch.from_numpy(pad_mask))
    _close(got, want)        # the dense arm: pad rows agree too


@pytest.mark.parametrize("start", [0, 7, 32])
def test_ops_chunk_and_decode_attention_match_reference(start, reference_arm):
    b, c, s, h, kv, hd = 1, 8, 48, 4, 2, 16
    q, k, v = _draw(9, (b, c, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    want = r_ops.chunk_attention(*_j(q, k, v), start=start)
    _close(p_ops.chunk_attention(*_t(q, k, v), start=start), want)
    valid = np.arange(s)[None, :] <= start
    want = r_ops.decode_attention(*_j(q[:, :1], k, v),
                                  valid_mask=jnp.asarray(valid))
    _close(p_ops.decode_attention(*_t(q[:, :1], k, v),
                                  torch.from_numpy(valid)), want)


def test_kernel_wrappers_reject_cpu_and_bad_inputs():
    """On the CPU the ops take the plain versions; the CUDA wrappers
    themselves raise on anything they cannot launch."""
    q, k = _t(*_draw(10, (1, 8, 4, 32), (1, 8, 2, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        p_fa.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        p_fa.flash_attention_cuda(q[..., :16], k[..., :16], k[..., :16])
    with pytest.raises(ValueError, match="kind"):
        p_fa.flash_attention_cuda(q, k, k, kind="banded")
    with pytest.raises(ValueError, match="share"):
        p_fa.flash_attention_cuda(q, k.double(), k)
    with pytest.raises(ValueError, match="kv heads"):
        p_fa.flash_attention_cuda(q[:, :, :3], k, k)
    with pytest.raises(ValueError, match="CUDA"):
        p_da.decode_attention_cuda(q[:, :1], k, k,
                                   torch.ones(1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\(B, 1, H, hd\)"):
        p_da.decode_attention_cuda(q, k, k, torch.ones(1, 8, dtype=torch.bool))


def test_live_pairs_counts_the_visible_keys():
    """The flash bound's pair count against a dense count of the mask."""
    for kind, window, pad in [("causal", 0, None), ("local", 5, [0, 3]),
                              ("full", 0, [2, 0]), ("causal", 0, [4, 9])]:
        sq = sk = 12
        base = p_ref.build_mask(kind, sq, sk, window)
        base = torch.ones(sq, sk, dtype=torch.bool) if base is None else base
        rows = [0, 0] if pad is None else pad
        want = sum(int((base & (torch.arange(sk)[None] >= p)).sum())
                   for p in rows)
        assert p_fa.live_pairs(2, sq, sk, kind, window, pad) == want
