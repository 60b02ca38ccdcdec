"""Card-only tests of the port (``-m gpu``): each CUDA kernel against its
plain PyTorch version, the grid's Oracle path launching the partition
sweep, the serving engine launching the attention kernels (both modes),
the sanitizer's guards, checkpoints, and the learning loop (a training
episode; a PPO update, card against CPU).

This file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each test decides inside its body whether there is a card and skips where
there is none.  Tolerance: rtol 1e-4 / atol 1e-3 on feasible cells and the
same infeasible set (the reference's sweep tolerance); argmins must agree
wherever the plain table's best and second best are further apart than
that, and elsewhere the kernel's pick must score within it of the best.
Attention: 2e-5 in float32, 2e-2 in bf16 (the reference's kernel
tolerances); query rows inside a left pad see no key and must be zero.
Scans: 1e-4 in float32 (the reference's scan tolerance), 2e-2 for an SSD y
or RG-LRU h that comes out in bf16, 1e-4 for the SSD state, which is
float32 from the same inputs either way.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.core import env as p_env
from repro_torch.core import lymdo as p_lymdo
from repro_torch.core import policies as p_pol
from repro_torch.core import ppo as p_ppo
from repro_torch.core import scenarios as p_sc
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import decode_attention as p_da
from repro_torch.kernels import flash_attention as p_fa
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import partition_sweep as p_ps
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rglru_scan as p_rg
from repro_torch.kernels import ssd_scan as p_ssd
from repro_torch.models import transformer as p_tf
from repro_torch.serving import engine as p_engine

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
    # C = 1 (one cut, L = 0) draws as C = 2 does, then clips
    L = np.minimum(rng.integers(max(1, c // 3), max(c, 2), lead), c - 1)
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
                                    ((1, 37), 11), ((2, 3), 70),
                                    # rows packed 32 / 4 / 2 / 1 to a warp
                                    # at C = 1 / 8 / 16 / 17, 32, 33, and
                                    # row counts no block's rows divide
                                    ((37, 3), 1), ((19, 5), 8), ((23, 3), 16),
                                    ((7, 9), 17), ((5, 11), 32),
                                    ((3, 13), 33)])
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
    gap = (srt[..., 1] - srt[..., 0] > 1e-3 + 1e-4 * np.abs(srt[..., 0])
           if c > 1 else np.ones(srt.shape[:-1], bool))   # one cut: no tie
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
@pytest.mark.parametrize("policy", ["oracle", "random"])
def test_one_rank_nccl_mesh_grid_equals_the_unsharded_card_grid(policy,
                                                                tmp_path):
    """A grid sharded over a one-rank NCCL cells mesh (padded by 2) gives
    the unsharded card grid's cuts and, to 1e-5, its floats; the Oracle
    launches the sweep once a slot, over the padded rows."""
    _need_card()
    import torch.distributed as dist
    from repro_torch.launch import mesh as p_mesh
    cells = p_sc.multicell_grid(64, 8)
    want = p_sc.ScenarioGrid(cells).rollout(policy, steps=3, seed=5)
    p_mesh.init_group("nccl", "cuda", rank=0, world_size=1,
                      init_method=f"file://{tmp_path}/store")
    try:
        grid = p_sc.ScenarioGrid(cells).use_mesh(pad_to=66)
        assert p_mesh.make_cells_mesh().device_type == "cuda"
        before = p_ps.partition_sweep_cuda.launches
        got = grid.rollout(policy, steps=3, seed=5)
        torch.cuda.synchronize()
        launched = p_ps.partition_sweep_cuda.launches - before
    finally:
        dist.destroy_process_group()
    assert launched == (3 if policy == "oracle" else 0)
    assert grid._run_params.L.shape[0] == 66
    (st_g, res_g, sum_g), (st_w, res_w, sum_w) = got, want
    assert torch.equal(res_g.cut, res_w.cut)
    leaves = [_tree.leaves([st, res, summary]) for st, res, summary
              in (got, want)]
    assert len(leaves[0]) == len(leaves[1]) == 5 + 13 + 7
    for g, w in zip(*leaves):
        assert g.shape == w.shape and g.is_cuda
        torch.testing.assert_close(g.to(w.dtype), w, rtol=1e-5, atol=1e-7)


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


def _att_inputs(b, sq, sk, h, kv, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
    return rnd(b, sq, h, hd), rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,kind,window,pad", [
    (1, 32, 32, 16, 8, 128, "causal", 0, [5]),
    (2, 300, 300, 16, 8, 128, "causal", 0, [0, 299]),
    (2, 100, 100, 6, 2, 64, "local", 24, [0, 50]),
    (2, 37, 75, 4, 2, 32, "full", 0, None),
    (1, 96, 96, 10, 1, 256, "causal", 0, None),
    # every kind with left pads, Sq != Sk both ways, odd lengths, G = 2, 3
    # and 10, hd 32 to 256 (bf16 takes the tensor-core body)
    (2, 512, 512, 16, 8, 128, "causal", 0, None),
    (4, 300, 300, 16, 8, 128, "causal", 0, [0, 13, 40, 299]),
    (3, 77, 77, 16, 8, 128, "local", 24, [0, 5, 70]),
    (3, 50, 50, 4, 2, 32, "full", 0, [0, 13, 40]),
    (2, 37, 75, 4, 2, 32, "causal", 0, None),
    (2, 75, 37, 4, 2, 64, "causal", 0, [0, 9]),
    (2, 37, 75, 6, 2, 64, "full", 0, None),
    (2, 192, 192, 6, 2, 64, "local", 96, [0, 100]),
    (2, 512, 512, 10, 1, 256, "local", 2048, None),
    (2, 130, 130, 10, 1, 256, "local", 64, [0, 7]),
    (1, 32, 32, 10, 1, 256, "local", 2048, [5])])
def test_flash_kernel_matches_plain(dtype, tol, b, sq, sk, h, kv, hd, kind,
                                    window, pad):
    _need_card()
    q, k, v = _att_inputs(b, sq, sk, h, kv, hd, dtype, sq + hd)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    before = p_fa.flash_attention_cuda.launches
    got = p_ops.flash_attention(q, k, v, kind=kind, window=window,
                                pad_mask=None if pad is None else
                                torch.arange(sk, device="cuda")[None] >= pad_t[:, None])
    torch.cuda.synchronize()
    assert p_fa.flash_attention_cuda.launches == before + 1
    want = p_ref.flash_attention_ref(q, k, v, kind=kind, window=window,
                                     pad=pad_t)
    assert torch.isfinite(got.float()).all()
    for i in range(b):
        p0 = 0 if pad is None else pad[i]
        torch.testing.assert_close(got[i, p0:].float(), want[i, p0:].float(),
                                   rtol=tol, atol=tol)
        if kind != "full":
            assert (got[i, :p0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd", [(8, 512, 16, 8, 128),
                                         (3, 33, 4, 2, 32),
                                         (2, 100, 10, 1, 256)])
def test_decode_kernel_matches_plain(dtype, tol, b, s, h, kv, hd):
    """Ragged lengths and one row with no valid key (the uniform average)."""
    _need_card()
    q, k, v = _att_inputs(b, 1, s, h, kv, hd, dtype, s)
    lens = torch.randint(1, s + 1, (b,), device="cuda")
    valid = torch.arange(s, device="cuda")[None] < lens[:, None]
    valid[-1] = False
    before = p_da.decode_attention_cuda.launches
    got = p_ops.decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert p_da.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(got.float(),
                               p_ref.decode_attention_ref(q, k, v, valid).float(),
                               rtol=tol, atol=tol)


def _split_masks(b, s, seed, *, dead_row, dead_split):
    """Ragged valid prefixes; optionally a row with no valid key and a row
    whose second 64-key split is wholly masked."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    valid = torch.arange(s, device="cuda")[None] < lens[:, None]
    if dead_split:
        valid[0] = True
        valid[0, 64:128] = False
    if dead_row:
        valid[-1] = False
    return valid


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,dead_row,dead_split", [
    (8, 512, 16, 8, 128, False, True),     # qwen3's tick: 8 splits
    (8, 2048, 10, 1, 256, True, True),     # recurrentgemma's ring
    (3, 1000, 4, 2, 32, True, False),      # S not a multiple of a split
    (2, 130, 10, 1, 256, False, True),
    (1, 77, 40, 2, 64, True, False),       # 20 heads a kv head: 2 groups
    (2, 5, 4, 2, 32, True, False)])
def test_split_decode_matches_plain(dtype, tol, b, s, h, kv, hd, dead_row,
                                    dead_split):
    _need_card()
    splits, _ = p_da.decode_splits(b, kv * p_da.head_groups(h // kv), s)
    if s >= 130:
        assert splits >= 2
    q, k, v = _att_inputs(b, 1, s, h, kv, hd, dtype, s + h)
    valid = _split_masks(b, s, s, dead_row=dead_row, dead_split=dead_split)
    got = p_da.decode_attention_cuda(q, k, v, valid)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(),
                               p_ref.decode_attention_ref(q, k, v, valid).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,m,bs,h,kv,hd,seq_lens", [
    (8, 32, 16, 16, 8, 128, [0, 15, 16, 511, 100, 300, 1, 64]),
    (4, 9, 16, 10, 1, 256, [0, 143, 16, 70]),
    (3, 5, 8, 4, 2, 32, [39, 0, 8])])
def test_paged_decode_matches_gather_and_plain(dtype, tol, b, m, bs, h, kv,
                                               hd, seq_lens):
    """The paged entry on a scattered table against the gather and the
    plain version; seq_lens of 0, of a block boundary and of the table's
    end; one launch a call, counted with the dense entry's."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(m * bs)
    n_blocks = b * m + 3
    k_pool = torch.randn((n_blocks, bs, kv, hd), generator=g,
                         device="cuda").to(dtype)
    v_pool = torch.randn((n_blocks, bs, kv, hd), generator=g,
                         device="cuda").to(dtype)
    q = torch.randn((b, 1, h, hd), generator=g, device="cuda").to(dtype)
    table = torch.randperm(n_blocks, generator=g, device="cuda")[:b * m]
    table = table.reshape(b, m).to(torch.int32)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    before = p_da.decode_attention_cuda.launches
    got = p_ops.decode_attention_paged(q, k_pool, v_pool, table, lens)
    torch.cuda.synchronize()
    assert p_da.decode_attention_cuda.launches == before + 1
    k_rows = k_pool[table.long()].reshape(b, m * bs, kv, hd)
    v_rows = v_pool[table.long()].reshape(b, m * bs, kv, hd)
    valid = torch.arange(m * bs, device="cuda")[None] <= lens[:, None]
    torch.testing.assert_close(
        got.float(), p_ref.decode_attention_ref(q, k_rows, v_rows,
                                                valid).float(),
        rtol=tol, atol=tol)


def _ring_valid(b, w, pos, seed):
    """The mask of a full ring of ``w`` slots after the token at ``pos``:
    slot j holds the latest position congruent to j, valid at or past
    each row's left pad (none on row 0, past every slot on the last)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    slots = torch.arange(w, device="cuda")
    at = pos - (pos - slots) % w
    pad = torch.randint(0, pos + 1, (b,), generator=g, device="cuda")
    pad[0], pad[-1] = 0, pos + 1
    return at[None] >= pad[:, None]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout,b,s,h,kv,hd", [
    ("dense", 4, 1028, 4, 1, 256),     # gemma3-1b's global cache, a rank's half
    ("dense", 3, 33, 4, 2, 32),        # one split
    ("ring", 4, 512, 4, 1, 256),       # gemma3-1b's ring, a rank's half
    ("paged", 3, 9, 4, 2, 32)])
def test_partial_decode_entry_matches_plain(dtype, tol, layout, b, s, h, kv,
                                            hd):
    """The partial entry (``with_ml``): the output, and each (row, head)'s
    float32 softmax max and sum, against the plain version's, on a dense
    cache, a ring and a pool; one row with no valid key (max -1e30, its
    sum the key count); one launch a call, counted with the others."""
    _need_card()
    q, k, v = _att_inputs(b, 1, s, h, kv, hd, dtype, s + 7)
    if layout == "paged":
        bs, n_blocks = 16, b * s + 2
        g = torch.Generator(device="cuda").manual_seed(s)
        k_pool = torch.randn((n_blocks, bs, kv, hd), generator=g,
                             device="cuda").to(dtype)
        v_pool = torch.randn((n_blocks, bs, kv, hd), generator=g,
                             device="cuda").to(dtype)
        table = torch.randperm(n_blocks, generator=g, device="cuda")[:b * s]
        table = table.reshape(b, s).to(torch.int32)
        lens = torch.tensor([0, 100, s * bs - 1][:b], dtype=torch.int32,
                            device="cuda")
        before = (p_da.decode_attention_cuda.launches,
                  p_da.decode_attention_cuda.ml_launches)
        got = p_da.decode_attention_paged_cuda(q, k_pool, v_pool, table,
                                               lens, with_ml=True)
        k = k_pool[table.long()].reshape(b, s * bs, kv, hd)
        v = v_pool[table.long()].reshape(b, s * bs, kv, hd)
        valid = torch.arange(s * bs, device="cuda")[None] <= lens[:, None]
    else:
        valid = (_ring_valid(b, s, 2 * s + 5, s) if layout == "ring" else
                 _split_masks(b, s, s, dead_row=True, dead_split=s >= 130))
        before = (p_da.decode_attention_cuda.launches,
                  p_da.decode_attention_cuda.ml_launches)
        got = p_ops.decode_attention(q, k, v, valid, with_ml=True)
    torch.cuda.synchronize()
    assert (p_da.decode_attention_cuda.launches,
            p_da.decode_attention_cuda.ml_launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = p_ref.decode_attention_ref(q, k, v, valid, with_ml=True)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    for g_t, w_t in zip(got[1:], want[1:]):
        assert g_t.dtype == torch.float32 and g_t.shape == (b, h)
        torch.testing.assert_close(g_t, w_t, rtol=1e-4, atol=1e-4)
    if layout != "paged":
        dead = ~valid.any(1)
        assert dead.any()
        assert (got[1][dead] == -1e30).all()
        assert (got[2][dead] == s).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd", [(4, 2056, 4, 1, 256),
                                         (3, 1024, 16, 8, 128),
                                         (4, 64, 4, 2, 32)])
def test_two_block_merge_matches_the_whole_kernel(dtype, tol, b, s, h, kv,
                                                  hd):
    """A sequence attended in two halves by the partial entry and merged
    (``ref.merge_partials``, the kernel's merge rule) against the kernel
    on the whole sequence: a row valid in the second half alone (its first
    half weighs nothing) and a row with no valid key anywhere (the uniform
    average of all S values)."""
    _need_card()
    q, k, v = _att_inputs(b, 1, s, h, kv, hd, dtype, s + 11)
    valid = _split_masks(b, s, s, dead_row=True, dead_split=False)
    valid[0] = False
    valid[0, s // 2 + 3:] = True
    whole = p_ops.decode_attention(q, k, v, valid)
    parts = [p_ops.decode_attention(q, kh.contiguous(), vh.contiguous(),
                                    mh.contiguous(), with_ml=True)
             for kh, vh, mh in zip(k.chunk(2, 1), v.chunk(2, 1),
                                   valid.chunk(2, 1))]
    assert (parts[0][1][0] == -1e30).all()
    merged = p_ref.merge_partials(*(torch.stack(t) for t in zip(
        *((o[:, 0], m, l) for o, m, l in parts))))
    torch.testing.assert_close(merged.to(dtype).float(), whole[:, 0].float(),
                               rtol=tol, atol=tol)
    uniform = v[-1].float().mean(0).repeat_interleave(h // kv, 0)
    torch.testing.assert_close(merged[-1], uniform, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_attention_wrappers_reject_bad_inputs_on_card():
    _need_card()
    q, k, v = _att_inputs(2, 8, 8, 4, 2, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="contiguous"):
        p_fa.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2),
                                  k, v)
    with pytest.raises(ValueError, match="pad"):
        p_fa.flash_attention_cuda(q, k, v, pad=torch.zeros(2, device="cuda"))
    with pytest.raises(ValueError, match="valid_mask"):
        p_da.decode_attention_cuda(q[:, :1].contiguous(), k, v,
                                   torch.ones(2, 8, device="cuda"))
    with pytest.raises(ValueError, match="valid_mask"):
        p_da.decode_attention_cuda(q[:, :1].contiguous(), k, v,
                                   torch.ones(2, 7, dtype=torch.bool,
                                              device="cuda"))


@pytest.mark.gpu
def test_engine_on_card_gives_the_cpu_engines_tokens():
    """float32, a narrow qwen3 with 32-wide heads: the engine on the card
    launches both attention kernels and serves the CPU engine's tokens."""
    _need_card()
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=2, head_dim=32)
    cpu = p_tf.init_params(0, cfg, "cpu")
    gpu = _tree.to_device(cpu, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 9, 70)]
    outs = []
    for params in (cpu, gpu):
        eng = p_engine.ServingEngine(cfg, params, slots=2, s_max=128)
        reqs = [p_engine.Request(rid=i, prompt=pr, max_new=6)
                for i, pr in enumerate(prompts)]
        before = (p_fa.flash_attention_cuda.launches,
                  p_da.decode_attention_cuda.launches)
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        outs.append([r.out for r in reqs])
    assert p_fa.flash_attention_cuda.launches > before[0]
    assert p_da.decode_attention_cuda.launches == before[1] + 2 * eng.decode_steps
    assert outs[0] == outs[1]


def ssd_inputs(b, s, h, p, g, n, dtype, device, seed=0):
    """The reference's SSD test inputs, drawn with numpy: x, dt (softplus),
    a_log, b, c, d_skip."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    x = f32(rng.standard_normal((b, s, h, p))).to(dtype)
    dt = f32(np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    a_log = f32(np.log(np.linspace(1.0, 8.0, h)))
    bm = f32(rng.standard_normal((b, s, g, n)) * 0.5).to(dtype)
    cm = f32(rng.standard_normal((b, s, g, n)) * 0.5).to(dtype)
    d = f32(np.linspace(0.5, 1.5, h))
    return x, dt, a_log, bm, cm, d


def resets(b, s, at, device):
    r = torch.zeros(b, s, dtype=torch.bool)
    for row, t in at:
        r[row, t] = True
    return r.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,reset_at", [
    (2, 64, 4, 16, 2, 8, 16, None),            # tests/test_kernels.py cases
    (1, 128, 2, 32, 1, 16, 32, None),
    (2, 96, 3, 16, 3, 8, 24, None),
    (2, 64, 3, 8, 1, 4, 16, ((0, 5), (0, 16), (1, 37))),
    (2, 160, 3, 8, 1, 4, 16, ((0, 5), (0, 64), (0, 100), (1, 127))),
    (1, 13, 2, 8, 1, 4, 1, None),              # odd length
    (1, 32, 64, 64, 1, 128, 32, ((0, 0), (0, 1), (0, 2))),   # mamba2 prefill
    # the chunk passes (64 steps a chunk) at their edges: one launch a call
    # whether the call issues one device kernel or three
    (1, 63, 4, 16, 2, 8, 63, ((0, 0),)),       # S = T - 1, reset at step 0
    (2, 64, 3, 16, 3, 8, 64, ((0, 10), (0, 40), (1, 63))),   # twice a chunk
    (2, 65, 4, 16, 2, 8, 65, ((0, 64), (1, 0))),   # S = T + 1, on the edge
    (2, 197, 4, 32, 2, 16, 197,
     ((0, 64), (0, 128), (1, 70), (1, 100), (1, 196))),
    (1, 197, 8, 64, 2, 128, 197, ((0, 0), (0, 128))),     # mamba2's widths
    (1, 32, 64, 64, 1, 128, 32, ((0, 0), (0, 1), (0, 2), (0, 3))),  # pad 3
    (2, 512, 64, 64, 1, 128, 256, None),       # the split check's shape
])
def test_ssd_kernel_matches_plain(dtype, b, s, h, p, g, n, chunk, reset_at):
    _need_card()
    args = ssd_inputs(b, s, h, p, g, n, dtype, "cuda")
    reset = None if reset_at is None else resets(b, s, reset_at, "cuda")
    before = p_ssd.ssd_scan_cuda.launches
    y, st = p_ops.ssd_scan(*args, chunk=chunk, reset=reset)
    torch.cuda.synchronize()
    assert p_ssd.ssd_scan_cuda.launches == before + 1
    y_want, st_want = p_ref.ssd_scan_ref(*args, chunk=chunk, reset=reset)
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(y.float()), _np(y_want.float()), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(st), _np(st_want), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,r,reset_at", [
    (2, 128, 64, None), (1, 64, 128, None), (3, 256, 32, None),
    (2, 64, 16, ((0, 5), (0, 16), (1, 37))),
    (2, 37, 16, ((0, 20), (1, 20))),            # odd length
    (2, 512, 2560, ((1, 0), (1, 1), (1, 2))),   # recurrentgemma's width
    # the segmented kernel's edges (plan: 4 steps a segment up to S = 64,
    # 8 above; tiles of 16 x 8 steps from S = 65): resets at step 0, on a
    # segment's first and last step, on a tile boundary, twice in one
    # segment; S = 1, odd S, S not a multiple of the tile; R not a
    # multiple of the 16-channel tile
    (1, 32, 2560, ((0, 0), (0, 1), (0, 2))),    # engine shape, pad 3
    (2, 1, 16, ((1, 0),)),
    (2, 32, 37, ((0, 4), (0, 7), (1, 11), (1, 12))),
    (2, 197, 37, ((0, 8), (0, 15), (0, 128), (1, 130), (1, 133), (1, 127))),
    (1, 300, 40, ((0, 0), (0, 256), (0, 299))),
])
def test_rglru_kernel_matches_plain(dtype, b, s, r, reset_at):
    _need_card()
    rng = np.random.default_rng(1)
    x = torch.as_tensor((rng.standard_normal((b, s, r)) * 0.3)
                        .astype(np.float32), device="cuda").to(dtype)
    a = torch.sigmoid(torch.as_tensor(rng.standard_normal((b, s, r))
                                      .astype(np.float32), device="cuda")
                      + 2.0).to(dtype)
    reset = None if reset_at is None else resets(b, s, reset_at, "cuda")
    before = p_rg.rglru_scan_cuda.launches
    got = p_ops.rglru_scan(x, a, reset)
    torch.cuda.synchronize()
    assert p_rg.rglru_scan_cuda.launches == before + 1
    want = p_ref.rglru_scan_ref(x, a, reset)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(_np(got.float()), _np(want.float()), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_grid_refuses_a_clock_the_sweep_kernel_cannot_take():
    """A CUDA grid with a cell whose f_max_ue is above the kernel's limit
    raises once, when it is built; the same cell on the CPU is taken."""
    _need_card()
    from repro_torch.core.env import MecConfig
    fast = p_sc.paper_table1(cfg=MecConfig(f_max_ue=5e12))
    with pytest.raises(ValueError, match="F_MAX_UE_LIMIT"):
        p_sc.ScenarioGrid([p_sc.paper_table1(), fast])
    p_sc.ScenarioGrid([fast], device="cpu")
    p_sc.ScenarioGrid([p_sc.paper_table1(
        cfg=MecConfig(f_max_ue=p_ps.F_MAX_UE_LIMIT))])


@pytest.mark.gpu
def test_ssd_kernel_takes_views_at_any_element_offset():
    """A unit's slice of a stacked parameter (a_log, d_skip of 2 heads in
    unit 1 start 8 bytes in) is contiguous but not 16-byte aligned; the
    kernel reads it element by element and must take it."""
    _need_card()
    x, dt, a_log, bm, cm, d = ssd_inputs(1, 8, 2, 8, 1, 4, torch.float32,
                                         "cuda")
    stacked_a, stacked_d = torch.stack([a_log, a_log]), torch.stack([d, d])
    assert stacked_a[1].data_ptr() % 16 == 8
    y, st = p_ssd.ssd_scan_cuda(x, dt, stacked_a[1], bm, cm, stacked_d[1])
    y_want, st_want = p_ref.ssd_scan_ref(x, dt, a_log, bm, cm, d, chunk=8)
    np.testing.assert_allclose(_np(y), _np(y_want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(st), _np(st_want), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_scan_wrappers_reject_bad_inputs_on_card():
    _need_card()
    x, dt, a_log, bm, cm, d = ssd_inputs(1, 8, 2, 8, 1, 4, torch.float32,
                                         "cuda")
    with pytest.raises(ValueError, match="float32"):
        p_ssd.ssd_scan_cuda(x, dt.bfloat16(), a_log, bm, cm, d)
    with pytest.raises(ValueError, match="share"):
        p_ssd.ssd_scan_cuda(x, dt, a_log, bm.bfloat16(), cm, d)
    with pytest.raises(ValueError, match="multiples of 4"):
        p_ssd.ssd_scan_cuda(x[..., :6].contiguous(), dt, a_log, bm, cm, d)
    with pytest.raises(ValueError, match="contiguous"):
        p_ssd.ssd_scan_cuda(torch.cat([x, x], -1)[..., :8], dt, a_log, bm,
                            cm, d)
    with pytest.raises(ValueError, match="share"):
        p_rg.rglru_scan_cuda(x[:, :, 0], x[:, :, 0].bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        p_rg.rglru_scan_cuda(x[:, :, 0].cpu(), x[:, :, 0].cpu())


_WRAPPERS = {"ssd": p_ssd.ssd_scan_cuda, "rglru": p_rg.rglru_scan_cuda,
             "flash": p_fa.flash_attention_cuda,
             "decode": p_da.decode_attention_cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("arch,pattern,kernels", [
    pytest.param("recurrentgemma-2b", None, ("rglru", "flash", "decode"),
                 id="recurrentgemma-2b"),
    pytest.param("mamba2-1.3b", ("g", "r", "s"),
                 ("ssd", "rglru", "flash", "decode"), id="hybrid-grs")])
def test_engine_on_card_serves_ring_and_recurrent_stacks(arch, pattern,
                                                         kernels):
    """float32, reduced recurrentgemma (r, r, l units, an r, r tail) and a
    g/r/s stack with 32-wide heads: the engine on the card launches the
    kernel of every layer kind it holds and serves the CPU engine's
    tokens."""
    _need_card()
    cfg = reduced(get_config(arch), head_dim=32)
    if pattern is not None:
        cfg = reduced(get_config(arch), head_dim=32, n_layers=6, n_heads=4,
                      n_kv=2, block_pattern=pattern, rnn_width=32)
    cpu = p_tf.init_params(0, cfg, "cpu")
    gpu = _tree.to_device(cpu, "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 9, 70)]
    outs = []
    for params in (cpu, gpu):
        eng = p_engine.ServingEngine(cfg, params, slots=2, s_max=128)
        reqs = [p_engine.Request(rid=i, prompt=pr, max_new=6)
                for i, pr in enumerate(prompts)]
        before = {k: _WRAPPERS[k].launches for k in kernels}
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        outs.append([r.out for r in reqs])
    for k in kernels:
        assert _WRAPPERS[k].launches > before[k], k
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The engine's sync mode, sanitizer and checkpoints on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_sync_wave_shapes_match_plain(dtype, tol):
    """The sync engine's shapes: a wave prefill of 8 left-padded rows (flash
    with a per-row pad at B = 8) and its decode against the dense
    (8, 512) cache under the pad mask (the dense decode entry, keys below
    each row's pad masked)."""
    _need_card()
    pads = [0, 13, 40, 299, 7, 150, 1, 290]
    q, k, v = _att_inputs(8, 300, 300, 16, 8, 128, dtype, 300)
    pad_t = torch.tensor(pads, dtype=torch.int32, device="cuda")
    keys = torch.arange(300, device="cuda")
    got = p_ops.flash_attention(q, k, v, kind="causal",
                                pad_mask=keys[None] >= pad_t[:, None])
    want = p_ref.flash_attention_ref(q, k, v, kind="causal", pad=pad_t)
    for i, p0 in enumerate(pads):
        torch.testing.assert_close(got[i, p0:].float(), want[i, p0:].float(),
                                   rtol=tol, atol=tol)
        assert (got[i, :p0] == 0).all()
    q, k, v = _att_inputs(8, 1, 512, 16, 8, 128, dtype, 512)
    slots = torch.arange(512, device="cuda")
    valid = (slots <= 330)[None] & (slots[None] >= pad_t[:, None])
    before = p_da.decode_attention_cuda.launches
    got = p_ops.decode_attention(q, k, v, valid)
    assert p_da.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), p_ref.decode_attention_ref(q, k, v, valid).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol,scan_tol", [(torch.float32, 2e-5, 1e-4),
                                                (torch.bfloat16, 2e-2, 2e-2)])
def test_recurrentgemma_sync_wave_shapes_match_plain(dtype, tol, scan_tol):
    """recurrentgemma-2b's sync wave at full width: the RG-LRU scan at B8
    R2560 (32-channel blocks) with each row's pad-reset run, its "l"
    prefill (10 heads over 1, hd 256, window 2048) with a per-row pad, and
    the decode over the 2048-slot ring under the pad mask."""
    _need_card()
    pads = [6, 120, 72, 8, 0, 16, 109, 74]
    b, s = len(pads), 144
    pad_t = torch.tensor(pads, dtype=torch.int32, device="cuda")
    keys = torch.arange(s, device="cuda")
    pad_mask = keys[None] >= pad_t[:, None]
    prev = torch.cat([torch.zeros_like(pad_mask[:, :1]), ~pad_mask[:, :-1]], 1)
    reset = ~pad_mask | prev                      # models.common.pad_reset
    assert p_rg.plan(b, s, 2560)[0] == 32
    rng = np.random.default_rng(3)
    x = torch.as_tensor((rng.standard_normal((b, s, 2560)) * 0.3)
                        .astype(np.float32), device="cuda").to(dtype)
    a = torch.sigmoid(torch.as_tensor(rng.standard_normal((b, s, 2560))
                                      .astype(np.float32), device="cuda")
                      + 2.0).to(dtype)
    before = p_rg.rglru_scan_cuda.launches
    got = p_ops.rglru_scan(x, a, reset)
    assert p_rg.rglru_scan_cuda.launches == before + 1
    torch.testing.assert_close(
        got.float(), p_ref.rglru_scan_ref(x, a, reset).float(),
        rtol=scan_tol, atol=scan_tol)
    q, k, v = _att_inputs(b, s, s, 10, 1, 256, dtype, 144)
    got = p_ops.flash_attention(q, k, v, kind="local", window=2048,
                                pad_mask=pad_mask)
    want = p_ref.flash_attention_ref(q, k, v, kind="local", window=2048,
                                     pad=pad_t)
    for i, p0 in enumerate(pads):
        torch.testing.assert_close(got[i, p0:].float(), want[i, p0:].float(),
                                   rtol=tol, atol=tol)
        assert (got[i, :p0] == 0).all()
    q, k, v = _att_inputs(b, 1, 2048, 10, 1, 256, dtype, 2048)
    slots = torch.arange(2048, device="cuda")
    valid = (slots <= s + 20)[None] & (slots[None] >= pad_t[:, None])
    got = p_ops.decode_attention(q, k, v, valid)
    torch.testing.assert_close(
        got.float(), p_ref.decode_attention_ref(q, k, v, valid).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernels", [
    ("qwen3-0.6b", ("flash", "decode")),
    ("recurrentgemma-2b", ("rglru", "flash", "decode")),
    ("mamba2-1.3b", ("ssd",))])
def test_sync_engine_on_card_gives_the_cpu_engines_tokens(arch, kernels):
    """float32, reduced stacks with 32-wide heads: the sync engine on the
    card launches each of its stack's kernels and serves the CPU's sync
    engine's tokens over ragged waves."""
    _need_card()
    cfg = reduced(get_config(arch), head_dim=32)
    cpu = p_tf.init_params(0, cfg, "cpu")
    gpu = _tree.to_device(cpu, "cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 9, 70, 17)]
    outs = []
    for params in (cpu, gpu):
        eng = p_engine.ServingEngine(cfg, params, slots=3, s_max=96,
                                     sync_batching=True)
        reqs = [p_engine.Request(rid=i, prompt=pr, max_new=6)
                for i, pr in enumerate(prompts)]
        before = {k: _WRAPPERS[k].launches for k in kernels}
        for r in reqs:
            eng.submit(r)
        eng.run_until_idle()
        outs.append([r.out for r in reqs])
    for k in kernels:
        assert _WRAPPERS[k].launches > before[k], k
    assert outs[0] == outs[1]


@pytest.mark.gpu
def test_sanitizer_on_card_is_clean_and_guards_the_paged_decode():
    """The flash-crowd run is clean on the card; an out-of-range table
    entry is refused before it reaches the paged decode kernel."""
    _need_card()
    from repro_torch.analysis.sanitize import GuardError, run_sanitize
    rep = run_sanitize(device="cuda", head_dim=32)
    assert rep.ok and rep.preemptions > 0, [f.render() for f in rep.failures]
    cfg = reduced(get_config("qwen3-0.6b"), n_layers=1, head_dim=32)
    eng = p_engine.ServingEngine(cfg, p_tf.init_params(0, cfg, "cuda"),
                                 slots=2, s_max=32, sanitize=True)
    eng.submit(p_engine.Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                max_new=8))
    assert eng.step()
    (slot,) = [i for i, r in enumerate(eng.active) if r is not None]
    eng.block_tables[slot, 0] = eng.allocator.n_blocks + 5
    before = p_da.decode_attention_cuda.launches
    with pytest.raises(GuardError, match="block id"):
        eng.step()
    assert p_da.decode_attention_cuda.launches == before


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(tmp_path):
    _need_card()
    from repro_torch.runtime.checkpoint import CheckpointManager
    env = p_env.paper_env(device="cuda")
    agent = p_ppo.PPO(p_pol.GaussianTanhPolicy(env.obs_dim, env.L),
                      env.obs_dim, p_ppo.PPOConfig())
    state = agent.init(env.generator(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    mgr.wait()
    back, _ = mgr.restore(agent.init(env.generator(1)))
    for a, b in zip(_tree.leaves(back), _tree.leaves(state)):
        assert a.device == b.device and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The learning loop on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_training_episode_on_card():
    """One K = 16 training episode of the quickstart's agent on the card:
    a CUDA generator, Adam's step count, finite metrics, moved parameters,
    and the Oracle baseline through the sweep kernel."""
    _need_card()
    env = p_env.paper_env()
    agent = p_ppo.PPO(p_pol.CategoricalPolicy(env.obs_dim, env.L),
                      env.obs_dim)
    runner = p_lymdo.Runner(env, agent, steps=16)
    assert env.generator(0).device.type == "cuda"
    init = agent.init(env.generator(0))
    state, hist = runner.train(p_lymdo.RunConfig(episodes=1, steps=16,
                                                 chunk=1, log=False))
    assert int(state.opt_state.step) == agent.cfg.epochs
    assert all(x.is_cuda for x in _tree.leaves(state.params))
    assert all(v.shape == (1,) and np.isfinite(v).all() for v in hist.values())
    moved = max(float((a - b).abs().max()) for a, b in
                zip(_tree.leaves(state.params), _tree.leaves(init.params)))
    assert moved > 0
    before = p_ps.partition_sweep_cuda.launches
    m, _ = p_lymdo.run_fixed(env, p_lymdo.oracle_cut_fn(env), episodes=1,
                             steps=4)
    assert p_ps.partition_sweep_cuda.launches == before + 4
    assert all(np.isfinite(v) for v in m.values())


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["categorical", "joint"])
def test_ppo_update_card_matches_cpu(head):
    """One 8-epoch update from the same parameters on the same trajectory
    (collected on the CPU), card against CPU, at the CPU parity tests'
    update tolerance: metrics rtol 1e-4, parameters atol 1e-5."""
    _need_card()
    env = p_env.paper_env(device="cpu")

    def make(device):
        L = env.L.to(device)
        pol = (p_pol.JointGaussianPolicy(env.obs_dim, L, env.cfg.f_max_ue,
                                         env.cfg.f_max_es) if head == "joint"
               else p_pol.CategoricalPolicy(env.obs_dim, L))
        return p_ppo.PPO(pol, env.obs_dim)

    agent, card = make("cpu"), make("cuda")
    state = agent.init(env.generator(0))
    traj, _, _ = p_lymdo.Runner(env, agent, steps=16,
                                mode="joint" if head == "joint" else "lymdo"
                                ).episode(state.params, env.generator(1))
    want_state, want = agent.update(state, traj)
    got_state, got = card.update(_tree.to_device(state, "cuda"),
                                 _tree.to_device(traj, "cuda"))
    for name in want:
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for a, b in zip(_tree.leaves(got_state.params),
                    _tree.leaves(want_state.params)):
        assert a.is_cuda
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)
    assert int(got_state.opt_state.step) == 8


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["gaussian", "categorical", "joint"])
def test_head_from_layer_list_lives_on_card(head):
    """A head given its layer counts as a list and no device lives on the
    card, and so does the PPO state it initialises."""
    _need_card()
    L = [8, 8, 18, 18, 18]
    pol = {"gaussian": lambda: p_pol.GaussianTanhPolicy(12, L),
           "categorical": lambda: p_pol.CategoricalPolicy(12, L),
           "joint": lambda: p_pol.JointGaussianPolicy(12, L, 1.5e9, 15e9)}[head]()
    assert pol.device.type == "cuda"
    state = p_ppo.PPO(pol, 12).init(torch.Generator(device="cuda").manual_seed(0))
    assert all(x.is_cuda for x in _tree.leaves(state))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,kind,pad", [
    (4, 512, 512, 16, 16, 64, "full", None),       # seamless's encoder
    (4, 128, 512, 16, 16, 64, "full", None),       # seamless's cross
    (4, 128, 1024, 64, 8, 128, "full", None),      # vision's cross
    (4, 128, 128, 40, 8, 128, "causal", [0, 51, 96, 27]),   # llama4, G 5
    (4, 128, 128, 64, 8, 128, "causal", [0, 96, 38, 71]),   # vision, G 8
    (1, 256, 256, 16, 16, 128, "causal", [85])])   # moonshot solo, G 1
def test_flash_at_the_remaining_kinds_shapes_matches_plain(
        dtype, tol, b, sq, sk, h, kv, hd, kind, pad):
    """Flash at the shapes the "m", "x", "e" and "d" kinds give it: full
    attention with Sq != Sk, GQA groups of 1, 5 and 8."""
    _need_card()
    q, k, v = _att_inputs(b, sq, sk, h, kv, hd, dtype, sq + sk)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    before = p_fa.flash_attention_cuda.launches
    got = p_ops.flash_attention(q, k, v, kind=kind, pad_mask=None if pad is None
                                else torch.arange(sk, device="cuda")[None]
                                >= pad_t[:, None])
    torch.cuda.synchronize()
    assert p_fa.flash_attention_cuda.launches == before + 1
    want = p_ref.flash_attention_ref(q, k, v, kind=kind, pad=pad_t)
    for i in range(b):
        p0 = 0 if pad is None else pad[i]
        torch.testing.assert_close(got[i, p0:].float(), want[i, p0:].float(),
                                   rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd", [(4, 1024, 64, 8, 128),
                                         (4, 512, 16, 16, 64)])
def test_cross_decode_over_a_whole_context_matches_plain(dtype, tol, b, s, h,
                                                         kv, hd):
    """Cross-attention decode: every key of the 1,024- or 512-key context
    valid."""
    _need_card()
    q, k, v = _att_inputs(b, 1, s, h, kv, hd, dtype, s)
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    got = p_ops.decode_attention(q, k, v, valid)
    torch.testing.assert_close(
        got.float(), p_ref.decode_attention_ref(q, k, v, valid).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_decode_at_moonshots_heads_matches_plain(dtype, tol):
    """The paged entry at moonshot's 16 heads over 16 kv heads (G 1)."""
    _need_card()
    b, m, bs, h, kv, hd = 8, 32, 16, 16, 16, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)
    n_blocks = b * m + 1
    q, kp, vp = rnd(b, 1, h, hd), rnd(n_blocks, bs, kv, hd), rnd(n_blocks, bs, kv, hd)
    table = torch.randperm(n_blocks, generator=g, device="cuda")[:b * m]
    table = table.reshape(b, m).to(torch.int32)
    lens = torch.tensor([0, 15, 16, 511, 100, 300, 1, 64], dtype=torch.int32,
                        device="cuda")
    got = p_ops.decode_attention_paged(q, kp, vp, table, lens)
    rows = lambda pool: pool[table.long()].reshape(b, m * bs, kv, hd)
    valid = torch.arange(m * bs, device="cuda")[None] <= lens[:, None]
    torch.testing.assert_close(
        got.float(), p_ref.decode_attention_ref(q, rows(kp), rows(vp),
                                                valid).float(),
        rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_engine_on_card_serves_moe_stacks_with_the_cpu_engines_tokens(arch):
    """float32, reduced MoE stacks with 32-wide heads at the no-drop
    capacity factor ceil(E / k): both engine modes on the card launch the
    attention kernels, prefill whole prompts and serve the CPU engines'
    tokens.  (At the configs' 1.25 a bucketed prefill's left-pad tokens
    compete for capacity, and a pad row, which sees no key, is zeros from
    the flash kernel but the uniform average from the plain version: the
    two engines may then drop different tokens.)"""
    _need_card()
    cfg = reduced(get_config(arch), head_dim=32)
    cfg = dataclasses.replace(
        cfg, capacity_factor=float(-(-cfg.n_experts // cfg.top_k)))
    cpu = p_tf.init_params(0, cfg, "cpu")
    gpu = _tree.to_device(cpu, "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 9, 70)]
    for sync in (False, True):
        outs = []
        for params in (cpu, gpu):
            eng = p_engine.ServingEngine(cfg, params, slots=2, s_max=128,
                                         sync_batching=sync)
            assert eng.prefill_chunk is None
            reqs = [p_engine.Request(rid=i, prompt=pr, max_new=6)
                    for i, pr in enumerate(prompts)]
            before = p_da.decode_attention_cuda.launches
            for r in reqs:
                eng.submit(r)
            eng.run_until_idle()
            outs.append([r.out for r in reqs])
        assert p_da.decode_attention_cuda.launches == (
            before + eng.decode_steps * cfg.n_layers)
        assert outs[0] == outs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_cross_attention_stacks_on_card_match_the_cpu(arch):
    """float32, reduced vision and seamless with 32-wide heads: prefill
    (left-padded) and three decode steps on the card give the CPU's logits
    at 1e-4, launching flash for the encoder and cross-attention and the
    decode kernel over the context."""
    _need_card()
    cfg = reduced(get_config(arch), head_dim=32)
    cpu = p_tf.init_params(0, cfg, "cpu")
    gpu = _tree.to_device(cpu, "cuda")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g)}
    key = "image_embeds" if cfg.frontend == "vision" else "src_embeds"
    batch[key] = torch.randn(2, 24, cfg.d_model, generator=g)
    pad = torch.tensor([0, 3], dtype=torch.int32)
    logits = []
    for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = {k: v.to(dev) for k, v in batch.items()}
        before = p_fa.flash_attention_cuda.launches
        lg, cache = p_tf.prefill(params, cfg, b, s_max=16, pad=pad.to(dev))
        out = [lg.cpu()]
        for t in range(3):
            lg, cache = p_tf.decode_step(params, cfg, cache,
                                         b["tokens"][:, t])
            out.append(lg.cpu())
        logits.append(torch.stack(out))
    assert p_fa.flash_attention_cuda.launches - before == (
        cfg.n_layers + cfg.enc_layers + sum(k == "d" for k in cfg.block_pattern)
        * cfg.n_units)
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# training: the flash backward, the gradient rule, a train step
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,hd,kind,window,pad", [
    (2, 128, 128, 16, 8, 128, "causal", 0, None),
    (2, 100, 300, 64, 8, 128, "full", 0, None),
    (1, 200, 200, 4, 1, 256, "local", 64, None),
    (3, 96, 96, 8, 2, 64, "causal", 0, [0, 17, 40]),
    (2, 37, 37, 4, 2, 32, "causal", 0, None),
    (2, 17, 17, 8, 2, 64, "causal", 0, None),
    (2, 17, 300, 16, 8, 128, "full", 0, None),
    (2, 300, 17, 16, 8, 128, "full", 0, None),
    (1, 1100, 1100, 4, 1, 256, "local", 1024, None),
    (1, 40, 40, 64, 1, 64, "causal", 0, None),
    (2, 320, 320, 8, 4, 128, "causal", 0, None)])
def test_flash_backward_matches_plain_autograd(dt, b, sq, sk, h, kv, hd,
                                               kind, window, pad):
    """``ops.flash_attention`` with a gradient wanted runs the backward
    kernel: dq, dk, dv against autograd through the float32 plain version
    on the same inputs (1e-4 in float32, 2e-2 in bf16, of max(1, max |g|)).
    Rows that see no key have their dO zeroed on both sides; with it
    restored the kernel gives them dq = 0 and dk, dv keep every bit.  The
    shapes include the edges of the bf16 backward's tiling: Sq or Sk under
    one 64-row tile, gemma3's window at hd 256 and one kv head, a group of
    64 (one position a dQ block) and 5 key tiles under causal masking."""
    _need_card()
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(sq + hd)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda").to(dtype)
    q, k, v, dout = rnd(b, sq, h, hd), rnd(b, sk, kv, hd), rnd(b, sk, kv, hd), \
        rnd(b, sq, h, hd)
    pad_t = None if pad is None else torch.tensor(pad, dtype=torch.int32,
                                                  device="cuda")
    pad_mask = None if pad is None else (
        torch.arange(sk, device="cuda")[None, :] >= pad_t[:, None])
    mask = p_ref.build_mask(kind, sq, sk, window, device="cuda")
    seen = torch.ones(b, sq, dtype=torch.bool, device="cuda")
    if mask is not None:
        seen = seen & mask.any(-1)[None]
    if pad is not None:
        seen = (mask[None] & pad_mask[:, None, :]).any(-1)
    live = dout * seen[:, :, None, None].to(dtype)

    def kernel(d):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = p_ops.flash_attention(*leaves, kind=kind, window=window,
                                    pad_mask=pad_mask)
        return torch.autograd.grad(out, leaves, d)

    before = (p_fa.flash_attention_cuda.launches,
              p_fa.flash_attention_backward_cuda.launches)
    got = kernel(live)
    assert (p_fa.flash_attention_cuda.launches,
            p_fa.flash_attention_backward_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    plain = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        p_ref.flash_attention_ref(*plain, kind=kind, window=window,
                                  pad=pad_t), plain, live.float())
    tol = 1e-4 if dt == "f32" else 2e-2
    for gg, w in zip(got, want):
        assert gg.dtype == dtype
        assert float((gg.float() - w).abs().max()) <= tol * max(
            1.0, float(w.abs().max()))
    if not bool(seen.all()):
        again = kernel(dout)
        assert not bool((again[0][~seen] != 0).any())
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,hd,kind,window", [
    (4, 512, 16, 8, 128, "causal", 0),
    (1, 1100, 4, 1, 256, "local", 1024),
    (2, 130, 10, 2, 64, "causal", 0),
    (1, 40, 64, 1, 32, "full", 0)])
def test_flash_backward_is_bit_identical_across_calls(b, s, h, kv, hd, kind,
                                                      window):
    """Two bf16 backward calls on the same inputs give the same dq, dk and
    dv bit for bit: no atomics, nothing hangs on the order blocks run in
    (a resumed training run equals an uninterrupted one through this)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(s + hd)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device="cuda").to(torch.bfloat16)
    q, k, v, dout = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd), \
        rnd(b, s, h, hd)
    out, lse = p_fa.flash_attention_cuda(q, k, v, kind=kind, window=window,
                                         with_lse=True)
    first = p_fa.flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                               kind=kind, window=window)
    # other work between the calls, so that blocks land elsewhere
    torch.randn(4096, 4096, device="cuda") @ torch.randn(4096, 4096,
                                                         device="cuda")
    second = p_fa.flash_attention_backward_cuda(q, k, v, out, lse, dout,
                                                kind=kind, window=window)
    for a, c in zip(first, second):
        assert torch.equal(a, c)
        assert bool(torch.isfinite(a.float()).all())


@pytest.mark.gpu
def test_kernels_without_a_backward_refuse_a_gradient():
    """On the card, decode attention (dense and paged) and the sweep raise
    NotImplementedError when a gradient is wanted through them, and run as
    before under no_grad (the SSD and RG-LRU scans have backward kernels:
    ``test_scan_backward_*``)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    q = rnd(2, 1, 4, 32).requires_grad_(True)
    k, v = rnd(2, 16, 2, 32), rnd(2, 16, 2, 32)
    valid = torch.ones(2, 16, dtype=torch.bool, device="cuda")
    table = torch.arange(4, device="cuda", dtype=torch.int32).reshape(2, 2)
    lens = torch.tensor([5, 11], device="cuda", dtype=torch.int32)
    calls = {
        "decode_attention": lambda: p_ops.decode_attention(q, k, v, valid),
        "decode_attention_paged": lambda: p_ops.decode_attention_paged(
            q, rnd(4, 8, 2, 32), rnd(4, 8, 2, 32), table, lens),
    }
    args, scalars = random_sweep_inputs((2, 3), 5, "cuda")
    args[0].requires_grad_(True)
    row = p_ref.pack_scalars(scalars, "cuda")
    calls["partition_sweep"] = lambda: p_ops.partition_sweep_batched(*args,
                                                                     row)
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=name):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


def _grads(outs, leaves, cots):
    """autograd.grad with zeros for a leaf the outputs never read (the
    plain RG-LRU at S = 1 never reads a)."""
    got = torch.autograd.grad(outs, leaves, cots, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(got, leaves)]


def _assert_grads_close(got, want):
    """1e-4 of max(1, max |g|) for a float32 gradient, 2e-2 for one that
    comes out in bf16 (the flash backward's bands)."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        tol = 2e-2 if g.dtype == torch.bfloat16 else 1e-4
        assert float((g.float() - w.float()).abs().max()) <= tol * max(
            1.0, float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,reset_at,final", [
    (2, 1, 8, 64, 1, 128, ((1, 0),), "random"),        # the one-kernel path
    (2, 65, 4, 16, 2, 8, ((0, 64), (1, 0)), "random"),  # G 2, chunk edge
    (1, 333, 8, 64, 1, 128, ((0, 0), (0, 128), (0, 140), (0, 150)), None),
    (2, 130, 8, 64, 1, 128, ((0, 64),), "zero"),
    (4, 512, 64, 64, 1, 128, None, None),               # mamba2 training
    (2, 97, 4, 20, 2, 12, ((0, 64),), "random"),        # N, P not by 16
])
def test_scan_backward_ssd_matches_plain_autograd(dtype, b, s, h, p, g, n,
                                                  reset_at, final):
    """The SSD backward kernel (``ops.ssd_scan`` with a gradient wanted, so
    ``SsdScan``) against autograd through the float32 plain version; the
    final state's cotangent absent (as in training), zero or drawn; a
    second call equal to the first bit for bit."""
    _need_card()
    args = ssd_inputs(b, s, h, p, g, n, dtype, "cuda", seed=2)
    reset = None if reset_at is None else resets(b, s, reset_at, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda").to(dtype)
    dstate = (None if final is None else torch.zeros(b, h, n, p, device="cuda")
              if final == "zero" else
              torch.randn(b, h, n, p, generator=gen, device="cuda"))

    def grads(fn, values, cot):
        leaves = [t.detach().requires_grad_(True) for t in values]
        y, st = fn(*leaves)
        if dstate is None:
            return _grads(y, leaves, cot)
        return _grads([y, st], leaves, [cot, dstate])

    kernel = lambda *v: p_ops.ssd_scan(*v, chunk=64, reset=reset)
    before = p_ssd.ssd_scan_backward_cuda.launches
    got, again = grads(kernel, args, dy), grads(kernel, args, dy)
    torch.cuda.synchronize()
    assert p_ssd.ssd_scan_backward_cuda.launches == before + 2
    want = grads(lambda *v: p_ref.ssd_scan_padded(*v, 64, reset=reset),
                 [t.float() for t in args], dy.float())
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype, torch.float32]
    _assert_grads_close(got, want)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,r,reset_at", [
    (2, 1, 16, ((1, 0),)),
    (2, 197, 37, ((0, 8), (0, 15), (0, 128), (1, 127), (1, 130), (1, 133))),
    (1, 300, 40, ((0, 0), (0, 256), (0, 299))),
    (4, 512, 2560, None),                                # recurrentgemma
])
def test_scan_backward_rglru_matches_plain_autograd(dtype, b, s, r,
                                                    reset_at):
    """The RG-LRU backward kernel (``ops.rglru_scan`` with a gradient
    wanted, so ``RglruScan``) against autograd through the float32 plain
    version, and a second call equal to the first bit for bit."""
    _need_card()
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.standard_normal((b, s, r)) * 0.3)
                        .astype(np.float32), device="cuda").to(dtype)
    a = torch.sigmoid(torch.as_tensor(rng.standard_normal((b, s, r))
                                      .astype(np.float32), device="cuda")
                      + 2.0).to(dtype)
    dh = torch.as_tensor(rng.standard_normal((b, s, r)).astype(np.float32),
                         device="cuda").to(dtype)
    reset = None if reset_at is None else resets(b, s, reset_at, "cuda")

    def grads(fn, values, cot):
        leaves = [t.detach().requires_grad_(True) for t in values]
        return _grads(fn(*leaves, reset), leaves, cot)

    before = p_rg.rglru_scan_backward_cuda.launches
    got = grads(p_ops.rglru_scan, (x, a), dh)
    again = grads(p_ops.rglru_scan, (x, a), dh)
    torch.cuda.synchronize()
    assert p_rg.rglru_scan_backward_cuda.launches == before + 2
    want = grads(p_ref.rglru_scan_ref, (x.float(), a.float()), dh.float())
    assert all(t.dtype == dtype for t in got)
    _assert_grads_close(got, want)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_scan_stack_train_step_on_card_matches_the_cpu(arch):
    """float32 at full width, remat on: mamba2-1.3b at 2 "s" layers and
    recurrentgemma-2b as one (r, r, l) unit and an (r,) tail; a gradient
    step on the card against the CPU from the same parameters and batch:
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its max
    |g|; the scans' backward kernels launched once a layer, each unit's
    forward twice (the recompute)."""
    from repro_torch.data.pipeline import for_arch
    from repro_torch.models import steps as p_steps
    _need_card()
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    if arch == "mamba2-1.3b":
        cfg = dataclasses.replace(get_config(arch), n_layers=2, **f32)
        counters = (p_ssd.ssd_scan_cuda, p_ssd.ssd_scan_backward_cuda)
        want_launches = (4, 2)
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=4,
                                  tail_pattern=("r",), **f32)
        counters = (p_rg.rglru_scan_cuda, p_rg.rglru_scan_backward_cuda,
                    p_fa.flash_attention_cuda,
                    p_fa.flash_attention_backward_cuda)
        want_launches = (5, 3, 2, 1)
    assert cfg.remat
    gpu = p_tf.init_params(0, cfg, "cuda")
    cpu = _tree.to_device(gpu, "cpu")
    stream = for_arch(cfg, batch=2, seq=96, seed=5)
    before = [fn.launches for fn in counters]
    (loss, _), grads = p_steps.value_and_grad(
        gpu, cfg, _tree.to_device(stream.get_batch(0), "cuda"))
    torch.cuda.synchronize()
    assert tuple(fn.launches - b for fn, b in zip(counters, before)) == \
        want_launches
    (cpu_loss, _), cpu_grads = p_steps.value_and_grad(cpu, cfg,
                                                      stream.get_batch(0))
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    for g, w in zip(_tree.leaves(grads), _tree.leaves(cpu_grads)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.gpu
def test_train_step_on_card_matches_the_cpu():
    """float32 qwen3-0.6b at full width, 2 layers, remat on: one
    ``make_train_step`` step on the card against the CPU from the same
    parameters and batch (the stream draws on the CPU, so both get the same
    tokens): loss within 1e-5 relative, gradients within 1e-4 of each
    leaf's max |g|; after the step Adam's first moments, (1 - b1) g, within
    1e-4 of each leaf's max and its second moments, (1 - b2) g^2, within
    2e-4 (a square doubles the gradients' relative error), and the loss on
    the next batch within 1e-5 relative (the parameters themselves are not
    held: a first Adam step moves an entry by lr * g / |g|, so where g is
    near 0 the two devices may move it opposite ways); 2 flash forwards,
    2 recomputes and 2 backwards a microbatch."""
    import dataclasses

    from repro_torch.data.pipeline import for_arch
    from repro_torch.models import steps as p_steps
    _need_card()
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    assert cfg.remat
    gpu = p_tf.init_params(0, cfg, "cuda")
    cpu = _tree.to_device(gpu, "cpu")
    stream = for_arch(cfg, batch=2, seq=64, seed=4)
    card_batch = for_arch(cfg, batch=2, seq=64, seed=4,
                          device="cuda").get_batch(0)
    assert all(torch.equal(card_batch[k].cpu(), v)
               for k, v in stream.get_batch(0).items())
    before = (p_fa.flash_attention_cuda.launches,
              p_fa.flash_attention_backward_cuda.launches)
    (loss, _), grads = p_steps.value_and_grad(gpu, cfg, card_batch)
    assert (p_fa.flash_attention_cuda.launches - before[0],
            p_fa.flash_attention_backward_cuda.launches - before[1]) == (4, 2)
    (cpu_loss, _), cpu_grads = p_steps.value_and_grad(cpu, cfg,
                                                      stream.get_batch(0))
    assert abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
    for gg, w in zip(_tree.leaves(grads), _tree.leaves(cpu_grads)):
        assert float((gg.cpu() - w).abs().max()) <= 1e-4 * float(w.abs().max())
    lr = 1e-3
    opt_init, step = p_steps.make_train_step(cfg, lr=lr)
    new, opt, m = step(gpu, opt_init(gpu), card_batch)
    cpu_new, cpu_opt, _ = step(cpu, opt_init(cpu), stream.get_batch(0))
    for tol, tree, cpu_tree in ((1e-4, opt.mu, cpu_opt.mu),
                                (2e-4, opt.nu, cpu_opt.nu)):
        for a, b in zip(_tree.leaves(tree), _tree.leaves(cpu_tree)):
            assert float((a.cpu() - b).abs().max()) <= tol * float(b.abs().max())
    nxt = stream.get_batch(1)
    after = float(p_steps.loss_fn(new, cfg, _tree.to_device(nxt, "cuda"))[0])
    cpu_after = float(p_steps.loss_fn(cpu_new, cfg, nxt)[0])
    assert abs(after - cpu_after) <= 1e-5 * abs(cpu_after)


def _one_rank_card_tokens(ma) -> dict:
    """The one-rank card engine's tokens on every card case, on seed 0's
    weights drawn on the host as ``init_rank_params`` draws them."""
    want = {}
    for name in ma.CARD_NAMES:
        cfg = ma.card_cfg(name)
        params = _tree.to_device(p_tf.init_params(0, cfg, "cpu"), "cuda")
        for case in ma.CARD_CASES:
            want[(name, case)] = ma.run_engine(p_engine, cfg, params, case)
    return want


@pytest.mark.gpu
def test_model_axis_on_card_matches_one_rank():
    """Two ranks on the one card (gloo: NCCL takes one rank a device) on a
    2-way model axis give the one-rank card engine's float32 tokens, with
    chunked prefill and preemption: qwen3-0.6b at full width (2 layers)
    and the g, r, s hybrid (one unit)."""
    _need_card()
    import _model_axis as ma
    from repro_torch.launch.mesh import run_world
    ranks = run_world(ma.card_world, 2, backend="gloo", device="cuda:0",
                      deadline_s=300)
    want = _one_rank_card_tokens(ma)
    for key, w in want.items():
        for r in ranks:
            assert r[key] == w, key


@pytest.mark.gpu
@pytest.mark.parametrize("model", [2, 4])
def test_model_axis_under_nccl_matches_one_rank(model):
    """``model`` ranks, one a card, on a ``model``-way axis under NCCL:
    the collectives run on the device (in place, no host copy), and each
    rank, holding only its drawn shard, gives the one-rank card engine's
    float32 tokens on both stacks, with chunked prefill and
    preemption."""
    _need_card()
    if torch.cuda.device_count() < model:
        pytest.skip(f"needs {model} cards, one a rank under NCCL; this "
                    f"machine has {torch.cuda.device_count()}")
    import _model_axis as ma
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_world
    _build.build_all(_build.all_libraries())      # once, not once a rank
    ranks = run_world(ma.card_world, model, args=(model,), backend="nccl",
                      device="cuda", deadline_s=300)
    want = _one_rank_card_tokens(ma)
    for key, w in want.items():
        for r in ranks:
            assert r[key] == w, key


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [2, 4])
def test_model_axis_training_under_nccl_matches_one_rank(ranks):
    """``ranks`` ranks, one a card, under NCCL on a 2-way model axis (and
    a 2-way data axis at 4): one float32 step of qwen3-0.6b at full width
    (2 layers) gives each rank's shard of the one-rank card step's Adam
    moments (1e-4 and 2e-4 of each leaf's max) and the next batch's loss
    (1e-5 relative)."""
    _need_card()
    if torch.cuda.device_count() < ranks:
        pytest.skip(f"needs {ranks} cards, one a rank under NCCL; this "
                    f"machine has {torch.cuda.device_count()}")
    import _model_axis_train as mt
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_world
    _build.build_all(_build.all_libraries())      # once, not once a rank
    out = run_world(mt.card_train_world, ranks, backend="nccl",
                    device="cuda", deadline_s=300)
    for r in out:
        assert r["shape"] == (ranks // 2, 2)
        assert r["mu"] <= 1e-4 and r["nu"] <= 2e-4, r
        assert abs(r["loss_mesh"] - r["loss_one"]) <= 1e-5 * abs(
            r["loss_one"]), r


def _leaves_np(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_np(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_np(v)]
    return [np.asarray(tree)]


@pytest.mark.gpu
def test_moe_data_axis_step_on_card_matches_the_cpu():
    """A (data 2) step of reduced moonshot (16 experts, capacity 1.25, 2
    microbatches of 1,280 tokens: the 1,024-token dispatch group straddles
    the two ranks, the last one padded): two ranks on the one card over
    gloo against the same world on the CPU, float32.  Every MoE call's
    kept (token, expert) set is the same; loss, ce and aux within 1e-5
    relative; Adam's moments within 1e-4 / 2e-4 of each leaf's max."""
    _need_card()
    import _moe_data_axis as md
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_world
    _build.build_all(_build.all_libraries())      # once, not once a rank
    card = run_world(md.card_world, 2, args=("cuda",), backend="gloo",
                     device="cuda:0", deadline_s=300)
    cpu = run_world(md.card_world, 2, args=("cpu",), deadline_s=300)
    for c, h in zip(card, cpu):
        # one layer, two microbatches
        assert len(c["kept"]) == len(h["kept"]) == 2
        for (at_c, m_c), (at_h, m_h) in zip(c["kept"], h["kept"]):
            assert at_c == at_h
            np.testing.assert_array_equal(m_c, m_h)
        for k in ("loss", "ce", "aux"):
            assert abs(c["metrics"][k] - h["metrics"][k]) <= 1e-5 * abs(
                h["metrics"][k]), (k, c["metrics"], h["metrics"])
        for part, tol in (("mu", 1e-4), ("nu", 2e-4)):
            for i, (g, w) in enumerate(zip(_leaves_np(c[part]),
                                           _leaves_np(h[part]))):
                bound = tol * max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g - w).max()) <= bound, (part, i)
