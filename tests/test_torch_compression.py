"""``repro_torch.runtime.compression`` against the reference's module.

The reference's ``make_grad_sync`` / ``make_dp_train_step`` run under
``shard_map`` in a subprocess with N host devices (as tests/test_runtime.py
runs them); the port's on N gloo ranks (``launch.mesh.run_world``, rank
bodies in ``tests/_compression_ranks.py``), on the same per-rank gradients
and batches, at N = 2 and 4:

* mode "none" within 1e-6;
* int8: the mean and the residual bit for bit (the scale's MAX, the
  requantized int32 sum);
* bf16 bit for bit at 2 ranks, and within one bf16 ulp of the sum at 4
  (gloo adds in bf16 in its own order);
* 50 int8 steps with error feedback: the bias of the mean under 2e-3;
* an unknown mode raises ValueError;
* 3 ``make_dp_train_step`` steps per mode: each step's loss at rtol 1e-5,
  Adam's moments within 1e-4 (first) and 2e-4 (second) of each leaf's
  largest entry, the parameters within 1e-4.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import _compression_ranks as cr
from repro_torch.launch import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = r"""
import os, sys
n, out_path = int(sys.argv[1]), sys.argv[2]
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import warnings
warnings.simplefilter("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import _compression_ranks as cr
from repro.optim.adam import adam
from repro.runtime.compression import make_dp_train_step, make_grad_sync

mesh = jax.make_mesh((n,), ("data",))
g = {k: jnp.asarray(v) for k, v in cr.grads(n).items()}
zeros = {k: jnp.zeros_like(v) for k, v in g.items()}
spec = P("data")
out = {}

def mapped(sync):
    return jax.jit(shard_map(sync, mesh=mesh, in_specs=(spec, spec),
                             out_specs=(spec, spec), check_rep=False))

for mode in cr.MODES:
    synced, res = mapped(make_grad_sync(mesh, "data", mode))(g, zeros)
    for k in g:
        out[f"sync/{mode}/mean/{k}"] = np.asarray(synced[k])
        out[f"sync/{mode}/res/{k}"] = np.asarray(res[k])
f = mapped(make_grad_sync(mesh, "data", "int8"))
res, acc = zeros, {k: np.zeros(v.shape, np.float32) for k, v in g.items()}
for _ in range(cr.EF_STEPS):
    synced, res = f(g, res)
    acc = {k: acc[k] + np.asarray(synced[k]) for k in g}
for k in g:
    out[f"ef/mean/{k}"] = acc[k] / cr.EF_STEPS
    out[f"ef/res/{k}"] = np.asarray(res[k])
init, update = adam(cr.LR)
loss_fn = lambda p, b: cr.linear_loss(p, b)
for mode in cr.MODES:
    step = jax.jit(make_dp_train_step(mesh, loss_fn, update, "data", mode))
    params = {k: jnp.asarray(v) for k, v in cr.linear_params().items()}
    opt = init(params)
    res = {k: jnp.zeros_like(v) for k, v in params.items()}
    losses = []
    for i in range(cr.DP_STEPS):
        batch = {k: jnp.asarray(v) for k, v in cr.linear_batch(n, i).items()}
        params, opt, res, loss = step(params, opt, res, batch)
        losses.append(float(np.asarray(loss)))
    for k in params:
        out[f"dp/{mode}/params/{k}"] = np.asarray(params[k])
        out[f"dp/{mode}/mu/{k}"] = np.asarray(opt.mu[k])
        out[f"dp/{mode}/nu/{k}"] = np.asarray(opt.nu[k])
    out[f"dp/{mode}/losses"] = np.asarray(losses)
np.savez(out_path, **out)
"""

NS = (2, 4)


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    tmp = tmp_path_factory.mktemp("compression")
    for n in NS:
        path = str(tmp / f"ref{n}.npz")
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", _REF, str(n), path],
                              env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(path) as ref:
            want = dict(ref)
        got = pmesh.run_world(cr.sync_world, n, args=(n,), deadline_s=300)
        out[n] = (want, got)
    return out


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("mode", cr.MODES)
@pytest.mark.parametrize("n", NS)
def test_grad_sync_matches_the_reference(runs, n, mode):
    want, got = runs[n]
    for r, out in enumerate(got):
        mean, res = out[("sync", mode)]
        for k in mean:
            w_mean = want[f"sync/{mode}/mean/{k}"][r:r + 1]
            w_res = want[f"sync/{mode}/res/{k}"][r:r + 1]
            where = f"{mode} N{n} rank {r} {k}"
            if mode == "none":
                np.testing.assert_allclose(mean[k], w_mean, rtol=0,
                                           atol=1e-6, err_msg=where)
                np.testing.assert_array_equal(res[k], w_res, err_msg=where)
            elif mode == "int8" or n == 2:
                np.testing.assert_array_equal(mean[k], w_mean, err_msg=where)
                np.testing.assert_array_equal(res[k], w_res, err_msg=where)
            else:
                sums, w_sums = mean[k] * n, w_mean * n
                assert (np.abs(sums - w_sums) <= _bf16_ulp(w_sums)).all(), \
                    where


@pytest.mark.parametrize("n", NS)
def test_error_feedback_drives_the_int8_bias_to_zero(runs, n):
    want, got = runs[n]
    true = {k: v.mean(0, keepdims=True) for k, v in cr.grads(n).items()}
    for r, out in enumerate(got):
        mean, res = out["ef"]
        for k in mean:
            assert np.abs(mean[k] - true[k]).max() < 2e-3
            np.testing.assert_array_equal(
                mean[k], want[f"ef/mean/{k}"][r:r + 1].astype(np.float32),
                err_msg=f"ef N{n} rank {r} {k}")
            np.testing.assert_array_equal(res[k],
                                          want[f"ef/res/{k}"][r:r + 1])


@pytest.mark.parametrize("n", NS)
def test_unknown_mode_raises(runs, n):
    for out in runs[n][1]:
        assert out["bad_mode"] == "fp4"


@pytest.mark.parametrize("mode", cr.MODES)
@pytest.mark.parametrize("n", NS)
def test_dp_train_step_matches_the_reference(runs, n, mode):
    want, got = runs[n]
    for r, out in enumerate(got):
        dp = out[("dp", mode)]
        np.testing.assert_allclose(dp["losses"], want[f"dp/{mode}/losses"],
                                   rtol=1e-5, err_msg=f"{mode} N{n}")
        for part, tol in (("mu", 1e-4), ("nu", 2e-4)):
            for k, g in dp[part].items():
                w = want[f"dp/{mode}/{part}/{k}"]
                bound = tol * max(float(np.abs(w).max()), 1e-30)
                assert np.abs(g - w).max() <= bound, (mode, n, r, part, k)
        for k, g in dp["params"].items():
            np.testing.assert_allclose(g, want[f"dp/{mode}/params/{k}"],
                                       rtol=0, atol=1e-4)
