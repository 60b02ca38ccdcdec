"""The cells mesh's entry points: ``repro_torch.scenario_sweep`` (the twin of
examples/scenario_sweep.py) and ``repro_torch.train_compare`` at tiny sizes
on one rank (in this process) and on a spawned 2-rank gloo world.

On two ranks the Fig. 4 grid shards (5 cells, one padded), every rank
evaluates rank 0's broadcast train states, and the Fig. 4 numbers equal the
one-rank run's to 1e-5; only rank 0 writes ``--out``.  The sweep's sharded
leg splits its 16 cells over the ranks with no drift.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _mesh_workers as mw
from repro_torch import scenario_sweep, train_compare
from repro_torch.launch import mesh as pmesh

TC = ["--device", "cpu", "--episodes", "1", "--steps", "2",
      "--eval-episodes", "1"]
SWEEP = ["--device", "cpu", "--steps", "2", "--episodes", "1"]
RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def no_group_left_behind():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-rank runs here (one thread, as each spawned rank has) and
    the two-rank world's."""
    out = tmp_path_factory.mktemp("twins")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {"fig4": train_compare.main(TC + ["--out", f"{out}/one.json"])
               ["fig4"], "sweep": scenario_sweep.main(SWEEP)}
    finally:
        torch.set_num_threads(threads)
    two = pmesh.run_world(mw.twins_world, 2, args=(str(out), TC, SWEEP),
                          deadline_s=300.0)
    return {"dir": out, "one": one, "two": two}


def test_scenario_sweep_one_rank_makes_and_ends_its_group(runs, capsys):
    got = scenario_sweep.main(SWEEP)
    printed = capsys.readouterr().out
    assert "sharded over 1 rank(s) (pad 0 cells)" in printed
    assert got["drift"] == 0.0 and got["pad"] == 0
    assert set(got["fig4"]) == {"oracle", "local", "edge"}
    assert len(got["grid16"]) == 16 and np.isfinite(got["grid16"]).all()
    assert got == runs["one"]["sweep"]


def test_scenario_sweep_two_ranks(runs):
    one = runs["one"]["sweep"]
    for out in runs["two"]:
        got = out["sweep"]
        assert got["pad"] == 0
        assert got["drift"] <= 1e-5 * max(got["grid16"])
        for key in ("grid16", "sharded"):
            np.testing.assert_allclose(got[key], one["grid16"], rtol=RTOL,
                                       atol=ATOL)
        for policy, delays in one["fig4"].items():
            np.testing.assert_allclose(got["fig4"][policy], delays,
                                       rtol=RTOL, atol=ATOL)


def test_train_compare_two_ranks_equal_one(runs):
    one = runs["one"]["fig4"]
    for out in runs["two"]:
        got = out["fig4"]
        assert set(got) == set(one)
        for rate, algs in one.items():
            assert set(got[rate]) == set(algs)
            for alg, metrics in algs.items():
                for name, want in metrics.items():
                    np.testing.assert_allclose(
                        got[rate][alg][name], want, rtol=RTOL, atol=ATOL,
                        err_msg=f"{rate} {alg} {name}")


def test_train_compare_only_rank0_writes(runs):
    written = sorted(p.name for p in runs["dir"].iterdir())
    assert written == ["one.json", "r0.json"]
