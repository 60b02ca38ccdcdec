"""The partitioned server, ``python -m repro_torch.serve_partitioned``, on
the CPU at full width and 2 layers: controller, split and ES engine, for
qwen3-0.6b (the default) and mamba2-1.3b (``--arch``); moonshot-v1-16b-a3b,
the MoE stack, at 1 layer (its init draws 0.9 B parameters a layer)."""
import math

import pytest

from repro_torch import serve_partitioned as sp

ARGV = ["--device", "cpu", "--layers", "2", "--requests", "4",
        "--prompt-max", "60", "--max-new", "4", "--slots", "2",
        "--s-max", "128"]


def test_main_serves_every_request_on_cpu():
    rep = sp.main(ARGV)
    assert (rep["arch"], rep["layers"], rep["device"]) == ("qwen3-0.6b", 2,
                                                           "cpu")
    assert rep["dtype"] == "bfloat16"
    cuts = rep["controller_cuts"]
    assert len(cuts) == sp.CTRL_SLOTS
    assert all(len(c) == sp.UES for c in cuts)
    assert 0 <= rep["unit_cut"] <= rep["layers"]

    assert rep["split"]
    for row in rep["split"]:
        assert row["finite"]
        # bf16 end to end: the split agrees with the monolithic pass
        assert row["max_abs_err"] <= 2e-2 + 2e-2 * row["max_abs_logit"], row
        assert row["boundary_bytes"] > 0

    srv = rep["serving"]
    assert srv["requests"] == 4 and srv["completed"] == 4
    assert sorted(srv["out"]) == [0, 1, 2, 3]
    assert all(len(o) == 4 for o in srv["out"].values())
    assert srv["generated_tokens"] == 16
    assert srv["decode_steps"] > 0 and srv["prefill_steps"] >= 4
    assert srv["ticks"] >= srv["decode_steps"]
    for key in ("decode_tick_ms_p50", "decode_tick_ms_p99",
                "prefill_tick_ms_p50", "prefill_tick_ms_p99",
                "tokens_per_s", "wall_s"):
        assert math.isfinite(srv[key]) and srv[key] > 0, key


def test_main_serves_mamba2_on_cpu():
    """``--arch mamba2-1.3b``: the SSD stack through the same path; its
    controller runs over mamba2's 50-layer profile."""
    rep = sp.main(["--arch", "mamba2-1.3b", "--device", "cpu", "--layers",
                   "2", "--requests", "3", "--prompt-max", "50",
                   "--max-new", "3", "--slots", "2", "--s-max", "96",
                   "--split-seq", "12"])
    assert (rep["arch"], rep["layers"], rep["dtype"]) == ("mamba2-1.3b", 2,
                                                          "bfloat16")
    for row in rep["split"]:
        assert row["finite"] and row["max_abs_err"] == 0.0, row
    srv = rep["serving"]
    assert srv["completed"] == 3
    assert all(len(o) == 3 for o in srv["out"].values())
    assert srv["prefill_steps"] - srv["chunk_steps"] == 3


def test_main_serves_moonshot_on_cpu():
    """``--arch moonshot-v1-16b-a3b``: the controller decides over
    moonshot's 50-layer profile, the split equals the monolithic pass (the
    same MoE groups on the same tokens) and the ES engine prefills whole
    prompts (no chunks for "m")."""
    rep = sp.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu",
                   "--layers", "1", "--requests", "2", "--prompt-max", "40",
                   "--max-new", "2", "--slots", "2", "--s-max", "64",
                   "--split-seq", "8"])
    assert (rep["arch"], rep["layers"], rep["dtype"]) == (
        "moonshot-v1-16b-a3b", 1, "bfloat16")
    assert len(rep["controller_cuts"]) == sp.CTRL_SLOTS
    for row in rep["split"]:
        assert row["finite"] and row["max_abs_err"] == 0.0, row
    srv = rep["serving"]
    assert srv["completed"] == 2 and srv["chunk_steps"] == 0
    assert srv["prefill_steps"] == 2
    assert all(len(o) == 2 for o in srv["out"].values())


def test_arch_choices_are_the_partitionable_configs():
    assert sp.partitionable() == ["llama4-maverick-400b-a17b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b", "qwen1.5-110b",
                                  "qwen3-0.6b", "starcoder2-7b"]
    for arch in ("llama-3.2-vision-90b", "seamless-m4t-large-v2"):
        with pytest.raises(SystemExit):
            sp.parse_args(["--arch", arch])       # "x"; an encoder
    with pytest.raises(SystemExit):
        sp.parse_args(["--arch", "recurrentgemma-2b"])    # a tail stack
    cfg = sp.model_config("mamba2-1.3b", layers=4, dtype="float32")
    assert (cfg.n_layers, cfg.d_model, cfg.compute_dtype) == (4, 2048,
                                                              "float32")
