"""``launch.specs`` against ``repro/launch/specs.py``: the shape table, the
skip rules and every stand-in tree, leaf for leaf (path, shape, dtype) at
full width, the reference's from ``jax.eval_shape`` and the port's on the
meta device (nothing allocated on either side).  Paths map as in
``transformer.params_from_reference``: the same dict keys and list
indices, and the caches' named-tuple fields by name; the reference keeps a
context's K/V as a plain (k, v) tuple, the port as a ``KVCache``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as r_get_config
from repro.launch import specs as r_specs
from repro_torch.configs import base as p_base
from repro_torch.launch import sharding as p_sh
from repro_torch.launch import specs as p_specs

ARCHS = sorted(p_base.load_all())
CACHE_ARCHS = ["qwen3-0.6b", "mamba2-1.3b", "recurrentgemma-2b",
               "llama-3.2-vision-90b", "seamless-m4t-large-v2"]


def _ref_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                      getattr(p, "idx", p))))
                       for p in path)
        key = key.replace("ctx_kv/0", "ctx_kv/k").replace("ctx_kv/1",
                                                          "ctx_kv/v")
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree) -> dict:
    out = {}
    p_sh.map_with_paths(lambda path, t: out.__setitem__(
        path, (tuple(t.shape), str(t.dtype).replace("torch.", ""))), tree)
    return out


def test_shape_table_and_skip_rules_equal_the_reference():
    assert p_specs.DECODE_MARGIN == r_specs.DECODE_MARGIN
    assert {k: tuple(vars(v).values()) for k, v in p_specs.SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in r_specs.SHAPES.items()}
    for arch in ARCHS:
        for name in p_specs.SHAPES:
            assert p_specs.cell_supported(
                p_base.get_config(arch), p_specs.SHAPES[name]) == \
                r_specs.cell_supported(r_get_config(arch),
                                       r_specs.SHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_inputs_equal_the_reference(arch):
    """params, Adam's state and the batch of ``train_4k``: every leaf."""
    want = r_specs.input_specs(r_get_config(arch), "train_4k")
    got = p_specs.input_specs(p_base.get_config(arch), "train_4k")
    assert all(t.device.type == "meta" for t in
               p_sh._tree.leaves([got["params"], got["opt_state"]]))
    assert _port_leaves(got["params"]) == _ref_leaves(want["params"])
    for part in ("mu", "nu"):
        assert _port_leaves(getattr(got["opt_state"], part)) == \
            _ref_leaves(getattr(want["opt_state"], part))
    assert (tuple(got["opt_state"].step.shape),
            got["opt_state"].step.dtype) == ((), torch.int32)
    assert _port_leaves(got["batch"]) == _ref_leaves(want["batch"])


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_decode_cache_equals_the_reference(arch):
    shape = "decode_32k"
    want = r_specs.input_specs(r_get_config(arch), shape)
    got = p_specs.input_specs(p_base.get_config(arch), shape)
    assert _port_leaves(got["cache"]) == _ref_leaves(want["cache"])
    assert _port_leaves({"t": got["tokens"]}) == \
        _ref_leaves({"t": want["tokens"]})
    if arch == "qwen3-0.6b":
        assert tuple(got["cache"]["units"]["slot0"].k.shape) == \
            (28, 128, 32896, 8, 128)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_prefill_batch_equals_the_reference(arch):
    shape = r_specs.SHAPES["prefill_32k"]
    want = r_specs.batch_specs(r_get_config(arch), shape, train=False)
    got = p_specs.batch_specs(p_base.get_config(arch),
                              p_specs.SHAPES["prefill_32k"], train=False)
    assert _port_leaves(got) == _ref_leaves(want)
