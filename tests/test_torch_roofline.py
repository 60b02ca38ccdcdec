"""Port parity: ``profiling.roofline``.  The analytic counts are the
reference's and must agree exactly for all ten configs and every step
kind; ``terms_for`` differs only through the hardware constants, which are
the H100 SXM's (989 TFLOP/s bf16, 67 TFLOP/s float32, 3.35 TB/s, NVLink 4
at 450 GB/s a direction) in place of the reference's TPU's."""
import dataclasses

import pytest

from repro.configs.base import get_config as r_get_config
from repro.configs.base import load_all as r_load_all
from repro.profiling import roofline as r_roof
from repro_torch.configs import base as p_base
from repro_torch.profiling import roofline as p_roof

NAMES = sorted(r_load_all())


@dataclasses.dataclass(frozen=True)
class Shape:
    batch: int
    seq: int


SHAPES = [Shape(8, 512), Shape(2, 4096), Shape(1, 131072)]


@pytest.mark.parametrize("name", NAMES)
def test_counts_match_reference(name):
    r_cfg, p_cfg = r_get_config(name), p_base.get_config(name)
    for active in (False, True):
        assert p_roof.param_count(p_cfg, active) == \
            r_roof.param_count(r_cfg, active)
    for shape in SHAPES:
        assert p_roof.fwd_flops(p_cfg, shape.batch, shape.seq) == \
            r_roof.fwd_flops(r_cfg, shape.batch, shape.seq)
        assert p_roof._cache_bytes(p_cfg, shape.batch, shape.seq) == \
            r_roof._cache_bytes(r_cfg, shape.batch, shape.seq)
        for kind in ("train", "prefill", "decode"):
            assert p_roof.step_flops(p_cfg, shape, kind) == \
                r_roof.step_flops(r_cfg, shape, kind)
            for mb in (1, 4):
                assert p_roof.step_hbm_bytes(p_cfg, shape, kind, mb) == \
                    r_roof.step_hbm_bytes(r_cfg, shape, kind, mb)


@pytest.mark.parametrize("name", NAMES)
def test_terms_differ_only_through_the_constants(name):
    r_cfg, p_cfg = r_get_config(name), p_base.get_config(name)
    wire = {"all-gather": 3e8, "all-reduce": 1e8, "collective-permute": 5e6}
    for shape in SHAPES[:2]:
        for kind in ("train", "prefill", "decode"):
            r = r_roof.terms_for(r_cfg, shape, kind, wire, chips=4,
                                 microbatches=2)
            p = p_roof.terms_for(p_cfg, shape, kind, wire, chips=4,
                                 microbatches=2)
            for f in ("executed_flops", "model_flops", "hbm_bytes",
                      "wire_bytes_per_dev", "chips"):
                assert getattr(p, f) == getattr(r, f)
            assert p.compute_s == pytest.approx(
                r.compute_s * r_roof.PEAK_FLOPS / p_roof.PEAK_FLOPS)
            assert p.memory_s == pytest.approx(
                r.memory_s * r_roof.HBM_BW / p_roof.HBM_BW)
            assert p.collective_s == pytest.approx(
                r.collective_s * r_roof.LINK_BW / p_roof.LINK_BW)
            assert p.useful_fraction == r.useful_fraction
            assert p.dominant in ("compute", "memory", "collective")
            assert p.roofline_fraction == pytest.approx(
                p.model_flops / p.step_time_s / (p_roof.PEAK_FLOPS * 4))


def test_h100_constants():
    assert p_roof.PEAK_FLOPS == 989e12
    assert p_roof.PEAK_F32_FLOPS == 67e12
    assert p_roof.HBM_BW == 3.35e12
    assert p_roof.LINK_BW == 450e9
    assert p_roof.COLLECTIVE_WEIGHT == r_roof.COLLECTIVE_WEIGHT
    assert p_roof.RooflineTerms(1, 1, 1, 1, 1, 1, 1).chips == 256
