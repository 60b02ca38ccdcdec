"""Exact per-logical-layer profiles for the paper's workloads.

A copy of ``repro/profiling/convnets.py`` (numpy only), kept by the port so
that it imports nothing of the reference package.

The paper evaluates two task types: AlexNet (type I) and ResNet18 (type II),
abstracted as sequential *logical layers* (Sec. II-A): straight-line layers
(conv/fc) map 1:1; ResNet basic blocks (parallel residual units) collapse to
one logical layer, following ref. [11].

MACs use the standard conv arithmetic ``k*k*Cin*Cout*Hout*Wout`` (per-example,
batch 1 — one task == one inference).  Parameter and activation sizes are
float32 (4 B), the framework the paper's numbers are consistent with.
"""
from __future__ import annotations

import numpy as np

from .profiles import LayerProfile

_BYTES = 4  # float32 activations/params, per the paper's MB-scale constants


def _conv(cin, h, w, cout, k, stride=1, pad=0, pool=1):
    """Conv (+ optional following maxpool) -> (macs, params, out_{c,h,w})."""
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    macs = k * k * cin * cout * ho * wo
    params = k * k * cin * cout + cout
    if pool > 1:
        ho //= pool
        wo //= pool
    return macs, params, (cout, ho, wo)


def _fc(din, dout):
    return din * dout, din * dout + dout, (dout,)


def alexnet_profile() -> LayerProfile:
    """AlexNet (ungrouped), 227x227x3 input, 8 logical layers."""
    names = ["input"]
    macs, params, acts = [0.0], [0.0], [227 * 227 * 3 * _BYTES]
    shape = (3, 227, 227)

    def push(name, m, p, out):
        names.append(name)
        macs.append(float(m))
        params.append(float(p * _BYTES))
        acts.append(float(np.prod(out) * _BYTES))
        return out

    c, h, w = shape
    m, p, out = _conv(c, h, w, 96, 11, stride=4, pad=0, pool=2)
    shape = push("conv1+pool", m, p, out)
    m, p, out = _conv(*_chw(shape), 256, 5, stride=1, pad=2, pool=2)
    shape = push("conv2+pool", m, p, out)
    m, p, out = _conv(*_chw(shape), 384, 3, stride=1, pad=1)
    shape = push("conv3", m, p, out)
    m, p, out = _conv(*_chw(shape), 384, 3, stride=1, pad=1)
    shape = push("conv4", m, p, out)
    m, p, out = _conv(*_chw(shape), 256, 3, stride=1, pad=1, pool=2)
    shape = push("conv5+pool", m, p, out)
    m, p, out = _fc(int(np.prod(shape)), 4096)
    shape = push("fc6", m, p, out)
    m, p, out = _fc(4096, 4096)
    shape = push("fc7", m, p, out)
    m, p, out = _fc(4096, 1000)
    shape = push("fc8", m, p, out)

    return LayerProfile(
        name="alexnet",
        macs=np.array(macs),
        param_bytes=np.array(params),
        act_bytes=np.array(acts),
        layer_names=tuple(names),
    )


def _chw(shape):
    c, h, w = shape
    return c, h, w


def _basic_block(cin, h, w, cout, stride):
    """ResNet basic block (2x conv3x3 + optional 1x1 downsample) as one
    logical layer."""
    m1, p1, (c1, h1, w1) = _conv(cin, h, w, cout, 3, stride=stride, pad=1)
    m2, p2, out = _conv(c1, h1, w1, cout, 3, stride=1, pad=1)
    macs, params = m1 + m2, p1 + p2
    if stride != 1 or cin != cout:
        md, pd, _ = _conv(cin, h, w, cout, 1, stride=stride, pad=0)
        macs += md
        params += pd
    return macs, params, out


def resnet18_profile() -> LayerProfile:
    """ResNet18, 224x224x3 input, 10 logical layers (stem + 8 blocks + fc)."""
    names = ["input"]
    macs, params, acts = [0.0], [0.0], [224 * 224 * 3 * _BYTES]

    def push(name, m, p, out):
        names.append(name)
        macs.append(float(m))
        params.append(float(p * _BYTES))
        acts.append(float(np.prod(out) * _BYTES))
        return out

    m, p, out = _conv(3, 224, 224, 64, 7, stride=2, pad=3, pool=2)
    shape = push("stem", m, p, out)
    plan = [(64, 1), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1)]
    for i, (cout, stride) in enumerate(plan):
        c, h, w = shape
        m, p, out = _basic_block(c, h, w, cout, stride)
        shape = push(f"block{i + 1}", m, p, out)
    # global average pool collapses to (512,); fold into the fc logical layer
    m, p, out = _fc(512, 1000)
    push("fc", m, p, out)

    return LayerProfile(
        name="resnet18",
        macs=np.array(macs),
        param_bytes=np.array(params),
        act_bytes=np.array(acts),
        layer_names=tuple(names),
    )
