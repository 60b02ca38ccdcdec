"""Logical-layer cost profiles (paper Sec. II-A).

A copy of ``repro/profiling/profiles.py`` (numpy only): the port keeps its
own so that it imports nothing of the reference package.

A DNN ``phi_n`` is abstracted as a sequence of ``L`` logical layers.  For each
layer ``l`` we track

* ``macs[l]``        -- multiply-accumulate ops to execute layer ``l`` (M_n(l))
* ``param_bytes[l]`` -- bytes of parameters that must be resident to run it (C_n(l))
* ``act_bytes[l]``   -- bytes of the layer's output feature map (psi_n(l))

Index ``0`` is the *input pseudo-layer*: zero MACs / params, and
``act_bytes[0]`` is the raw input size (so a cut at 0 == full edge offload,
shipping the raw input).  A *cut* ``c`` in ``{0, ..., L}`` executes layers
``1..c`` locally and ``c+1..L`` on the edge server, transmitting
``act_bytes[c]`` over the uplink (``c == L`` means fully local; the result
return is neglected per the paper).

Note: the paper's C8 writes ``l in {1..L}``, while its own Edge baseline is a
cut at 0.  We use the closed set ``{0..L}`` which strictly contains both.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["LayerProfile", "ProfileBatch"]


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Per-logical-layer cost profile of one DNN."""

    name: str
    macs: np.ndarray          # (L+1,) float64, macs[0] == 0
    param_bytes: np.ndarray   # (L+1,) float64, param_bytes[0] == 0
    act_bytes: np.ndarray     # (L+1,) float64, act_bytes[0] == input bytes
    layer_names: tuple = ()   # optional (L+1,) labels

    def __post_init__(self):
        L = self.num_layers
        for arr in (self.macs, self.param_bytes, self.act_bytes):
            if arr.shape != (L + 1,):
                raise ValueError(f"profile arrays must share shape (L+1,), got {arr.shape}")
        if self.macs[0] != 0 or self.param_bytes[0] != 0:
            raise ValueError("input pseudo-layer must have zero MACs/params")

    @property
    def num_layers(self) -> int:
        return len(self.macs) - 1

    @property
    def total_macs(self) -> float:
        return float(self.macs.sum())

    @property
    def total_param_bytes(self) -> float:
        return float(self.param_bytes.sum())

    def summary(self) -> str:
        return (
            f"{self.name}: L={self.num_layers} "
            f"MACs={self.total_macs / 1e9:.3f}G "
            f"params={self.total_param_bytes / 1e6:.1f}MB "
            f"max_act={self.act_bytes.max() / 1e6:.2f}MB"
        )


class ProfileBatch:
    """N user profiles padded to a common layer count, as dense arrays.

    Precomputes every per-cut quantity the per-slot problem P2 needs, so the
    jitted MEC step only does O(1) gathers:

    * ``prefix_macs[n, c]``  = sum_{l<=c} M_n(l)           (local MACs at cut c)
    * ``suffix_macs[n, c]``  = sum_{l>c}  M_n(l)           (edge MACs at cut c)
    * ``psi[n, c]``          = transmit bytes at cut c (0 at c == L_n: result
                               return neglected, paper Sec. II-B)
    * ``prefix_params`` / ``suffix_params``                 (bytes, eq. 6)
    * ``prefix_act_max`` / ``suffix_act_max``               (bytes, eq. 6)

    Cuts ``c > L_n`` for padded entries alias the fully-local cut ``L_n`` so
    any integer action in ``{0..Lmax}`` is well defined for every UE.
    """

    def __init__(self, profiles: Sequence[LayerProfile]):
        self.profiles = tuple(profiles)
        self.n = len(profiles)
        self.L = np.array([p.num_layers for p in profiles], dtype=np.int32)
        self.Lmax = int(self.L.max())
        C = self.Lmax + 1

        def pad(field: str) -> np.ndarray:
            out = np.zeros((self.n, C), dtype=np.float64)
            for i, p in enumerate(profiles):
                arr = getattr(p, field)
                out[i, : len(arr)] = arr
            return out

        macs = pad("macs")
        params = pad("param_bytes")
        act = pad("act_bytes")

        self.macs, self.param_bytes, self.act_bytes = macs, params, act
        self.prefix_macs = np.cumsum(macs, axis=1)
        self.prefix_params = np.cumsum(params, axis=1)
        total_macs = self.prefix_macs[:, -1:]
        total_params = self.prefix_params[:, -1:]
        self.total_macs = total_macs[:, 0]
        self.total_params = total_params[:, 0]
        self.suffix_macs = total_macs - self.prefix_macs
        self.suffix_params = total_params - self.prefix_params

        # Activation-footprint running maxima (eq. 6).  Local term covers
        # layers 1..c; edge term covers layers c+1..L_n.
        act_real = act.copy()
        idx = np.arange(C)[None, :]
        valid = idx <= self.L[:, None]
        act_real[~valid] = 0.0
        local_max = np.zeros((self.n, C))
        running = np.zeros(self.n)
        for c in range(1, C):
            running = np.maximum(running, act_real[:, c])
            local_max[:, c] = running
        edge_max = np.zeros((self.n, C))
        running = np.zeros(self.n)
        for c in range(C - 1, 0, -1):
            edge_max[:, c - 1] = np.maximum(running, act_real[:, c])
            running = edge_max[:, c - 1]
        self.prefix_act_max = local_max      # max act of layers 1..c (0 at c=0)
        self.suffix_act_max = edge_max       # max act of layers c+1..L (0 at c=L)

        # Transmit bytes: psi(c), but 0 at the fully-local cut (and beyond,
        # for padded cuts).
        psi = act_real.copy()
        psi[idx >= self.L[:, None]] = 0.0
        self.psi = psi

        # For cuts beyond L_n (padding), every per-cut array must alias the
        # c == L_n value.  cumsum/max already hold constant beyond L_n because
        # padded entries are zero, and psi is zeroed above; nothing else to do.

    def clip_cut(self, cut: np.ndarray) -> np.ndarray:
        return np.clip(cut, 0, self.L)
