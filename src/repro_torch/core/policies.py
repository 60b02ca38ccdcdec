"""Partitioning-policy heads for PPO (Sec. IV-B).

Port of ``repro/core/policies.py``:

* ``GaussianTanhPolicy``: the paper's head; a real score y_n per UE, which
  eq. (13) maps through tanh onto the cut.  The ratio is taken on the
  Gaussian over y.  The cut uses span L + 1 with a clip, so the closed set
  {0..L} is reachable.
* ``CategoricalPolicy``: a factored categorical over cuts, infeasible cuts
  masked.
* ``JointGaussianPolicy``: the paper's "PPO" baseline, a 4N action of cut,
  alpha, f_ue and f_es with no convex assist.

A head lives on ``device``, or, where none is given, on the device of its
``num_layers`` tensor; layer counts given as a list or an array and no
device mean CUDA, as every entry point of the port does.  ``init`` draws
from a generator on that device.  ``sample(params, obs, gen, noise=None)``
takes the draw it would make as ``noise``: the standard-normal draw of the
Gaussian heads, the Gumbel draw of the categorical one (the cut is
``argmax(logits + gumbel)``), so a test can replay another
implementation's draws.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device
from .networks import mlp_apply, mlp_init

_LOG2PI = math.log(2.0 * math.pi)


def _gauss_logp(y, mean, log_std):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * (torch.square(y - mean) / var + 2.0 * log_std
                             + _LOG2PI), dim=-1)


def _layer_counts(num_layers, device) -> torch.Tensor:
    """The (N,) per-UE L_n on ``device``; a tensor given with no device
    keeps its own."""
    if device is None and isinstance(num_layers, torch.Tensor):
        return num_layers
    return torch.as_tensor(num_layers, device=resolve_device(device))


def map_cut(y: torch.Tensor, num_layers) -> torch.Tensor:
    """Eq. (13) with the closed-range extension: cut in {0..L}."""
    num_layers = torch.as_tensor(num_layers, device=y.device)
    frac = 0.5 * (torch.tanh(y) + 1.0)
    cut = torch.floor((num_layers + 1) * frac)
    return torch.minimum(torch.clamp_min(cut, 0), num_layers).long()


class GaussianTanhPolicy:
    """Paper-faithful continuous head (one y per UE)."""

    def __init__(self, obs_dim: int, num_layers, hidden=(128, 64),
                 init_log_std: float = -0.5, device=None):
        self.obs_dim = obs_dim
        self.num_layers = _layer_counts(num_layers, device)   # (N,) L_n
        self.act_dim = int(self.num_layers.shape[0])
        self.hidden = tuple(hidden)
        self.init_log_std = init_log_std

    @property
    def device(self) -> torch.device:
        return self.num_layers.device

    @property
    def out_dim(self) -> int:
        """Width of the MLP's last layer."""
        return self.act_dim

    def init(self, gen: torch.Generator) -> dict:
        return {
            "mlp": mlp_init(gen, (self.obs_dim, *self.hidden, self.act_dim),
                            self.device),
            "log_std": torch.full((self.act_dim,), self.init_log_std,
                                  dtype=torch.float32, device=self.device),
        }

    def _mean(self, params, obs):
        return mlp_apply(params["mlp"], obs, final_scale=0.1)

    def sample(self, params, obs, gen=None, noise=None):
        mean = self._mean(params, obs)
        log_std = params["log_std"]
        if noise is None:
            noise = torch.randn(mean.shape, generator=gen,
                                device=mean.device, dtype=mean.dtype)
        noise = torch.as_tensor(noise, device=mean.device, dtype=mean.dtype)
        y = mean + torch.exp(log_std) * noise
        return y, _gauss_logp(y, mean, log_std)

    def logp(self, params, obs, y):
        return _gauss_logp(y, self._mean(params, obs), params["log_std"])

    def mean_action(self, params, obs):
        return self._mean(params, obs)

    def entropy(self, params, obs):
        del obs
        return torch.sum(params["log_std"] + 0.5 * (_LOG2PI + 1.0))

    def to_cut(self, y):
        return map_cut(y, self.num_layers)


class CategoricalPolicy:
    """Factored categorical over cuts {0..L_n} per UE."""

    def __init__(self, obs_dim: int, num_layers, hidden=(128, 64),
                 device=None):
        self.obs_dim = obs_dim
        self.num_layers = _layer_counts(num_layers, device)
        self.n_ue = int(self.num_layers.shape[0])
        self.num_cuts = int(self.num_layers.max()) + 1
        self.hidden = tuple(hidden)
        cuts = torch.arange(self.num_cuts, device=self.device)
        self._mask = cuts[None, :] <= self.num_layers[:, None]

    @property
    def device(self) -> torch.device:
        return self.num_layers.device

    @property
    def out_dim(self) -> int:
        """Width of the MLP's last layer."""
        return self.n_ue * self.num_cuts

    def init(self, gen: torch.Generator) -> dict:
        return {"mlp": mlp_init(gen, (self.obs_dim, *self.hidden,
                                      self.out_dim), self.device)}

    def _logits(self, params, obs):
        raw = mlp_apply(params["mlp"], obs, final_scale=0.1)
        logits = raw.reshape(*raw.shape[:-1], self.n_ue, self.num_cuts)
        return torch.where(self._mask, logits, -1e9)

    def sample(self, params, obs, gen=None, noise=None):
        """``noise`` is the (..., N, C) Gumbel draw."""
        logits = self._logits(params, obs)
        if noise is None:
            u = torch.rand(logits.shape, generator=gen, device=logits.device,
                           dtype=logits.dtype)
            noise = -torch.log(-torch.log(u))
        noise = torch.as_tensor(noise, device=logits.device, dtype=logits.dtype)
        cut = torch.argmax(logits + noise, dim=-1)
        return cut, self._logp_from_logits(logits, cut)

    @staticmethod
    def _logp_from_logits(logits, cut):
        logp = torch.log_softmax(logits, dim=-1)
        sel = torch.gather(logp, -1, cut[..., None].long())[..., 0]
        return torch.sum(sel, dim=-1)

    def logp(self, params, obs, cut):
        return self._logp_from_logits(self._logits(params, obs), cut)

    def mean_action(self, params, obs):
        return torch.argmax(self._logits(params, obs), dim=-1)

    def entropy(self, params, obs):
        logp = torch.log_softmax(self._logits(params, obs), dim=-1)
        return -torch.sum(torch.exp(logp) * torch.where(logp > -1e8, logp, 0.0))

    def to_cut(self, cut):
        return cut.long()


class JointGaussianPolicy(GaussianTanhPolicy):
    """The paper's "PPO" baseline head: a 4N action {cut, alpha, f_ue, f_es}
    with no convex assist.  alpha by softmax (C4), the frequencies by
    sigmoid and softmax caps (C3, C6); C7 is the projection LyMDO uses.
    """

    def __init__(self, obs_dim: int, num_layers, f_max_ue: float,
                 f_max_es: float, hidden=(128, 64), init_log_std: float = -0.5,
                 device=None):
        super().__init__(obs_dim, num_layers, hidden, init_log_std, device)
        self.act_dim = 4 * int(self.num_layers.shape[0])
        self.f_max_ue = f_max_ue
        self.f_max_es = f_max_es

    def split(self, y):
        """y (..., 4N) -> (cut, alpha, f_ue, f_es)."""
        y_cut, y_alpha, y_fue, y_fes = torch.chunk(y, 4, dim=-1)
        cut = map_cut(y_cut, self.num_layers)
        alpha = torch.softmax(y_alpha, dim=-1)
        f_ue = torch.sigmoid(y_fue) * self.f_max_ue
        f_es = torch.softmax(y_fes, dim=-1) * self.f_max_es
        return cut, alpha, f_ue, f_es
