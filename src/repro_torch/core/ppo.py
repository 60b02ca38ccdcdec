"""PPO (Sec. IV-B, Algorithm 1).

Port of ``repro/core/ppo.py``: actor and critic MLPs with hidden sizes
(128, 64), Adam at 3e-4 with a global-norm clip, clip eps 0.2, a replay
memory of one episode (K slots) consumed by every update.  The advantage
is GAE(gamma, lambda); ``gae_lambda = 1.0`` (the default) is the paper's
discounted estimator (eqs. 16-17) with a terminal episode end.

``update`` makes ``epochs`` full-batch passes over the trajectory, with no
shuffling: each is ``torch.autograd.grad`` of the loss, then Adam.  It is
the only place that builds an autograd graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import _tree
from ..device import resolve_device
from ..optim.adam import AdamState, adam
from .networks import mlp_apply, mlp_init
from .policies import GaussianTanhPolicy


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    gamma: float = 0.95
    gae_lambda: float = 1.0        # 1.0 == paper's estimator
    clip_eps: float = 0.2          # paper Sec. V-A
    epochs: int = 8                # passes over the filled memory
    value_coef: float = 0.5
    entropy_coef: float = 0.0      # paper uses none; ablations may set >0
    reward_scale: float = 0.02     # conditions the value target only
    adv_norm: bool = True
    bootstrap_last: bool = False   # paper sums to the episode end
    grad_clip: float = 0.5
    critic_hidden: tuple = (128, 64)


class Trajectory(NamedTuple):
    obs: torch.Tensor        # (K, obs_dim)
    action: torch.Tensor     # (K, ...) policy-native representation
    logp: torch.Tensor       # (K,)
    reward: torch.Tensor     # (K,) raw environment rewards (eq. 14)
    value: torch.Tensor      # (K,) critic at collection time
    last_value: torch.Tensor  # () critic at s_K


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState


class PPO:
    """Policy-agnostic PPO: works with any head from ``policies.py``."""

    def __init__(self, policy, obs_dim: int, cfg: PPOConfig = PPOConfig()):
        self.policy = policy
        self.obs_dim = obs_dim
        self.cfg = cfg
        self._opt_init, self._opt_update = adam(cfg.lr, grad_clip=cfg.grad_clip)

    # -- parameters --------------------------------------------------------

    def init(self, gen: torch.Generator) -> TrainState:
        params = {
            "pi": self.policy.init(gen),
            "v": mlp_init(gen, (self.obs_dim, *self.cfg.critic_hidden, 1),
                          self.policy.device),
        }
        return TrainState(params=params, opt_state=self._opt_init(params))

    def value(self, params, obs):
        return mlp_apply(params["v"], obs)[..., 0]

    def act(self, params, obs, gen=None, noise=None):
        """Sample an action and its diagnostics for rollout collection."""
        action, logp = self.policy.sample(params["pi"], obs, gen, noise)
        return action, logp, self.value(params, obs)

    # -- advantage estimation ----------------------------------------------

    def gae(self, traj: Trajectory):
        cfg = self.cfg
        r = traj.reward * cfg.reward_scale
        v = traj.value
        last_v = (traj.last_value if cfg.bootstrap_last
                  else torch.zeros_like(traj.last_value))
        v_next = torch.cat([v[1:], last_v[None]])
        deltas = r + cfg.gamma * v_next - v
        carry = torch.zeros_like(last_v)
        adv = []
        for delta in reversed(deltas.unbind(0)):
            carry = delta + cfg.gamma * cfg.gae_lambda * carry
            adv.append(carry)
        adv = torch.stack(adv[::-1])
        return adv, adv + v

    # -- update -------------------------------------------------------------

    def _loss(self, params, traj: Trajectory, adv, returns):
        cfg = self.cfg
        logp = self.policy.logp(params["pi"], traj.obs, traj.action)
        ratio = torch.exp(logp - traj.logp)
        surrogate = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv)
        actor_loss = -torch.mean(surrogate)                         # eq. (15)
        v = self.value(params, traj.obs)
        critic_loss = torch.mean(torch.square(v - returns))         # eq. (18)
        ent = self.policy.entropy(params["pi"], traj.obs)
        loss = (actor_loss + cfg.value_coef * critic_loss
                - cfg.entropy_coef * ent)
        return loss, actor_loss, critic_loss, ratio

    def update(self, state: TrainState, traj: Trajectory):
        """``epochs`` full-batch passes; returns the new state and the last
        epoch's metrics (0-d tensors, not synchronised)."""
        cfg = self.cfg
        with torch.no_grad():
            adv, returns = self.gae(traj)
            if cfg.adv_norm:
                adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        params, opt_state = state
        for _ in range(cfg.epochs):
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(True)
                          for x in _tree.leaves(params)]
                live = _tree.unflatten(params, leaves)
                loss, al, cl, ratio = self._loss(live, traj, adv, returns)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                params, opt_state = self._opt_update(
                    _tree.unflatten(params, grads), opt_state, params)
        metrics = {"loss": loss.detach(), "actor_loss": al.detach(),
                   "critic_loss": cl.detach(),
                   "ratio_max": torch.max(ratio.detach())}
        return TrainState(params, opt_state), metrics


def train_state_from_reference(tree, policy, device=None) -> TrainState:
    """The port's ``TrainState`` from another implementation's, given as
    numpy arrays (``params``, and ``opt_state`` with ``step``, ``mu`` and
    ``nu``): float32 leaves, an int32 step.  Raises ValueError where the
    actor does not fit ``policy``."""
    device = resolve_device(device)
    pi = tree.params["pi"]
    width = np.shape(pi["mlp"][-1]["w"])[-1]
    gaussian = isinstance(policy, GaussianTanhPolicy)
    if width != policy.out_dim or ("log_std" in pi) != gaussian:
        raise ValueError(
            f"the actor's last layer is {width} wide"
            f"{' with' if 'log_std' in pi else ' without'} a log_std; "
            f"{type(policy).__name__} needs {policy.out_dim}")
    f32 = lambda t: _tree.from_numpy(t, device, torch.float32)
    opt = tree.opt_state
    return TrainState(
        params=f32(tree.params),
        opt_state=AdamState(
            step=torch.tensor(np.asarray(opt.step), dtype=torch.int32,
                              device=device),
            mu=f32(opt.mu), nu=f32(opt.nu)))
