"""The reference learner: one REINFORCE step over a rollout whose env axis
is split over a torch.distributed process group (parallel/sharding.py).

The update differentiates only the policy's log-probability (the
advantages are detached), never the physics, so a train step runs the
env step's kernels in its rollout and plain autograd in its update.  The
policy is a dict of leaf tensors with requires_grad (w1, b1, w2, b2, w3,
b3, log_std: a tanh MLP with a Gaussian head), the layout of the JAX
package's params, so `policy_from_jax` carries weights across.

Across ranks (group given): the advantage's mean is the mean over the
whole batch (an all_reduce of its sum and count), and the gradients are
all_reduced and averaged, so a step over W ranks equals one step over
their envs in one process.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from dartenv_tpu_torch.parallel.sharding import (
    group_shape, make_sharded_rollout, replicate_model, sharded_reset,
)
from dartenv_tpu_torch.parallel.vec_env import VecEnv

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3", "log_std")


# ---------------------------------------------------------------------------
# a small Gaussian MLP policy
# ---------------------------------------------------------------------------

def init_policy(generator: torch.Generator, obs_size: int, act_size: int,
                hidden: int = 64, dtype=torch.float32
                ) -> Dict[str, torch.Tensor]:
    """Weights N(0, 1/fan_in) (the last layer x 0.01), zero biases and
    log_std, on the generator's device."""
    dev = generator.device

    def w(a, b, scale=1.0):
        x = torch.randn((a, b), generator=generator, device=dev, dtype=dtype)
        return x / math.sqrt(a) * scale

    z = lambda k: torch.zeros((k,), dtype=dtype, device=dev)
    p = {"w1": w(obs_size, hidden), "b1": z(hidden),
         "w2": w(hidden, hidden), "b2": z(hidden),
         "w3": w(hidden, act_size, 0.01), "b3": z(act_size),
         "log_std": z(act_size)}
    return {k: v.requires_grad_() for k, v in p.items()}


def policy_from_jax(params_np, dtype=torch.float64, device="cpu"):
    """The JAX package's policy params (a dict of arrays, e.g. numpy) as
    the port's leaf tensors."""
    return {k: torch.tensor(params_np[k], dtype=dtype,
                            device=device).requires_grad_()
            for k in PARAM_NAMES}


def policy_mean(params, obs):
    h = torch.tanh(obs @ params["w1"] + params["b1"])
    h = torch.tanh(h @ params["w2"] + params["b2"])
    return torch.tanh(h @ params["w3"] + params["b3"])


def policy_sample(params, obs, generator=None):
    """mu + std * N(0, 1) from `generator` (no autograd graph)."""
    with torch.no_grad():
        mu = policy_mean(params, obs)
        eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                          dtype=mu.dtype)
        return mu + torch.exp(params["log_std"]) * eps


def policy_logp(params, obs, act):
    mu = policy_mean(params, obs)
    log_std = params["log_std"]
    z = (act - mu) * torch.exp(-log_std)
    return torch.sum(-0.5 * z * z - log_std, dim=-1)


# ---------------------------------------------------------------------------
# the update and the train step
# ---------------------------------------------------------------------------

def discounted_returns(rewards, dones, gamma: float):
    """(T, B) rewards / dones -> (T, B) reward-to-go, episode-aware (a
    reverse loop over T)."""
    rets = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t] + gamma * carry * (1.0 - dones[t].to(
            rewards.dtype))
        rets[t] = carry
    return rets


def reinforce_update(params, traj, lr: float = 3e-4, gamma: float = 0.99,
                     group=None):
    """One SGD step of the REINFORCE loss -mean(logp * adv) on a collected
    trajectory (obs, act, rew, done) of (T, B, ...) stacks: adv = the
    reward-to-go less its mean over the whole batch (over the group's
    ranks), detached; `loss.backward()`, the gradients averaged over the
    group, then p - lr * grad.  Returns (new params, this rank's loss)."""
    obs, act, rew, done = traj
    rets = discounted_returns(rew, done, gamma)
    tot = torch.stack([rets.sum(), rets.new_tensor(float(rets.numel()))])
    world, _ = group_shape(group)
    if group is not None:
        dist.all_reduce(tot, group=group)
    adv = (rets - tot[0] / tot[1]).detach()
    loss = -torch.mean(policy_logp(params, obs, act) * adv)
    for p in params.values():
        p.grad = None
    loss.backward()
    new = {}
    for k, p in params.items():
        g = p.grad
        if group is not None:
            dist.all_reduce(g, group=group)
            g = g / world
        new[k] = (p.detach() - lr * g).requires_grad_()
    return new, loss.detach()


class TrainStep:
    """train_step(params, state, generator) -> (params, state, stats):
    `collect` (the rollout with collect=True) then `update`
    (reinforce_update on the trajectory)."""

    def __init__(self, rollout, lr, gamma, group):
        self.collect = rollout
        self.lr, self.gamma, self.group = lr, gamma, group

    def update(self, params, traj):
        return reinforce_update(params, traj, self.lr, self.gamma,
                                self.group)

    def __call__(self, params, state, generator):
        state, stats, traj = self.collect(params, state, generator)
        params, _ = self.update(params, traj)
        return params, state, stats


def make_train_step(task, num_envs: int, horizon: int, group=None,
                    max_episode_steps: int = 1000, lr: float = 3e-4,
                    gamma: float = 0.99):
    """(init_fn(generator) -> (params, state), train_step) for one
    REINFORCE update per call over a rollout of `horizon` control steps of
    `num_envs` envs, split over `group`'s ranks (None: one process).
    init_fn draws the policy from `generator` (then broadcasts rank 0's)
    and resets the whole batch from it, each rank keeping its slice.
    Raises unless num_envs divides over the ranks."""
    world, _ = group_shape(group)
    if num_envs % world:
        raise ValueError(f"num_envs={num_envs} must divide over {world} "
                         "ranks")
    vec = VecEnv(task, num_envs, max_episode_steps=max_episode_steps)
    rollout = make_sharded_rollout(vec, policy_sample, horizon, group,
                                   collect=True)

    def init_fn(generator):
        params = init_policy(generator, task.obs_size, task.action_size,
                             dtype=task.model.dtype)
        params = replicate_model(params, group)
        vec.generator = generator
        return params, sharded_reset(vec, group)[0]

    return init_fn, TrainStep(rollout, lr, gamma, group)
