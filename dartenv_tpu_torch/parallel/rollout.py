"""On-device rollouts: a Python loop over env steps; O(1) memory for
stepping, O(T) only when recording trajectories."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from dartenv_tpu_torch.parallel.vec_env import VecEnv


@dataclasses.dataclass(frozen=True)
class EpisodeStats:
    """On-device episode statistics of a batched run."""

    returns_sum: Any      # sum of completed-episode returns
    lengths_sum: Any      # sum of completed-episode lengths
    episodes: Any         # number of completed episodes
    running_return: Any   # (B,) current-episode return accumulator
    running_length: Any   # (B,)

    @staticmethod
    def init(num_envs: int, dtype=torch.float32, device="cuda"):
        z = torch.zeros((), dtype=dtype, device=device)
        return EpisodeStats(
            returns_sum=z, lengths_sum=z, episodes=z,
            running_return=torch.zeros(num_envs, dtype=dtype, device=device),
            running_length=torch.zeros(num_envs, dtype=dtype, device=device),
        )

    def update(self, reward, done):
        d = done.to(reward.dtype)
        rr = self.running_return + reward
        rl = self.running_length + 1.0
        return EpisodeStats(
            returns_sum=self.returns_sum + torch.sum(rr * d),
            lengths_sum=self.lengths_sum + torch.sum(rl * d),
            episodes=self.episodes + torch.sum(d),
            running_return=rr * (1.0 - d),
            running_length=rl * (1.0 - d),
        )

    def mean_return(self):
        return self.returns_sum / torch.clamp(self.episodes, min=1.0)

    def mean_length(self):
        return self.lengths_sum / torch.clamp(self.episodes, min=1.0)


def make_rollout(vec_env: VecEnv, policy_fn: Callable, horizon: int,
                 collect: bool = False, step_hook: Callable = None):
    """Build rollout(params, state, generator=None) -> (state, stats[,
    traj]).  policy_fn(params, obs, generator) -> actions.  With
    collect=True the per-step (obs, action, reward, done) stacks are also
    returned.  step_hook(info), if given, sees every step's info dict."""

    def rollout(params, state, generator=None):
        model = vec_env.task.model
        stats = EpisodeStats.init(vec_env.num_envs, dtype=model.dtype,
                                  device=model.device)
        obs = vec_env.task.obs(state.sim, state.aux)
        traj = []
        for _ in range(horizon):
            actions = policy_fn(params, obs, generator)
            state, next_obs, reward, done, info = vec_env.step(
                state, actions)
            if step_hook is not None:
                step_hook(info)
            stats = stats.update(reward, done)
            if collect:
                traj.append((obs, actions, reward, done))
            obs = next_obs
        if collect:
            return state, stats, tuple(torch.stack(x) for x in zip(*traj))
        return state, stats

    return rollout
