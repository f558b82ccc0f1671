"""Batched vector env with on-device auto-reset.

One call steps B envs in lockstep.  Auto-reset computes the reset state for
every env and selects per env on `done` (`torch.where`) — no host sync, no
data-dependent control flow.  The episode-step TimeLimit runs on the
device too.  The terminal observation of a finished episode is returned in
`info["terminal_obs"]` (the post-reset obs is what flows to the policy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dartenv_tpu_torch.envs.base import (
    EnvState, Task, make_env_reset, make_env_step,
)


def _select(done, a, b):
    """Per-env select over matching (nested) dataclasses / tuples of
    tensors (None leaves pass through): a where done else b."""
    if a is None or b is None:
        return b
    if torch.is_tensor(a):
        d = done.reshape(done.shape + (1,) * (a.ndim - done.ndim))
        return torch.where(d, a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _select(done, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    return tuple(_select(done, x, y) for x, y in zip(a, b))


class VecEnv:
    """Functional batched env: state is carried by the caller (a batched
    EnvState).  `device` is the task model's device; randomness comes from
    the `generator` given at construction (a torch.Generator on that
    device, or None for the global one)."""

    def __init__(self, task: Task, num_envs: int,
                 max_episode_steps: Optional[int] = None,
                 auto_reset: bool = True, generator=None):
        self.task = task
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.auto_reset = auto_reset
        self.generator = generator
        self.device = task.model.device
        self._step = make_env_step(task)
        self._reset = make_env_reset(task)

    def reset(self, noise=None):
        return self._reset(self.num_envs, self.generator, noise)

    def step(self, state: EnvState, actions, reset_noise=None):
        """reset_noise: optional (2, B, n) noise for the auto-reset branch
        (see Task.reset_sim)."""
        new_state, obs, reward, done, step_info = self._step(state, actions)
        if self.max_episode_steps is not None:
            done = done | (new_state.steps >= self.max_episode_steps)
        info = {"terminal_obs": obs, "steps": new_state.steps, **step_info}
        if self.auto_reset:
            reset_state, reset_obs = self._reset(
                self.num_envs, self.generator, reset_noise)
            new_state = _select(done, reset_state, new_state)
            obs = _select(done, reset_obs, obs)
        return new_state, obs, reward, done, info
