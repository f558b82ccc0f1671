"""Env / Wrapper contract — the reference's 0.9.x-vintage API surface
(`gym/core.py:~1-380` † — SURVEY.md §2.1): public `step/reset/render/seed`
delegating to `_step/_reset/_render/_seed`, `metadata`, `reward_range`,
`spec` backref, and the four wrapper flavors.

This is the thin OO shim around the functional core (SURVEY.md §7
"functional core, OO shim"): single-env, numpy-in/numpy-out, for drop-in
compatibility.  Batched/sharded stepping lives in dartenv_tpu_torch.parallel.
"""
from __future__ import annotations

import numpy as np


class Env(object):
    """The main environment contract.

    The reference semantics to replicate (SURVEY.md §2.1): partially
    observed envs, `step -> (observation, reward, done, info)`, `reset`
    starting a new episode, `render(mode)`, `seed` seeding the RNG.
    """

    metadata = {"render.modes": []}
    reward_range = (-np.inf, np.inf)
    spec = None

    action_space = None
    observation_space = None

    # internal hooks (0.9.x style)
    def _step(self, action):
        raise NotImplementedError

    def _reset(self):
        raise NotImplementedError

    def _render(self, mode="human", close=False):
        if close:
            return
        raise NotImplementedError

    def _seed(self, seed=None):
        return []

    def _close(self):
        pass

    # public API
    def step(self, action):
        """Run one timestep: returns (observation, reward, done, info)."""
        return self._step(action)

    def reset(self):
        """Reset and return an initial observation."""
        return self._reset()

    def render(self, mode="human", close=False):
        if not close:
            modes = self.metadata.get("render.modes", [])
            if mode not in modes:
                raise NotImplementedError(
                    "Render mode {} not supported (supported: {})".format(
                        mode, modes
                    )
                )
        return self._render(mode=mode, close=close)

    def seed(self, seed=None):
        """Seed the env RNG(s); returns the list of seeds used."""
        return self._seed(seed)

    def close(self):
        self._close()

    @property
    def unwrapped(self):
        return self

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __str__(self):
        if self.spec is None:
            return "<{} instance>".format(type(self).__name__)
        return "<{}<{}>>".format(type(self).__name__, self.spec.id)


class Wrapper(Env):
    def __init__(self, env):
        self.env = env
        self.action_space = env.action_space
        self.observation_space = env.observation_space
        self.reward_range = env.reward_range
        self.metadata = env.metadata
        self.spec = getattr(env, "spec", None)

    def _step(self, action):
        return self.env.step(action)

    def _reset(self):
        return self.env.reset()

    def _render(self, mode="human", close=False):
        return self.env.render(mode, close)

    def _seed(self, seed=None):
        return self.env.seed(seed)

    def _close(self):
        return self.env.close()

    @property
    def unwrapped(self):
        return self.env.unwrapped

    def __str__(self):
        return "<{}{}>".format(type(self).__name__, self.env)

    def __getattr__(self, name):
        # delegate anything not found here to the wrapped env
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.env, name)


class ObservationWrapper(Wrapper):
    def _step(self, action):
        observation, reward, done, info = self.env.step(action)
        return self._observation(observation), reward, done, info

    def _reset(self):
        return self._observation(self.env.reset())

    def _observation(self, observation):
        raise NotImplementedError


class RewardWrapper(Wrapper):
    def _step(self, action):
        observation, reward, done, info = self.env.step(action)
        return observation, self._reward(reward), done, info

    def _reward(self, reward):
        raise NotImplementedError


class ActionWrapper(Wrapper):
    def _step(self, action):
        return self.env.step(self._action(action))

    def _action(self, action):
        raise NotImplementedError

    def _reverse_action(self, action):
        raise NotImplementedError
