"""Env registry (reference: `gym/envs/registration.py:~1-180` † —
SURVEY.md §2.1): id->EnvSpec table, `make()` instantiating the entry point
and wrapping in TimeLimit when episode caps are set, the exact
`name-vN` id grammar, and deprecation errors for stale versions.
"""
from __future__ import annotations

import importlib
import re

import torch

from dartenv_tpu_torch.api import error

# the reference's id grammar: optional `username/` prefix, name, -v<N>
env_id_re = re.compile(r"^(?:[\w:-]+\/)?([\w:.-]+)-v(\d+)$")


def load(name):
    mod_name, attr = name.split(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)


class EnvSpec(object):
    """A specification for a particular instance of the environment."""

    def __init__(self, id, entry_point=None, trials=100,
                 reward_threshold=None, kwargs=None, nondeterministic=False,
                 tags=None, max_episode_steps=None,
                 max_episode_seconds=None, timestep_limit=None):
        self.id = id
        self.trials = trials
        self.reward_threshold = reward_threshold
        self.nondeterministic = nondeterministic
        self.tags = tags or {}

        if timestep_limit is not None and max_episode_steps is None:
            max_episode_steps = timestep_limit
        self.max_episode_steps = max_episode_steps
        self.max_episode_seconds = max_episode_seconds

        self._entry_point = entry_point
        self._kwargs = {} if kwargs is None else kwargs

        match = env_id_re.search(id)
        if not match:
            raise error.Error(
                "Attempted to register malformed environment ID: {}. "
                "(Currently all IDs must be of the form {}.)".format(
                    id, env_id_re.pattern
                )
            )
        self._env_name = match.group(1)

    @property
    def timestep_limit(self):
        return self.max_episode_steps

    def make(self, device="cuda", dtype=torch.float32):
        """Instantiate the entry point with the spec's kwargs and `device`,
        `dtype` (every env class of the package takes both)."""
        if self._entry_point is None:
            raise error.Error(
                "Attempting to make deprecated env {}. (HINT: is there a "
                "newer registered version of this env?)".format(self.id)
            )
        if callable(self._entry_point):
            cls = self._entry_point
        else:
            cls = load(self._entry_point)
        env = cls(**dict(self._kwargs, device=device, dtype=dtype))
        # make a copy so the env's spec can be tweaked independently
        env.unwrapped.spec = self
        return env

    def __repr__(self):
        return "EnvSpec({})".format(self.id)


class EnvRegistry(object):
    def __init__(self):
        self.env_specs = {}

    def make(self, id, device="cuda", dtype=torch.float32):
        spec = self.spec(id)
        env = spec.make(device=device, dtype=dtype)
        if (spec.max_episode_steps is not None
                or spec.max_episode_seconds is not None):
            from dartenv_tpu_torch.api.wrappers import TimeLimit

            env = TimeLimit(
                env,
                max_episode_steps=spec.max_episode_steps,
                max_episode_seconds=spec.max_episode_seconds,
            )
        return env

    def all(self):
        return self.env_specs.values()

    def spec(self, id):
        match = env_id_re.search(id)
        if not match:
            raise error.Error(
                "Attempted to look up malformed environment ID: {}. "
                "(Currently all IDs must be of the form {}.)".format(
                    id.encode("utf-8"), env_id_re.pattern
                )
            )
        try:
            return self.env_specs[id]
        except KeyError:
            env_name = match.group(1)
            matching = [
                valid_id
                for valid_id, valid_spec in self.env_specs.items()
                if env_name == valid_spec._env_name
            ]
            if matching:
                raise error.DeprecatedEnv(
                    "Env {} not found (valid versions include {})".format(
                        id, matching
                    )
                )
            raise error.UnregisteredEnv(
                "No registered env with id: {}".format(id)
            )

    def register(self, id, **kwargs):
        if id in self.env_specs:
            raise error.Error(
                "Cannot re-register id: {}".format(id)
            )
        self.env_specs[id] = EnvSpec(id, **kwargs)


registry = EnvRegistry()


def register(id, **kwargs):
    return registry.register(id, **kwargs)


def make(id, device="cuda", dtype=torch.float32):
    """The env of `id` on `device` ("cuda" unless the caller asks for the
    CPU) in `dtype`, wrapped in TimeLimit when its spec caps episodes."""
    return registry.make(id, device=device, dtype=dtype)


def spec(id):
    return registry.spec(id)
