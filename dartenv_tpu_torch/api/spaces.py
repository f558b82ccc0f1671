"""Observation/action spaces (reference: `gym/spaces/` † — SURVEY.md §2.1).

Same public surface as the reference's 0.9.x vintage: Box / Discrete /
Tuple / MultiDiscrete / MultiBinary, a module-level sampling PRNG
(`gym.spaces.prng` analogue), `sample`/`contains` and jsonable round-trips.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np


class _Prng:
    """Module-level sampling RNG (`gym/spaces/prng.py` † analogue)."""

    def __init__(self):
        self.np_random = np.random.RandomState()

    def seed(self, seed=None):
        self.np_random = np.random.RandomState(seed)


prng = _Prng()


def seed(s=None):
    prng.seed(s)


class Space(object):
    """Minimal space contract: sample/contains + jsonable helpers."""

    def sample(self):
        raise NotImplementedError

    def contains(self, x):
        raise NotImplementedError

    def to_jsonable(self, sample_n):
        return sample_n

    def from_jsonable(self, sample_n):
        return sample_n


class Box(Space):
    """A (possibly unbounded) box in R^n."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            low = np.asarray(low, dtype=dtype)
            high = np.asarray(high, dtype=dtype)
            assert low.shape == high.shape
        else:
            low = np.full(shape, low, dtype=dtype)
            high = np.full(shape, high, dtype=dtype)
        self.low = low
        self.high = high
        self.dtype = dtype

    @property
    def shape(self):
        return self.low.shape

    def sample(self):
        low = np.where(np.isfinite(self.low), self.low, -1e9)
        high = np.where(np.isfinite(self.high), self.high, 1e9)
        return prng.np_random.uniform(
            low=low, high=high, size=self.low.shape
        ).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool(np.all(x >= self.low - 1e-6))
            and bool(np.all(x <= self.high + 1e-6))
        )

    def to_jsonable(self, sample_n):
        return np.array(sample_n).tolist()

    def from_jsonable(self, sample_n):
        return [np.asarray(sample, dtype=self.dtype) for sample in sample_n]

    def __repr__(self):
        return "Box" + str(self.shape)

    def __eq__(self, other):
        return (
            isinstance(other, Box)
            and np.allclose(self.low, other.low)
            and np.allclose(self.high, other.high)
        )


class Discrete(Space):
    def __init__(self, n):
        self.n = int(n)

    @property
    def shape(self):
        return (self.n,)

    def sample(self):
        return int(prng.np_random.randint(self.n))

    def contains(self, x):
        if isinstance(x, (np.generic, np.ndarray)):
            x = int(x)
        return isinstance(x, int) and 0 <= x < self.n

    def __repr__(self):
        return "Discrete(%d)" % self.n

    def __eq__(self, other):
        return isinstance(other, Discrete) and self.n == other.n


class MultiDiscrete(Space):
    """Series of discrete dims given as [[min, max], ...] (0.9.x style)."""

    def __init__(self, array_of_param_array):
        self.low = np.asarray([p[0] for p in array_of_param_array])
        self.high = np.asarray([p[1] for p in array_of_param_array])
        self.num_discrete_space = self.low.shape[0]

    @property
    def shape(self):
        return (self.num_discrete_space,)

    def sample(self):
        random_array = prng.np_random.rand(self.num_discrete_space)
        return np.floor(
            (self.high - self.low + 1.0) * random_array + self.low
        ).astype(int)

    def contains(self, x):
        x = np.asarray(x)
        return (
            len(x) == self.num_discrete_space
            and bool(np.all(x >= self.low))
            and bool(np.all(x <= self.high))
        )


class MultiBinary(Space):
    def __init__(self, n):
        self.n = int(n)

    @property
    def shape(self):
        return (self.n,)

    def sample(self):
        return prng.np_random.randint(0, 2, self.n)

    def contains(self, x):
        return np.all(np.logical_or(np.asarray(x) == 0, np.asarray(x) == 1))


class Tuple(Space):
    def __init__(self, spaces):
        self.spaces = tuple(spaces)

    def sample(self):
        return tuple(s.sample() for s in self.spaces)

    def contains(self, x):
        if isinstance(x, list):
            x = tuple(x)
        return (
            isinstance(x, tuple)
            and len(x) == len(self.spaces)
            and all(s.contains(p) for s, p in zip(self.spaces, x))
        )

    def to_jsonable(self, sample_n):
        return [
            space.to_jsonable([sample[i] for sample in sample_n])
            for i, space in enumerate(self.spaces)
        ]

    def from_jsonable(self, sample_n):
        return [
            sample for sample in zip(
                *[s.from_jsonable(sample_n[i])
                  for i, s in enumerate(self.spaces)]
            )
        ]
