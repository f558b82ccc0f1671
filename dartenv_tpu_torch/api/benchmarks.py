"""Benchmark suites + scoring (reference: `gym/benchmarks/__init__.py` †,
`gym/benchmarks/scoring.py` † — SURVEY.md §2.1).

A benchmark is a named set of (env_id, trials, max_timesteps/max_seconds,
reward_floor, reward_ceiling) tasks; scoring clips per-episode rewards to
[floor, ceiling], rescales to [0, 1] and averages (the reference's
ClipTo01ThenAverage rule).  The defunct scoreboard HTTP upload is out of
scope by recorded decision (SURVEY.md §2.1).
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Optional

import numpy as np

from dartenv_tpu_torch.api import error


class BenchmarkTaskSpec(object):
    def __init__(self, env_id, trials, max_timesteps=None,
                 max_seconds=None, reward_floor=0.0, reward_ceiling=100.0):
        self.env_id = env_id
        self.trials = trials
        self.max_timesteps = max_timesteps
        self.max_seconds = max_seconds
        self.reward_floor = reward_floor
        self.reward_ceiling = reward_ceiling


class BenchmarkSpec(object):
    def __init__(self, id, scorer, tasks, description=None, name=None):
        self.id = id
        self.scorer = scorer
        self.description = description
        self.name = name
        self.tasks = [
            t if isinstance(t, BenchmarkTaskSpec) else BenchmarkTaskSpec(**t)
            for t in tasks
        ]

    def task_specs(self, env_id) -> List[BenchmarkTaskSpec]:
        out = [t for t in self.tasks if t.env_id == env_id]
        if not out:
            raise error.Unregistered(
                "No task with env_id {} registered for benchmark {}".format(
                    env_id, self.id
                )
            )
        return out


class ClipTo01ThenAverage(object):
    """Per-task: clip episode rewards to [floor, ceiling], rescale to
    [0, 1], average over the first `trials` episodes (missing episodes
    count as 0)."""

    def __init__(self, num_episodes: Optional[int] = None):
        self.num_episodes = num_episodes

    def score_evaluation(self, benchmark, env_id, episode_lengths,
                         episode_rewards):
        tasks = benchmark.task_specs(env_id)
        scores = []
        for task in tasks:
            n = self.num_episodes or task.trials
            rewards = np.asarray(episode_rewards, dtype=np.float64)[:n]
            clipped = np.clip(rewards, task.reward_floor,
                              task.reward_ceiling)
            scaled = (clipped - task.reward_floor) / (
                task.reward_ceiling - task.reward_floor
            )
            # missing episodes score 0
            total = np.sum(scaled)
            scores.append(float(total) / n)
        return float(np.mean(scores))


class BenchmarkRegistry(object):
    def __init__(self):
        self.benchmarks = {}

    def register_benchmark(self, id, **kwargs):
        if id in self.benchmarks:
            raise error.Error("Cannot re-register benchmark {}".format(id))
        self.benchmarks[id] = BenchmarkSpec(id=id, **kwargs)

    def benchmark_spec(self, id) -> BenchmarkSpec:
        try:
            return self.benchmarks[id]
        except KeyError:
            raise error.Unregistered(
                "No registered benchmark with id: {}".format(id)
            )


registry = BenchmarkRegistry()
register_benchmark = registry.register_benchmark
benchmark_spec = registry.benchmark_spec


# ---------------------------------------------------------------------------
# The dart control suite (thresholds mirror the env registrations ‡)
# ---------------------------------------------------------------------------

register_benchmark(
    id="DartControl-v0",
    name="DartControl",
    description="Five DART-lineage control tasks (SURVEY.md configs 1-5).",
    scorer=ClipTo01ThenAverage(),
    tasks=[
        dict(env_id="DartCartPole-v1", trials=3, max_timesteps=100000,
             reward_floor=0.0, reward_ceiling=1000.0),
        dict(env_id="DartReacher-v1", trials=3, max_timesteps=100000,
             reward_floor=-200.0, reward_ceiling=-3.75),
        dict(env_id="DartHopper-v1", trials=3, max_timesteps=1000000,
             reward_floor=0.0, reward_ceiling=3800.0),
        dict(env_id="DartWalker2d-v1", trials=3, max_timesteps=1000000,
             reward_floor=0.0, reward_ceiling=4000.0),
        dict(env_id="DartHumanWalker-v1", trials=3, max_timesteps=1000000,
             reward_floor=0.0, reward_ceiling=1500.0),
    ],
)
