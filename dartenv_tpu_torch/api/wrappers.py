"""Wrappers: TimeLimit + episode-statistics Monitor.

Reference: `gym/wrappers/time_limit.py:~1-60` † and the Monitor stack
(`gym/wrappers/monitoring.py` †, `gym/monitoring/stats_recorder.py` † —
SURVEY.md §2.1, §3.5).  The Monitor here records the same episode
statistics (rewards, lengths, wall-clock timestamps) to JSON with
crash-resilient atomic writes; the defunct scoreboard HTTP upload is out of
scope (recorded decision, SURVEY.md §2.1), and video capture hooks in once
a software renderer exists.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from dartenv_tpu_torch.api import error
from dartenv_tpu_torch.api.core import Wrapper
from dartenv_tpu_torch.utils.atomic_write import atomic_write


class TimeLimit(Wrapper):
    def __init__(self, env, max_episode_steps=None, max_episode_seconds=None):
        super(TimeLimit, self).__init__(env)
        self._max_episode_steps = max_episode_steps
        self._max_episode_seconds = max_episode_seconds
        self._elapsed_steps = 0
        self._episode_started_at = None

    @property
    def _elapsed_seconds(self):
        return time.time() - self._episode_started_at

    def _past_limit(self):
        if (self._max_episode_steps is not None
                and self._elapsed_steps >= self._max_episode_steps):
            return True
        if (self._max_episode_seconds is not None
                and self._episode_started_at is not None
                and self._elapsed_seconds >= self._max_episode_seconds):
            return True
        return False

    def _step(self, action):
        assert self._episode_started_at is not None, (
            "Cannot call env.step() before calling reset()"
        )
        observation, reward, done, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._past_limit():
            done = True
        return observation, reward, done, info

    def _reset(self):
        self._episode_started_at = time.time()
        self._elapsed_steps = 0
        return self.env.reset()


def capped_cubic_video_schedule(episode_id):
    """Record on perfect cubes until 1000, then every 1000 episodes †."""
    if episode_id < 1000:
        return int(round(episode_id ** (1.0 / 3))) ** 3 == episode_id
    return episode_id % 1000 == 0


class StatsRecorder(object):
    """Episode statistics sink (`gym/monitoring/stats_recorder.py` †)."""

    def __init__(self, directory, file_prefix, env_id=None):
        self.directory = directory
        self.file_prefix = file_prefix
        self.env_id = env_id
        self.initial_reset_timestamp = None
        self.timestamps = []
        self.episode_lengths = []
        self.episode_rewards = []
        self.episode_types = []
        self._type = "t"
        self.steps = None
        self.rewards = None
        self.done = None
        self.closed = False
        self.path = os.path.join(
            self.directory, "{}.stats.json".format(self.file_prefix)
        )

    @property
    def type(self):
        return self._type

    @type.setter
    def type(self, t):
        if t not in ("t", "e"):
            raise error.Error(
                "Invalid episode type {}: must be t or e".format(t)
            )
        self._type = t

    def before_step(self, action):
        if self.closed:
            raise error.ResetNotAllowed(
                "trying to step an env which is currently done"
            )
        if self.done:
            raise error.ResetNeeded(
                "Trying to step environment which is currently done."
            )
        elif self.steps is None:
            raise error.ResetNeeded(
                "Trying to step an environment before reset."
            )

    def after_step(self, observation, reward, done, info):
        self.steps += 1
        self.rewards += reward
        if done:
            self.done = True
            self.save_complete()

    def before_reset(self):
        if self.closed:
            raise error.Error("recorder closed")
        self.done = False
        if self.initial_reset_timestamp is None:
            self.initial_reset_timestamp = time.time()

    def after_reset(self, observation):
        self.steps = 0
        self.rewards = 0
        self.episode_types.append(self._type)

    def save_complete(self):
        # reference semantics †: after saving, null the accumulators so a
        # following close()/reset cannot double-count the episode
        if self.steps is not None:
            self.timestamps.append(time.time())
            self.episode_lengths.append(self.steps)
            self.episode_rewards.append(float(self.rewards))
            self.steps = None
            self.rewards = None

    def close(self):
        self.save_complete()
        self.flush()
        self.closed = True

    def flush(self):
        if self.closed:
            return
        with atomic_write(self.path) as f:
            json.dump(
                {
                    "initial_reset_timestamp": self.initial_reset_timestamp,
                    "timestamps": self.timestamps,
                    "episode_lengths": self.episode_lengths,
                    "episode_rewards": self.episode_rewards,
                    "episode_types": self.episode_types,
                    "env_id": self.env_id,
                },
                f,
            )


class Monitor(Wrapper):
    """Records episode stats (and later: video) to a results directory
    (`gym/wrappers/monitoring.py` † Monitor)."""

    def __init__(self, env, directory, video_callable=None, force=False,
                 resume=False, uid=None, mode=None, write_upon_reset=False):
        super(Monitor, self).__init__(env)
        if not os.path.exists(directory):
            os.makedirs(directory)
        elif not (force or resume) and os.listdir(directory):
            raise error.Error(
                "Trying to write to non-empty monitor directory {}. "
                "Use force=True to clear, resume=True to append.".format(
                    directory
                )
            )
        if force:
            for f in os.listdir(directory):
                if f.endswith(".stats.json") or f.endswith(".manifest.json"):
                    os.unlink(os.path.join(directory, f))
        self.directory = directory
        self.write_upon_reset = write_upon_reset
        env_id = env.spec.id if env.spec else "(unknown)"
        prefix = "dartenvtpu.{}.{}".format(uid or os.getpid(), "episodes")
        self.stats_recorder = StatsRecorder(directory, prefix, env_id=env_id)
        self._monitor_id = prefix
        self.enabled = True
        # video schedule: the reference's capped-cubic default †
        if video_callable is None:
            video_callable = capped_cubic_video_schedule
        elif video_callable is False:
            video_callable = lambda episode_id: False
        self.video_callable = video_callable
        self.video_recorder = None
        self.videos = []
        self.episode_id = 0

    def _step(self, action):
        self.stats_recorder.before_step(action)
        observation, reward, done, info = self.env.step(action)
        self.stats_recorder.after_step(observation, reward, done, info)
        if self.video_recorder is not None:
            self.video_recorder.capture_frame()
        return observation, reward, done, info

    def _reset(self):
        self.stats_recorder.before_reset()
        observation = self.env.reset()
        self.stats_recorder.after_reset(observation)
        self._reset_video_recorder()
        self.episode_id += 1
        if self.write_upon_reset:
            self.stats_recorder.flush()
        return observation

    def _reset_video_recorder(self):
        from dartenv_tpu_torch.api.video_recorder import VideoRecorder

        if self.video_recorder is not None:
            self._close_video_recorder()
        if not self.video_callable(self.episode_id):
            self.video_recorder = None
            return
        base = os.path.join(
            self.directory,
            "{}.video{:06}".format(self._monitor_id, self.episode_id),
        )
        self.video_recorder = VideoRecorder(
            env=self.env, base_path=base,
            metadata={"episode_id": self.episode_id},
        )
        self.video_recorder.capture_frame()

    def _close_video_recorder(self):
        self.video_recorder.close()
        if not self.video_recorder.empty and not self.video_recorder.broken:
            self.videos.append(self.video_recorder.path)
        self.video_recorder = None

    def _close(self):
        if getattr(self, "video_recorder", None) is not None:
            self._close_video_recorder()
        if getattr(self, "stats_recorder", None) is not None:
            self.stats_recorder.close()
            self._write_manifest()
        self.env.close()

    def _write_manifest(self):
        path = os.path.join(
            self.directory, "{}.manifest.json".format(self._monitor_id)
        )
        with atomic_write(path) as f:
            json.dump(
                {
                    "stats": os.path.basename(self.stats_recorder.path),
                    "videos": [os.path.basename(v) for v in self.videos],
                    "env_info": {
                        "env_id": self.stats_recorder.env_id,
                    },
                },
                f,
            )

    def get_episode_rewards(self):
        return self.stats_recorder.episode_rewards

    def get_episode_lengths(self):
        return self.stats_recorder.episode_lengths
