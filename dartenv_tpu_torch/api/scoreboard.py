"""Scoreboard: local scoring/packaging of Monitor results.

Reference: `gym/scoreboard/api.py` † + `gym/scoreboard/client/` †
(SURVEY.md §2.1 "Scoreboard") uploaded Monitor results to the OpenAI
scoreboard HTTP service.  **That service is defunct upstream; by recorded
decision (SURVEY.md §2.1) no network upload is replicated.**  This module
keeps the same `upload(training_dir, ...)` entry point and evaluation
packaging, but scores locally and writes the bundle next to the results:

* scans `training_dir` for Monitor `*.manifest.json` / `*.stats.json`,
* merges episode statistics per env_id (same merge the reference performed
  server-side),
* when `benchmark_id` is given, scores every env with the registered
  benchmark's scorer (ClipTo01ThenAverage †),
* writes `scoreboard_upload.json` and returns the evaluation dict.
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from typing import Optional

from dartenv_tpu_torch.api import error
from dartenv_tpu_torch.api.benchmarks import benchmark_spec
from dartenv_tpu_torch.utils.atomic_write import atomic_write


def _load_results(training_dir: str):
    manifests = sorted(glob.glob(os.path.join(training_dir,
                                              "*.manifest.json")))
    if not manifests:
        raise error.Error(
            "No Monitor manifests found in {} — wrap your env in "
            "dartenv_tpu_torch.Monitor and close() it first".format(training_dir)
        )
    by_env = defaultdict(lambda: {"episode_lengths": [],
                                  "episode_rewards": [],
                                  "episode_types": [],
                                  "timestamps": [],
                                  "videos": [],
                                  "initial_reset_timestamp": None})
    for mpath in manifests:
        with open(mpath) as f:
            manifest = json.load(f)
        spath = os.path.join(training_dir, manifest["stats"])
        with open(spath) as f:
            stats = json.load(f)
        env_id = (manifest.get("env_info") or {}).get("env_id") \
            or stats.get("env_id")
        agg = by_env[env_id]
        agg["episode_lengths"] += stats.get("episode_lengths", [])
        agg["episode_rewards"] += stats.get("episode_rewards", [])
        agg["episode_types"] += stats.get("episode_types", [])
        agg["timestamps"] += stats.get("timestamps", [])
        agg["videos"] += manifest.get("videos", [])
        t0 = stats.get("initial_reset_timestamp")
        if t0 is not None and (agg["initial_reset_timestamp"] is None
                               or t0 < agg["initial_reset_timestamp"]):
            agg["initial_reset_timestamp"] = t0
    return dict(by_env)


def upload(training_dir: str, algorithm_id: Optional[str] = None,
           benchmark_id: Optional[str] = None,
           writeup: Optional[str] = None,
           api_key: Optional[str] = None) -> dict:
    """Package (and locally score) Monitor results.

    Signature-compatible with the reference's `gym.scoreboard.api.upload` †;
    `api_key` is accepted and ignored (no network — see module docstring).
    Returns the evaluation dict and writes `scoreboard_upload.json` into
    `training_dir`.
    """
    del api_key  # recorded decision: the scoreboard HTTP service is defunct
    results = _load_results(training_dir)

    evaluation = {
        "training_dir": os.path.abspath(training_dir),
        "algorithm_id": algorithm_id,
        "benchmark_id": benchmark_id,
        "writeup": writeup,
        "envs": {},
    }
    scores = []
    for env_id, agg in sorted(results.items()):
        entry = {
            "episodes": len(agg["episode_rewards"]),
            "total_steps": int(sum(agg["episode_lengths"])),
            "mean_reward": (
                float(sum(agg["episode_rewards"]))
                / max(len(agg["episode_rewards"]), 1)
            ),
            "videos": agg["videos"],
        }
        if benchmark_id is not None:
            bench = benchmark_spec(benchmark_id)
            score = bench.scorer.score_evaluation(
                bench, env_id, agg["episode_lengths"],
                agg["episode_rewards"],
            )
            entry["benchmark_score"] = score
            scores.append(score)
        evaluation["envs"][env_id] = entry
    if scores:
        evaluation["benchmark_score"] = float(sum(scores) / len(scores))

    out = os.path.join(training_dir, "scoreboard_upload.json")
    with atomic_write(out) as f:
        json.dump(evaluation, f, indent=2)
    return evaluation
