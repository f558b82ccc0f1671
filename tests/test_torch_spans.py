"""The program's profiler spans (utils/span.py) on the CPU: under
torch.profiler a walker2d VecEnv step, a pushed one and a gym step and
reset write their spans to the exported trace, nested as the benchmark's
readers take them; with no profiler running no record_function is
called at all; the profiler changes no result.  The walker2d task is cut
to one substep a control step (B = 2, float64): the spans are the same at
any frame_skip."""
import functools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.envs.base import DartEnv
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.parallel.vec_env import VecEnv
from dartenv_tpu_torch.utils import span as span_mod

CASES = ("fused", "pushed", "gym")


def walker2d(perturb=False):
    task = make_task("walker2d", dtype=torch.float64, device="cpu")
    task.frame_skip = 1
    task.add_perturbation = perturb
    return task


def run(case):
    """One control step: of a VecEnv (B = 2) whose envs all reach their
    episode cap, so the auto-reset selects (fused, pushed); or of a
    DartEnv, reset, step, reset (gym).  Returns the results."""
    if case == "gym":
        env = DartEnv(walker2d(), device="cpu", dtype=torch.float64)
        env.seed(5)
        obs0 = env.reset()
        obs, reward, done, _ = env.step(np.full(env.action_space.shape,
                                                0.3))
        return (obs0, obs, np.float64(reward), np.bool_(done),
                env.state_vector(), env.reset())
    task = walker2d(perturb=case == "pushed")
    gen = torch.Generator().manual_seed(3)
    venv = VecEnv(task, 2, max_episode_steps=1, generator=gen)
    state, _ = venv.reset()
    a = torch.rand((2, task.action_size), generator=gen,
                   dtype=torch.float64) * 2 - 1
    state, obs, reward, done, info = venv.step(state, a)
    return (obs, reward, done, info["terminal_obs"], state.sim.q,
            state.sim.dq, state.sim.lam, state.steps)


@functools.lru_cache(maxsize=None)
def plain(case):
    """run(case) with no profiler, record_function made to raise."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(span_mod, "record_function", refuse)
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        return run(case)


@functools.lru_cache(maxsize=None)
def traced(case):
    """run(case) under torch.profiler: (results, {span: [(start, end)]})
    from the exported Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run(case)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    return out, spans


def nested(inner, outer):
    return all(any(a <= x and y <= b for a, b in outer) for x, y in inner)


@pytest.mark.parametrize("case,names,inside", [
    ("fused", ("env.step", "env.action", "env.obs", "env.reward",
               "env.done", "env.reset", "substep_fused", "constraints",
               "integrate"),
     (("constraints", "substep_fused"), ("integrate", "substep_fused"),
      ("substep_fused", "env.step"), ("env.reset", "env.step"))),
    ("pushed", ("env.step", "env.push", "dynamics", "collision",
                "constraints", "integrate"),
     (("env.push", "env.step"), ("dynamics", "env.step"))),
    ("gym", ("gym.step", "gym.host_copy", "gym.reset", "env.action",
             "substep_fused"),
     (("gym.host_copy", "gym.step"), ("substep_fused", "gym.step"))),
])
def test_trace_holds_the_spans(case, names, inside):
    spans = traced(case)[1]
    assert set(names) <= set(spans), sorted(spans)
    for inner, outer in inside:
        assert nested(spans[inner], spans[outer]), (inner, outer)
    if case == "pushed":
        # the phase-wise path; the push bookkeeping apart from the substep
        assert "substep_fused" not in spans
        assert not nested(spans["dynamics"], spans["env.push"])


@pytest.mark.parametrize("case", CASES)
def test_no_record_function_without_a_profiler(case):
    assert plain(case) is not None


@pytest.mark.parametrize("case", CASES)
def test_the_profiler_changes_no_result(case):
    for a, b in zip(plain(case), traced(case)[0], strict=True):
        same = (torch.equal(a, b) if torch.is_tensor(a)
                else np.array_equal(a, b))
        assert same
