"""The readers of the program's spans on a hand-made Chrome trace: each
gives the expected number where its span is there and is left out (None)
where it is not."""
import types

import pytest

from benchmark.harness.common import reader
from benchmark.harness.trace import Profile

TID = 7


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": TID,
            "args": args}


def launch(corr, ts, op, op_ts, op_dur, cat="kernel",
           call="cudaLaunchKernel"):
    return [ev(call, "cuda_runtime", ts, 2, correlation=corr),
            dict(ev(op, cat, op_ts, op_dur, correlation=corr), tid=0)]


def batched_events():
    """Two control steps of a fused batch.  Step 1 [100, 500]: env.action,
    substep_fused [200, 300] with constraints and integrate inside it,
    env.obs, env.reset; step 2 [600, 800]: substep_fused [650, 700]."""
    out = [ev("bench_slice", "user_annotation", 0, 1000),
           ev("bench_inputs", "user_annotation", 50, 40),
           ev("env.step", "user_annotation", 100, 400),
           ev("env.action", "user_annotation", 110, 20),
           ev("substep_fused", "user_annotation", 200, 100),
           ev("constraints", "user_annotation", 220, 30),
           ev("integrate", "user_annotation", 260, 30),
           ev("env.obs", "user_annotation", 320, 20),
           ev("env.reset", "user_annotation", 400, 80),
           ev("env.step", "user_annotation", 600, 200),
           ev("substep_fused", "user_annotation", 650, 50),
           ev("cudaStreamSynchronize", "cuda_runtime", 275, 5),
           ev("cudaStreamSynchronize", "cuda_runtime", 60, 5),   # bench
           ev("cudaDeviceSynchronize", "cuda_runtime", 900, 5)]  # no span
    out += launch(1, 55, "fill", 56, 2)                         # bench
    out += launch(2, 115, "clamp", 120, 5)                      # action
    out += launch(3, 205, "substep_kernel", 210, 20)            # fused
    out += launch(4, 225, "bpp_fused_kernel", 230, 20)          # constr.
    out += launch(5, 265, "mul", 266, 3)                        # integrate
    out += launch(6, 270, "Memcpy HtoD (Pageable -> Device)", 271, 2,
                  cat="gpu_memcpy", call="cudaMemcpyAsync")     # integrate
    out += launch(7, 410, "rand", 411, 3)                       # reset
    out += launch(8, 420, "where", 421, 3)                      # reset
    out += launch(9, 450, "where", 451, 3)                      # reset
    out += launch(10, 660, "substep_kernel", 661, 20)           # fused
    out += launch(11, 610, "add", 611, 2)                       # env.step
    return out


def gym_events():
    out = [ev("bench_slice", "user_annotation", 0, 1000),
           ev("gym.step", "user_annotation", 100, 300),
           ev("gym.host_copy", "user_annotation", 300, 90),
           ev("gym.step", "user_annotation", 500, 300),
           ev("gym.host_copy", "user_annotation", 700, 60),
           ev("gym.reset", "user_annotation", 850, 50)]
    out += launch(1, 110, "substep_kernel", 115, 100)
    out += launch(2, 305, "Memcpy DtoH (Device -> Pageable)", 320, 5,
                  cat="gpu_memcpy", call="cudaMemcpyAsync")
    return out


def read(metric, events, steps=2):
    ctx = types.SimpleNamespace(profile=Profile(events, steps=steps))
    return reader(metric)(ctx)


@pytest.mark.parametrize("metric,want", [
    ("env.reset.launches_per_step", 1.5),          # 3 launches / 2 steps
    ("engine.integrate.launches_per_step", 1.0),   # mul + the copy
    # env.step 400 + 200 us, less substep_fused 100 + 50 us inside them
    ("env.host_ms_per_step", (600 - 150) * 1e-3 / 2),
    # the sync and the pageable copy inside integrate; not the bench's
    # sync, not the one with no span
    ("device.host_syncs_per_step", 1.0),
    ("gym.wait_ms_per_step", None),
])
def test_batched_readers(metric, want):
    got = read(metric, batched_events())
    assert got == (want if want is None else pytest.approx(want))


def test_one_pageable_copy_in_integrate_is_one_sync():
    events = [e for e in batched_events()
              if not (e["name"] == "cudaStreamSynchronize"
                      and e["ts"] == 275)]
    assert read("device.host_syncs_per_step", events, steps=1) == 1.0
    # a cudaMemcpy of pageable memory counts once, not twice
    for e in events:
        if e["name"] == "cudaMemcpyAsync":
            e["name"] = "cudaMemcpy"
    assert read("device.host_syncs_per_step", events, steps=1) == 1.0


@pytest.mark.parametrize("metric,want", [
    ("gym.wait_ms_per_step", (90 + 60) * 1e-3 / 2),
    ("env.reset.launches_per_step", None),
    ("engine.integrate.launches_per_step", None),
    ("env.host_ms_per_step", None),
    ("device.host_syncs_per_step", 0.5),           # the copy to pageable
])
def test_gym_readers(metric, want):
    got = read(metric, gym_events())
    assert got == (want if want is None else pytest.approx(want))


@pytest.mark.parametrize("metric", [
    "env.reset.launches_per_step", "engine.integrate.launches_per_step",
    "env.host_ms_per_step", "device.host_syncs_per_step",
    "gym.wait_ms_per_step"])
def test_left_out_without_spans(metric):
    """A profile with only the benchmark's own ranges (a program without
    spans) leaves every metric out."""
    events = [ev("bench_slice", "user_annotation", 0, 1000),
              ev("bench_inputs", "user_annotation", 10, 100),
              ev("cudaStreamSynchronize", "cuda_runtime", 200, 5)]
    events += launch(1, 20, "fill", 30, 10)
    events += launch(2, 300, "Memcpy HtoD (Pageable -> Device)", 301, 2,
                     cat="gpu_memcpy", call="cudaMemcpyAsync")
    assert read(metric, events) is None
    assert reader(metric)(types.SimpleNamespace(profile=None)) is None
