"""Shared helpers of the harness's CPU tests: a cell cut to a tiny batch
and a short window, run through its driver on the CPU."""
import time
import types

import pytest

from benchmark.harness import batched, common, gym


def tiny_run(workload, seed=11, batch=None, control=False, samples=2,
             seconds=2.5, trace=0):
    cell = common.Cell(workload)
    tr = dict(cell.traffic, warm_steps=1, check_samples=samples,
              check_gap=2)
    if batch is not None:
        tr["batch"] = batch
    cell.traffic = tr
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    drv = batched if tr["driver"] == "batched" else gym
    return drv.run(cell, args, time.perf_counter(), device="cpu",
                   control=control)


@pytest.fixture
def run_tiny():
    return tiny_run
