"""Where one control step's time goes on the card.

    python -m dartenv_tpu_torch.bench.profile_step [--env walker2d]
        (any name of envs/tasks._TASKS: walker3d, humanwalker, ...)
        [--batch 4096] [--steps 20] [--perturb | --dr]
        [--solver pgs|dantzig] [--escalate_ref64 N]
        [--out out/profile.json]

Steps a batched env under the random policy for `--steps` control steps
inside torch.profiler and prints one JSON object: host wall time per
control step (from an un-profiled pass), device-busy time per control step
(from the profiled pass), device launches per control step, and the
kernels that take the most device time.  `--perturb` turns on the task's
random pushes (the phase-wise path with external forces); `--solver`
overrides the task's LCP solver ("dantzig": the phase-wise path with the
exact block-pivoting solve over the whole batch); `--escalate_ref64 N`
sets the passes of the escalation's mixed-precision refinement tier.
`--dr` profiles
bench/throughput.bench_dr's step instead: a domain-randomized batch (the
bench's spec), frame_skip randomized sim steps per control step under
fixed random torques (no env step around them).  Needs a GPU (it
measures nothing on a CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch


def _control_step(task, batch, gen, dr):
    """A function that runs one control step of the batch: the env step
    under the random policy, or (dr) frame_skip randomized sim steps."""
    from dartenv_tpu_torch.bench.throughput import DR_SPEC, random_policy
    from dartenv_tpu_torch.engine.world import init_state
    from dartenv_tpu_torch.parallel.domain_rand import (
        make_randomized_sim_step, randomize_model,
    )
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    model = task.model
    if dr:
        bmodel = randomize_model(model, DR_SPEC, batch, gen)
        step = make_randomized_sim_step(model, list(DR_SPEC))
        sim = [init_state(model, batch, warm_start=task.warm_start)]
        tau = (torch.rand((batch, model.n), generator=gen,
                          device=model.device) * 2 - 1) * 50.0

        def run():
            for _ in range(task.frame_skip):
                sim[0], _ = step(bmodel, sim[0], tau)
        return run
    vec = VecEnv(task, batch, max_episode_steps=1000, generator=gen)
    policy = random_policy(task)
    env = list(vec.reset())

    def run():
        env[0], env[1], *_ = vec.step(env[0], policy(None, env[1], gen))
    return run


def profile(env="walker2d", batch=4096, steps=20, top=12, perturb=False,
            dr=False, solver=None, solver_overrides=None):
    """The JSON object of the module docstring; `solver_overrides`
    ({SolverConfig field: value}) as bench/throughput.bench_env takes
    them."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from dartenv_tpu_torch.bench.throughput import card_name
    from dartenv_tpu_torch.envs.tasks import make_task

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    dev = torch.device("cuda")
    task = make_task(env, device=dev, lcp_solver=solver,
                     **(solver_overrides or {}))
    task.add_perturbation = perturb
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    control_step = _control_step(task, batch, gen, dr)
    for _ in range(10):                       # build kernels, warm caches
        control_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):                    # un-profiled wall time
        control_step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            control_step()
        torch.cuda.synchronize()
    # device-side events only (kernels, memcpy, memset): the op-level rows
    # repeat their kernels' time and would count it twice
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev_us, ev.count))
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows) / 1e3
    return {
        "env": env, "perturb": perturb, "dr": dr,
        "solver": task.model.solver.solver, "batch": batch,
        "control_steps": steps,
        "card": card_name(dev),
        "wall_ms_per_control_step": plain_wall_ms / steps,
        "device_busy_ms_per_control_step": dev_ms / steps,
        "device_launches_per_control_step":
            sum(r[2] for r in rows) / steps,
        "note": "wall time from an un-profiled pass of the same length; "
                "device time from the profiled pass",
        "top_device_kernels": [
            {"name": k[:80], "ms_per_control_step": us / 1e3 / steps,
             "launches_per_control_step": c / steps}
            for k, us, c in rows[:top]],
    }


def main():
    from dartenv_tpu_torch.envs.tasks import _TASKS

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--env", default="walker2d", choices=sorted(_TASKS))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--dr", action="store_true")
    ap.add_argument("--solver", default=None, choices=["pgs", "dantzig"],
                    help="override the task's LCP solver")
    ap.add_argument("--escalate_ref64", type=int, default=None,
                    help="passes of the escalation's mixed-precision "
                         "(float64 residual) refinement tier")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = profile(args.env, args.batch, args.steps, perturb=args.perturb,
                  dr=args.dr, solver=args.solver,
                  solver_overrides=None if args.escalate_ref64 is None
                  else {"escalate_ref64": args.escalate_ref64})
    text = json.dumps(res, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
