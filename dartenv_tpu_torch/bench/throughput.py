"""Throughput of the batched env step under a random policy.

Every entry point takes an explicit `device` (default "cuda") and fails on
a machine without one rather than measuring the CPU: a CPU timing says
nothing about the port.  Tests pass device="cpu" to check control flow.
"""
from __future__ import annotations

import time

import torch

_TASKS = {
    "cartpole": ("dartenv_tpu_torch.envs.cart_pole", "make_cartpole_task"),
    "hopper": ("dartenv_tpu_torch.envs.hopper", "make_hopper_task"),
    "walker2d": ("dartenv_tpu_torch.envs.walker2d", "make_walker2d_task"),
    "doublependulum": ("dartenv_tpu_torch.envs.double_pendulum",
                       "make_double_pendulum_task"),
    "reacher": ("dartenv_tpu_torch.envs.reacher", "make_reacher_task"),
    "walker3d": ("dartenv_tpu_torch.envs.walker3d", "make_walker3d_task"),
    "humanwalker": ("dartenv_tpu_torch.envs.human_walker",
                    "make_humanwalker_task"),
    "reacher2d": ("dartenv_tpu_torch.envs.reacher2d", "make_reacher2d_task"),
    "snake7link": ("dartenv_tpu_torch.envs.snake_7link",
                   "make_snake7link_task"),
    "dog": ("dartenv_tpu_torch.envs.dog", "make_dog_task"),
}


def make_task(name: str, dtype=torch.float32, device="cuda",
              lcp_solver=None, **solver_kw):
    """The named task on `device`; `lcp_solver` ("pgs" or "dantzig", None:
    the task's own) picks the contact solver and `solver_kw` overrides
    SolverConfig fields, as the task factories take them."""
    import importlib

    mod, fn = _TASKS[name]
    return getattr(importlib.import_module(mod), fn)(
        dtype=dtype, device=device, lcp_solver=lcp_solver, **solver_kw)


def random_policy(task):
    hi = torch.as_tensor(task.control_bounds[0], dtype=task.model.dtype,
                         device=task.model.device)
    lo = torch.as_tensor(task.control_bounds[1], dtype=task.model.dtype,
                         device=task.model.device)

    def policy(params, obs, generator=None):
        del params
        shape = obs.shape[:-1] + (task.action_size,)
        u = torch.rand(shape, generator=generator, device=obs.device,
                       dtype=obs.dtype)
        return u * (hi - lo) + lo

    return policy


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ref64_kw(escalate_ref64):
    """make_task's solver override for an escalate_ref64 option (None:
    none)."""
    return {} if escalate_ref64 is None else dict(
        escalate_ref64=int(escalate_ref64))


def bench_env(name: str = "walker2d", batch: int = 4096,
              horizon: int = 100, iters: int = 5,
              max_episode_steps: int = 1000, device="cuda", seed: int = 0,
              return_state: bool = False, perturb: bool = False,
              solver=None, escalate_ref64=None, group=None):
    """Returns a dict with env-steps/s and timing detail of `iters`
    rollouts of `horizon` control steps after one warm-up rollout (which
    also builds the kernels); with iters=0 the rate is the warm-up's.
    `perturb` turns on the task's random perturbation pushes; `solver`
    ("pgs" or "dantzig", None: the task's own) picks the LCP solver;
    `escalate_ref64` (None: the task's own) sets the passes of the
    escalation's mixed-precision refinement tier.  With a process `group`
    (parallel/sharding.py) the batch is split over its ranks, each
    stepping its slice on its own device, and the episode totals are
    summed over the group; `devices` is the group's size and
    `env_steps_per_s_per_chip` the rate over it."""
    from dartenv_tpu_torch.parallel.rollout import make_rollout
    from dartenv_tpu_torch.parallel.sharding import (
        group_shape, make_sharded_rollout, sharded_reset,
    )
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    device = torch.device(device)
    task = make_task(name, device=device, lcp_solver=solver,
                     **ref64_kw(escalate_ref64))
    task.add_perturbation = perturb
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vec = VecEnv(task, num_envs=batch, max_episode_steps=max_episode_steps,
                 generator=gen)
    zero = torch.zeros((), dtype=task.model.dtype, device=device)
    track = {"overflow": zero, "pushed_substeps": zero, "env_share": zero,
             "substeps": 0}

    def track_step(info):
        track["overflow"] = torch.maximum(track["overflow"],
                                          info["contact_overflow"].max())
        if perturb:
            share = info["perturb_env_share"]
            track["pushed_substeps"] = (track["pushed_substeps"]
                                        + (share > 0).sum())
            track["env_share"] = track["env_share"] + share.sum()
            track["substeps"] += share.shape[0]

    n_dev, _ = group_shape(group)
    if group is None:
        rollout = make_rollout(vec, random_policy(task), horizon,
                               step_hook=track_step)
        state, _ = vec.reset()
    else:
        rollout = make_sharded_rollout(vec, random_policy(task), horizon,
                                       group, step_hook=track_step)
        state, _ = sharded_reset(vec, group)

    t0 = time.perf_counter()
    state, stats = rollout(None, state, gen)
    _sync(device)
    warmup_s = time.perf_counter() - t0

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, stats = rollout(None, state, gen)
        _sync(device)
        times.append(time.perf_counter() - t0)

    best = min(times) if times else warmup_s
    steps = batch * horizon
    out = {
        "env": name,
        "perturb": perturb,
        "solver": task.model.solver.solver,
        "batch": batch,
        "horizon": horizon,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "devices": n_dev,
        "env_steps_per_s": steps / best,
        "env_steps_per_s_per_chip": steps / best / n_dev,
        "substeps_per_s": steps * task.frame_skip / best,
        "warmup_s": warmup_s,
        "iter_times_s": times,
        "control_steps_run": horizon * (iters + 1),
        "episodes_seen": float(stats.episodes),
        "mean_return": float(stats.mean_return()),
        "mean_length": float(stats.mean_length()),
        "max_contact_overflow": float(track["overflow"]),
    }
    if perturb:
        # over every rollout, warm-up included
        n_sub = max(1, track["substeps"])
        out["pushed_substep_share"] = float(track["pushed_substeps"]) / n_sub
        out["pushed_env_share"] = float(track["env_share"]) / n_sub
    if return_state:
        out["state"] = state
        out["task"] = task
    return out


DR_SPEC = {"mass": 0.3, "geom_friction": 0.3, "damping": 0.3}


def bench_dr(name: str = "walker2d", batch: int = 4096, substeps: int = 400,
             iters: int = 5, device="cuda", seed: int = 0,
             force_phasewise: bool = False):
    """Throughput of a domain-randomized batch: per-env mass, friction and
    damping (DR_SPEC: each scaled per env by uniform(0.7, 1.3)), stepped
    `substeps` physics substeps under fixed random torques, after one
    warm-up run (which also builds the kernels).  force_phasewise skips
    the fused route (parallel/domain_rand.make_randomized_sim_step).  The
    env-steps/s divide the substeps by the task's frame_skip, so they are
    comparable to bench_env's control-step rate."""
    import numpy as np

    from dartenv_tpu_torch.engine.world import init_state
    from dartenv_tpu_torch.parallel.domain_rand import (
        make_randomized_sim_step, randomize_model,
    )

    device = torch.device(device)
    task = make_task(name, device=device)
    model = task.model
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bmodel = randomize_model(model, DR_SPEC, batch, gen)
    step = make_randomized_sim_step(model, list(DR_SPEC),
                                    force_phasewise=force_phasewise)
    state0 = init_state(model, batch, warm_start=task.warm_start)
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(rng.uniform(-1.0, 1.0, (batch, model.n)) * 50.0,
                          dtype=model.dtype, device=device)

    def roll():
        state = state0
        for _ in range(substeps):
            state, _ = step(bmodel, state, tau)
        return state

    t0 = time.perf_counter()
    out = roll()
    _sync(device)
    warmup_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = roll()
        _sync(device)
        times.append(time.perf_counter() - t0)
    best = min(times) if times else warmup_s
    return {
        "env": name, "batch": batch, "substeps": substeps,
        "frame_skip": task.frame_skip, "runs": iters + 1,
        "dr_fields": sorted(DR_SPEC), "kernel_path": not force_phasewise,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "env_steps_per_s": batch * substeps / task.frame_skip / best,
        "warmup_s": warmup_s, "iter_times_s": times,
        "finite_state": bool(torch.isfinite(out.q).all()
                             and torch.isfinite(out.dq).all()),
    }


def main():
    """python -m dartenv_tpu_torch.bench.throughput [--env walker2d]
    [--batch 4096 ...] [--horizon 100] [--iters 3] [--repeat 1]
    [--perturb] [--solver pgs|dantzig] [--escalate_ref64 N]
    [--device cuda]: one JSON line
    per (batch, repeat) with the card's name and power limit beside the
    rate.  The horizon
    defaults to 1000 for cartpole, 100 otherwise.  --dr measures bench_dr
    instead (400 substeps, or --substeps), and --dr_phasewise its
    phase-wise route."""
    import argparse
    import json
    import subprocess

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--env", default="walker2d", choices=sorted(_TASKS))
    ap.add_argument("--batch", type=int, nargs="+", default=[4096])
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--solver", default=None, choices=["pgs", "dantzig"],
                    help="override the task's LCP solver")
    ap.add_argument("--escalate_ref64", type=int, default=None,
                    help="passes of the escalation's mixed-precision "
                         "(float64 residual) refinement tier")
    ap.add_argument("--dr", action="store_true")
    ap.add_argument("--dr_phasewise", action="store_true")
    ap.add_argument("--substeps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card = "cpu"
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    horizon = args.horizon or (1000 if args.env == "cartpole" else 100)
    for batch in args.batch:
        for rep in range(args.repeat):
            if args.dr or args.dr_phasewise:
                out = bench_dr(args.env, batch=batch,
                               substeps=args.substeps, iters=args.iters,
                               device=args.device, seed=rep,
                               force_phasewise=args.dr_phasewise)
            else:
                out = bench_env(args.env, batch=batch, horizon=horizon,
                                iters=args.iters, device=args.device,
                                seed=rep, perturb=args.perturb,
                                solver=args.solver,
                                escalate_ref64=args.escalate_ref64)
            print(json.dumps({"card": card, "repeat": rep, **out}),
                  flush=True)


if __name__ == "__main__":
    main()
