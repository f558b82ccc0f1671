"""Throughput of the batched env step under a random policy.

Every entry point takes an explicit `device` (default "cuda") and fails on
a machine without one rather than measuring the CPU: a CPU timing says
nothing about the port.  Tests pass device="cpu" to check control flow.

The CLI is the JAX package's bench CLI with its knobs (`--all` over
BASELINE_CONFIGS, `--cold`, the solver overrides, `--profile_dir`) and
prints, after the port's detailed JSON line, the JAX CLI's one-line
metric with the card beside it.
"""
from __future__ import annotations

import dataclasses
import os
import time

import torch

from dartenv_tpu_torch.envs.tasks import _TASKS, make_task

# The JAX bench's anecdotal single-core CPU estimate of the reference
# stack's speed (its SURVEY.md section 6; the reference publishes no
# number): the denominator of `vs_baseline`, not a measurement.
REFERENCE_CPU_STEPS_PER_S = 5000.0

# the JAX bench's five configs (env, batch, horizon): humanwalker's batch
# is smaller for its 29 dofs x frame_skip 15; cartpole runs a 1000-step
# horizon so that one timed rollout is not one short call
BASELINE_CONFIGS = (("cartpole", 8192, 1000), ("reacher", 4096, 100),
                    ("hopper", 4096, 100), ("walker2d", 4096, 100),
                    ("humanwalker", 1024, 100))


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


def profile_rollout(rollout, state, gen, device, profile_dir, tag):
    """One rollout under torch.profiler (CPU activity, and CUDA activity on
    a CUDA device); its Chrome trace goes to
    `profile_dir`/`tag`.trace.json.  Returns the rollout's (state,
    stats)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        state, stats = rollout(None, state, gen)
        _sync(device)
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"{tag}.trace.json"))
    return state, stats


def bench_env(name: str = "walker2d", batch: int = 4096,
              horizon: int = 100, iters: int = 5,
              max_episode_steps: int = 1000, device="cuda", seed: int = 0,
              return_state: bool = False, perturb: bool = False,
              solver=None, group=None, profile_dir=None,
              warm_start: bool = True, solver_overrides=None):
    """Returns a dict with env-steps/s and timing detail of `iters`
    rollouts of `horizon` control steps after one warm-up rollout (which
    also builds the kernels); with iters=0 the rate is the warm-up's.
    `perturb` turns on the task's random perturbation pushes; `solver`
    ("pgs" or "dantzig", None: the task's own) picks the LCP solver;
    `warm_start=False` starts every substep's LCP cold; `solver_overrides`
    ({SolverConfig field: value}) go to the task factory, which applies
    them with envs/base.with_solver over its own settings (a new pgs_iters
    or refinement tier builds its own kernels).  With `profile_dir`, one
    more rollout after the warm-up runs under torch.profiler (CPU and, on
    the card, CUDA activity) and its Chrome trace is written into that
    directory (`profile_trace`), with the engine's named ranges
    (engine/world.py).  With a process `group`
    (parallel/sharding.py) the batch is split over its ranks, each
    stepping its slice on its own device, and the episode totals are
    summed over the group; `devices` is the group's size and
    `env_steps_per_s_per_chip` the rate over it."""
    from dartenv_tpu_torch.engine.hopper_substep import escalation_size
    from dartenv_tpu_torch.parallel.rollout import make_rollout
    from dartenv_tpu_torch.parallel.sharding import (
        group_shape, make_sharded_rollout, sharded_reset,
    )
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    device = torch.device(device)
    task = make_task(name, device=device, lcp_solver=solver,
                     **(solver_overrides or {}))
    task.add_perturbation = perturb
    if not warm_start:
        task.warm_start = False
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

    trace = None
    if profile_dir:
        state, stats = profile_rollout(rollout, state, gen, device,
                                       profile_dir, f"{name}_B{batch}")
        trace = os.path.join(profile_dir, f"{name}_B{batch}.trace.json")

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, stats = rollout(None, state, gen)
        _sync(device)
        times.append(time.perf_counter() - t0)

    best = min(times) if times else warmup_s
    steps = batch * horizon
    cfg = task.model.solver
    out = {
        "env": name,
        "perturb": perturb,
        "solver": cfg.solver,
        "warm_start": task.warm_start,
        "solver_config": dataclasses.asdict(cfg),
        "escalation_k": (escalation_size(batch, cfg.escalate_frac,
                                         cfg.escalate_kmax)
                         if cfg.escalate_frac > 0 else 0),
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
        "control_steps_run": horizon * (iters + 1 + bool(profile_dir)),
        "profile_trace": trace,
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
        "nonfinite_envs": int((~(torch.isfinite(out.q).all(1)
                                 & torch.isfinite(out.dq).all(1))).sum()),
    }


# SolverConfig overrides of the CLI: flag -> field
_OVERRIDES = ("pgs_iters", "escalate_frac", "escalate_iters",
              "escalate_iters2", "escalate_refine", "escalate_kmax",
              "escalate_ref64", "escalate_ref")


def card_name(device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card ("cpu" for a
    CPU device): written beside every rate."""
    import subprocess

    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, check=True,
        text=True).stdout.strip().splitlines()[0]


def metric_line(kind, env, batch, per_chip, card, suffix=""):
    """The JAX bench CLI's one-line metric, with the card beside it."""
    return {
        "metric": f"env-steps/s/chip ({kind} Dart{env.capitalize()}, "
                  f"B={batch}{suffix})",
        "value": round(per_chip, 1),
        "unit": "env-steps/s/chip",
        "vs_baseline": round(per_chip / REFERENCE_CPU_STEPS_PER_S, 2),
        "card": card,
    }


def main(argv=None):
    """python -m dartenv_tpu_torch.bench.throughput [--env walker2d]
    [--all] [--batch 4096 ...] [--horizon H] [--iters 5] [--repeat 1]
    [--perturb] [--solver pgs|dantzig] [--cold] [--pgs_iters N]
    [--escalate_frac F] [--escalate_iters N] [--escalate_iters2 N]
    [--escalate_refine N] [--escalate_kmax N] [--escalate_ref64 N]
    [--escalate_ref N] [--profile_dir DIR] [--verbose]
    [--dr [--dr_phasewise | --dr_xla] [--substeps 400]] [--device cuda]:
    per (config, batch, repeat) the detailed JSON line (with the card's
    name and power limit; indented with --verbose), then the JAX CLI's
    metric line.  The horizon defaults to 1000 for cartpole, 100
    otherwise; --all runs the five BASELINE_CONFIGS at their own batch
    and horizon (--horizon overrides).  --dr measures bench_dr instead
    (400 substeps, or --substeps), and --dr_phasewise (alias --dr_xla,
    the JAX flag) its phase-wise route.  Returns the [(detail,
    metric line)] of the runs."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--env", default="walker2d", choices=sorted(_TASKS))
    ap.add_argument("--all", action="store_true",
                    help="run the five BASELINE_CONFIGS in turn")
    ap.add_argument("--batch", type=int, nargs="+", default=[4096])
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--perturb", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of one rollout here")
    ap.add_argument("--solver", default=None, choices=["pgs", "dantzig"],
                    help="override the task's LCP solver")
    ap.add_argument("--cold", action="store_true",
                    help="no LCP warm start (cold start every substep)")
    ap.add_argument("--pgs_iters", type=int, default=None,
                    help="override the task's PGS sweeps")
    ap.add_argument("--escalate_frac", type=float, default=None,
                    help="override the escalated share (0 disables)")
    ap.add_argument("--escalate_iters", type=int, default=None,
                    help="tier-1 escalation pivot budget")
    ap.add_argument("--escalate_iters2", type=int, default=None,
                    help="tier-2 cold re-solve pivot budget (0 disables)")
    ap.add_argument("--escalate_refine", type=int, default=None,
                    help="tier-1 refinement pivots (-1: the default count)")
    ap.add_argument("--escalate_kmax", type=int, default=None,
                    help="cap on the escalated batch K")
    ap.add_argument("--escalate_ref64", type=int, default=None,
                    help="passes of the mixed-precision (float64 residual) "
                         "refinement tier")
    ap.add_argument("--escalate_ref", type=int, default=None,
                    help="passes of the compensated refinement tier")
    ap.add_argument("--dr", action="store_true",
                    help="bench a domain-randomized batch (bench_dr)")
    ap.add_argument("--dr_phasewise", "--dr_xla", action="store_true",
                    help="with --dr: the phase-wise route")
    ap.add_argument("--substeps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    card = card_name(args.device)
    overrides = {f: getattr(args, f) for f in _OVERRIDES
                 if getattr(args, f) is not None} or None
    if args.all:
        configs = [(e, [b], args.horizon or h)
                   for e, b, h in BASELINE_CONFIGS]
    else:
        configs = [(args.env, args.batch, args.horizon or (
            1000 if args.env == "cartpole" else 100))]
    runs = []
    for env, batches, horizon in configs:
        for batch in batches:
            for rep in range(args.repeat):
                if args.dr or args.dr_phasewise:
                    out = bench_dr(env, batch=batch, substeps=args.substeps,
                                   iters=args.iters, device=args.device,
                                   seed=rep,
                                   force_phasewise=args.dr_phasewise)
                    line = metric_line(
                        "DR", env, batch, out["env_steps_per_s"], card,
                        ", kernel" if out["kernel_path"] else ", phasewise")
                else:
                    out = bench_env(env, batch=batch, horizon=horizon,
                                    iters=args.iters, device=args.device,
                                    seed=rep, perturb=args.perturb,
                                    solver=args.solver,
                                    profile_dir=args.profile_dir,
                                    warm_start=not args.cold,
                                    solver_overrides=overrides)
                    line = metric_line("batched", env, batch,
                                       out["env_steps_per_s_per_chip"], card)
                detail = {"card": card, "repeat": rep, **out}
                print(json.dumps(detail, indent=2 if args.verbose else None),
                      flush=True)
                print(json.dumps(line), flush=True)
                runs.append((detail, line))
    return runs


if __name__ == "__main__":
    main()
