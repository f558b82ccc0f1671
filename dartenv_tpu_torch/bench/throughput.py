"""Throughput of the batched env step under a random policy.

Every entry point takes an explicit `device` (default "cuda") and fails on
a machine without one rather than measuring the CPU: a CPU timing says
nothing about the port.  Tests pass device="cpu" to check control flow.
"""
from __future__ import annotations

import time

import torch

_TASKS = {
    "hopper": ("dartenv_tpu_torch.envs.hopper", "make_hopper_task"),
    "walker2d": ("dartenv_tpu_torch.envs.walker2d", "make_walker2d_task"),
}


def make_task(name: str, dtype=torch.float32, device="cuda", **solver_kw):
    """The named task on `device`; `solver_kw` overrides SolverConfig
    fields (and `lcp_solver`), as the task factories take them."""
    import importlib

    mod, fn = _TASKS[name]
    return getattr(importlib.import_module(mod), fn)(
        dtype=dtype, device=device, **solver_kw)


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


def bench_env(name: str = "walker2d", batch: int = 4096,
              horizon: int = 100, iters: int = 5,
              max_episode_steps: int = 1000, device="cuda", seed: int = 0,
              return_state: bool = False):
    """Returns a dict with env-steps/s and timing detail of `iters`
    rollouts of `horizon` control steps after one warm-up rollout (which
    also builds the kernels)."""
    from dartenv_tpu_torch.parallel.rollout import make_rollout
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    device = torch.device(device)
    task = make_task(name, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vec = VecEnv(task, num_envs=batch, max_episode_steps=max_episode_steps,
                 generator=gen)
    overflow = [torch.zeros((), dtype=task.model.dtype, device=device)]

    def track_overflow(info):
        overflow[0] = torch.maximum(overflow[0],
                                    info["contact_overflow"].max())

    rollout = make_rollout(vec, random_policy(task), horizon,
                           step_hook=track_overflow)
    state, _ = vec.reset()

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
        "batch": batch,
        "horizon": horizon,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "env_steps_per_s": steps / best,
        "substeps_per_s": steps * task.frame_skip / best,
        "warmup_s": warmup_s,
        "iter_times_s": times,
        "control_steps_run": horizon * (iters + 1),
        "episodes_seen": float(stats.episodes),
        "mean_return": float(stats.mean_return()),
        "max_contact_overflow": float(overflow[0]),
    }
    if return_state:
        out["state"] = state
        out["task"] = task
    return out


def main():
    """python -m dartenv_tpu_torch.bench.throughput [--env walker2d]
    [--batch 4096 ...] [--horizon 100] [--iters 3] [--repeat 1]
    [--device cuda]: one JSON line per (batch, repeat) with the card's
    name and power limit beside the rate."""
    import argparse
    import json
    import subprocess

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--env", default="walker2d", choices=sorted(_TASKS))
    ap.add_argument("--batch", type=int, nargs="+", default=[4096])
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card = "cpu"
    if torch.device(args.device).type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for batch in args.batch:
        for rep in range(args.repeat):
            out = bench_env(args.env, batch=batch, horizon=args.horizon,
                            iters=args.iters, device=args.device, seed=rep)
            print(json.dumps({"card": card, "repeat": rep, **out}),
                  flush=True)


if __name__ == "__main__":
    main()
