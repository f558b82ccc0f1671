"""Where one control step's time goes on the card.

    python -m dartenv_tpu_torch.bench.profile_step [--env walker2d]
        [--batch 4096] [--steps 20] [--out out/profile_step.json]

Steps a batched env under the random policy for `--steps` control steps
inside torch.profiler and prints one JSON object: host wall time per
control step (from an un-profiled pass), device-busy time per control step
and its share of the wall time, device launches per control step, and the
kernels that take the most device time.  Needs a GPU (it measures nothing on a CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch


def profile(env="walker2d", batch=4096, steps=20, top=12):
    from torch.profiler import ProfilerActivity, profile as tprofile

    from dartenv_tpu_torch.bench.throughput import make_task, random_policy
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    dev = torch.device("cuda")
    task = make_task(env, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    vec = VecEnv(task, batch, max_episode_steps=1000, generator=gen)
    policy = random_policy(task)
    state, obs = vec.reset()
    for _ in range(10):                       # build kernels, warm caches
        state, obs, *_ = vec.step(state, policy(None, obs, gen))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):                    # un-profiled wall time
        state, obs, *_ = vec.step(state, policy(None, obs, gen))
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, obs, *_ = vec.step(state, policy(None, obs, gen))
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return {
        "env": env, "batch": batch, "control_steps": steps,
        "card": smi,
        "wall_ms_per_control_step": plain_wall_ms / steps,
        "device_busy_ms_per_control_step": dev_ms / steps,
        "device_busy_share": dev_ms / plain_wall_ms,
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
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--env", default="walker2d")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    res = profile(args.env, args.batch, args.steps)
    text = json.dumps(res, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
