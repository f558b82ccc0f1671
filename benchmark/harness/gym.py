"""The gym driver: one caller in a closed loop of `env.step` calls on one
env of `make(env_id)`, and `env.reset()` whenever a step returns done.

Set-up: `make`, `seed`, `reset` and `warm_steps` steps (the first builds
and loads the kernels).  Window: `env.step` calls until `--seconds` have
passed, each timed by the host clock from before the call to its return
(each call ends in the host copy of its results), with the `reset()` that
follows a done added to that call's sample: `step_ms_p95` is the 95th
percentile of every sample of the window.  The calls that `sample_steps`
names keep the env's state before and after the call, the action and the
answers; every reset's state and obs are kept for the reset check.  A
`--trace 1` run profiles `trace_steps` calls from call `trace_at` on.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, common
from benchmark.harness.trace import read_slice, traced_slice
from benchmark.reference.env import RefEnv
from benchmark.traffic.generator import gym_actions, sample_steps
from benchmark.traffic.gym_seeding import reset_noises


def _state(env):
    s = env.unwrapped._state
    return dict(q=s.sim.q, dq=s.sim.dq, lam=s.sim.lam, steps=s.steps)


class ControlEnv:
    """The control: the reference in the program's place behind the gym
    calls, one env, its state, inputs and outputs held in bfloat16
    between substeps; its resets take the noise gym's seeding draws for
    `seed` (benchmark/traffic/gym_seeding.py)."""

    def __init__(self, cell, device):
        self.ref = RefEnv(cell.ref_config(), cell.skel_bytes(), cell.hooks,
                          device=device, dtype=torch.float32,
                          storage=torch.bfloat16)
        self.cap = cell.traffic["max_episode_steps"]
        self.unwrapped = self
        self._state = None

    def seed(self, seed):
        self.noises = reset_noises(seed, self.ref.model.n,
                                   float(self.ref.config["reset_noise"]))

    def _set(self, st):
        sim = SimpleNamespace(q=st["q"], dq=st["dq"], lam=st["lam"])
        self._state = SimpleNamespace(sim=sim, steps=st["steps"])
        self._dict = {k: st[k] for k in ("q", "dq", "lam", "steps")}

    def reset(self):
        st = self.ref.reset(torch.as_tensor(next(self.noises)))
        self._set(st)
        return st["obs"][0].double().cpu().numpy()

    def step(self, a):
        a = torch.as_tensor(np.asarray(a, dtype=np.float64))[None]
        out = self.ref.step(self._dict, a, None, None, self.cap)
        self._set(out)
        return (out["obs"][0].double().cpu().numpy(),
                float(out["reward"][0]), bool(out["done"][0]), {})


def run(cell, args, t0, device="cuda", control=False):
    import dartenv_tpu_torch as port

    tr = cell.traffic
    env = (ControlEnv(cell, device) if control
           else port.make(cell.config["env_id"], device=device))
    env.seed(int(args.seed))
    draw = gym_actions(cell.config, args.seed)
    resets = []
    max_resets = int(tr.get("check_resets", 64))

    def reset():
        obs0 = env.reset()
        if len(resets) < max_resets:
            s = _state(env)
            resets.append((s["q"], s["dq"],
                           torch.as_tensor(np.asarray(obs0))[None]))

    reset()
    for _ in range(int(tr["warm_steps"])):
        if env.step(draw())[2]:
            reset()
    if device != "cpu":
        torch.cuda.synchronize()
    common.steady_host()
    setup_s = time.perf_counter() - t0

    checks = set(sample_steps(tr, args.seed, dense=control))
    samples, times = [], []
    failed = [0]

    def one(k):
        a = draw()
        pre = _state(env) if k in checks else None
        t = time.perf_counter()
        obs, reward, done, _ = env.step(a)
        post = _state(env) if pre is not None else None
        if done:
            reset()
        times.append(time.perf_counter() - t)
        if not np.all(np.isfinite(obs)):
            failed[0] += 1
        if pre is not None:
            f = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
            samples.append(dict(
                pre=pre, inputs=(f(a)[None], None, None),
                post=dict(post, obs=f(obs)[None], terminal_obs=f(obs)[None],
                          reward=f([reward]), done=torch.tensor([done]))))

    trace_at = int(tr["trace_at"]) if args.trace else -1
    n_slice = int(tr["trace_steps"])
    sync = (torch.cuda.synchronize if device != "cpu" else (lambda: None))
    box = None
    start = time.perf_counter()
    k = 0
    last = max(checks)
    while (time.perf_counter() - start < args.seconds
           or (control and k <= last)):
        if k == trace_at:
            with traced_slice(sync, n_slice) as box:
                for _ in range(n_slice):
                    one(k)
                    k += 1
            del times[-n_slice:]
        else:
            one(k)
            k += 1
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

    metrics = {}
    if args.trace:
        if box is None:
            raise RuntimeError("the window ended before its traced slice")
        profile = read_slice(box)
        metrics = common.read_per_layer(cell, common.Context(cell, profile))
    else:
        ms = np.asarray(times) * 1e3
        metrics = {"step_ms_p95": {"value": float(np.percentile(ms, 95)),
                                   "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    del env
    common.release_host()

    ref = RefEnv(cell.ref_config(), cell.skel_bytes(), cell.hooks,
                 device="cpu",
                 dtype=getattr(torch, cell.config["reference_dtype"]))
    to_cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)
                        for k, v in d.items()}
    samples = [dict(pre=to_cpu(s["pre"]), inputs=s["inputs"],
                    post=to_cpu(s["post"])) for s in samples]
    t_ref = time.perf_counter()
    found = check.compare_batched(ref, samples, tr["max_episode_steps"])
    values = check.numbers(found)
    values["reset_gap_max"] = check.compare_resets(
        ref, [(q.cpu(), dq.cpu(), o) for q, dq, o in resets],
        reset_noises(args.seed, ref.model.n,
                     float(cell.config["reset_noise"])))
    correct, checks_out = check.judge(values, cell.limits)
    print(f"reference {time.perf_counter() - t_ref:.2f} s over "
          f"{len(samples)} samples; numbers {values}; per sample "
          f"{[] if found is None else found['gap'].tolist()}",
          file=sys.stderr)
    dev = (common.device_info(torch, 1, peak) if device != "cpu"
           else {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    out = dict(correct=correct, attempted=k, failed=failed[0],
               metrics=metrics, device=dev, checks=checks_out,
               samples=len(samples), values=values)
    if args.trace:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
        out["breakdown"] = profile.breakdown()
    return out
