"""The batched driver: a closed loop of `VecEnv.step` calls over B envs.

Set-up: the env on the card, the first inputs, `warm_steps` control steps
(the first builds and loads this configuration's kernels).  Window: one
control step after another until `--seconds` have passed, each with
inputs drawn from the seed; the window ends at a synchronization after
the last step, and `env_steps_per_s` is B times the steps over its length.
The steps that `sample_steps` names keep references to their state before
the step, their inputs and the program's answers (the step is functional,
so nothing is copied in the window).  A `--trace 1` run profiles
`trace_steps` control steps from step `trace_at` on, and after the window
runs the residual pass (`residual_substeps` substeps through the envelope
hook beside the program's own substep).  Then the program is freed and the
reference checks the samples.
"""
from __future__ import annotations

import contextlib
import sys
import time

import torch

from benchmark.harness import check, common
from benchmark.harness.trace import read_slice, traced_slice
from benchmark.reference.env import RefEnv
from benchmark.traffic.generator import Inputs, sample_steps


class ProgramSide:
    """The port: `make(env_id)`'s task stepped by `VecEnv`."""

    def __init__(self, cell, device):
        import dartenv_tpu_torch as port
        from dartenv_tpu_torch.parallel.vec_env import VecEnv

        task = port.make(cell.config["env_id"], device=device).unwrapped.task
        pushes = cell.traffic.get("pushes")
        if pushes is not None:
            task.add_perturbation = True
            task.perturbation_parameters = tuple(pushes)
        self.task = task
        self.venv = VecEnv(task, cell.batch,
                           max_episode_steps=cell.traffic["max_episode_steps"],
                           auto_reset=True)

    def reset(self, noise):
        return self.venv.reset(noise)

    def step(self, state, a, rn, pn):
        state, obs, reward, done, info = self.venv.step(
            state, a, reset_noise=rn, perturb_noise=pn)
        return state, dict(obs=obs, reward=reward, done=done,
                           terminal_obs=info["terminal_obs"])

    @staticmethod
    def view(state):
        out = dict(q=state.sim.q, dq=state.sim.dq, lam=state.sim.lam,
                   steps=state.steps)
        if isinstance(state.aux, dict):
            out.update(state.aux)
        return out


class ControlSide:
    """The control: the reference in the program's place, its state,
    inputs and outputs held in bfloat16 between substeps."""

    def __init__(self, cell, device):
        self.cap = cell.traffic["max_episode_steps"]
        self.ref = RefEnv(cell.ref_config(), cell.skel_bytes(), cell.hooks,
                          device=device, dtype=torch.float32,
                          storage=torch.bfloat16)
        self.keys = None

    def reset(self, noise):
        st = self.ref.reset(noise)
        self.keys = [k for k in st if k != "obs"]
        return {k: st[k] for k in self.keys}, st["obs"]

    def step(self, state, a, rn, pn):
        out = self.ref.step(state, a, rn, pn, self.cap)
        return {k: out[k] for k in self.keys}, out

    @staticmethod
    def view(state):
        return state


def residual_pass(side, state, inputs, substeps):
    """`substeps` substeps of the window's last state with the cell's own
    policy, each through the envelope hook (validation/residual.
    make_envelope_substep) and through the program's own sim step on the
    same inputs.  Returns (res_pre, envelope) pooled over envs and
    substeps, and the substeps at which the two paths' states differ."""
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.validation.residual import make_envelope_substep

    task = side.task
    model = task.model
    sub, real = make_envelope_substep(model), make_sim_step(model)
    q, dq, lam = state.sim.q, state.sim.dq, state.sim.lam
    pre, env, differ = [], [], 0
    for k in range(substeps):
        if k % task.frame_skip == 0:
            tau = task.action_to_tau(inputs.actions(), state.aux)
        q2, dq2, lam2, diag = sub(q, dq, lam, tau)
        st2, _ = real(SimState(q=q, dq=dq, time=state.sim.time, lam=lam),
                      tau)
        if not (torch.equal(q2, st2.q) and torch.equal(dq2, st2.dq)
                and torch.equal(lam2, st2.lam)):
            differ += 1
        pre.append(diag["res_pre"])
        env.append(diag["envelope"])
        q, dq, lam = q2, dq2, lam2
    return torch.cat(pre), torch.cat(env), differ


def run(cell, args, t0, device="cuda", control=False):
    """One run of a batched cell; returns the result's fields as a dict."""
    tr = cell.traffic
    side = (ControlSide if control else ProgramSide)(cell, device)
    inputs = Inputs(cell.config, tr, args.seed, device)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    noise0 = inputs.reset_noise()
    state, obs0 = side.reset(noise0)
    start_view = dict(side.view(state), obs=obs0)
    for _ in range(int(tr["warm_steps"])):
        state, _ = side.step(state, *inputs.step())
    sync()
    common.steady_host()
    setup_s = time.perf_counter() - t0

    rf = (torch.profiler.record_function if args.trace
          else (lambda name: contextlib.nullcontext()))
    checks = set(sample_steps(tr, args.seed, dense=control))
    samples = []
    failed = torch.zeros((), dtype=torch.int64, device=device)

    def one(k):
        nonlocal state, failed
        with rf("bench_inputs"):
            a, rn, pn = inputs.step()
        pre = side.view(state) if k in checks else None
        state, out = side.step(state, a, rn, pn)
        with rf("bench_count"):
            failed = failed + (~torch.isfinite(out["terminal_obs"]).all(1)
                               ).sum()
        if pre is not None:
            samples.append(dict(pre=pre, inputs=(a, rn, pn),
                                post=dict(side.view(state), **out)))

    trace_at = int(tr["trace_at"]) if args.trace else -1
    n_slice = int(tr["trace_steps"])
    box = None
    start = time.perf_counter()
    stamps = [start]
    k = 0
    last = max(checks)
    while (time.perf_counter() - start < args.seconds
           or (control and k <= last)):
        if k == trace_at:
            with traced_slice(sync, n_slice) as box:
                for _ in range(n_slice):
                    one(k)
                    k += 1
        else:
            one(k)
            k += 1
        if k % 100 == 0:
            stamps.append(time.perf_counter())
    sync()
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    rate = cell.batch * k / window_s
    per = [round(100 * cell.batch / (b - a)) for a, b in zip(stamps, stamps[1:])]
    print(f"window: {k} steps in {window_s:.3f} s; env-steps/s of each 100 "
          f"steps as enqueued: {per}", file=sys.stderr)
    failed = int(failed)

    metrics = {}
    residual = differ = None
    if args.trace:
        if box is None:
            raise RuntimeError("the window ended before its traced slice")
        sub = int(tr.get("residual_substeps", 0))
        if sub and not control and tr.get("pushes") is None:
            res_pre, env, differ = residual_pass(side, state, inputs, sub)
            residual = dict(res_pre=res_pre, envelope=env)
        profile = read_slice(box)
        metrics = common.read_per_layer(
            cell, common.Context(cell, profile, residual))
    else:
        metrics = {"env_steps_per_s": {"value": rate,
                                       "unit": cell.end_to_end[
                                           "env_steps_per_s"]["unit"]},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    del side, state
    common.release_host()
    if device != "cpu":
        torch.cuda.empty_cache()

    ref = RefEnv(cell.ref_config(), cell.skel_bytes(), cell.hooks,
                 device=device,
                 dtype=getattr(torch, cell.config["reference_dtype"]))
    t_ref = time.perf_counter()
    found = check.compare_batched(ref, samples, tr["max_episode_steps"])
    values = check.numbers(found)
    values["reset_gap_max"] = max(values.get("reset_gap_max", 0.0),
                                  check.compare_start(ref, start_view,
                                                      noise0))
    correct, checks_out = check.judge(values, cell.limits)
    print(f"reference {time.perf_counter() - t_ref:.2f} s over "
          f"{len(samples)} samples; numbers {values}", file=sys.stderr)
    if differ is not None:
        checks_out["hook_vs_path_substeps"] = {"value": differ, "limit": 0}
        correct = correct and differ == 0
    dev = (common.device_info(torch, 1, peak) if device != "cpu"
           else {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": 0})
    out = dict(correct=correct, attempted=cell.batch * k, failed=failed,
               metrics=metrics, device=dev, checks=checks_out,
               samples=len(samples), values=values)
    if args.trace:
        dev["busy_s"] = profile.busy_s
        dev["window_s"] = profile.window_s
        out["breakdown"] = profile.breakdown()
    return out
