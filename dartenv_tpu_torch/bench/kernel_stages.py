"""Where a launch of kernels 1 and 2 spends its time on the card.

    python -m dartenv_tpu_torch.bench.kernel_stages [--env walker2d]
        [--batch 4096] [--out out/kernel_stages.json]

On a batch of live states (control steps of the port's own rollout under
the random policy), it prints one JSON object with

  * kernel 1 (csrc/substep.cu) built with SS_STAMPS: the clock64() cycles
    of each stage of substep_body.h, per env (lane 0 of each warp stamps
    the end of each stage), beside the stamped launch's device time;
  * kernel 2's fused mode (csrc/bpp.cu) built with ES_STAMPS on the same
    batch's escalation: cycles per escalated env and stage, beside its
    device time.

Device times are the kernels' own, from torch.profiler over 20 launches.
The card's name and power limit are in the output.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

SS_STAGES = ("load_dynamics", "collision_compaction", "rows",
             "minv_jt_A_warm", "pgs", "residual_stores")
ES_STAGES = ("load", "rebuild", "tiers", "patch")


def device_ms(fn, name, runs=20):
    """Mean device time of the kernel whose name starts with `name`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.key.startswith(name) and ev.count:
            return ev.self_device_time_total / ev.count / 1e3
    return None


def live_batch(env, batch, steps=25):
    """(task, q, dq, tau, lam) after `steps` control steps of a rollout."""
    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    dev = torch.device("cuda")
    task = make_task(env, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    vec = VecEnv(task, batch, max_episode_steps=1000, generator=gen)
    state, _ = vec.reset()
    hi = torch.as_tensor(task.control_bounds[0], device=dev,
                         dtype=torch.float32)
    act = lambda: (torch.rand((batch, task.action_size), generator=gen,
                              device=dev) * 2 - 1) * hi
    for _ in range(steps):
        state, *_ = vec.step(state, act())
    tau = task.action_to_tau(act(), ())
    return task, state.sim.q, state.sim.dq, tau, state.sim.lam


def run(env="walker2d", batch=4096):
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_stages needs a CUDA device")
    task, q, dq, tau, lam = live_batch(env, batch)
    model, cfg = task.model, task.model.solver
    st = hs._SubStatic(model)

    stamped = hs.SubstepKernel(model, st)
    stamped._header += "#define SS_STAMPS 1\n"
    es_header = st.escalation_header + "#define ES_STAMPS 1\n"
    stamped.start_build()
    hb.load(st.m_c, hb.start_build(st.m_c, es_header), es_header)

    # ---- kernel 1, stage split -------------------------------------------
    cyc = (ctypes.c_ulonglong * len(SS_STAGES))()
    lib = stamped.load()
    lib.substep_stage_cycles.argtypes = [ctypes.c_void_p]
    stamped(q, dq, tau, lam)
    torch.cuda.synchronize()
    lib.substep_stage_cycles(cyc)               # clear the warm-up's
    outs = stamped(q, dq, tau, lam)
    torch.cuda.synchronize()
    assert lib.substep_stage_cycles(cyc) == len(SS_STAGES)
    per_env = {n: cyc[i] / batch for i, n in enumerate(SS_STAGES)}
    ss_split = dict(
        cycles_per_env=per_env, total_cycles_per_env=sum(per_env.values()),
        stamped_device_ms=device_ms(lambda: stamped(q, dq, tau, lam),
                                    "substep_kernel"))

    # ---- kernel 2, fused mode, stage split --------------------------------
    res = outs["res"][:, 0]
    K = hs.escalation_size(batch, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res, K)
    budgets = hb.tier_budgets(cfg.escalate_iters, cfg.escalate_refine,
                              cfg.escalate_iters2)
    fused = lambda: hb.bpp_fused(es_header, st.escalation_dims, outs["esc"],
                                 outs["dq_plus"], outs["lam_full"], idx,
                                 worst, st.findex_c, cfg.escalate_tol,
                                 budgets)
    blib = hb.load(st.m_c, header_text=es_header)
    blib.bpp_stage_cycles.argtypes = [ctypes.c_void_p]
    ecyc = (ctypes.c_ulonglong * len(ES_STAGES))()
    fused()
    torch.cuda.synchronize()
    blib.bpp_stage_cycles(ecyc)
    take = fused()[2]
    torch.cuda.synchronize()
    assert blib.bpp_stage_cycles(ecyc) == len(ES_STAGES)
    es_split = dict(
        K=K, taken=int(take.sum()),
        cycles_per_env={n: ecyc[i] / K for i, n in enumerate(ES_STAGES)},
        stamped_device_ms=device_ms(fused, "bpp_fused_kernel"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return {"env": env, "batch": batch, "card": smi,
            "substep_stages": ss_split, "escalate_stages": es_split}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--env", default="walker2d")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    text = json.dumps(run(args.env, args.batch), indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
