"""Where a launch of each of the four kernels spends its time on the card.

    python -m dartenv_tpu_torch.bench.kernel_stages [--env walker2d]
        [--batch 4096] [--out out/kernel_stages.json]

On batches of live states (control steps of the port's own rollout under
the random policy), it prints one JSON object with

  * kernel 1 (csrc/substep.cu) built with SS_STAMPS: the clock64() cycles
    of each stage of substep_body.h, per env (lane 0 of each warp stamps
    the end of each stage), beside the stamped launch's device time;
  * kernel 2's fused mode (csrc/bpp.cu) built with ES_STAMPS on the same
    batch's escalation: cycles per escalated env and stage, beside its
    device time;
  * kernel 4 (csrc/pgs.cu) built with PG_STAMPS on the LCPs of the
    perturbed env's phase-wise step (about half of the envs pushed, 8
    sweeps + residual): cycles per env and stage;
  * kernel 3 (csrc/dynamics.cu) built with DY_STAMPS on the env's states
    and on cartpole at twice the batch (random states): cycles per warp
    and stage (the latency of the stage as lane 0 of a warp sees it);
  * the unstamped kernels' device times (`device_ms`) and their wrappers'
    times (`wrapper_ms`, CUDA events, allocation and ctypes call
    included) at the same shapes;
  * for a model with a BALL or FREE joint, the position-update kernel
    (csrc/integrate.cu) on the batch's (q, dq): device and wrapper times,
    its plain version's time, its largest gap to the plain version and its
    registers (`integrate`; null for other models).

Device times are the kernels' own, from torch.profiler over 20 launches.
The card's name and power limit are in the output.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

import numpy as np
import torch

SS_STAGES = ("load_dynamics", "collision_compaction", "rows",
             "minv_jt_A_warm", "pgs", "residual_stores")
ES_STAGES = ("load", "rebuild", "tiers", "patch")
PG_STAGES = ("load", "sweeps", "residual", "stores")
DY_STAGES = ("load", "joint_kinematics", "tree_composition", "phi",
             "mass_matrix", "bias_forces", "solve", "stores")
# torch.profiler at times reports no device event for all launches of a
# profile (seen on one-block launches late in chip_smoke.py's run, not
# alone), so device_ms takes up to this many profiles.
PROFILE_TRIES = 3


def device_ms(fn, name, runs=20):
    """Mean device time of the kernel whose name contains `name`, or None
    when none of PROFILE_TRIES profiles caught it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if name in ev.key and ev.count:
                return ev.self_device_time_total / ev.count / 1e3
    return None


def wrapper_ms(fn, runs=20, warmup=3):
    """Median time of fn() in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def stage_split(lib_fn, names, launch, per):
    """Run `launch` twice (the first clears the warm-up's cycles) and
    return the second's cycles per unit of `per` for each stage."""
    cyc = (ctypes.c_ulonglong * len(names))()
    lib_fn.argtypes = [ctypes.c_void_p]
    launch()
    torch.cuda.synchronize()
    lib_fn(cyc)
    launch()
    torch.cuda.synchronize()
    assert lib_fn(cyc) == len(names)
    split = {n: cyc[i] / per for i, n in enumerate(names)}
    return dict(cycles=split, total_cycles=sum(split.values()))


def live_batch(env, batch, steps=25):
    """(task, q, dq, tau, lam) after `steps` control steps of a rollout."""
    from dartenv_tpu_torch.envs.tasks import make_task
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


def perturbed_lcps(task, q, dq, tau, lam_prev, seed=1):
    """The boxed LCPs of the phase-wise step with about half of the envs
    pushed by the task's perturbation force along +-x or +-y, assembled
    as engine/world.make_sim_step assembles them.  Returns (A, b, lo, hi,
    findex, mu, act, lam0)."""
    from dartenv_tpu_torch.collision.narrowphase import collide
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.engine.constraints import (
        assemble_lcp, build_layout, compact_lam,
    )

    model, B, dev = task.model, q.shape[0], q.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    _, mag, body, _ = task.perturbation_parameters
    on = (torch.rand(B, generator=gen, device=dev) < 0.5).float()
    axis = torch.randint(0, 2, (B,), generator=gen, device=dev)
    sign = torch.randint(0, 2, (B,), generator=gen, device=dev) * 2.0 - 1.0
    f_ext = torch.zeros((B, model.nb, 6), device=dev)
    f_ext[torch.arange(B, device=dev), body, 3 + axis] = sign * mag * on
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, model.dt,
                                      f_ext)
    dq_star = dq + model.dt * ddq
    contacts = collide(model, kin.R_w, kin.p_w)
    A, b, lo, hi, act, mu, findex, _, row_sel, _ = assemble_lcp(
        model, build_layout(model), kin.phi, M, q, dq, dq_star, contacts,
        model.dt)
    return A, b, lo, hi, findex, mu, act, compact_lam(lam_prev, row_sel,
                                                      act)


def random_states(model, B, seed=0):
    """(q, dq, tau): q_init + U(-0.3, 0.3), dq ~ U(-2, 2), tau ~
    U(-50, 50), float32 on the card."""
    rng = np.random.default_rng(seed)
    n = model.n
    q = model.q_init.cpu().numpy()[None] + rng.uniform(-0.3, 0.3, (B, n))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device="cuda")
    return (f(q), f(rng.uniform(-2.0, 2.0, (B, n))),
            f(rng.uniform(-50.0, 50.0, (B, n))))


def substep_and_escalate(task, q, dq, tau, lam, batch):
    """Kernel 1's stage split and device times; kernel 2's fused mode's
    stage split on the same batch's escalation."""
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb

    model, cfg = task.model, task.model.solver
    st = hs._SubStatic(model)
    plain = hs.get_substep_kernel(model)
    stamped = hs.SubstepKernel(model, st)
    stamped._header += "#define SS_STAMPS 1\n"
    es_header = st.escalation_header + "#define ES_STAMPS 1\n"
    stamped.start_build()
    plain.start_build()
    hb.load(st.m_c, hb.start_build(st.m_c, es_header), es_header)

    run = lambda k: (lambda: k(q, dq, tau, lam))
    split = stage_split(stamped.load().substep_stage_cycles, SS_STAGES,
                        run(stamped), batch)
    outs = plain(q, dq, tau, lam)
    ss = dict(split, stamped_device_ms=device_ms(run(stamped),
                                                 "substep_kernel"),
              device_ms=device_ms(run(plain), "substep_kernel"),
              wrapper_ms=wrapper_ms(run(plain)))

    res = outs["res"][:, 0]
    K = hs.escalation_size(batch, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res, K)
    budgets = hb.tier_budgets(cfg.escalate_iters, cfg.escalate_refine,
                              cfg.escalate_iters2, cfg.escalate_ref)
    fused = lambda: hb.bpp_fused(es_header, st.escalation_dims, outs["esc"],
                                 outs["dq_plus"], outs["lam_full"], idx,
                                 worst, st.findex_c, cfg.escalate_tol,
                                 budgets)
    blib = hb.load(st.m_c, header_text=es_header)
    es = dict(stage_split(blib.bpp_stage_cycles, ES_STAGES, fused, K), K=K,
              stamped_device_ms=device_ms(fused, "bpp_fused_kernel"))
    return ss, es


def pgs_split(task, states, batch):
    """Kernel 4 on the perturbed env's LCPs: stage split (stamped build
    swapped in for the two stamped launches) and times."""
    from dartenv_tpu_torch import cuda_build
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    A, b, lo, hi, findex, mu, act, lam0 = perturbed_lcps(task, *states)
    cfg = task.model.solver
    run = lambda: hp.pgs_solve_cuda(A, b, lo, hi, findex, mu, act,
                                    iters=cfg.pgs_iters,
                                    omega=cfg.pgs_omega, lam0=lam0,
                                    return_residual=True)
    plain_lib = hp.load()
    out = dict(B=batch, m=int(b.shape[1]), iters=cfg.pgs_iters,
               device_ms=device_ms(run, "pgs_kernel"), wrapper_ms=wrapper_ms(run))
    stamped = cuda_build.finish_build(cuda_build.start_build(
        "dartenv_pgs_stamped", "pgs.cu", deps=("pgs_row.h",),
        defines=("PG_STAMPS",)))
    hp.bind(stamped)
    hp._LIB = stamped
    try:
        out.update(stage_split(stamped.pgs_stage_cycles, PG_STAGES, run,
                               batch))
        out["stamped_device_ms"] = device_ms(run, "pgs_kernel")
    finally:
        hp._LIB = plain_lib
    return out


def dynamics_split(model, q, dq, tau):
    """Kernel 3 on (q, dq, tau): stage split per warp and times."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    B = q.shape[0]
    plain = hd.get_dynamics_kernel(model)
    stamped = hd.DynamicsKernel(model)
    stamped._header += "#define DY_STAMPS 1\n"
    stamped.start_build()
    plain.start_build()
    run = lambda k: (lambda: k(q, dq, tau))
    lib = stamped.load()
    warps = B * getattr(stamped, "group", 1) / 32
    out = dict(B=B, n=model.n, nb=model.nb, warps=warps,
               device_ms=device_ms(run(plain), "dynamics_kernel"),
               wrapper_ms=wrapper_ms(run(plain)))
    out.update(stage_split(lib.dynamics_stage_cycles, DY_STAGES,
                           run(stamped), max(warps, 1)))
    out["stamped_device_ms"] = device_ms(run(stamped), "dynamics_kernel")
    return out


def integrate_times(model, q, dq):
    """The position-update kernel (csrc/integrate.cu) on (q, dq): device
    and wrapper times, its plain version's wrapper time, the largest
    |x - x_plain| / (1 + |x_plain|) and the compiler's register report."""
    from dartenv_tpu_torch import cuda_build
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi

    dt = model.dt
    kern = lambda: hi.integrate_cuda(model, q, dq, dt)
    plain = lambda: batched.integrate_positions(model, q, dq, dt)
    got, ref = kern(), plain()          # the first call builds and loads
    err = ((got - ref).abs() / (1.0 + ref.abs())).max()
    log = cuda_build.build_log(hi.start_build())
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return dict(B=int(q.shape[0]), n=model.n,
                joints=int(hi.joint_table(model).shape[0]),
                device_ms=device_ms(kern, "integrate_kernel"),
                wrapper_ms=wrapper_ms(kern),
                plain_wrapper_ms=wrapper_ms(plain),
                max_rel_err=float(err), ptxas=ptxas)


def run(env="walker2d", batch=4096):
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi
    from dartenv_tpu_torch.envs.tasks import make_task

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_stages needs a CUDA device")
    task, q, dq, tau, lam = live_batch(env, batch)
    ss, es = substep_and_escalate(task, q, dq, tau, lam, batch)
    pg = pgs_split(task, (q, dq, tau, lam), batch)
    dy = {env: dynamics_split(task.model, q, dq, tau)}
    ig = None
    if hi.has_rotations(task.model):
        ig = integrate_times(task.model, q, dq)
    cart = make_task("cartpole", device="cuda").model
    dy["cartpole"] = dynamics_split(cart, *random_states(cart, 2 * batch))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    return {"env": env, "batch": batch, "card": smi,
            "substep_stages": ss, "escalate_stages": es,
            "pgs_stages": pg, "dynamics_stages": dy, "integrate": ig}


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
