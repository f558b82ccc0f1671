#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts on a GPU.

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  python3 chip_smoke.py

It builds the port's five CUDA kernels from dartenv_tpu_torch/csrc (every
build it needs, all nvcc processes started together) and then, in
float32:

  * for DartWalker2d and DartHopper at B = 4096, DartWalker3d and DartDog
    at B = 4096 and DartHumanWalker at B = 1024 (the fused-substep path):
    the substep kernel and the BPP kernel's core mode against their plain
    PyTorch versions at that path's shapes; the escalation stage (the BPP
    kernel's fused mode, one launch; humanwalker's with its compensated
    refinement tier, dog's with 32 + 2 pivots) against its plain version
    on the same substep outputs, and for walker2d once more with a cold
    tier 2; the kernel path and a plain path composed here in lockstep
    (B = 1024); for DartReacher and DartReacher2d (limit rows, no contact,
    no escalation) and DartSnake7Link (14 contact slots, no compaction, no
    escalation; also on a raised ground, where its contacts are live) at
    B = 4096 the substep kernel and the lockstep;
  * the position-update kernel (dynamics/hopper_integrate) against its
    plain version batched.integrate_positions on the rollout states of
    humanwalker (B = 1024), walker3d and dog (B = 4096) and on the
    multi-skeleton world's (its FREE box): linear columns to the bit,
    rotation and translation columns within INTEGRATE_TOL (phase
    integrate); its launches are counted on every path below, one a
    substep of a model with a BALL or FREE joint, and the plain version's
    runs, one a substep of any other model;
  * the dynamics kernel against its plain version on cartpole and the
    double pendulum at B = 8192, on walker2d states at B = 4096 and on two
    ModelBuilder chains that hold the six joint types the substep kernel
    lacks, at B = 1024; on cartpole at B = 8191 and walker2d states at
    B = 4095, whose last block is partly filled;
  * the PGS kernel against its plain version on the LCPs of perturbed
    walker2d's phase-wise step and on random LCPs of 40 rows at B = 4096
    and of perturbed humanwalker's (41 rows) at B = 1024; the BPP kernel's
    core mode on walker2d's hybrid top K and its hybrid mode (the whole
    escalation, one launch; humanwalker's with two refinement passes)
    against their plain versions on both, and the hybrid mode above 32
    rows on the escalated LCPs of walker3d, dog and humanwalker;
  * the BPP kernel's core mode over whole batches, as the solver="dantzig"
    mode runs it, on the phase-wise LCPs of walker2d (B = 4096, 24 rows),
    walker3d (4096, 36) and humanwalker (1024, 41) against its plain
    version;
  * lockstep control steps of cartpole and of perturbed walker2d at
    B = 1024 beside plain paths composed here, and one substep of
    walker2d's solver="dantzig" mode (the dynamics kernel, then the BPP
    kernel's core mode over the batch);
  * each path (bench_env: batched rollout under a random policy) with
    every kernel's launch counter and plain-call counter set to 0 just
    before it and read just after: walker2d and hopper, cartpole at
    B = 8192 for 1000 control steps, perturbed walker2d at B = 4096 for 100,
    reacher, walker3d, dog, snake7link, reacher2d and walker2d in the
    solver="dantzig" mode at B = 4096 for 100, humanwalker at B = 1024 for
    100 and perturbed humanwalker at B = 1024 for 15 (the first rollout of
    each path is bench_env's warm-up);
  * per escalating contact model, the residual envelope after the
    escalation (median, p95, max over the substeps of a kernel-path
    rollout, through escalate_batch's with_diag hook) beside the JAX
    harness's bounds (a finding; it does not gate), the first substep's
    record held against the plain route's;
  * domain randomization (phase dr): the substep kernel built with per-env
    DR leaves (walker2d with the throughput bench's spec and with all
    twelve leaves, walker3d and humanwalker with the spec) and the
    dynamics kernel built with them (cartpole with all seven dynamics
    leaves and with the spec's, walker2d states with mass and damping),
    each against its plain version on the model with the per-env leaves,
    at the bounds of phases substep and dynamics; env identity under a
    permutation of the envs (to the bit) and the base model's values
    against the build without DR inputs; a partly filled last block
    (walker2d B = 4095, cartpole B = 8191); the escalation kernel's fused
    mode on the walker2d DR substep's outputs; one walker2d DR control
    step in lockstep with a plain path; then bench_dr for walker2d
    (B = 4096, the DR substep kernel and the fused escalation on every
    substep), walker3d (B = 4096, the same on a 3D model; at most
    DR_RUNAWAY_MAX of its envs may run away under the bench's fixed
    torques) and cartpole (B = 8192, the DR dynamics kernel), counters
    zeroed just before each (phase dr_path); walker2d with per-env joint axes and offsets, limits,
    ground height and mass (walker2d_frames, B = 4096, 40 substeps: no
    kernel takes frame leaves, so the plain batched dynamics, then the
    PGS kernel and the BPP kernel's hybrid mode on every substep; 256 of
    its envs held for 4 substeps against the float64 CPU step);
  * the multi-skeleton world (walker2d.skel composed with a free box:
    n 15, nb 8, 36 solver rows) and the servo walker (servo rows on its 6
    actuated dofs, 30 rows) at B = 4096: the dynamics kernel (against its
    plain version in float64), the PGS kernel and the BPP kernel's hybrid
    mode on their LCPs against their plain versions, a one-substep
    lockstep with a plain path, engine/world.make_lcp_capture on the
    card (the multi-skeleton world), the dynamics kernel with its model
    tables in global memory beside __constant__ (line `tables`); the JAX
    package's servo behaviours at B = 4096 (servo_behaviour); every
    collision-matrix scene at B = 1024, one phase-wise substep of the
    kernel route against the plain route, and two scenes settled for 600
    substeps (matrix); the BPP kernel's ES_REF64 builds (the
    mixed-precision refinement tier) in the fused mode on humanwalker and
    the hybrid mode on perturbed humanwalker against refine_mixed's plain
    version, beside the compensated tier (ref64);
  * the two phase-wise paths through engine/world.make_do_simulation
    (B = 4096, 100 control steps: kernels 3, 4 and 2 on every substep;
    line `sim_path`) and humanwalker with escalate_ref64 = 2 (B = 1024,
    20 control steps, and perturbed, 3), counters zeroed just before each;
  * the device launches of one eager walker2d control step at B = 4096,
    counted by torch.profiler as dartenv_tpu_torch/bench/profile_step.py
    counts them (line `launches`);
  * the gym surface at B = 1: every registered id made on the card
    (`dartenv_tpu_torch.make`), 50 control steps of a seeded action
    sequence with the launch counters zeroed just before, each step in
    lockstep with the same env class on the CPU in float64, the wall ms
    and device launches per env.step, and each kernel of the path at
    B = 1 against its plain version (phase gym; an obs_type="image"
    hopper against its CPU frame); the pydart2 facade on walker2d (its
    views, a force staged by add_ext_force: kernels 4 and 2; the servo
    walker's commands staged by set_commands: kernels 3, 4 and 2; phase
    facade); the checked step at B = 4096 (checked); a 200-substep trace
    on the card beside the CPU's (trace, not gated); a walker2d VecEnv
    at B = 4096 saved and restored with its generator, equal to the bit
    (resume); the JAX residual harness's protocol at B = 1 for walker2d,
    hopper, walker3d, dog and humanwalker (harness_envelope, gated for
    walker2d);
  * the learner (phase learn): parallel/train.make_train_step on walker2d
    at B = 4096 inside an NCCL process group of one rank, three REINFORCE
    steps of horizon 16, kernel 1 and the BPP kernel's fused mode on every
    substep and no plain call, the third update held to the float64 CPU
    update; the URDF and SDF loaders (phase loaders): the URDF double
    pendulum and floating block and the SDF pendulum-and-crate world at
    B = 4096 through make_sim_step, the route and kernels of each, the
    kernels against their plain versions and a lockstep substep, and
    DartEnv([a .urdf]) for 20 control steps; the C++ golden engines
    (phase golden): the dynamics kernel's accelerations on walker2d and
    humanwalker states against native.aba, the BPP kernel's core mode on
    captured walker2d LCPs against native.lcp_solve by residual;
  * the bench CLI (phase bench_cli): bench/throughput.main --all at
    horizon 10 (five metric lines with the card), a walker2d run with
    --cold --pgs_iters 12 --escalate_kmax 256 at B = 8192 (its kernels
    against their plain versions first; then the substep kernel and the
    fused mode once per substep, K = 256), and bench_env's profile_dir
    (the substep_fused range with both kernels' launches inside it).

Each phase prints one JSON line; any failing phase raises, and without a
GPU the script exits non-zero before printing a result.  The last line is
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import statistics
import sys
import time

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def time_ms(fn, runs=20, warmup=3):
    """Median time of fn() on the card in ms (CUDA events)."""
    import torch

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


def substep_work(st, B, dr_width=0):
    """(bytes, flops) one fused-substep launch must move / do for B envs:
    each input read once (dr_width: the floats of an env's DR leaves),
    each output written once; flops from the digest's sizes (dense counts
    of the stages that dominate)."""
    from dartenv_tpu_torch.engine.hopper_substep import _out_sizes

    n, nb, m, m_c = st.n, st.nb, st.layout.m, st.m_c
    words = 3 * n + m + dr_width + sum(_out_sizes(st).values())
    flops = (
        2 * (st.cfg.pgs_iters + 1) * m_c * m_c      # PGS sweeps + residual
        + n * m_c * (m_c + 1)                       # A = Jc (M^-1 Jc^T), half
        + m_c * 2 * n * n                           # M^-1 Jc^T substitutions
        + 2 * (n ** 3 // 3 + 2 * n * n)             # two Cholesky solves
        + nb * (n * 60 + n * (n + 1) * 6)           # mass matrix
        + nb * 400                                  # kinematics + bias forces
        + st.ns * 60 + st.cap * n * 40              # collision + contact rows
        + 2 * n * m_c                               # dq_plus
    )
    return 4 * words * B, flops * B


def solve_flops(m, iters, refine, polish):
    """Operations of one BPP solve of m rows."""
    pivot = (2 * m ** 3) // 3 + 2 * m * m + 6 * m * m   # GE + back-sub,
    #                                    masked operator, two matvecs
    return (iters + refine) * pivot + polish * 2 * m * m + 2 * m * m


def bpp_work(m, K, iters, refine, polish):
    """(bytes, flops) of one core-mode BPP launch for K problems of m
    rows."""
    words = m * m + 7 * m
    return 4 * words * K, solve_flops(m, iters, refine, polish) * K


def escalate_work(K, m, budgets, rows_in, rows_out, rebuild_n=0):
    """(bytes, flops) of one fused- or hybrid-mode launch for K envs: the
    rows it reads (rows_in floats per env: an `esc` row and the dq_plus /
    lam_full rows, or A, the vectors and lam) and writes (rows_out), the
    tiers' solves and residuals, and, in the fused mode, the operator
    rebuild from M (n x n) and Jc: n^3/3 + 2 m n^2 + 2 m^2 n per env."""
    it1, rf1, po1, it2, rf2, po2, passes, passes64 = budgets
    n = rebuild_n
    flops = solve_flops(m, it1, rf1, po1) + 2 * m * m
    if it2 > 0:
        flops += solve_flops(m, it2, rf2, po2) + 2 * m * m
    # a refinement pass: a compensated matvec (~20 m^2), the masked
    # operator's inverse (m^3) and product (2 m^2), a compensated residual;
    # then one plain residual
    flops += passes * (m ** 3 + 44 * m * m) + 22 * m * m + 2 * m * m
    # a mixed-precision pass: two float64 matvecs (counted twice: the
    # card's float64 rate is half its float32 rate), the float32 inverse
    # and product
    flops += passes64 * (m ** 3 + 10 * m * m) + (4 * m * m if passes64
                                                  else 0)
    if n:
        flops += n ** 3 // 3 + 2 * m * n * n + 2 * m * m * n
    return 4 * (rows_in + rows_out) * K, flops * K


def bound(bytes_, flops):
    tb, tf = bytes_ / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# copied or selected by the substep, never computed: held to the last bit
# (lo and hi hold 1e20, so a relative bound on them would hold nothing)
EXACT_BLOCKS = ("con_active", "overflow", "act", "sel_slots", "lo", "hi",
                "mu")
DISCRETE = ("con_active", "act", "sel_slots")
# Envs of an escalation batch (K = 128, or 16 for the hybrid mode above
# 32 rows) whose exact re-solve may take another branch than the plain
# version's, at every row count.  The plain versions sum in the kernel's
# order (every matvec and product entry over its index in ascending order,
# a polish row as the kernel's lane butterfly: math/linalg.seq_mv, seq_mm,
# lcp/hopper_bpp.lane_sum), and on the card the kernel equals them to the
# bit on all 128 escalated envs of walker2d, hopper, walker3d (36 rows)
# and humanwalker (41 rows, with the refinement tier) and on all 16 of the
# hybrid mode above 32 rows (NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
# Before, torch.sum added in another order (scripts/torch_sum_order.py):
# 73 of 128 walker3d and 111 of 128 humanwalker envs stayed the same, and
# half were allowed to part above 32 rows.
BPP_MAY_DIVERGE = 4


def solved_as_plain(K, solved_k, solved_p, n_same):
    """The kernel solves (< 1e-4) as many envs as its plain version, less
    the ones that parted."""
    return solved_k >= solved_p - (K - n_same)


LOCK_MAY_DIVERGE = 2           # envs of 1024 beyond 1e-3 after one step
CONTROL_STEPS_BEFORE = 25      # control steps before the states are taken
# (env, perturb) -> (batch, horizon, rollouts); the first rollout of each
# is bench_env's warm-up
# (env, perturb[, LCP solver]) -> (batch, horizon, rollouts); the first
# rollout of each is bench_env's warm-up.  The perturbed humanwalker path
# (15 phase-wise substeps per control step, host-bound) runs 15 control
# steps at full width.
PATHS = {("walker2d", False): (4096, 100, 1), ("hopper", False): (4096, 100, 1),
         ("cartpole", False): (8192, 1000, 1),
         ("walker2d", True): (4096, 100, 1),
         ("reacher", False): (4096, 100, 1),
         ("walker3d", False): (4096, 100, 1),
         ("humanwalker", False): (1024, 100, 1),
         ("dog", False): (4096, 100, 1),
         ("snake7link", False): (4096, 100, 1),
         ("reacher2d", False): (4096, 100, 1),
         ("walker2d", False, "dantzig"): (4096, 100, 1),
         ("humanwalker", True): (1024, 15, 1)}
# fused-substep envs checked kernel by kernel: env -> batch
FUSED_ENVS = {"walker2d": 4096, "hopper": 4096, "walker3d": 4096,
              "humanwalker": 1024, "reacher": 4096, "dog": 4096,
              "snake7link": 4096, "reacher2d": 4096}
# the FUSED_ENVS with a FREE root, whose position update is the
# position-update kernel's (phase integrate)
INTEGRATE_ENVS = ("humanwalker", "walker3d", "dog")
# DartSnake7Link's PLANAR zx root holds its capsules' axes at the height
# of their radius, so their contact depth is 0 in every state and no
# contact row is ever active (the JAX package's model does the same).  Its
# substep kernel is also held on the model with the ground raised by
# SUNK_GROUND m, where all 14 contact slots are active, so that the
# kernel's uncompacted contact branch (SS_COMPACT = 0) runs with live
# contact rows.
SUNK_GROUND = {"snake7link": 0.01}
# the dynamics kernel's bounds, relative to max(1, |ref|_inf): the JAX
# package's own (tests/test_pallas_dynamics.py::_check); dq_star goes
# through the n x n solve, whose conditioning amplifies rounding
DYN_TOL = {"dq_star": 2e-4, "M": 5e-6, "phi": 5e-6, "R_w": 5e-6,
           "p_w": 5e-6}


def cfg_budgets(cfg):
    """The escalation's tier tuple (lcp/hopper_bpp.tier_budgets) of a
    solver config."""
    from dartenv_tpu_torch.lcp.hopper_bpp import tier_budgets

    return tier_budgets(cfg.escalate_iters, cfg.escalate_refine,
                        cfg.escalate_iters2, cfg.escalate_ref,
                        cfg.escalate_ref64)


def plain_tiers(findex, budgets):
    """(exact1, exact2) of the escalation's tiers in `budgets` that run the
    BPP kernel's plain version whatever the device (exact2 None without
    tier 2)."""
    from dartenv_tpu_torch.lcp.hopper_bpp import bpp_solve_reference

    def make(iters, refine, polish):
        def solve(A, b, lo, hi, mu, active, lam0):
            return bpp_solve_reference(A, b, lo, hi, findex, mu, active,
                                       iters=iters, polish_iters=polish,
                                       lam0=lam0, refine_iters=refine)
        return solve
    return (make(*budgets[:3]),
            make(*budgets[3:6]) if budgets[3] > 0 else None)


def plain_substep(model, st, tiers, q, dq, lam, tau, m64=None):
    """One substep through the plain versions only, composed here as the
    port's substep phase composes the kernels: substep_reference ->
    escalate_batch with the plain BPP (when the model escalates) ->
    integrate_positions.  With m64 = (float64 model, its digest), the
    substep's plain version runs in float64 on the float32 inputs and its
    outputs are rounded to float32 (see plain64).  Returns (q, dq, lam,
    the escalated envs or None)."""
    from dartenv_tpu_torch.dynamics.batched import integrate_positions
    from dartenv_tpu_torch.engine import hopper_substep as hs

    if m64 is None:
        outs = hs.substep_reference(model, st, q, dq, tau, lam)
    else:
        outs = hs.substep_reference(m64[0], m64[1], q.double(), dq.double(),
                                    tau.double(), lam.double())
        outs = {k: v.float() for k, v in outs.items()}
    dq, lam, idx = outs["dq_plus"], outs["lam_full"], None
    if model.solver.escalate_frac > 0:
        dq, lam, idx = hs.escalate_reference(st, model.solver, outs, dq, lam,
                                             *tiers)[:3]
    return integrate_positions(model, q, dq, st.dt), dq, lam, idx


# Models of more than 12 dofs (walker3d, humanwalker): the substep
# kernel factors M by Cholesky, as the JAX package's kernel does, while
# its float32 plain version inverts M through math/linalg.inv_psd, which
# adds a relative 1e-6 diagonal jitter (the JAX package's XLA path does
# the same; tests/test_pallas_substep.py bounds the gap at 2e-2 for
# humanwalker).  Through the PGS sweeps the jitter moves walker3d's
# impulses by 0.45 and dq_plus by 0.27 of their max on rollout states
# (the host build against the float32 plain version, on the CPU), so for
# these models the substep kernel is held against its plain version
# evaluated in float64 on the same float32 inputs (no jitter there), at
# 1e-4 for the blocks computed before the PGS sweeps (contacts, rows, M,
# Jc: within 7.5e-6 on walker3d B = 4096) and the JAX package's n > 12
# bound of 2e-2 for those after them (AFTER_SWEEPS): on these operators
# the 20 sweeps amplify the float32 rounding of A and b, and at walker3d
# B = 4096 the kernel's impulses are 5.8e-4, dq_plus 1.5e-3 and the
# residual 2.5e-3 from the float64 plain version (PERF.md).  The
# escalation kernel's operator rebuild follows its float32 plain version
# (the jitter included), so the lockstep's plain path runs the substep's
# plain version in float64 and the escalation's in float32.
AFTER_SWEEPS = ("dq_plus", "lam_full", "lam_c", "res")


def plain64(model):
    """(float64 copy of the model, its digest) when its plain substep
    differs from the kernel's factorization (n > 12), else None."""
    import torch

    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.math.linalg import _UNROLL_MAX

    if model.n <= _UNROLL_MAX:
        return None
    m64 = model.to(dtype=torch.float64)
    return m64, hs._SubStatic(m64)


def check_bpp(name, cfg, findex, A, b, lo, hi, mu, act, lam_c,
              min_solved=0.5):
    """Phase bpp: the BPP kernel against its plain version on the K
    escalated problems of one env's path (warm start lam_c, the path's
    pivot budget).  Returns what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp.hybrid import comp_residual

    K, m_c = b.shape
    bpp_args = (A, b, lo, hi, findex, mu, act)
    it1, rf1, po1 = cfg_budgets(cfg)[:3]
    bpp_kw = dict(iters=it1, polish_iters=po1, lam0=lam_c, refine_iters=rf1)
    lam_k = hb.bpp_solve(*bpp_args, **bpp_kw)
    torch.cuda.synchronize()
    lam_r = hb.bpp_solve_reference(*bpp_args, **bpp_kw)
    resid = lambda lam: comp_residual(A, b, lam, lo, hi, findex, mu, act)
    r_k, r_r, r_pgs = resid(lam_k), resid(lam_r), resid(lam_c)
    # per env, relative to max(1, |plain impulses|)
    env_err = ((lam_k - lam_r).abs().max(1).values
               / lam_r.abs().max(1).values.clamp(min=1.0))
    same = env_err <= 1e-5
    n_same = int(same.sum())
    bpp_err = float((lam_k - lam_r)[same].abs().max())
    res_diff_same = float((r_k - r_r)[same].abs().max())
    bpp_ms = time_ms(lambda: hb.bpp_solve(*bpp_args, **bpp_kw))
    bpp_plain_ms = time_ms(
        lambda: hb.bpp_solve_reference(*bpp_args, **bpp_kw), runs=5,
        warmup=1)
    solved = lambda r: int((r < 1e-4).sum())
    emit("bpp", env=name, K=K, m=m_c, envs_same=n_same,
         lam_abs_err_same=bpp_err, res_abs_diff_same=res_diff_same,
         lam_abs_err_all=float((lam_k - lam_r).abs().max()),
         lam_abs_max=float(lam_r.abs().max()),
         res_kernel_max=float(r_k.max()), res_plain_max=float(r_r.max()),
         res_pgs_max=float(r_pgs.max()),
         res_kernel_median=float(r_k.median()),
         res_plain_median=float(r_r.median()),
         res_pgs_median=float(r_pgs.median()),
         solved_kernel=solved(r_k), solved_plain=solved(r_r),
         solved_pgs=solved(r_pgs),
         res_kernel_on_others=r_k[~same].tolist(),
         res_plain_on_others=r_r[~same].tolist(),
         ms=bpp_ms, plain_ms=bpp_plain_ms,
         tol_lam=1e-5, tol_res_diff=1e-5,
         tol_envs_same=K - BPP_MAY_DIVERGE)
    assert torch.isfinite(lam_k).all()
    # These are the WORST K envs of a live rollout under the shipped 4 + 2
    # pivot budget, which does not close every one of them in either
    # version (the escalation stage keeps the better point per env).  The
    # kernel is held to its plain version env by env: impulses within 1e-5
    # and residuals within 1e-5.  A few envs may part ways: in float32 the
    # pivot's re-open test compares rounding noise with 1e-10, and one
    # flipped row sends a stalling solve down another branch (the two
    # versions sum in the same order, and on the card all 128 have stayed
    # the same: see BPP_MAY_DIVERGE).  Those envs are counted and bounded,
    # and over all K the kernel must solve (< 1e-4) as many envs as the
    # plain version, less the ones that parted.
    assert n_same >= K - BPP_MAY_DIVERGE, (n_same, K)
    assert bpp_err <= 1e-5 and res_diff_same <= 1e-5
    assert solved_as_plain(K, solved(r_k), solved(r_r), n_same)
    assert solved(r_k) > K * min_solved
    assert float(r_k.median()) < float(r_pgs.median())
    bb, bf = bpp_work(m_c, K, it1, rf1, po1)
    return dict(max_abs_err=bpp_err, ms=bpp_ms, plain_ms=bpp_plain_ms,
                bound=bound(bb, bf),
                shape=f"{name} K={K} m={m_c} iters={it1} refine={rf1} "
                      f"polish={po1}")


def compare_escalation(phase, name, K, got, ref, others_equal):
    """Hold one escalation launch against its plain version.  got / ref:
    (patched rows (K, w), take (K,), residual of the kept point (K,)) of
    the K escalated envs; others_equal: whether every env outside the top
    K is equal to the bit.  Envs whose rows lie within 1e-5 of
    max(1, |plain|) and whose take flags agree count as the same; at most
    BPP_MAY_DIVERGE may part (the f32 re-open sensitivity of the bpp
    phase), and over all K the kernel must solve (< 1e-4) as many envs as
    the plain version, less those that parted."""
    import torch

    rows_k, take_k, res_k = got
    rows_r, take_r, res_r = ref
    env_err = ((rows_k - rows_r).abs().max(1).values
               / rows_r.abs().max(1).values.clamp(min=1.0))
    same = (env_err <= 1e-5) & (take_k == take_r)
    n_same = int(same.sum())
    err = float((rows_k - rows_r)[same].abs().max()) if n_same else 0.0
    solved = lambda r: int((r < 1e-4).sum())
    out = dict(env=name, K=K, envs_same=n_same, rows_abs_err_same=err,
               rows_rel_err_same=float(env_err[same].max()) if n_same
               else 0.0,
               take_kernel=int(take_k.sum()), take_plain=int(take_r.sum()),
               take_equal=int((take_k == take_r).sum()),
               others_bit_equal=bool(others_equal),
               solved_kernel=solved(res_k), solved_plain=solved(res_r),
               res_kernel_max=float(res_k.max()),
               res_plain_max=float(res_r.max()),
               tol_rel=1e-5, tol_envs_same=K - BPP_MAY_DIVERGE)
    assert torch.isfinite(rows_k).all() and torch.isfinite(res_k).all()
    assert others_equal, f"{phase} {name}: envs outside the top K changed"
    assert n_same >= K - BPP_MAY_DIVERGE, (phase, name, n_same, K)
    assert solved_as_plain(K, solved(res_k), solved(res_r),
                           n_same), (phase, name)
    return out, err


def check_escalate(name, st, cfg, outs, tier2=False):
    """Phase escalate: the escalation stage on a float32 CUDA batch (top K
    + one launch of the BPP kernel's fused mode) against its plain version
    (escalate_reference with the plain BPP) on the same substep outputs.
    Returns what the kernels line needs."""
    import dataclasses

    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.engine import hopper_substep as hs

    if tier2:
        cfg = dataclasses.replace(cfg, escalate_iters2=4)
    budgets = cfg_budgets(cfg)
    tiers = plain_tiers(st.findex_c, budgets)
    dqp0, lamf0 = outs["dq_plus"], outs["lam_full"]
    run_k = lambda: hs.escalate_fused(st, cfg, outs, dqp0, lamf0, budgets)
    run_r = lambda: hs.escalate_reference(st, cfg, outs, dqp0, lamf0,
                                          *tiers)
    dqp_k, lamf_k, idx, take_k, res_k = run_k()
    torch.cuda.synchronize()
    dqp_r, lamf_r, idx_r, take_r, res_r = run_r()
    assert torch.equal(idx, idx_r)
    K = idx.shape[0]
    rest = torch.ones(dqp0.shape[0], dtype=torch.bool, device=dqp0.device)
    rest[idx] = False
    others = (torch.equal(dqp_k[rest], dqp_r[rest])
              and torch.equal(lamf_k[rest], lamf_r[rest])
              and torch.equal(dqp_k[rest], dqp0[rest]))
    rows = lambda d, l: torch.cat([d[idx], l[idx]], dim=1)
    line, err = compare_escalation(
        "escalate", name, K, (rows(dqp_k, lamf_k), take_k, res_k),
        (rows(dqp_r, lamf_r), take_r, res_r), others)
    ms = time_ms(run_k)
    dev_ms = device_ms(run_k, "bpp_fused_kernel")
    plain_ms = time_ms(run_r, runs=5, warmup=1)
    n, m_c, m, width = st.escalation_dims[:4]
    eb, ef = escalate_work(K, m_c, budgets, width + n + m, n + m,
                           rebuild_n=n)
    emit("escalate", **line, iters2=cfg.escalate_iters2,
         refine_passes=budgets[6], ref64_passes=budgets[7], ms=ms,
         device_ms=dev_ms,
         plain_ms=plain_ms, bound_ms=bound(eb, ef)[0])
    assert torch.equal(dqp0, outs["dq_plus"])      # inputs not modified
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound=bound(eb, ef),
                shape=f"{name} K={K} m={m_c} n={n} fused "
                      f"iters={budgets[0]}+{budgets[1]} "
                      f"iters2={budgets[3]}+{budgets[4]} "
                      f"refine_passes={budgets[6]} "
                      f"ref64_passes={budgets[7]}",
                solved_kernel=line["solved_kernel"])


def check_hybrid_rows(name, cfg, findex, g, K=16):
    """Phase hybrid above 32 rows: the BPP kernel's hybrid mode on a batch
    of the K worst of the escalated LCPs of a model with more than 32 rows
    (with the model's refinement passes: humanwalker's 2) against its
    plain version (lcp/hybrid.escalate_rows), as check_pgs holds it at 24
    rows."""
    import torch

    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp.hybrid import comp_residual, escalate_rows

    A, b, lo, hi, mu, act, lam = (g[k] for k in ("A", "b", "lo", "hi", "mu",
                                                  "act", "lam_c"))
    B, m = b.shape
    budgets = cfg_budgets(cfg)
    assert m > 32
    res = comp_residual(A, b, lam, lo, hi, findex, mu, act)
    worst, idx = torch.topk(res, K)
    out_k, take_k, kept_k = hb.bpp_hybrid(A, b, lo, hi, mu, act, lam, idx,
                                          worst, findex, cfg.escalate_tol,
                                          budgets)
    torch.cuda.synchronize()
    out_r, take_r, kept_r = escalate_rows(A, b, lo, hi, mu, act, lam, idx,
                                          worst, findex, cfg.escalate_tol,
                                          *plain_tiers(findex, budgets),
                                          *budgets[6:8])
    rest = torch.ones(B, dtype=torch.bool, device=A.device)
    rest[idx] = False
    others = (torch.equal(out_k[rest], out_r[rest])
              and torch.equal(out_k[rest], lam[rest]))
    line, _ = compare_escalation(
        "hybrid", name, K, (out_k[idx], take_k, kept_k),
        (out_r[idx], take_r, kept_r), others)
    emit("hybrid", **line, m=m, refine_passes=budgets[6])


def sunk_model(model, depth):
    """The model with its ground (every world plane) raised by `depth`."""
    return model.replace(wg_offset=model.wg_offset + depth)


def hold_substep(name, model, kern, outs, ins, m64, dr_vals=(),
                 phase="substep"):
    """Hold one substep-kernel launch's outputs (on ins = (q, dq, tau,
    lam)) against the kernel's plain version on the same inputs, block by
    block, and time both (phase substep; phase dr for a DR build, whose
    plain version runs on the model with the per-env leaves dr_vals).
    Returns what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.dynamics.hopper_dynamics import with_leaves
    from dartenv_tpu_torch.engine import hopper_substep as hs

    st, fields = kern.st, kern.dr_fields
    q, dq, tau, lam_prev = ins
    B, dev = q.shape[0], q.device
    plain_model = with_leaves(model, fields, dr_vals)
    ref = hs.substep_reference(plain_model, st, *ins)
    got_b, ref_b = hs.output_blocks(st, outs), hs.output_blocks(st, ref)
    assert set(got_b) == set(ref_b) and "esc" not in got_b
    agree = torch.ones(B, dtype=torch.bool, device=dev)
    for f in DISCRETE:
        agree &= (got_b[f] == ref_b[f]).all(1)
    frac = float(agree.float().mean())
    ref_c = ref_b                 # the plain version the kernel is held to
    if m64 is not None:           # n > 12: see plain64
        ref64 = hs.substep_reference(
            with_leaves(m64[0], fields, [v.double() for v in dr_vals]),
            m64[1], *(x.double() for x in ins))
        ref_c = {k: v.float()
                 for k, v in hs.output_blocks(st, ref64).items()}
        for f in DISCRETE:
            agree &= (ref_c[f] == ref_b[f]).all(1)
    errs, abs_errs, unequal, errs32 = {}, {}, {}, {}
    for f in got_b:
        a, r = got_b[f][agree], ref_c[f][agree]
        assert torch.isfinite(a).all(), f
        if f in EXACT_BLOCKS:
            unequal[f] = int((a != ref_b[f][agree]).sum())
        elif a.numel():
            abs_errs[f] = float((a - r).abs().max())
            errs[f] = abs_errs[f] / max(1.0, float(r.abs().max()))
            r32 = ref_b[f][agree]
            errs32[f] = (float((a - r32).abs().max())
                         / max(1.0, float(r32.abs().max())))
    sub_ms = time_ms(lambda: kern(*ins, *dr_vals))
    sub_dev_ms = device_ms(lambda: kern(*ins, *dr_vals), "substep_kernel")
    sub_plain_ms = time_ms(
        lambda: hs.substep_reference(plain_model, st, *ins), runs=5,
        warmup=1)
    emit(phase, kernel="substep", env=name, B=B, dr_fields=list(fields),
         agree_frac=frac, agree_frac_all=float(agree.float().mean()),
         rel_err=errs, abs_err=abs_errs, unequal_entries=unequal,
         plain_dtype="float32" if m64 is None else "float64",
         rel_err_float32_plain=errs32, envs_per_block=kern.shape[0],
         active_slots=float(ref["con_active"].sum()),
         active_rows=float(ref_b["act"].sum()), ms=sub_ms,
         device_ms=sub_dev_ms, plain_ms=sub_plain_ms, tol_rel=1e-4,
         tol_rel_after_sweeps=1e-4 if m64 is None else 2e-2,
         tol_agree=0.999)
    if st.ns and name not in SUNK_GROUND:
        # (hopper stands on one foot and is in the air for part of its
        # stride)
        assert float(ref["con_active"].sum()) > 0.05 * B, \
            "contacts are not live"
    assert float(ref_b["act"].sum()) > B // 2, "constraint rows are not live"
    assert frac >= 0.999, f"discrete fields agree on {frac:.5f} of envs"
    assert float(agree.float().mean()) >= 0.99
    assert not any(unequal.values()), f"copied blocks differ: {unequal}"
    tol = lambda f: 2e-2 if m64 is not None and f in AFTER_SWEEPS else 1e-4
    bad = {f: e for f, e in errs.items() if not e <= tol(f)}
    assert not bad, f"substep kernel disagrees: {bad}"
    sb, sf = substep_work(st, B, kern.dr_width)
    lay = f"n={st.n} m={st.layout.m} m_c={st.m_c}"
    return dict(max_abs_err=max(abs_errs.values()), ms=sub_ms,
                device_ms=sub_dev_ms, plain_ms=sub_plain_ms,
                bound=bound(sb, sf),
                shape=f"{name} B={B} {lay} envs_per_block={kern.shape[0]}"
                      + (f" dr={len(fields)} leaves, {kern.dr_width} floats"
                         if fields else ""))


def check_env(name, B, dev):
    """Phases substep, bpp and lockstep for one env at batch B (bpp and
    escalate only for a model that escalates).  Returns what the kernels
    line needs."""
    import torch

    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    task = make_task(name, device=dev)
    model, cfg = task.model, task.model.solver
    kern = hs.get_substep_kernel(model)
    st = kern.st
    n_act = task.action_size
    escal = cfg.escalate_frac > 0
    m64 = plain64(model)
    # the plain path composed below is tier 1 only, as the shipped settings
    assert cfg.escalate_iters2 == 0

    # ---- 3. fused substep kernel vs its plain version -------------------
    # states from control steps of the port's own rollout, so contacts,
    # limits and warm starts are live
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    vec = VecEnv(task, B, max_episode_steps=1000, generator=gen)
    state, _ = vec.reset()
    hi_a = torch.as_tensor(task.control_bounds[0], device=dev,
                           dtype=torch.float32)
    rand_a = lambda b: (torch.rand((b, n_act), generator=gen, device=dev)
                        * 2 - 1) * hi_a
    for _ in range(CONTROL_STEPS_BEFORE):
        state, *_ = vec.step(state, rand_a(B))
    q, dq, lam_prev = state.sim.q, state.sim.dq, state.sim.lam
    if not st.ns or name in SUNK_GROUND:
        # no contact slots (reacher, reacher2d) or no contact ever active
        # (SUNK_GROUND): the random policy seldom reaches a joint limit, so
        # every second env has its limited dofs moved past their upper
        # limit, and the limit rows are live; three envs of four where the
        # model has one limited dof (hold_substep wants more than B / 2
        # live rows)
        lim = torch.as_tensor(model.host("limited") > 0, device=dev)
        past = model.q_upper + 0.05 - q
        env = torch.arange(B, device=dev)
        pushed = env % 4 != 3 if int(lim.sum()) == 1 else env % 2 == 0
        q = torch.where(lim & pushed[:, None], q + past, q)
    tau = task.action_to_tau(rand_a(B), state.aux)
    assert torch.isfinite(q).all() and torch.isfinite(dq).all()

    outs = kern(q, dq, tau, lam_prev)
    ins = (q, dq, tau, lam_prev)
    out = {"substep": hold_substep(name, model, kern, outs, ins, m64),
           "states": ins}
    if name in SUNK_GROUND:
        sk = hs.get_substep_kernel(sunk_model(model, SUNK_GROUND[name]))
        hold_substep(name + "_sunk", sk.model, sk, sk(*ins), ins, m64)

    # ---- 4. BPP kernel vs its plain version -----------------------------
    if escal:
        g = hs.gather_escalation(st, cfg, outs)
        K, m_c = g["b"].shape
        assert (K, m_c) == (hs.escalation_size(B, cfg.escalate_frac,
                                               cfg.escalate_kmax), st.m_c)
        # the 3D models' shipped pivot budgets (walker3d 8 + 2) leave
        # about half of their worst envs above 1e-4 in either version (the
        # JAX harness's walker3d bound on the max residual is 5e-3)
        out["bpp"] = check_bpp(name, cfg, st.findex_c, g["A"], g["b"],
                               g["lo"], g["hi"], g["mu"], g["act"],
                               g["lam_c"],
                               min_solved=0.5 if m64 is None else 0.25)
        out["escalate"] = check_escalate(name, st, cfg, outs)
        if name == "walker2d":
            check_escalate(name, st, cfg, outs, tier2=True)
        if st.m_c > 32:
            check_hybrid_rows(name, cfg, st.findex_c, g)

    # ---- 5. lockstep: kernel path vs plain path, same start, same actions
    # One control step, substep by substep: the port's own substep (the
    # kernels) beside the plain substep composed here.  Envs count as
    # having equal contact sets when the same normal and limit rows carry
    # an impulse after every one of the step's substeps.
    Bl = min(B, 1024)
    sl = lambda x: x[:Bl].clone()
    sim_step = make_sim_step(model)
    tiers = plain_tiers(st.findex_c, cfg_budgets(cfg))
    rows = list(range(0, 3 * st.ns, 3)) + list(
        range(3 * st.ns, st.layout.m))
    # error relative to max(1, |plain|) per entry: dq reaches tens of
    # rad/s under the random policy
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1.0)).max(
        1).values
    sk = SimState(q=sl(q), dq=sl(dq), time=sl(state.sim.time),
                  lam=sl(lam_prev))
    sp = (sk.q, sk.dq, sk.lam)
    aux_l = ({k: sl(v) for k, v in state.aux.items()}
             if isinstance(state.aux, dict) else state.aux)
    Kl = hs.escalation_size(Bl, cfg.escalate_frac, cfg.escalate_kmax)
    drift, lock = [], None
    plain_before = hs.PLAIN_CALLS
    # the bounds hold the first control step; the later ones print the
    # drift: 32 substeps of it (8 control steps at frame_skip 4), 2
    # control steps above 12 dofs, whose plain path runs the substep in
    # float64 (humanwalker's 0.3 s a substep)
    for i in range(2 if m64 is not None else max(2, 32 // task.frame_skip)):
        tau_l = task.action_to_tau(rand_a(Bl), aux_l)
        same = torch.ones(Bl, dtype=torch.bool, device=dev)
        touched = torch.zeros(Bl, dtype=torch.bool, device=dev)
        for _ in range(task.frame_skip):
            if escal and m64 is not None:
                # the envs the kernel path escalates in this substep (the
                # kernel is deterministic: the same outputs as inside the
                # sim step)
                res_k = kern(sk.q, sk.dq, tau_l, sk.lam)["res"][:, 0]
                touched[torch.topk(res_k, Kl).indices] = True
            sk, _ = sim_step(sk, tau_l)
            sp = plain_substep(model, st, tiers, *sp[:3], tau_l, m64)
            if sp[3] is not None:
                touched[sp[3]] = True
            same &= (sk.lam[:, rows] > 0).eq(sp[2][:, rows] > 0).all(1)
        dq_err, q_err = rel(sk.dq, sp[1]), rel(sk.q, sp[0])
        # the envs held to the bound: equal contact sets, and for n > 12
        # no escalation in either path during the step (see below)
        held = same & ~touched if m64 is not None else same
        if i == 0:
            lock = dict(same_contact_frac=float(same.float().mean()),
                        held_frac=float(held.float().mean()),
                        q_err=float(q_err[held].max()),
                        dq_err=float(dq_err[held].max()),
                        dq_err_all=float(dq_err.max()),
                        envs_beyond_tol=int(((dq_err > 1e-3)
                                             | (q_err > 1e-3))[held].sum()),
                        q_err_q99=float(q_err[held].quantile(0.99)),
                        dq_err_q99=float(dq_err[held].quantile(0.99)),
                        plain_substep_dtype="float32" if m64 is None
                        else "float64")
            if m64 is not None and escal:
                esc_envs = same & touched
                lock.update(
                    escalated_frac=float(touched.float().mean()),
                    escalated_dq_err_median=float(
                        dq_err[esc_envs].median()),
                    escalated_dq_err_q90=float(
                        dq_err[esc_envs].quantile(0.9)),
                    escalated_envs_beyond_tol=int(
                        (dq_err[esc_envs] > 1e-3).sum()))
        drift.append(float(torch.nanmedian(dq_err)))
    emit("lockstep", env=name, B=Bl, **lock, median_dq_drift_per_step=drift,
         tol=1e-3, tol_envs_beyond=LOCK_MAY_DIVERGE)
    assert hs.PLAIN_CALLS == plain_before    # the phase took no plain call
    assert lock["same_contact_frac"] > 0.9
    # Models of more than 12 dofs: the escalation's inputs differ between
    # the paths by the float32 rounding of the substep (the plain path's
    # substep runs in float64, see plain64), and its exact re-solve and
    # refinement on these ill-conditioned operators part on such
    # differences (the bpp phase's branch sensitivity, on every escalated
    # env); so the bound holds on the envs that neither path escalated in
    # the step, and the escalated envs' errors are printed beside it.
    assert lock["held_frac"] > 0.25
    # within 1e-3 on the envs with equal contact sets; an env whose exact
    # re-solve took another branch in one version (see the bpp phase) is
    # beyond it, and at most LOCK_MAY_DIVERGE envs may be
    assert lock["envs_beyond_tol"] <= LOCK_MAY_DIVERGE
    assert lock["q_err_q99"] <= 1e-3 and lock["dq_err_q99"] <= 1e-3
    return out


def check_envelope_diag(name, sub, model, q, dq, lam, tau):
    """Phase envelope, the hook: on one substep's outputs, the escalation
    through escalate_batch(with_diag=True) on the kernel route (the BPP
    kernel's fused mode) against the plain route's record (escalate_
    reference with the plain BPP, the same escalation_diag): idx equal,
    every env outside the top K equal to the bit, and the envelope equal
    (within 1e-5 of max(1, |plain|)) on every escalated env whose patched
    rows agree; at most BPP_MAY_DIVERGE envs part."""
    import torch

    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb

    st, cfg = sub.st, model.solver
    kern = hs.get_substep_kernel(model, st)
    outs = kern(q, dq, tau, lam)
    dqp0, lamf0 = outs["dq_plus"], outs["lam_full"]
    launches = hb.FUSED_LAUNCHES
    dqp_k, lamf_k, diag_k = hs.escalate_batch(
        st, cfg, outs, dqp0, lamf0, *hs.escalation_tiers(st, cfg),
        with_diag=True)
    assert hb.FUSED_LAUNCHES - launches == 1       # the kernel route
    ref = hs.escalate_reference(st, cfg, outs, dqp0, lamf0,
                                *plain_tiers(st.findex_c, cfg_budgets(cfg)))
    diag_r = hs.escalation_diag(outs, *ref[2:])
    idx = diag_k["idx"]
    assert torch.equal(idx, diag_r["idx"]), name
    rows = lambda d, l: torch.cat([d[idx], l[idx]], dim=1)
    rows_k, rows_r = rows(dqp_k, lamf_k), rows(ref[0], ref[1])
    same = ((rows_k - rows_r).abs().max(1).values
            / rows_r.abs().max(1).values.clamp(min=1.0)) <= 1e-5
    env_k, env_r = diag_k["envelope"], diag_r["envelope"]
    rest = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    rest[idx] = False
    err = ((env_k[idx] - env_r[idx]).abs()
           / env_r[idx].abs().clamp(min=1.0))[same]
    line = dict(K=int(idx.shape[0]), envs_same=int(same.sum()),
                envelope_rel_err_same=float(err.max()) if err.numel()
                else 0.0,
                envelope_bitwise_same=bool(torch.equal(env_k[idx][same],
                                                       env_r[idx][same])),
                others_bit_equal=bool(torch.equal(env_k[rest],
                                                  env_r[rest])),
                res_pre_equal=bool(torch.equal(diag_k["res_pre"],
                                               diag_r["res_pre"])))
    assert line["others_bit_equal"] and line["res_pre_equal"], (name, line)
    assert line["envs_same"] >= line["K"] - BPP_MAY_DIVERGE, (name, line)
    assert line["envelope_rel_err_same"] <= 1e-5, (name, line)
    return line


def residual_envelope(name, dev, states, control_steps=25):
    """Phase envelope: the escalation's effect on the residuals along a
    kernel-path rollout of one contact model, as the JAX harness measures
    it (scripts/residual_envelope.py of the JAX package; the port's
    scripts/torch_residual_envelope.py): per substep, escalate_batch's
    with_diag record (validation/residual.make_envelope_substep), every
    env's substep-kernel residual with the escalated envs' replaced by
    their kept point's.  From the check's states, random actions,
    control_steps control steps; the first substep's record is held
    against the plain route's (check_envelope_diag).  Printed beside the
    JAX harness's bounds, which were measured on a TPU: a finding, not a
    gate."""
    import torch

    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.validation import residual

    task = make_task(name, device=dev)
    model = task.model
    sub = residual.make_envelope_substep(model)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    hi_a = torch.as_tensor(task.control_bounds[0], device=dev,
                           dtype=torch.float32)
    q, dq, _, lam = (x.clone() for x in states)
    B = q.shape[0]
    env, pre, hook = [], [], None
    for _ in range(control_steps):
        a = (torch.rand((B, task.action_size), generator=gen, device=dev)
             * 2 - 1) * hi_a
        tau = task.action_to_tau(a, ())
        for _ in range(task.frame_skip):
            if hook is None:
                hook = check_envelope_diag(name, sub, model, q, dq, lam,
                                           tau)
            q, dq, lam, diag = sub(q, dq, lam, tau)
            pre.append(diag["res_pre"])
            env.append(diag["envelope"])
    env, pre = torch.cat(env), torch.cat(pre)
    finite = bool(torch.isfinite(q).all() and torch.isfinite(dq).all())
    pct = lambda x: [float(x.median()), float(x.quantile(0.95)),
                     float(x.max())]
    got = pct(env)
    bounds = residual.JAX_ENVELOPE[name]
    emit("envelope", env=name, B=B, substeps=task.frame_skip * control_steps,
         median_p95_max=got, before_escalation=pct(pre),
         jax_bounds_tpu=list(bounds),
         within_jax_bounds=[g <= b for g, b in zip(got, bounds)],
         finite_state=finite, hook_vs_plain=hook)
    assert finite
    return got


def joint_chains(dev):
    """Two ModelBuilder chains that together hold the six joint types the
    substep kernel lacks (FREE, UNIVERSAL, EULER, SCREW; TRANSLATIONAL,
    BALL, SCREW), with non-trivial joint frames, axes, COM offsets,
    springs and dampers.  Each stays at n <= 12 dofs, where the plain
    version solves with its unrolled Cholesky."""
    from dartenv_tpu_torch.model import skel_model as sm
    from dartenv_tpu_torch.model.builder import (
        ModelBuilder, box_inertia, rpy_to_mat,
    )

    ine = lambda m: box_inertia(m, (0.1, 0.06, 0.04))
    a = ModelBuilder(dt=0.002)
    a.add_body("root", None, sm.FREE, mass=2.0, inertia=ine(2.0),
               com=(0.01, 0.02, 0.0))
    a.add_body("uni", "root", sm.UNIVERSAL, axes=[(1, 0, 0), (0, 0.6, 0.8)],
               mass=0.8, inertia=ine(0.8), pj_pos=(0.1, 0, 0),
               pj_rot=rpy_to_mat(0.2, -0.1, 0.3), cj_pos=(0, 0.1, 0),
               damping=0.02)
    a.add_body("eul", "uni", sm.EULER, mass=0.6, inertia=ine(0.6),
               pj_pos=(0, -0.2, 0), cj_rot=rpy_to_mat(0.1, 0.2, -0.1),
               com=(0, 0.03, 0.01))
    a.add_body("scr", "eul", sm.SCREW, axes=[(0, 0, 1)], pitch=0.3,
               mass=0.3, inertia=ine(0.3), pj_pos=(0, -0.1, 0), spring=2.0,
               damping=0.5)
    b = ModelBuilder(dt=0.002)
    b.add_body("base", None, sm.TRANSLATIONAL, mass=2.0,
               inertia=box_inertia(2.0, (0.1, 0.1, 0.1)), spring=3.0,
               rest=(0.0, 0.1, 0.0))
    b.add_body("mid", "base", sm.BALL, mass=1.0,
               inertia=box_inertia(1.0, (0.05, 0.2, 0.05)),
               pj_pos=(0.0, 0.3, 0.0), cj_pos=(0.0, -0.2, 0.0))
    b.add_body("tip", "mid", sm.SCREW, mass=0.5,
               inertia=box_inertia(0.5, (0.05, 0.05, 0.05)),
               axes=[(0.0, 0.0, 1.0)], pitch=0.1, pj_pos=(0.0, 0.25, 0.0),
               damping=0.5, spring=2.0)
    return {"chain_free_uni_euler_screw": a.finalize(device=dev),
            "chain_trans_ball_screw": b.finalize(device=dev)}


def random_states(model, B, seed, dev):
    """(q, dq, tau) as the JAX package's kernel tests draw them: q_init +
    U(-0.3, 0.3), dq ~ U(-2, 2), tau ~ U(-50, 50), float32 on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = model.n
    q = model.q_init.cpu().numpy()[None] + rng.uniform(-0.3, 0.3, (B, n))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return (f(q), f(rng.uniform(-2.0, 2.0, (B, n))),
            f(rng.uniform(-50.0, 50.0, (B, n))))


def dynamics_work(model, B, dr_width=0):
    """(bytes, flops) of one dynamics launch for B envs: q, dq, tau (and
    dr_width floats of DR leaves) read once, dq_star, M, phi, R_w, p_w
    written once; flops of the stages that dominate (kinematics, mass
    matrix, bias forces, Cholesky solve)."""
    n, nb = model.n, model.nb
    words = 3 * n + dr_width + n + n * n + 6 * n + 12 * nb
    flops = (nb * 400 + nb * (n * 60 + n * (n + 1) * 6)
             + n ** 3 // 3 + 2 * n * n + 12 * n)
    return 4 * words * B, flops * B


def check_dynamics(name, model, B, q, dq, tau, dr_fields=(), dr_vals=(),
                   phase="dynamics", f64=False):
    """Phase dynamics for one model: the kernel against its plain version,
    output by output, relative to max(1, |ref|_inf).  With dr_fields
    (phase dr) the kernel built with those leaves as per-env inputs,
    dr_vals, against the plain version on the model with them.  With f64
    the plain version runs in float64 on the same float32 inputs: above
    n = 12 its float32 form inverts M with a 1e-6 jitter that the kernel
    does not add (6e-4 of dq_star on the walker-and-box forest against
    the kernel's host build's 1e-6, tests/test_torch_compose.py)."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    kern = hd.get_dynamics_kernel(model, dr_fields)
    plain_model = hd.with_leaves(model, dr_fields, dr_vals)
    got = kern(q, dq, tau, *dr_vals)
    torch.cuda.synchronize()
    if f64:
        ref = hd.dynamics_reference(plain_model.to(dtype=torch.float64),
                                    q.double(), dq.double(), tau.double())
    else:
        ref = hd.dynamics_reference(plain_model, q, dq, tau)
    errs, abs_errs = {}, {}
    for k, a, r in zip(DYN_TOL, got, ref):
        assert a.shape == r.shape and torch.isfinite(a).all(), k
        abs_errs[k] = float((a - r).abs().max())
        errs[k] = abs_errs[k] / max(1.0, float(r.abs().max()))
    ms = time_ms(lambda: kern(q, dq, tau, *dr_vals))
    dev_ms = device_ms(lambda: kern(q, dq, tau, *dr_vals),
                       "dynamics_kernel")
    plain_ms = time_ms(
        lambda: hd.dynamics_reference(plain_model, q, dq, tau), runs=5,
        warmup=1)
    joints = sorted({int(t) for t in model.joint_type})
    emit(phase, kernel="dynamics", env=name, B=B, n=model.n, nb=model.nb,
         dr_fields=list(dr_fields), lane_group=kern.group,
         joint_types=joints, rel_err=errs, abs_err=abs_errs, ms=ms,
         device_ms=dev_ms, plain_ms=plain_ms, tol_rel=DYN_TOL,
         plain_dtype="float64" if f64 else "float32")
    bad = {k: e for k, e in errs.items() if not e <= DYN_TOL[k]}
    assert not bad, f"dynamics kernel disagrees on {name}: {bad}"
    return dict(max_abs_err=max(abs_errs.values()), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms,
                bound=bound(*dynamics_work(model, B, kern.dr_width)),
                shape=f"{name} B={B} n={model.n} nb={model.nb}"
                      + (f" dr={len(dr_fields)} leaves, {kern.dr_width} "
                         f"floats" if dr_fields else ""))


# the position-update kernel's bound on the rotation and translation
# columns, max |x - x_ref| / (1 + |x_ref|): tests/test_torch_integrate.py's
INTEGRATE_TOL = 1e-6


def integrate_work(model, B):
    """(bytes, flops) of one position-update launch for B envs: q and dq
    read once, q_new written once; 2 flops a column, about 72 a BALL /
    FREE joint's rotation (two exp-maps to quaternions, their product, the
    log) and 105 more a FREE joint's translation (the exp-map to a matrix,
    a matvec), a transcendental counted as one."""
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi

    table = hi.joint_table(model)
    flops = 2 * model.n + 72 * len(table) + 105 * int(table[:, 1].sum())
    return 4 * 3 * model.n * B, flops * B


def check_integrate(name, model, q, dq):
    """Phase integrate for one model: the position-update kernel
    (dynamics/hopper_integrate.integrate on a float32 CUDA batch, one
    launch a call) against its plain version batched.integrate_positions
    on the same (q, dq): the linear columns to the bit, the rotation and
    translation columns of each BALL / FREE joint within INTEGRATE_TOL."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi

    B, dt = q.shape[0], model.dt
    table = hi.joint_table(model)
    rot = [int(s) + k for s, _ in table for k in range(3)]
    tra = [int(s) + 3 + k for s, free in table if free for k in range(3)]
    lin = sorted(set(range(model.n)) - set(rot) - set(tra))
    launches = hi.INTEGRATE_LAUNCHES
    got = hi.integrate(model, q, dq, dt)
    assert hi.INTEGRATE_LAUNCHES == launches + 1, "no kernel launch"
    ref = batched.integrate_positions(model, q, dq, dt)
    torch.cuda.synchronize()
    lin_equal = bool(torch.equal(got[:, lin], ref[:, lin]))
    rel = lambda c: float(((got[:, c] - ref[:, c]).abs()
                           / (1.0 + ref[:, c].abs())).max()) if c else 0.0
    errs = dict(rotation=rel(rot), translation=rel(tra))
    abs_err = float((got - ref).abs().max())
    kern = lambda: hi.integrate(model, q, dq, dt)
    ms = time_ms(kern)
    dev_ms = device_ms(kern, "integrate_kernel")
    plain_ms = time_ms(lambda: batched.integrate_positions(model, q, dq, dt),
                       runs=5, warmup=1)
    emit("integrate", kernel="integrate", env=name, B=B, n=model.n,
         joints=len(table), free_joints=int(table[:, 1].sum()),
         linear_equal=lin_equal, rel_err=errs, abs_err=abs_err, ms=ms,
         device_ms=dev_ms, plain_ms=plain_ms, tol_rel=INTEGRATE_TOL)
    assert torch.isfinite(got).all(), name
    assert lin_equal, f"integrate kernel: linear columns differ on {name}"
    bad = {k: e for k, e in errs.items() if not e <= INTEGRATE_TOL}
    assert not bad, f"integrate kernel disagrees on {name}: {bad}"
    return dict(max_abs_err=abs_err, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound=bound(*integrate_work(model, B)),
                shape=f"{name} B={B} n={model.n} joints={len(table)}")


def random_pushes(model, task, B, gen, dev):
    """(B, nb, 6) external forces as the perturbation branch applies them:
    about half of the envs pushed with `magnitude` N along +-x or +-y at
    the perturbed body's origin."""
    import torch

    _, mag, body, _ = task.perturbation_parameters
    on = (torch.rand(B, generator=gen, device=dev) < 0.5).float()
    axis = torch.randint(0, 2, (B,), generator=gen, device=dev)
    sign = torch.randint(0, 2, (B,), generator=gen, device=dev) * 2.0 - 1.0
    f = torch.zeros((B, model.nb, 6), device=dev)
    f[torch.arange(B, device=dev), body, 3 + axis] = sign * mag * on
    return f


def phasewise_lcp(model, q, dq, tau, lam_prev, f_ext, dyn=None,
                  servo=None):
    """The boxed LCPs of the phase-wise step, as engine/world.make_sim_step
    assembles them (plain dynamics with the external force f_ext, or the
    dynamics phase's outputs dyn = (dq_star, M, phi, R_w, p_w); collision,
    assemble_lcp with the servo targets `servo`, compacted warm start).
    Returns (dq_star, contacts, (A, b, lo, hi, act, mu, findex, MinvJt,
    row_sel), lam0)."""
    from dartenv_tpu_torch.collision.narrowphase import collide
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.engine.constraints import (
        assemble_lcp, build_layout, compact_lam,
    )

    dt = model.dt
    if dyn is None:
        kin = batched.bkin(model, q, dq)
        ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt, f_ext)
        dyn = (dq + dt * ddq, M, kin.phi, kin.R_w, kin.p_w)
    dq_star, M, phi, R_w, p_w = dyn
    contacts = collide(model, R_w, p_w)
    A, b, lo, hi, act, mu, findex, MinvJt, row_sel, _ = assemble_lcp(
        model, build_layout(model), phi, M, q, dq, dq_star, contacts, dt,
        servo_target=servo)
    lam0 = compact_lam(lam_prev, row_sel, act)
    return dq_star, contacts, (A, b, lo, hi, act, mu, findex, MinvJt,
                               row_sel), lam0


def plain_hybrid(cfg, findex, A, b, lo, hi, mu, act, lam0):
    """lcp/hybrid.make_hybrid_solver's stages through the plain versions
    only (PGS with residual, top K, keep-best with the plain BPP,
    scatter), whatever the device."""
    import torch

    from dartenv_tpu_torch.lcp.hopper_pgs import pgs_solve_reference
    from dartenv_tpu_torch.lcp.hybrid import escalate_rows, escalation_size

    assert cfg.escalate_frac > 0 and cfg.escalate_iters2 == 0
    lam, res = pgs_solve_reference(A, b, lo, hi, findex, mu, act,
                                   iters=cfg.pgs_iters, omega=cfg.pgs_omega,
                                   lam0=lam0, return_residual=True)
    K = escalation_size(b.shape[0], cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res, K)
    budgets = cfg_budgets(cfg)
    return escalate_rows(A, b, lo, hi, mu, act, lam, idx, worst, findex,
                         cfg.escalate_tol, *plain_tiers(findex, budgets),
                         *budgets[6:8])[0]


def plain_solve(cfg, findex, A, b, lo, hi, mu, act, lam0):
    """engine/constraints.run_lcp_solver through the plain versions only:
    the BPP kernel's over the batch in the "dantzig" mode, else the plain
    hybrid solve, or plain PGS without escalation."""
    from dartenv_tpu_torch.lcp.hopper_bpp import bpp_solve_reference
    from dartenv_tpu_torch.lcp.hopper_pgs import pgs_solve_reference

    if cfg.solver == "dantzig":
        return bpp_solve_reference(A, b, lo, hi, findex, mu, act, lam0=lam0)
    if cfg.escalate_frac > 0:
        return plain_hybrid(cfg, findex, A, b, lo, hi, mu, act, lam0)
    return pgs_solve_reference(A, b, lo, hi, findex, mu, act,
                               iters=cfg.pgs_iters, omega=cfg.pgs_omega,
                               lam0=lam0)


def plain_phasewise_substep(model, q, dq, lam, tau, f_ext, servo=None):
    """One phase-wise substep through the plain versions only, composed
    here as engine/world.make_sim_step composes the kernels: without an
    external force the dynamics kernel's plain version (in float64 above
    n = 12, see check_dynamics), and for a model with constraint rows
    collision, assembly (with the servo targets `servo`) and
    `plain_solve`; with an external force the plain dynamics, collision,
    assembly and the plain solve.  Then the position update.  Returns (q,
    dq, lam)."""
    import torch

    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine.constraints import (
        build_layout, scatter_lam,
    )
    from dartenv_tpu_torch.math.linalg import _UNROLL_MAX

    m = build_layout(model).m
    dyn = None
    if f_ext is None and model.n > _UNROLL_MAX:
        dyn = tuple(x.float() for x in hd.dynamics_reference(
            model.to(dtype=torch.float64), q.double(), dq.double(),
            tau.double()))
    elif f_ext is None:
        dyn = hd.dynamics_reference(model, q, dq, tau)
    if m == 0:
        dq_plus = dyn[0]
    else:
        dq_star, _, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam,
                                               f_ext, dyn, servo)
        A, b, lo, hi, act, mu, findex, MinvJt, row_sel = prob
        assert f_ext is None or model.solver.solver != "dantzig"
        lam_c = plain_solve(model.solver, findex, A, b, lo, hi, mu, act,
                            lam0)
        dq_plus = dq_star + torch.sum(MinvJt * lam_c[:, None, :], dim=-1)
        lam = scatter_lam(lam_c, row_sel, m)
    return (batched.integrate_positions(model, q, dq_plus, model.dt),
            dq_plus, lam)


def random_lcps(B, nc, nl, seed, dev):
    """Boxed LCPs as the JAX package's kernel tests draw them
    (tests/test_pallas_kernels.py::_problems): m = 3 nc + nl rows, nc
    contacts with two friction rows each (mu 0.8), A = G G^T / (m + 4) +
    1e-5 I, about 80 % of the rows active; a warm start U(0, 0.2) on the
    active rows.  Returns (A, b, lo, hi, findex, mu, act, lam0), float32 on
    `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = 3 * nc + nl
    findex = -np.ones(m, dtype=np.int64)
    lo = np.zeros(m)
    mu = np.zeros(m)
    for s in range(nc):
        findex[3 * s + 1:3 * s + 3] = 3 * s
        lo[3 * s + 1:3 * s + 3] = -1e20
        mu[3 * s + 1:3 * s + 3] = 0.8
    G = rng.normal(size=(B, m, m + 4))
    A = G @ np.swapaxes(G, 1, 2) / (m + 4) + 1e-5 * np.eye(m)
    act = (rng.uniform(size=(B, m)) > 0.2).astype(np.float64)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    return (f(A), f(rng.normal(size=(B, m))), f(np.tile(lo, (B, 1))),
            f(np.full((B, m), 1e20)), findex, f(np.tile(mu, (B, 1))),
            f(act), f(rng.uniform(0.0, 0.2, (B, m)) * act))


def compare_pgs(label, prob, iters, omega):
    """The PGS kernel against its plain version on one batch of LCPs, at
    the JAX package's bound between its Pallas kernel and XLA: impulses
    rtol 1e-5 / atol 1e-6, residuals rtol 1e-4 / atol 1e-7.  Returns the
    kernel's (lam, res) and what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    A, b, lo, hi, findex, mu, act, lam0 = prob
    B, m = b.shape
    args = (A, b, lo, hi, findex, mu, act)
    kw = dict(iters=iters, omega=omega, lam0=lam0, return_residual=True)
    lam_k, res_k = hp.pgs_solve_cuda(*args, **kw)
    torch.cuda.synchronize()
    lam_r, res_r = hp.pgs_solve_reference(*args, **kw)
    lam_bad = (lam_k - lam_r).abs() > 1e-6 + 1e-5 * lam_r.abs()
    res_bad = (res_k - res_r).abs() > 1e-7 + 1e-4 * res_r.abs()
    lam_err = float((lam_k - lam_r).abs().max())
    run = lambda: hp.pgs_solve_cuda(*args, **kw)
    ms = time_ms(run)
    dev_ms = device_ms(run, "pgs_kernel")
    plain_ms = time_ms(lambda: hp.pgs_solve_reference(*args, **kw),
                       runs=5, warmup=1)
    emit("pgs", env=label, B=B, m=m, iters=iters,
         active_rows=float(act.sum()), lam_abs_err=lam_err,
         lam_abs_max=float(lam_r.abs().max()),
         res_abs_err=float((res_k - res_r).abs().max()),
         res_max=float(res_r.max()), res_median=float(res_r.median()),
         lam_entries_beyond_tol=int(lam_bad.sum()),
         res_envs_beyond_tol=int(res_bad.sum()),
         lam_envs_unequal=int((lam_k != lam_r).any(1).sum()),
         res_envs_unequal=int((res_k != res_r).sum()), ms=ms,
         device_ms=dev_ms, plain_ms=plain_ms,
         tol_lam=dict(rtol=1e-5, atol=1e-6),
         tol_res=dict(rtol=1e-4, atol=1e-7))
    assert float(act.sum()) > B, "constraint rows are not live"
    assert torch.isfinite(lam_k).all() and torch.isfinite(res_k).all()
    assert not bool(lam_bad.any()) and not bool(res_bad.any()), label
    words = m * m + 7 * m + 1          # A, 6 vectors in; lam, res out
    flops = 2 * (iters + 1) * m * (m + 4)
    return lam_k, res_k, dict(
        max_abs_err=lam_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound=bound(4 * words * B, flops * B),
        shape=f"{label} B={B} m_c={m} iters={iters} residual")


def check_pgs(dev, name, states, ref64=0):
    """Phase pgs: the PGS kernel against its plain version on the LCPs of
    the perturbed env's phase-wise step (states from its rollout, about
    half of the envs pushed): walker2d at B = 4096, humanwalker at
    B = 1024 (41 rows, two per lane); for walker2d also on random LCPs of
    m = 40 rows and the BPP kernel's core mode on the hybrid's top K.
    Then the BPP kernel's hybrid mode (with humanwalker's two refinement
    passes, or `ref64` passes of the mixed-precision tier) on the hybrid's
    top K.  Returns what the kernels line needs for the PGS kernel and the
    hybrid mode."""
    import dataclasses

    import torch

    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp.hybrid import escalation_size

    task = make_task(name, device=dev)
    model, cfg = task.model, task.model.solver
    label = name + "_perturbed"
    if ref64:
        # the mixed-precision tier (ES_REF64) in place of the model's own
        cfg = dataclasses.replace(cfg, escalate_ref64=ref64)
        label += "_ref64"
    q, dq, tau, lam_prev = states
    B = q.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    f_ext = random_pushes(model, task, B, gen, dev)
    _, _, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam_prev, f_ext)
    A, b, lo, hi, act, mu, findex, _, _ = prob
    lam_k, res_k, pgs = compare_pgs(
        label, (A, b, lo, hi, findex, mu, act, lam0), cfg.pgs_iters,
        cfg.pgs_omega)
    if name == "walker2d":
        compare_pgs("random_m40", random_lcps(B, 10, 10, 3, dev),
                    cfg.pgs_iters, cfg.pgs_omega)

    K = escalation_size(B, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res_k, K)
    if name == "walker2d":
        check_bpp(label, cfg, findex, A[idx], b[idx], lo[idx], hi[idx],
                  mu[idx], act[idx], lam_k[idx])

    # the hybrid mode: the whole escalation of the phase-wise solve
    return pgs, check_hybrid_batch(label, cfg, findex, (A, b, lo, hi, mu,
                                                       act), lam_k, worst,
                                   idx)


def check_hybrid_batch(label, cfg, findex, prob, lam_k, worst, idx):
    """Phase hybrid: the BPP kernel's hybrid mode (the whole escalation of
    a phase-wise solve, one launch, with the refinement tier of `cfg`)
    against its plain version (lcp/hybrid.escalate_rows) on a batch's
    LCPs `prob` = (A, b, lo, hi, mu, act), the PGS kernel's impulses lam_k
    and the top K (worst, idx) of its residuals.  Returns what the kernels
    line needs."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp.hybrid import escalate_rows

    A, b, lo, hi, mu, act = prob
    B, m = b.shape
    K = idx.shape[0]
    budgets = cfg_budgets(cfg)
    tiers = plain_tiers(findex, budgets)
    run_k = lambda: hb.bpp_hybrid(A, b, lo, hi, mu, act, lam_k, idx, worst,
                                  findex, cfg.escalate_tol, budgets)
    run_r = lambda: escalate_rows(A, b, lo, hi, mu, act, lam_k, idx, worst,
                                  findex, cfg.escalate_tol, *tiers,
                                  *budgets[6:8])
    out_k, take_k, kept_k = run_k()
    torch.cuda.synchronize()
    out_r, take_r, kept_r = run_r()
    rest = torch.ones(B, dtype=torch.bool, device=A.device)
    rest[idx] = False
    others = (torch.equal(out_k[rest], out_r[rest])
              and torch.equal(out_k[rest], lam_k[rest]))
    line, err = compare_escalation(
        "hybrid", label, K, (out_k[idx], take_k, kept_k),
        (out_r[idx], take_r, kept_r), others)
    ms = time_ms(run_k)
    dev_ms = device_ms(run_k, "bpp_hybrid_kernel")
    plain_ms = time_ms(run_r, runs=5, warmup=1)
    hbb, hbf = escalate_work(K, m, budgets, m * m + 7 * m, m)
    emit("hybrid", **line, m=m, refine_passes=budgets[6],
         ref64_passes=budgets[7], ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
         bound_ms=bound(hbb, hbf)[0])
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound=bound(hbb, hbf), solved_kernel=line["solved_kernel"],
                shape=f"{label} K={K} m={m} hybrid "
                      f"iters={budgets[0]}+{budgets[1]} "
                      f"refine_passes={budgets[6]} "
                      f"ref64_passes={budgets[7]}")


def check_core_batch(name, dev, states):
    """Phase bpp_batch: the BPP kernel's core mode over a whole batch, as
    the solver="dantzig" mode runs it (lcp/dantzig.make_exact_solver with
    its defaults: 24 damped + 8 undamped pivots and 10 polish sweeps, warm
    from the compacted impulses, one warp per env and a grid of B blocks),
    on the phase-wise LCPs of the env's rollout states (dynamics through
    the plain path), against its plain version env by env, as check_bpp
    holds the escalation's K: at most BPP_MAY_DIVERGE of every 128 envs
    may part.  Returns what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp.dantzig import make_exact_solver
    from dartenv_tpu_torch.lcp.hybrid import comp_residual

    model = make_task(name, device=dev, lcp_solver="dantzig").model
    q, dq, tau, lam_prev = states
    _, _, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam_prev, None)
    A, b, lo, hi, act, mu, findex, _, _ = prob
    B, m = b.shape
    solve = make_exact_solver(findex)
    run_k = lambda: solve(A, b, lo, hi, mu, act, lam0)
    # make_exact_solver's defaults
    run_r = lambda: hb.bpp_solve_reference(A, b, lo, hi, findex, mu, act,
                                           iters=24, polish_iters=10,
                                           lam0=lam0)
    launches = hb.CORE_LAUNCHES
    lam_k = run_k()
    torch.cuda.synchronize()
    assert hb.CORE_LAUNCHES == launches + 1
    lam_r = run_r()
    resid = lambda lam: comp_residual(A, b, lam, lo, hi, findex, mu, act)
    r_k, r_r, r_w = resid(lam_k), resid(lam_r), resid(lam0)
    env_err = ((lam_k - lam_r).abs().max(1).values
               / lam_r.abs().max(1).values.clamp(min=1.0))
    same = env_err <= 1e-5
    n_same = int(same.sum())
    err = float((lam_k - lam_r)[same].abs().max())
    res_diff = float((r_k - r_r)[same].abs().max())
    allowed = BPP_MAY_DIVERGE * -(-B // 128)
    ms = time_ms(run_k)
    dev_ms = device_ms(run_k, "bpp_core_kernel")
    plain_ms = time_ms(run_r, runs=2, warmup=0)
    lib = hb.load(m)
    per_sm = lib.bpp_core_blocks_per_sm()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    solved = lambda r: int((r < 1e-4).sum())
    bb, bf = bpp_work(m, B, 24, 8, 10)
    emit("bpp_batch", env=name, solver="dantzig", B=B, m=m,
         active_rows=float(act.sum()), envs_same=n_same,
         envs_parted=B - n_same, lam_abs_err_same=err,
         res_abs_diff_same=res_diff,
         lam_abs_max=float(lam_r.abs().max()),
         res_kernel_max=float(r_k.max()), res_plain_max=float(r_r.max()),
         res_warm_start_max=float(r_w.max()),
         res_kernel_median=float(r_k.median()),
         solved_kernel=solved(r_k), solved_plain=solved(r_r),
         solved_warm_start=solved(r_w), blocks_per_sm=per_sm, sms=sms,
         waves=B / (per_sm * sms), ms=ms, device_ms=dev_ms,
         plain_ms=plain_ms, bound_ms=bound(bb, bf)[0],
         bound_by=bound(bb, bf)[1], tol_lam=1e-5, tol_res_diff=1e-5,
         tol_envs_parted=allowed)
    assert torch.isfinite(lam_k).all()
    assert float(act.sum()) > B, "constraint rows are not live"
    assert B - n_same <= allowed, (name, B - n_same, allowed)
    assert err <= 1e-5 and res_diff <= 1e-5
    assert solved_as_plain(B, solved(r_k), solved(r_r), n_same)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound=bound(bb, bf),
                shape=f"{name} B={B} m={m} core iters=24+8 polish=10")


# ---- domain randomization ------------------------------------------------
# The builds with per-env DR leaves, (env, field set) -> batch: "spec" is
# the throughput bench's spec (bench/throughput.DR_SPEC: mass,
# geom_friction, damping; kernel 3 takes its dynamics leaves), "all" every
# leaf the kernel takes (DR_FIELDS_SUB, DR_FIELDS_DYN).
DR_SUBSTEP = {("walker2d", "spec"): 4096, ("walker2d", "all"): 4096,
              ("walker3d", "spec"): 4096, ("humanwalker", "spec"): 1024}
DR_DYNAMICS = {("cartpole", "all"): 8192, ("cartpole", "spec"): 8192,
               ("walker2d", "mass_damping"): 4096}
# bench_dr paths: env -> (batch, substeps); one warm-up run and one more
DR_PATHS = {"walker2d": (4096, 400), "cartpole": (8192, 400),
            "walker3d": (4096, 400)}
# env -> the most envs of its bench_dr path that may end non-finite.
# bench_dr holds fixed torques U(-50, 50) on every dof, the FREE root's
# included, and walker3d envs run away under it in every route
# (scripts/torch_dr_runaway.py, 4096 envs, 400 substeps, on an H100): env
# 1717 in the fused kernel route with and without DR and in the
# phase-wise route, envs 1717 and 3050 in the plain versions in float64
# (PERF.md)
DR_RUNAWAY_MAX = {"walker3d": 2}
# the walker2d_frames path: per-env leaves outside the fused route's set
# (joint axes and offsets, limits, the ground's height, and mass), which
# run the phase-wise route with the plain batched dynamics; (batch,
# substeps) of the counted drive, and (envs, substeps) of its lockstep
# against the float64 plain version on the CPU
FRAME_FIELDS = ("axes", "pj_pos", "q_lower", "q_upper", "wg_offset", "mass")
FRAMES_PATH = (4096, 40)
FRAMES_LOCK = (256, 4)


def dr_fields_of(tag, kernel):
    """The DR leaves of a build of phase dr."""
    from dartenv_tpu_torch.bench.throughput import DR_SPEC
    from dartenv_tpu_torch.dynamics.hopper_dynamics import DR_FIELDS_DYN
    from dartenv_tpu_torch.engine.hopper_substep import DR_FIELDS_SUB

    if tag == "mass_damping":
        return ("mass", "damping")
    if tag == "all":
        return DR_FIELDS_SUB if kernel == "substep" else DR_FIELDS_DYN
    return tuple(f for f in DR_SPEC
                 if kernel == "substep" or f in DR_FIELDS_DYN)


def dr_values(model, fields, B, seed, dev):
    """Per-env values of the DR leaves, (B, ...) float32 on `dev`, drawn
    from `seed`: each leaf scaled entry by entry by uniform(0.7, 1.3) (the
    inertia tensors by one such factor per body, so they stay positive
    definite), spring stiffness uniform(0, 20) and rest positions
    uniform(-0.1, 0.1) (zero in the shipped models): every env its own
    values, up to 30 % apart."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(
        shape, generator=gen, device=dev)
    out = []
    for f in fields:
        base = getattr(model, f)
        shape = (B,) + tuple(base.shape)
        if f == "inertia":
            v = base * u(shape[:2] + (1, 1), 0.7, 1.3)
        elif f == "spring_stiff":
            v = u(shape, 0.0, 20.0)
        elif f == "rest_pos":
            v = u(shape, -0.1, 0.1)
        else:
            v = base * u(shape, 0.7, 1.3)
        out.append(v.contiguous())
    return out


def base_values(model, fields, B):
    """The base model's values of the DR leaves, for every env."""
    return [getattr(model, f).expand((B,) + tuple(getattr(model, f).shape))
            for f in fields]


def identity_and_base(label, kern, plain_kern, ins, vals, model, gen,
                      blocks=None, tol=None):
    """Phase dr, two properties of a DR build: env identity (the envs of
    the inputs and of the DR leaves permuted: the outputs are the
    unpermuted outputs, permuted, to the bit), and the base values (every
    DR value the base model's: the outputs within the phase's bound of the
    build without DR inputs, `plain_kern`; whether to the bit is
    printed).  blocks: outputs -> named blocks; tol: block -> bound."""
    import torch

    B = ins[0].shape[0]
    outs = kern(*ins, *vals)
    perm = torch.randperm(B, generator=gen, device=ins[0].device)
    outs_p = kern(*(x[perm] for x in ins), *(v[perm] for v in vals))
    as_dict = lambda o: o if isinstance(o, dict) else dict(enumerate(o))
    ident = all(torch.equal(a, as_dict(outs)[k][perm])
                for k, a in as_dict(outs_p).items())
    got = kern(*ins, *base_values(model, kern.dr_fields, B))
    want = plain_kern(*ins)
    got_b, want_b = (blocks(x) for x in (got, want)) if blocks else (
        as_dict(got), as_dict(want))
    bitwise = all(torch.equal(got_b[k], want_b[k]) for k in want_b)
    errs = {str(k): float((got_b[k] - w).abs().max())
            / max(1.0, float(w.abs().max()))
            for k, w in want_b.items() if w.numel()}
    emit("dr", check="identity_and_base", env=label, B=B,
         permuted_outputs_bitwise=ident, base_values_bitwise=bitwise,
         base_values_rel_err=errs)
    assert ident, f"{label}: the outputs do not follow the envs"
    bad = {k: e for k, e in errs.items() if not e <= tol(k)}
    assert not bad, f"{label}: base values off the build without DR: {bad}"


def lockstep_dr(dev, kern, states):
    """Phase dr, lockstep: one walker2d control step of a DR batch
    (B = 1024, the bench's draw of randomize_model) through the port's
    randomized sim step (the DR substep kernel and the escalation kernel)
    beside the plain path composed here on the per-env model, as phase
    lockstep holds the paths without DR."""
    import torch

    from dartenv_tpu_torch.bench.throughput import DR_SPEC
    from dartenv_tpu_torch.dynamics.hopper_dynamics import with_leaves
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.engine.world import SimState
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel.domain_rand import (
        make_randomized_sim_step, randomize_model,
    )

    task = make_task("walker2d", device=dev)
    model, cfg, st = task.model, task.model.solver, kern.st
    Bl = min(1024, states[0].shape[0])
    q, dq, _, lam = (x[:Bl].clone() for x in states)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    bmodel = randomize_model(model, DR_SPEC, Bl, gen)
    fields = tuple(DR_SPEC)
    assert fields == kern.dr_fields
    m_dr = with_leaves(model, fields, [getattr(bmodel, f) for f in fields])
    step = make_randomized_sim_step(model, fields)
    tiers = plain_tiers(st.findex_c, cfg_budgets(cfg))
    hi_a = torch.as_tensor(task.control_bounds[0], device=dev,
                           dtype=torch.float32)
    a = (torch.rand((Bl, task.action_size), generator=gen, device=dev)
         * 2 - 1) * hi_a
    tau = task.action_to_tau(a, ())
    rows = list(range(0, 3 * st.ns, 3)) + list(range(3 * st.ns,
                                                     st.layout.m))
    sk = SimState(q=q, dq=dq, time=q.new_zeros(Bl), lam=lam)
    sp = (q, dq, lam)
    same = torch.ones(Bl, dtype=torch.bool, device=dev)
    plain_before = plain_counts()
    launches_before = hs.SUBSTEP_LAUNCHES
    for _ in range(task.frame_skip):
        sk, _ = step(bmodel, sk, tau)
        sp = plain_substep(m_dr, st, tiers, *sp[:3], tau)
        same &= (sk.lam[:, rows] > 0).eq(sp[2][:, rows] > 0).all(1)
    rel = lambda x, y: ((x - y).abs() / y.abs().clamp(min=1.0)).max(
        1).values
    q_err, dq_err = rel(sk.q, sp[0]), rel(sk.dq, sp[1])
    lock = dict(same_contact_frac=float(same.float().mean()),
                q_err=float(q_err[same].max()),
                dq_err=float(dq_err[same].max()),
                dq_err_all=float(dq_err.max()),
                envs_beyond_tol=int(((dq_err > 1e-3)
                                     | (q_err > 1e-3))[same].sum()),
                q_err_q99=float(q_err[same].quantile(0.99)),
                dq_err_q99=float(dq_err[same].quantile(0.99)))
    emit("dr", check="lockstep", env="walker2d_dr", B=Bl, **lock,
         tol=1e-3, tol_envs_beyond=LOCK_MAY_DIVERGE)
    assert plain_counts() == plain_before    # the kernel path took none
    assert hs.SUBSTEP_LAUNCHES - launches_before == task.frame_skip
    assert torch.isfinite(sk.q).all() and torch.isfinite(sk.dq).all()
    assert lock["same_contact_frac"] > 0.9
    assert lock["envs_beyond_tol"] <= LOCK_MAY_DIVERGE
    assert lock["q_err_q99"] <= 1e-3 and lock["dq_err_q99"] <= 1e-3


def check_dr(dev, checks, dr_kerns, dyn_models):
    """Phase dr: the substep kernel and the dynamics kernel built with
    per-env DR leaves, each against its DR plain version at the bounds of
    phases substep and dynamics, on the check states of those phases with
    per-env leaves (dr_values); env identity under a permutation and the
    base values (identity_and_base); a partly filled last block (walker2d
    B = 4095, cartpole B = 8191); the escalation kernel's fused mode on the
    walker2d DR substep's outputs (phase escalate's rules); a lockstep
    control step (lockstep_dr).  Returns what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.engine import hopper_substep as hs

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    out = {}
    for i, ((e, tag), kern) in enumerate(dr_kerns.items()):
        B, model = DR_SUBSTEP[(e, tag)], kern.model
        ins = checks[e]["states"]
        assert ins[0].shape[0] == B
        vals = dr_values(model, kern.dr_fields, B, 20 + i, dev)
        m64 = plain64(model)
        outs = kern(*ins, *vals)
        c = hold_substep(f"{e}_dr_{tag}", model, kern, outs, ins, m64, vals,
                         phase="dr")
        after = lambda f: m64 is not None and f in AFTER_SWEEPS
        identity_and_base(
            f"{e}_dr_{tag}", kern, hs.get_substep_kernel(model), ins, vals,
            model, gen, blocks=lambda o: hs.output_blocks(kern.st, o),
            tol=lambda f: 0.0 if f in EXACT_BLOCKS else (
                2e-2 if after(f) else 1e-4))
        if (e, tag) == ("walker3d", "spec"):
            out["substep_walker3d"] = c
        if (e, tag) == ("walker2d", "spec"):
            out["substep"] = c
            # B not a multiple of the 16 envs per block
            Bp = 4095
            assert Bp % kern.shape[0]
            part = [x[:Bp] for x in ins]
            vp = [v[:Bp] for v in vals]
            hold_substep(f"{e}_dr_{tag}", model, kern, kern(*part, *vp),
                         part, m64, vp, phase="dr")
            out["escalate"] = check_escalate(f"{e}_dr", kern.st,
                                             model.solver, outs)
            lockstep_dr(dev, kern, ins)
    for i, ((e, tag), Bd) in enumerate(DR_DYNAMICS.items()):
        from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

        model = dyn_models[e]
        fields = dr_fields_of(tag, "dynamics")
        sizes = [Bd] + ([Bd - 1] if tag == "all" else [])
        for Bs in sizes:
            if e == "walker2d":
                q, dq, tau = (x[:Bs] for x in checks[e]["states"][:3])
            else:
                q, dq, tau = random_states(model, Bs, 200 + i, dev)
            vals = dr_values(model, fields, Bs, 30 + i, dev)
            c = check_dynamics(f"{e}_dr_{tag}", model, Bs, q, dq, tau,
                               fields, vals, phase="dr")
            if Bs == Bd:
                identity_and_base(
                    f"{e}_dr_{tag}", hd.get_dynamics_kernel(model, fields),
                    hd.get_dynamics_kernel(model), (q, dq, tau), vals,
                    model, gen,
                    tol=lambda k: DYN_TOL[("dq_star", "M", "phi", "R_w",
                                           "p_w")[int(k)]])
            if (e, tag) == ("cartpole", "spec") and Bs == Bd:
                out["dynamics"] = c
    return out


def drive_dr_path(dev, name, smi):
    """Phase dr_path: bench_dr (a domain-randomized batch, the bench's
    spec, fixed random torques) with every launch counter and plain-call
    counter set to 0 just before and read just after.  Walker2d and
    walker3d run the DR substep kernel and the escalation kernel's fused
    mode on every substep; cartpole (no constraint rows) the DR dynamics
    kernel; walker3d's position update the position-update kernel, the
    others' its plain version (integrate_counts).  The
    rate is printed with the card; it sets no limit.  Returns the launch
    counts."""
    import torch

    from dartenv_tpu_torch.bench.throughput import bench_dr
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel import domain_rand as tdr

    B, substeps = DR_PATHS[name]
    zero_counters()
    tdr.PLAIN_DYNAMICS_STEPS = 0
    t0 = time.time()
    out = bench_dr(name, batch=B, substeps=substeps, iters=1, device=dev)
    seconds = time.time() - t0
    counts = read_counters()
    plain = sum(plain_counts())
    emit("dr_path", card=smi, **out,
         nonfinite_envs_max=DR_RUNAWAY_MAX.get(name, 0),
         **{f"{k}_launches": v for k, v in counts.items()},
         plain_calls=plain,
         plain_dynamics_steps=tdr.PLAIN_DYNAMICS_STEPS, seconds=seconds)
    sub = substeps * out["runs"]
    want = dict.fromkeys(counts, 0)
    want.update(integrate_counts(make_task(name, device=dev).model, sub))
    if name == "cartpole":
        want.update(dynamics=sub)
    else:
        want.update(substep=sub, bpp_fused=sub)
    assert counts == want, (counts, want)
    assert plain == 0 and tdr.PLAIN_DYNAMICS_STEPS == 0
    assert out["nonfinite_envs"] <= DR_RUNAWAY_MAX.get(name, 0), out
    assert torch.cuda.is_available()
    return dict(counts, steps=sub / out["frame_skip"])


def frame_model(model, B, gen):
    """The walker2d_frames batch: `model` with per-env FRAME_FIELDS, drawn
    from `gen` with randomize_model (joint axes and offsets scaled per env
    by U(0.95, 1.05), the limits by U(0.9, 1.1), mass by U(0.7, 1.3)),
    and the ground plane moved along its normal by U(-0.02, 0.02) m per
    env (its offset is 0, which a scale would keep)."""
    import torch

    from dartenv_tpu_torch.parallel.domain_rand import randomize_model

    bm = randomize_model(model, {"axes": 0.05, "pj_pos": 0.05,
                                 "q_lower": 0.1, "q_upper": 0.1,
                                 "mass": 0.3}, B, gen)
    off = model.wg_offset
    shift = torch.rand((B,) + tuple(off.shape), generator=gen,
                       device=gen.device) * 0.04 - 0.02
    return bm.replace(wg_offset=off[None] + shift.to(off))


def drive_frames_path(dev, smi, states):
    """Phase dr_path, walker2d_frames: a walker2d batch with per-env
    FRAME_FIELDS (frame_model) from the check's states (q, dq, tau, lam),
    stepped by make_randomized_sim_step under fixed random torques.  No
    fused route serves these leaves, and a frame leaf keeps the dynamics
    kernel out (its build holds the base model's frames): each substep
    runs the plain batched dynamics (PLAIN_DYNAMICS_STEPS), collision on
    the per-env ground, the limit rows from the per-env limits, the PGS
    kernel and the BPP kernel's hybrid mode.  First FRAMES_LOCK envs and
    substeps are held against the same step in float64 on the CPU (the
    plain versions), at phase dr's lockstep bound; then FRAMES_PATH with
    every counter set to 0 just before and read just after.  Returns the
    launch counts."""
    import torch

    from dartenv_tpu_torch.engine.world import SimState
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel import domain_rand as tdr

    task = make_task("walker2d", device=dev)
    model = task.model
    B, substeps = FRAMES_PATH
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    bmodel = frame_model(model, B, gen)
    step = tdr.make_randomized_sim_step(model, FRAME_FIELDS)
    q, dq, _, lam = (x[:B].clone() for x in states)
    tau = (torch.rand((B, model.n), generator=gen, device=dev) * 2
           - 1) * 50.0
    s0 = SimState(q=q, dq=dq, time=q.new_zeros(B), lam=lam)

    # lockstep: the card's float32 step beside the CPU's float64 one
    Bl, nl = FRAMES_LOCK
    cpu64 = lambda x: x[:Bl].to(device="cpu", dtype=torch.float64)
    base64 = model.to("cpu", torch.float64)
    b64 = base64.replace(**{f: cpu64(getattr(bmodel, f))
                            for f in FRAME_FIELDS})
    bml = model.replace(**{f: getattr(bmodel, f)[:Bl]
                           for f in FRAME_FIELDS})
    step64 = tdr.make_randomized_sim_step(base64, FRAME_FIELDS)
    sk = SimState(q=q[:Bl], dq=dq[:Bl], time=q.new_zeros(Bl), lam=lam[:Bl])
    sp = SimState(q=cpu64(q), dq=cpu64(dq), time=torch.zeros(
        Bl, dtype=torch.float64), lam=cpu64(lam))
    same = torch.ones(Bl, dtype=torch.bool)
    for _ in range(nl):
        sk, _ = step(bml, sk, tau[:Bl])
        sp, _ = step64(b64, sp, cpu64(tau))
        same &= (sk.lam.cpu() > 0).eq(sp.lam > 0).all(1)
    rel = lambda x, y: ((x.cpu().double() - y).abs()
                        / y.abs().clamp(min=1.0)).max(1).values
    q_err, dq_err = rel(sk.q, sp.q), rel(sk.dq, sp.dq)
    lock = dict(same_contact_frac=float(same.float().mean()),
                q_err=float(q_err[same].max()),
                dq_err=float(dq_err[same].max()),
                dq_err_all=float(dq_err.max()),
                envs_beyond_tol=int(((q_err > 1e-3)
                                     | (dq_err > 1e-3))[same].sum()),
                envs_beyond_tol_all=int(((q_err > 1e-3)
                                         | (dq_err > 1e-3)).sum()),
                q_err_q99=float(q_err[same].quantile(0.99)),
                dq_err_q99=float(dq_err[same].quantile(0.99)))
    # phase dr's lockstep rule (lockstep_dr): envs whose contact sets
    # stayed the same are held
    emit("lockstep", env="walker2d_frames", B=Bl, substeps=nl,
         reference="float64 CPU", **lock, tol=1e-3,
         tol_envs_beyond=LOCK_MAY_DIVERGE)
    assert lock["same_contact_frac"] > 0.9, lock
    assert lock["envs_beyond_tol"] <= LOCK_MAY_DIVERGE, lock
    assert lock["q_err_q99"] <= 1e-3 and lock["dq_err_q99"] <= 1e-3, lock

    state = s0
    for _ in range(4):                   # warm-up, outside the count
        state, _ = step(bmodel, state, tau)
    zero_counters()
    tdr.PLAIN_DYNAMICS_STEPS = 0
    torch.cuda.synchronize()
    t0 = time.time()
    state = s0
    for _ in range(substeps):
        state, _ = step(bmodel, state, tau)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = read_counters()
    plain = sum(plain_counts())
    finite = bool(torch.isfinite(state.q).all()
                  and torch.isfinite(state.dq).all())
    emit("dr_path", env="walker2d_frames", card=smi, batch=B,
         substeps=substeps, dr_fields=list(FRAME_FIELDS),
         env_steps_per_s=B * substeps / task.frame_skip / seconds,
         **{f"{k}_launches": v for k, v in counts.items()},
         plain_calls=plain, plain_dynamics_steps=tdr.PLAIN_DYNAMICS_STEPS,
         finite_state=finite, seconds=seconds)
    want = dict.fromkeys(counts, 0)
    want.update(pgs=substeps, bpp_hybrid=substeps,
                **integrate_counts(model, substeps))
    assert counts == want, (counts, want)
    assert plain == 0 and tdr.PLAIN_DYNAMICS_STEPS == substeps
    assert finite
    return dict(counts, steps=substeps / task.frame_skip)


# ---- the bench surface ---------------------------------------------------

# the knob run of phase bench_cli: a cold start, 12 PGS sweeps and an
# escalation cap of 256, at a batch whose 1/32 is 256
BENCH_KNOBS = ["--env", "walker2d", "--batch", "8192", "--cold",
               "--pgs_iters", "12", "--escalate_kmax", "256",
               "--horizon", "10", "--iters", "1"]


def knob_model(dev):
    """walker2d's model with BENCH_KNOBS' solver overrides."""
    from dartenv_tpu_torch.envs.base import with_solver
    from dartenv_tpu_torch.envs.tasks import make_task

    return with_solver(make_task("walker2d", device=dev).model,
                       pgs_iters=12, escalate_kmax=256)


def check_knob_kernels(kern, states):
    """Phase bench_cli, the knob run's builds against their plain versions
    on walker2d's check states (q, dq, tau, lam): the substep kernel built
    with 12 PGS sweeps, and the fused escalation on its outputs (the cap
    of 256 leaves K = 128 at B = 4096).  Returns the kernels line's
    checks."""
    model = kern.model
    outs = kern(*states)
    return {"substep": hold_substep("walker2d_knobs", model, kern, outs,
                                    states, None, phase="bench_cli"),
            "bpp_fused": check_escalate("walker2d_knobs", kern.st,
                                        model.solver, outs)}


def kernels_in_ranges(path, name):
    """Names of the device kernels launched inside the record_function
    ranges `name` of a torch.profiler Chrome trace: a kernel whose launch
    (the runtime call of the same correlation id) lies within a host range
    of that name on the same thread, or whose execution lies within the
    device range of that name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    host = [(e["tid"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("name") == name and e.get("cat") == "user_annotation"]
    gpu = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
           if e.get("name") == name
           and e.get("cat") == "gpu_user_annotation"]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel"
               and "correlation" in e.get("args", {})}
    found = set()
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr in kernels and any(
                e["tid"] == tid and a <= e["ts"] <= b for tid, a, b in host):
            found.add(kernels[corr]["name"])
    for k in kernels.values():
        if any(a <= k["ts"] <= b for a, b in gpu):
            found.add(k["name"])
    return dict(host_ranges=len(host), device_ranges=len(gpu),
                kernels=sorted(found))


def check_bench_cli(dev, smi, root):
    """Phase bench_cli: the bench CLI in this process.  (1) --all at
    horizon 10, one timed rollout: five metric lines, the JAX CLI's
    metric strings, each with the card.  (2) BENCH_KNOBS with every
    counter set to 0 just before and read just after: the substep kernel
    (its pgs_iters 12 build) and the BPP kernel's fused mode once per
    substep, no plain call, K = 256, no warm start.  (3) one bench_env
    rollout with profile_dir: the trace holds the substep_fused range
    with the substep kernel's and the fused mode's launches inside it.
    Returns the knob run's launch counts."""
    from dartenv_tpu_torch.bench import throughput
    from dartenv_tpu_torch.envs.tasks import make_task

    t0 = time.time()
    runs = throughput.main(["--all", "--horizon", "10", "--iters", "1"])
    lines = [ln for _, ln in runs]
    want = [f"env-steps/s/chip (batched Dart{e.capitalize()}, B={b})"
            for e, b, _ in throughput.BASELINE_CONFIGS]
    emit("bench_cli", check="all", lines=lines, seconds=time.time() - t0)
    assert [ln["metric"] for ln in lines] == want
    assert all(ln["card"] == smi and ln["value"] > 0 and
               set(ln) == {"metric", "value", "unit", "vs_baseline", "card"}
               for ln in lines)

    zero_counters()
    t0 = time.time()
    (detail, line), = throughput.main(BENCH_KNOBS)
    seconds = time.time() - t0
    counts = read_counters()
    plain = sum(plain_counts())
    sub = (detail["control_steps_run"]
           * make_task("walker2d", device=dev).frame_skip)
    cfg = detail["solver_config"]
    emit("bench_cli", check="knobs", argv=BENCH_KNOBS, metric=line,
         escalation_k=detail["escalation_k"],
         warm_start=detail["warm_start"], pgs_iters=cfg["pgs_iters"],
         escalate_kmax=cfg["escalate_kmax"],
         **{f"{k}_launches": v for k, v in counts.items()},
         plain_calls=plain, seconds=seconds)
    want = dict.fromkeys(counts, 0)
    want.update(substep=sub, bpp_fused=sub, **integrate_counts(
        make_task("walker2d", device=dev).model, sub))
    assert counts == want, (counts, want)
    assert plain == 0
    assert (detail["escalation_k"], detail["warm_start"], cfg["pgs_iters"],
            cfg["escalate_kmax"]) == (256, False, 12, 256)

    trace_dir = os.path.join(root, "build", "chip_smoke_profile")
    for attempt in range(3):     # a late profile may catch no launch (§7)
        out = throughput.bench_env("walker2d", batch=4096, horizon=3,
                                   iters=0, device=dev,
                                   profile_dir=trace_dir)
        inside = kernels_in_ranges(out["profile_trace"], "substep_fused")
        ok = all(any(k in n for n in inside["kernels"])
                 for k in ("substep_kernel", "bpp_fused_kernel"))
        if ok:
            break
    emit("bench_cli", check="profile_dir", trace=out["profile_trace"],
         attempts=attempt + 1, range="substep_fused", **inside)
    assert inside["host_ranges"] >= 12, inside     # 3 steps x 4 substeps
    assert ok, inside
    return dict(counts, steps=detail["control_steps_run"])


def plain_counts():
    """The plain-call counters of the dispatchers of the four kernels that
    every model's main path runs (the position update's: read_counters)."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    return (hs.PLAIN_CALLS, hb.PLAIN_CALLS, hd.PLAIN_CALLS, hp.PLAIN_CALLS)


def lockstep_phasewise(name, dev, states=None, perturb=False, solver=None):
    """Phase lockstep for a phase-wise path: one control step at B = 1024,
    the port's sim step (the kernels) beside plain_phasewise_substep, from
    `states` (q, dq, tau, lam) where given, else from reset states
    (cartpole); with `perturb` the same external force in both (perturbed
    walker2d); `solver` "dantzig": one substep of the exact mode (kernel
    3, then the BPP kernel's core mode over the batch: every env's exact
    solve may branch on kernel 3's rounding, as one escalated env's may on
    the fused path).  Contact sets compared after every substep."""
    import torch

    from dartenv_tpu_torch.engine.constraints import build_layout
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.envs.base import make_env_reset
    from dartenv_tpu_torch.envs.tasks import make_task

    B = 1024 if states is None else min(1024, states[0].shape[0])
    task = make_task(name, device=dev, lcp_solver=solver)
    model = task.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    if states is None:
        sim = make_env_reset(task)(B, gen)[0].sim
    else:
        q, dq, _, lam = (x[:B].clone() for x in states)
        sim = SimState(q=q, dq=dq, time=q.new_zeros(B), lam=lam)
    f_ext = random_pushes(model, task, B, gen, dev) if perturb else None
    hi_a = torch.as_tensor(task.control_bounds[0], device=dev,
                           dtype=torch.float32)
    a = (torch.rand((B, task.action_size), generator=gen, device=dev)
         * 2 - 1) * hi_a
    tau = task.action_to_tau(a, ())
    step = make_sim_step(model)
    plain_before = plain_counts()
    sk, sp = sim, (sim.q, sim.dq, sim.lam)
    same = torch.ones(B, dtype=torch.bool, device=dev)
    impulse_rows = 0
    for _ in range(1 if solver == "dantzig" else task.frame_skip):
        sk, _ = step(sk, tau, f_ext)
        sp = plain_phasewise_substep(model, *sp, tau, f_ext)
        if sk.lam is not None:
            same &= (sk.lam > 0).eq(sp[2] > 0).all(1)
            impulse_rows += int((sp[2] > 0).sum())
    rel = lambda x, y: ((x - y).abs() / y.abs().clamp(min=1.0)).max(
        1).values
    q_err, dq_err = rel(sk.q, sp[0]), rel(sk.dq, sp[1])
    lock = dict(same_contact_frac=float(same.float().mean()),
                impulse_rows=impulse_rows,
                q_err=float(q_err[same].max()),
                dq_err=float(dq_err[same].max()),
                dq_err_all=float(dq_err.max()),
                envs_beyond_tol=int(((q_err > 1e-3)
                                     | (dq_err > 1e-3)).sum()),
                q_err_q99=float(q_err.quantile(0.99)),
                dq_err_q99=float(dq_err.quantile(0.99)))
    # The dantzig mode re-solves every env exactly, where the fused paths
    # escalate 32 of 1024: an env whose exact solve takes another branch
    # on kernel 3's rounding (the bpp phase's re-open sensitivity) ends
    # beyond the bound, and as in phase bpp_batch BPP_MAY_DIVERGE of every
    # 128 such envs may (on an H100: 3 of 1024 after one substep, 2 after
    # a control step of four; PERF.md)
    may = (BPP_MAY_DIVERGE * -(-B // 128) if solver == "dantzig"
           else LOCK_MAY_DIVERGE)
    emit("lockstep", env=name + ("_perturbed" if perturb else "")
         + (f"_{solver}" if solver else ""), B=B, **lock, tol=1e-3,
         tol_envs_beyond=may)
    assert torch.isfinite(sk.q).all() and torch.isfinite(sk.dq).all()
    assert plain_counts() == plain_before    # the kernel path took none
    assert lock["same_contact_frac"] > 0.9
    assert lock["envs_beyond_tol"] <= may
    if solver == "dantzig":
        assert lock["q_err_q99"] <= 1e-3 and lock["dq_err_q99"] <= 1e-3
    if build_layout(model).m:
        # (over the one dantzig substep from walker2d's rollout states:
        # about 900 rows at B = 1024)
        assert impulse_rows > (B // 2 if solver == "dantzig" else B), \
            "contacts are not live"


def drive_main_path(dev, name, perturb=False, solver=None, ref64=None):
    """Phase rollout: the batched rollout of one path through bench_env
    (`solver`: the LCP solver mode, None: the task's; `ref64`: passes of
    the escalation's mixed-precision tier, a REF64_PATHS path), with every
    kernel's launch counter and every plain-call counter set to 0 just
    before and read just after.  Returns the launch counts."""
    import torch

    from dartenv_tpu_torch.bench.throughput import bench_env
    from dartenv_tpu_torch.engine import hopper_substep as hs

    B, horizon, rollouts = (REF64_PATHS[(name, perturb)] if ref64 else
                            PATHS[(name, perturb) + ((solver,) if solver
                                                     else ())])
    zero_counters()
    t0 = time.time()
    out = bench_env(name, batch=B, horizon=horizon, iters=rollouts - 1,
                    max_episode_steps=1000, device=dev,
                    return_state=True, perturb=perturb, solver=solver,
                    solver_overrides=ref64 and {"escalate_ref64": ref64})
    seconds = time.time() - t0
    counts = read_counters()
    plain = sum(plain_counts())
    end, task = out.pop("state"), out.pop("task")
    obs = task.obs(end.sim, end.aux)
    steps_run = out["control_steps_run"]
    finite = all(bool(torch.isfinite(x).all())
                 for x in (end.sim.q, end.sim.dq, obs))
    emit("rollout", **out, **{f"{k}_launches": v for k, v in counts.items()},
         plain_calls=plain, finite_state=finite, seconds=seconds,
         escalate_ref64=ref64)
    assert finite
    assert obs.shape[0] == B and end.sim.q.shape == (B, task.model.n)
    # (a reacher's or a snake's episode ends only at the time limit, 1000
    # steps; so may the perturbed humanwalker's short rollout)
    assert out["episodes_seen"] > 0 or name in ("reacher", "reacher2d",
                                                "snake7link") or (
        name == "humanwalker" and perturb)
    sub = task.frame_skip * steps_run
    want = dict.fromkeys(counts, 0)
    want.update(integrate_counts(task.model, sub))
    if perturb:                      # the external-force route
        want.update(bpp_hybrid=sub, pgs=sub)
    elif solver == "dantzig":        # kernel 3, the exact solve over B
        want.update(dynamics=sub, bpp_core=sub)
    elif hs.in_fused_scope(task.model):
        want.update(substep=sub)
        if task.model.solver.escalate_frac > 0:
            want.update(bpp_fused=sub)
    else:                            # no constraint rows: kernel 3 only
        want.update(dynamics=sub)
    assert counts == want, (counts, want)
    assert plain == 0
    return dict(counts, steps=steps_run)


# ---- the multi-skeleton, servo, matrix and ref64 phases ------------------

# (path) -> (batch, frame_skip, control steps): the multi-skeleton world
# and the servo walker driven through engine/world.make_do_simulation
SIM_PATHS = {"multiskel": (4096, 4, 100), "servo": (4096, 4, 100)}
MATRIX_B = 1024
MATRIX_SETTLE = ("box_box", "cylinder_side")   # settle runs, 600 substeps
REF64 = 2          # passes of the mixed-precision tier in phase ref64
# paths run with escalate_ref64 = REF64: (env, perturb) -> (batch,
# horizon, rollouts)
REF64_PATHS = {("humanwalker", False): (1024, 20, 1),
               ("humanwalker", True): (1024, 3, 1)}


def sim_model(name, dev):
    """The model of a SIM_PATHS path (bench/scenes.py)."""
    from dartenv_tpu_torch.bench import scenes

    return (scenes.walker_box_world(dev) if name == "multiskel"
            else scenes.servo_walker(dev))


def sim_inputs(model, B, gen, dev, servo):
    """(tau, servo commands) of one control step: random walker torques
    U(-100, 100) N m on its 6 actuated dofs, or for the servo walker no
    torque and random servo commands U(-2, 2) rad/s on those dofs (its
    motors drive it).  Both packages run away in some envs on either path
    (RUNAWAY_MAX); the servo walker under these torques as well, in about
    1 env of 100 within 100 control steps (ROADMAP.md Queue 3 item 6)."""
    import torch

    u = lambda: torch.rand((B, 6), generator=gen, device=dev) * 2 - 1
    tau = torch.zeros((B, model.n), device=dev)
    cmd = None
    if servo:
        cmd = torch.zeros((B, model.n), device=dev)
        cmd[:, 3:9] = 2.0 * u()
    else:
        tau[:, 3:9] = 100.0 * u()
    return tau, cmd


RUNAWAY_DQ = 1e3    # rad/s or m/s: an env beyond it has blown up
# (path) -> the most envs of its sim_path run (B = 4096 envs, 100 control
# steps) that may run away and be reset.  The hybrid solve's exact
# re-solve can return a point of huge impulses on a near-singular free set
# and keep it when its normalized residual is lower than the PGS point's;
# the JAX package does the same.  Runaway envs of 4 x 1024 envs x 100
# control steps, float32, the same inputs in both packages
# (scripts/torch_rollout_blowup.py, seeds 0-3): walker-and-box world, the
# JAX package's CPU path 11, its TPU path (Pallas kernels in interpret
# mode) 7, the port 3; servo walker driven by its commands, 0, 2 and 1
# (PERF.md section 6, ROADMAP.md Queue 3 item 6).  The limit is twice the
# larger of the reference's two counts.
RUNAWAY_MAX = {"multiskel": 22, "servo": 4}


def runaway(st):
    """(B,) bool: the envs of `st` whose state is non-finite or whose |dq|
    exceeds RUNAWAY_DQ."""
    import torch

    return ~(torch.isfinite(st.q).all(1) & torch.isfinite(st.dq).all(1)
             & (st.dq.abs().amax(1) <= RUNAWAY_DQ))


def reset_runaway(st, st0):
    """The runaway envs of `st` set back to `st0`, as the env layer's
    auto-reset ends such an episode.  Returns (state, (B,) bool: the envs
    reset).  No host sync."""
    import torch

    bad = runaway(st)
    keep = lambda x, x0: torch.where(bad[:, None], x0, x)
    return dataclasses.replace(st, q=keep(st.q, st0.q),
                               dq=keep(st.dq, st0.dq),
                               lam=keep(st.lam, st0.lam)), bad


def sim_states(name, model, B, dev, substeps=40):
    """(q, dq, tau, lam, servo) of B envs after `substeps` substeps of the
    model's own phase-wise path from jittered walker poses under
    `sim_inputs`: live contacts and warm starts.  No env is reset: a
    runaway env here fails the phase."""
    import torch

    from dartenv_tpu_torch.engine.world import init_state, make_sim_step

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    st = init_state(model, B)
    jit = torch.zeros_like(st.q)
    jit[:, :9] = (torch.rand((B, 9), generator=gen, device=dev) - 0.5) * 0.1
    st = dataclasses.replace(st, q=st.q + jit)
    step = make_sim_step(model)
    servo = name == "servo"
    for _ in range(substeps):
        tau, cmd = sim_inputs(model, B, gen, dev, servo)
        st, _ = step(st, tau, None, cmd)
    ran = int(runaway(st).sum())
    assert ran == 0, f"{name}: {ran} envs ran away in the check states"
    tau, cmd = sim_inputs(model, B, gen, dev, servo)
    return st.q, st.dq, tau, st.lam, cmd


def capsule_box_pairs(model, q, dq):
    """Line cb_pairs: the walker-and-box world's 7 capsule-box cross pairs
    collided as one `_capsule_box_pairs` call (the route of `collide`)
    and as 7 calls of one pair: wall ms, device ms and device launches per
    collision, outputs equal to the bit."""
    import torch

    from dartenv_tpu_torch.collision import narrowphase as nph
    from dartenv_tpu_torch.dynamics import batched

    kin = batched.bkin(model, q, dq)
    pose = lambda g: nph._geom_pose(model, kin.R_w, kin.p_w, g)
    run, = [r for r in nph._self_pair_runs(model)
            if nph._is_capsule_box(model, r[0])]
    one = lambda: nph._capsule_box_pairs(model, run, pose)
    each = lambda: [torch.cat(x, dim=1) for x in zip(
        *(nph._capsule_box_pairs(model, [pr], pose) for pr in run))]
    same = all(torch.equal(a, b) for a, b in zip(one(), each()))
    out = {}
    for tag, fn in (("one_call", one), ("per_pair", each)):
        wall, busy, launches = profile_calls(fn, 3)
        out[tag] = dict(wall_ms=wall, device_ms=busy,
                        device_launches=launches)
    emit("cb_pairs", env="multiskel", B=q.shape[0], pairs=len(run),
         outputs_equal=same, **out)
    assert same


def global_tables_kernel(model):
    """Kernel 3 of `model` with its model tables in global memory
    (__device__) in place of __constant__: the table-space measurement of
    phase tables (a build of its own)."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    kern = hd.DynamicsKernel(model)
    kern._header = "#define DY_CONST __device__\n" + kern._header
    return kern


def table_space(name, model, gkern, q, dq, tau):
    """Phase tables: kernel 3's device ms with its model tables in
    __constant__ memory (the shipped build) and in global memory
    (`global_tables_kernel`), on the same inputs, and the two outputs
    equal to the bit."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    ckern = hd.get_dynamics_kernel(model)
    same = all(torch.equal(a, b) for a, b in zip(ckern(q, dq, tau),
                                                 gkern(q, dq, tau)))
    ms = {}
    for tag, k in (("constant", ckern), ("global", gkern), ("constant2",
                                                             ckern)):
        ms[tag] = device_ms(lambda: k(q, dq, tau), "dynamics_kernel")
    emit("tables", env=name, B=q.shape[0], nb=model.nb, n=model.n,
         device_ms_constant=ms["constant"], device_ms_global=ms["global"],
         device_ms_constant_again=ms["constant2"], outputs_equal=same)
    assert same


def check_phasewise_model(name, model, states):
    """Phases dynamics, pgs and hybrid on the LCPs of a phase-wise path's
    states (q, dq, tau, lam, servo): kernel 3 against its plain version
    in float64 (above n = 12 the float32 one adds an inv_psd jitter; on
    the servo walker's fast states its float32 rounding is no reference
    either), kernel 4 and kernel 2's hybrid mode against their plain
    versions.  Returns the three kernels' entries."""
    import torch

    from dartenv_tpu_torch.lcp.hybrid import escalation_size

    q, dq, tau, lam_prev, servo = states
    B = q.shape[0]
    cfg = model.solver
    dyn = check_dynamics(name, model, B, q, dq, tau, f64=True)
    _, contacts, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam_prev,
                                            None, servo=servo)
    A, b, lo, hi, act, mu, findex, _, _ = prob
    emit("lcp", env=name, B=B, m=b.shape[1], findex_plain_rows=int(
        (findex < 0).sum()), active_rows=float(act.sum()),
         active_contact_slots=float(contacts.active.sum()),
         max_contact_overflow=float(contacts.overflow.max()),
         finite_two_sided_rows=int(((lo > -1e19) & (hi < 1e19)
                                    & (lo < 0)).sum()))
    lam_k, res_k, pgs = compare_pgs(name, (A, b, lo, hi, findex, mu, act,
                                           lam0), cfg.pgs_iters,
                                    cfg.pgs_omega)
    K = escalation_size(B, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res_k, K)
    hyb = check_hybrid_batch(name, cfg, findex, (A, b, lo, hi, mu, act),
                             lam_k, worst, idx)
    return dict(dynamics=dyn, pgs=pgs, bpp_hybrid=hyb)


def lockstep_model(name, model, states, B=1024):
    """Phase lockstep for a SIM_PATHS model: one substep of the port's sim
    step (kernels 3, 4 and 2) beside plain_phasewise_substep from the same
    states, with the same torques and servo commands.  An env whose exact
    re-solve branches on the kernels' rounding may part: BPP_MAY_DIVERGE
    of every 128 envs beyond 1e-3, as in phase bpp_batch (the hybrid
    solve escalates 32 of 1024 envs here; the q99 errors are printed)."""
    import torch

    from dartenv_tpu_torch.engine.world import SimState, make_sim_step

    q, dq, tau, lam, servo = (None if x is None else x[:B].clone()
                              for x in states)
    plain_before = plain_counts()
    sk, _ = make_sim_step(model)(SimState(q=q, dq=dq, time=q.new_zeros(B),
                                          lam=lam), tau, None, servo)
    assert plain_counts() == plain_before     # the kernel path took none
    sp = plain_phasewise_substep(model, q, dq, lam, tau, None, servo)
    rel = lambda x, y: ((x - y).abs() / y.abs().clamp(min=1.0)).max(
        1).values
    q_err, dq_err = rel(sk.q, sp[0]), rel(sk.dq, sp[1])
    beyond = int(((q_err > 1e-3) | (dq_err > 1e-3)).sum())
    may = BPP_MAY_DIVERGE * -(-B // 128)
    same = (sk.lam > 0).eq(sp[2] > 0).all(1)
    emit("lockstep", env=name, B=B, substeps=1,
         same_contact_frac=float(same.float().mean()),
         q_err_q99=float(q_err.quantile(0.99)),
         dq_err_q99=float(dq_err.quantile(0.99)),
         dq_err_max=float(dq_err.max()), envs_beyond_tol=beyond, tol=1e-3,
         tol_envs_beyond=may, impulse_rows=int((sp[2] > 0).sum()))
    assert torch.isfinite(sk.q).all() and torch.isfinite(sk.dq).all()
    assert same.float().mean() > 0.9
    assert beyond <= may


def check_capture(name, model, states, B=1024):
    """Phase capture: engine/world.make_lcp_capture on the card (cold, as
    the validation hook runs it): A symmetric within 1e-5 of its max, and
    the impulses of the kernel route (kernel 4, kernel 2's hybrid mode)
    against the plain solve of the captured problems, env by env within
    the PGS phase's bound (1e-6 + 1e-5 |plain|); BPP_MAY_DIVERGE of every
    128 envs may part."""
    import torch

    from dartenv_tpu_torch.engine.world import SimState, make_lcp_capture

    q, dq, tau, _, servo = states
    assert servo is None                  # the capture takes no commands
    q, dq, tau = q[:B], dq[:B], tau[:B]
    cap = make_lcp_capture(model)(SimState(q=q, dq=dq, time=q.new_zeros(B),
                                           lam=None), tau)
    A = cap["A"]
    sym = float(((A - A.transpose(1, 2)).abs().amax((1, 2))
                 / A.abs().amax((1, 2)).clamp(min=1e-30)).max())
    lam_r = plain_solve(model.solver, cap["findex"], A, cap["b"], cap["lo"],
                        cap["hi"], cap["mu"], cap["active"],
                        torch.zeros_like(cap["b"]))
    lam_k = cap["lam"]
    bad = ((lam_k - lam_r).abs() > 1e-6 + 1e-5 * lam_r.abs()).any(1)
    may = BPP_MAY_DIVERGE * -(-B // 128)
    emit("capture", env=name, B=B, m=int(A.shape[1]), A_asym_rel=sym,
         envs_beyond_tol=int(bad.sum()), tol_envs_beyond=may,
         lam_abs_err_same=float((lam_k - lam_r)[~bad].abs().max()),
         dq_plus_finite=bool(torch.isfinite(cap["dq_plus"]).all()),
         active_rows=float(cap["active"].sum()))
    assert sym <= 1e-5
    assert int(bad.sum()) <= may
    assert torch.isfinite(cap["dq_plus"]).all()


def profile_calls(fn, calls):
    """(wall ms per call from an un-profiled pass, device-busy ms per call,
    device launches per call) of fn on the card, counted as
    bench/profile_step.py counts them (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = launches = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += us
            launches += ev.count
    return wall, busy / 1e3 / calls, launches / calls


def zero_counters():
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    hs.SUBSTEP_LAUNCHES = hd.DYNAMICS_LAUNCHES = hp.PGS_LAUNCHES = 0
    hb.CORE_LAUNCHES = hb.FUSED_LAUNCHES = hb.HYBRID_LAUNCHES = 0
    hs.PLAIN_CALLS = hb.PLAIN_CALLS = hd.PLAIN_CALLS = hp.PLAIN_CALLS = 0
    hi.INTEGRATE_LAUNCHES = hi.PLAIN_CALLS = 0


def read_counters():
    """Every kernel's launches, and `integrate_plain`: the runs of the
    position update's plain version (the main path of a model without a
    BALL or FREE joint, so it is checked by integrate_counts and not
    among plain_counts)."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    return dict(substep=hs.SUBSTEP_LAUNCHES, bpp_core=hb.CORE_LAUNCHES,
                bpp_fused=hb.FUSED_LAUNCHES, bpp_hybrid=hb.HYBRID_LAUNCHES,
                dynamics=hd.DYNAMICS_LAUNCHES, pgs=hp.PGS_LAUNCHES,
                integrate=hi.INTEGRATE_LAUNCHES,
                integrate_plain=hi.PLAIN_CALLS)


def integrate_counts(model, calls):
    """The position update's counts over `calls` substeps of `model` on
    the card: a kernel launch each (`integrate`) where the model has a
    BALL or FREE joint, else a run of the plain version each
    (`integrate_plain`: planar and revolute-only models)."""
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi

    rot = hi.has_rotations(model)
    return dict(integrate=calls if rot else 0,
                integrate_plain=0 if rot else calls)


def drive_sim_path(name, dev):
    """Phase sim_path: a SIM_PATHS path through make_do_simulation under
    random torques or servo commands (`sim_inputs`), every launch and
    plain-call counter set to 0 just before and read just after: kernels
    3, 4 and 2 (hybrid mode) once per substep each, no plain call.  A
    runaway env is reset after its control step (`reset_runaway`), and
    the path fails when more than RUNAWAY_MAX[name] envs were.  Then the
    device launches of one control step (torch.profiler).  Returns the
    counts."""
    import torch

    from dartenv_tpu_torch.engine.world import (
        init_state, make_do_simulation,
    )

    B, frame_skip, steps = SIM_PATHS[name]
    model = sim_model(name, dev)
    do_sim = make_do_simulation(model, frame_skip)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    servo = name == "servo"
    st = st0 = init_state(model, B)
    tau, cmd = sim_inputs(model, B, gen, dev, servo)
    st, _ = do_sim(st, tau, None, cmd)                           # warm-up
    torch.cuda.synchronize()
    zero_counters()
    overflow = torch.zeros(B, device=dev)
    resets = torch.zeros((), device=dev)
    t0 = time.time()
    for _ in range(steps):
        tau, cmd = sim_inputs(model, B, gen, dev, servo)
        st, con = do_sim(st, tau, None, cmd)
        st, bad = reset_runaway(st, st0)
        overflow = torch.maximum(overflow, con.overflow)
        resets = resets + bad.sum()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = read_counters()
    plain = sum(plain_counts())
    finite = bool(torch.isfinite(st.q).all() and torch.isfinite(st.dq).all())
    tau, cmd = sim_inputs(model, B, gen, dev, servo)
    wall, busy, launches = profile_calls(lambda: do_sim(st, tau, None, cmd),
                                         2)
    sub = steps * frame_skip
    emit("sim_path", path=name, B=B, n=model.n, nb=model.nb,
         frame_skip=frame_skip, control_steps=steps, seconds=seconds,
         env_steps_per_s=B * steps / seconds,
         **{f"{k}_launches": v for k, v in counts.items()},
         launches_per_substep={k: v / sub for k, v in counts.items()},
         plain_calls=plain, finite_state=finite,
         runaway_resets=int(resets), runaway_dq=RUNAWAY_DQ,
         runaway_max=RUNAWAY_MAX[name],
         max_contact_overflow=float(overflow.max()),
         wall_ms_per_control_step=wall,
         device_busy_ms_per_control_step=busy,
         device_launches_per_control_step=launches)
    assert finite and plain == 0
    assert int(resets) <= RUNAWAY_MAX[name], (name, int(resets))
    want = dict.fromkeys(counts, 0)
    want.update(dynamics=sub, pgs=sub, bpp_hybrid=sub,
                **integrate_counts(model, sub))
    assert counts == want, (counts, want)
    return dict(counts, steps=steps)


def check_servo_behaviour(dev, B=4096):
    """Phase servo_behaviour: the JAX package's servo tests at batch size
    on the card (a servo pendulum, the phase-wise path): a pinned command
    reached within 1e-4 in 5 substeps, and a saturated servo whose
    per-substep velocity change stays below flimit * dt / I."""
    import torch

    from dartenv_tpu_torch.engine.world import init_state, make_sim_step
    from dartenv_tpu_torch.model import skel_model as sm
    from dartenv_tpu_torch.model.builder import ModelBuilder, box_inertia

    def pendulum(flimit):
        b = ModelBuilder(dt=0.002)
        b.add_body("l1", None, sm.REVOLUTE, axes=[(0, 0, 1)],
                   cj_pos=(0, 0.5, 0), mass=1.0,
                   inertia=box_inertia(1.0, (0.05, 0.5, 0.05)),
                   servo_flimit=flimit)
        return b.finalize(device=dev)

    zero = torch.zeros((B, 1), device=dev)
    model = pendulum(1e4)
    step = make_sim_step(model)
    st = init_state(model, B)
    cmd = torch.full((B, 1), 1.7, device=dev)
    for _ in range(5):
        st, _ = step(st, zero, None, cmd)
    track_err = float((st.dq - 1.7).abs().max())
    flimit = 0.5
    model = pendulum(flimit)
    step = make_sim_step(model)
    st = init_state(model, B)
    I_hinge = float(model.inertia[0, 2, 2] + model.mass[0] * 0.25)
    dv_max = flimit * model.dt / I_hinge
    cmd = torch.full((B, 1), 50.0, device=dev)
    dv = []
    for _ in range(3):
        prev = st.dq
        st, _ = step(st, zero, None, cmd)
        dv.append(float((st.dq - prev).max()))
    emit("servo_behaviour", B=B, track_err=track_err, tol_track=1e-4,
         dv_max_per_substep=max(dv), dv_bound=dv_max * 1.01,
         dq_after=float(st.dq.max()))
    assert track_err <= 1e-4
    assert max(dv) <= dv_max * 1.01 + 1e-7
    assert float(st.dq.max()) < 49.0


def check_matrix(dev):
    """Phase matrix: every collision-matrix scene (bench/scenes.py) at
    B = 1024 with per-env pose jitter of the dropped body, lowered onto
    its rest height: one phase-wise substep of the kernel route (kernel 3,
    collision, kernel 4) against the plain route, within 1e-3 on all but
    BPP_MAY_DIVERGE of every 128 envs; then MATRIX_SETTLE scenes settle
    for 600 substeps on the kernel route to the JAX tests' rest heights."""
    import torch

    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.engine.constraints import build_layout
    from dartenv_tpu_torch.engine.world import (
        SimState, init_state, make_sim_step,
    )

    B = MATRIX_B
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    may = BPP_MAY_DIVERGE * -(-B // 128)
    rows = {}
    for name in scenes.SCENES:
        model = scenes.scene_builder(name).finalize(device=dev)
        rest, _ = scenes.REST[name]
        q = model.q_init.expand(B, -1).clone()
        q[:, 1] = rest - 0.01
        q = q + (torch.rand(q.shape, generator=gen, device=dev) - 0.5) * 0.04
        dq = (torch.rand(q.shape, generator=gen, device=dev) - 0.5) * 0.2
        lam = q.new_zeros((B, build_layout(model).m))
        tau = torch.zeros_like(q)
        plain_before = plain_counts()
        sk, con = make_sim_step(model)(
            SimState(q=q, dq=dq, time=q.new_zeros(B), lam=lam), tau)
        assert plain_counts() == plain_before
        sp = plain_phasewise_substep(model, q, dq, lam, tau, None)
        err = ((sk.dq - sp[1]).abs() / sp[1].abs().clamp(min=1.0)).max(
            1).values
        rows[name] = dict(active_slots_mean=float(con.active.sum(1).mean()),
                          dq_err_q99=float(err.quantile(0.99)),
                          envs_beyond_tol=int((err > 1e-3).sum()))
        assert float(con.active.sum()) > 0, name
        assert rows[name]["envs_beyond_tol"] <= may, (name, rows[name])
    settle = {}
    for name in MATRIX_SETTLE:
        model = scenes.scene_builder(name).finalize(device=dev)
        rest, tol = scenes.REST[name]
        step = make_sim_step(model)
        st = init_state(model, B)
        st = dataclasses.replace(st, q=st.q + (torch.rand(
            st.q.shape, generator=gen, device=dev) - 0.5) * 0.02)
        tau = torch.zeros_like(st.q)
        for _ in range(600):
            st, con = step(st, tau)
        y = st.q[:, 1]
        settle[name] = dict(rest=rest, y_err_max=float((y - rest).abs().max()),
                            tol=tol, dq_max=float(st.dq.abs().max()),
                            active_min=float(con.active.sum(1).min()))
        assert settle[name]["y_err_max"] < tol, (name, settle[name])
        assert settle[name]["dq_max"] < 1e-2, (name, settle[name])
    emit("matrix", B=B, scenes=rows, tol=1e-3, tol_envs_beyond=may,
         settle=settle)


def check_ref64(dev, checks, kerns, comp_hybrid):
    """Phase ref64: the BPP kernel's ES_REF64 builds (the mixed-precision
    refinement tier, REF64 passes) against refine_mixed's plain version:
    the fused mode on humanwalker's substep outputs (K = 128, m 41) and
    the hybrid mode on perturbed humanwalker's phase-wise LCPs, with the
    env-count rules of phases escalate and hybrid; beside each, the
    compensated tier's solved count (< 1e-4) and device ms on the same
    inputs (line ref64; comp_hybrid: phase pgs's compensated entry of
    perturbed humanwalker).  Returns the two builds' entries."""
    from dartenv_tpu_torch.engine import hopper_substep as hs

    hw = kerns["humanwalker"]
    model = hw.model.replace(solver=dataclasses.replace(
        hw.model.solver, escalate_ref64=REF64))
    st64 = hs._SubStatic(model)
    assert st64.ref_passes == (0, REF64)
    q, dq, tau, lam = checks["humanwalker"]["states"]
    outs = hw(q, dq, tau, lam)
    fused = check_escalate("humanwalker_ref64", st64, model.solver, outs)
    _, hybrid = check_pgs(dev, "humanwalker",
                          checks["humanwalker"]["states"], ref64=REF64)
    comp_f = checks["humanwalker"]["escalate"]
    comp_h = comp_hybrid
    emit("ref64", passes=REF64,
         fused=dict(solved_f64=fused["solved_kernel"],
                    solved_compensated=comp_f["solved_kernel"],
                    device_ms_f64=fused["device_ms"],
                    device_ms_compensated=comp_f["device_ms"]),
         hybrid=dict(solved_f64=hybrid["solved_kernel"],
                     solved_compensated=comp_h["solved_kernel"],
                     device_ms_f64=hybrid["device_ms"],
                     device_ms_compensated=comp_h["device_ms"]))
    return fused, hybrid



# ---- the gym surface: single envs (B = 1) ---------------------------------

GYM_STEPS = 50        # control steps of each registered id in phase gym
# The float64 CPU twin of the 3D ids takes about a second (walker3d, dog)
# to six (humanwalker) per control step on one CPU core (the plain
# versions at 18 and 29 dofs), so their lockstep runs on every k-th step
# of the 50 (the card env steps all 50).
GYM_LOCK_EVERY = {"DartWalker3d-v1": 5, "DartDog-v1": 5,
                  "DartHumanWalker-v1": 10}
# Above n = 12 up to half of the held lockstep steps may part beyond 1e-3
# (drive_gym); none may part beyond this relative error on obs or reward,
# about ten times the largest parting measured (walker3d 3.3e-2 on an H100
# at 700 W, PERF.md section 6).
GYM_PARTED_MAX = 0.3
RESUME_B = 4096
CHECKED_REPEATS = 5   # rounds of the checked / unchecked timings


def to_device(tree, device, dtype):
    """A copy of a tree of dataclasses / dicts / tuples of tensors on
    `device`, its floating tensors cast to `dtype`."""
    import torch

    if torch.is_tensor(tree):
        return tree.to(device=device, dtype=dtype if tree.is_floating_point()
                       else tree.dtype, copy=True)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), device, dtype)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(x, device, dtype) for x in tree)
    return tree


def impulse_pattern(model, lam):
    """(1, rows) bool: which normal and limit rows of a (1, m) impulse
    vector carry an impulse (the contact set of phase lockstep), or None
    without constraint rows."""
    from dartenv_tpu_torch.engine.constraints import build_layout

    if lam is None:
        return None
    lay = build_layout(model)
    rows = list(range(0, 3 * lay.contact_slots, 3)) + list(
        range(3 * lay.contact_slots, lay.m))
    return (lam[:, rows] > 0).cpu()


def check_substep_b1(label, model, kern, candidates):
    """The substep kernel at B = 1 against its plain version (in float64
    above n = 12, see plain64), block by block at hold_substep's bounds,
    on the first of `candidates` ((q, dq, tau, lam) of one env) whose
    discrete blocks agree.  Returns what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.bench.kernel_stages import device_ms
    from dartenv_tpu_torch.engine import hopper_substep as hs

    st, m64 = kern.st, plain64(model)
    for tried, ins in enumerate(candidates, 1):
        got_b = hs.output_blocks(st, kern(*ins))
        ref_b = hs.output_blocks(st, hs.substep_reference(model, st, *ins))
        ref_c = ref_b
        if m64 is not None:
            ref64 = hs.substep_reference(m64[0], m64[1],
                                         *(x.double() for x in ins))
            ref_c = {k: v.float()
                     for k, v in hs.output_blocks(st, ref64).items()}
        if all(torch.equal(got_b[f], ref_b[f])
               and torch.equal(ref_c[f], ref_b[f]) for f in DISCRETE):
            break
    else:
        raise AssertionError(f"{label}: the discrete blocks differ on all "
                             f"{len(candidates)} states")
    errs, abs_errs, unequal = {}, {}, {}
    for f in got_b:
        a, r = got_b[f], ref_c[f]
        assert torch.isfinite(a).all(), f
        if f in EXACT_BLOCKS:
            unequal[f] = int((a != ref_b[f]).sum())
        elif a.numel():
            abs_errs[f] = float((a - r).abs().max())
            errs[f] = abs_errs[f] / max(1.0, float(r.abs().max()))
    run = lambda: kern(*ins)
    ms, dev_ms = time_ms(run), device_ms(run, "substep_kernel")
    plain_ms = time_ms(lambda: hs.substep_reference(model, st, *ins),
                       runs=5, warmup=1)
    bnd = bound(*substep_work(st, 1))
    tol = lambda f: 2e-2 if m64 is not None and f in AFTER_SWEEPS else 1e-4
    emit("b1", kernel="substep", env=label, B=1, states_tried=tried,
         rel_err=errs, abs_err=abs_errs, unequal_entries=unequal,
         active_rows=float(ref_b["act"].sum()),
         plain_dtype="float32" if m64 is None else "float64", ms=ms,
         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd[0],
         envs_per_block=kern.shape[0], tol_rel=1e-4,
         tol_rel_after_sweeps=tol("res"))
    assert not any(unequal.values()), f"copied blocks differ: {unequal}"
    bad = {f: e for f, e in errs.items() if not e <= tol(f)}
    assert not bad, f"substep kernel disagrees at B = 1: {bad}"
    return dict(max_abs_err=max(abs_errs.values()), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound=bnd,
                shape=f"{label} B=1 n={st.n} m={st.layout.m} m_c={st.m_c} "
                      f"envs_per_block={kern.shape[0]}")


def drive_gym(env_id, dev):
    """Phase gym for one registered id: make(env_id) on the card (float32),
    seed(0), reset(), GYM_STEPS control steps of a seeded action sequence,
    every launch counter set to 0 just before and read just after.  After
    each step (each GYM_LOCK_EVERY-th for the 3D ids) a one-step lockstep:
    the same env class on the CPU in float64 is given the card env's
    pre-step state (q, dq, warm-start impulses, task state) and stepped
    with the same action; obs and reward are held to 1e-3 of
    max(1, |twin|) (phase lockstep's bound; the 3D twins run the float64
    plain versions, as PERF.md sets out) when the contact sets agree, at
    most LOCK_MAY_DIVERGE steps beyond it.  Then the device launches per
    env.step (torch.profiler) and each kernel at B = 1 against its plain
    version on the path's own states.  Returns the counts and the
    kernels' entries."""
    import numpy as np
    import torch

    import dartenv_tpu_torch as gym
    from dartenv_tpu_torch.engine import hopper_substep as hs

    env = gym.make(env_id)
    u = env.unwrapped
    twin = gym.make(env_id, device="cpu", dtype=torch.float64).unwrapped
    task, model = u.task, u.model
    assert model.device.type == "cuda" and model.dtype == torch.float32
    env.seed(0)
    env.reset()
    twin.seed(0)
    twin.reset()
    rng = np.random.default_rng(11)
    lo, hi = env.action_space.low, env.action_space.high
    every = GYM_LOCK_EVERY.get(env_id, 1)
    ms, locks, records, resets = [], [], [], 0
    zero_counters()
    for k in range(GYM_STEPS):
        a = rng.uniform(lo, hi)
        pre = u._state
        records.append((pre, a))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs, r, d, _ = env.step(a)
        ms.append((time.perf_counter() - t0) * 1e3)
        if k % every == 0:
            twin._state = to_device(pre, "cpu", torch.float64)
            tobs, tr, td, _ = twin.step(a)
            pk = impulse_pattern(model, u._state.sim.lam)
            pt = impulse_pattern(model, twin._state.sim.lam)
            same = pk is None or bool(torch.equal(pk, pt))
            locks.append((float(np.abs(obs - tobs).max()
                                / max(1.0, float(np.abs(tobs).max()))),
                          abs(r - tr) / max(1.0, abs(tr)), d == td, same))
        if d:
            env.reset()
            resets += 1
    counts = read_counters()
    sub = task.frame_skip * GYM_STEPS
    want = dict.fromkeys(counts, 0)
    want.update(integrate_counts(model, sub))
    # the CPU twin's substeps run the plain version too
    want["integrate_plain"] += task.frame_skip * len(locks)
    fused = hs.in_fused_scope(model)
    if fused:
        want.update(substep=sub)
        if model.solver.escalate_frac > 0:
            want.update(bpp_fused=sub)
    else:
        want.update(dynamics=sub)
    a = np.zeros(env.action_space.shape)
    wall, busy, launches = profile_calls(lambda: env.step(a), 10)
    held = [x for x in locks if x[3]]
    obs_err = max((x[0] for x in held), default=0.0)
    rew_err = max((x[1] for x in held), default=0.0)
    beyond = sum(1 for x in held if x[0] > 1e-3 or x[1] > 1e-3)
    emit("gym", env=env_id, B=1, steps=GYM_STEPS, resets=resets,
         ms_per_step_median=statistics.median(ms[1:]),
         ms_per_step_max=max(ms[1:]), steps_per_s=1e3 / statistics.median(
             ms[1:]), profiled_wall_ms_per_step=wall,
         device_busy_ms_per_step=busy, device_launches_per_step=launches,
         launches={k: v for k, v in counts.items() if v},
         lockstep_steps=len(locks), lockstep_same_contacts=len(held),
         obs_rel_err=obs_err, reward_rel_err=rew_err,
         done_equal=sum(1 for x in held if x[2]), steps_beyond_tol=beyond,
         obs_rel_err_all=max(x[0] for x in locks), tol=1e-3,
         tol_parted=GYM_PARTED_MAX,
         tol_steps_beyond=(max(LOCK_MAY_DIVERGE, len(held) // 2)
                           if plain64(model) is not None
                           else LOCK_MAY_DIVERGE))
    assert counts == want, (env_id, counts, want)
    if fused:
        assert counts["substep"] > 0, f"{env_id}: no kernel 1 launch"
    else:
        assert counts["dynamics"] > 0, f"{env_id}: no kernel 3 launch"
    assert len(held) >= 0.8 * len(locks), (env_id, len(held), len(locks))
    # Above n = 12 phase lockstep holds only the envs that neither path
    # escalated: on these operators the exact re-solve branches on the
    # float32 rounding of its inputs.  A single env is the top K = 1 of
    # its batch on every substep, so here every step escalates, and half
    # of the held steps may part (PERF.md section 6), each by at most
    # GYM_PARTED_MAX.
    may = (max(LOCK_MAY_DIVERGE, len(held) // 2)
           if plain64(model) is not None else LOCK_MAY_DIVERGE)
    assert beyond <= may, (env_id, beyond, may)
    assert max(obs_err, rew_err) < GYM_PARTED_MAX, (env_id, obs_err,
                                                     rew_err)
    assert all(x[2] for x in held), f"{env_id}: done differs"

    # each kernel at B = 1 on the path's own pre-step states
    def ins_of(i):
        st, a = records[i]
        at = torch.as_tensor(a[None], dtype=torch.float32, device=dev)
        return (st.sim.q, st.sim.dq, task.action_to_tau(at, st.aux),
                st.sim.lam)

    label = "gym_" + env_id.split("-")[0][4:].lower()
    order = list(range(GYM_STEPS // 2, GYM_STEPS)) + list(
        range(GYM_STEPS // 2))
    entries = {}
    if fused:
        kern = hs.get_substep_kernel(model)
        entries["substep"] = check_substep_b1(
            label, model, kern, [ins_of(i) for i in order[:8]])
        if model.solver.escalate_frac > 0:
            outs = kern(*ins_of(order[0]))
            entries["bpp_fused"] = check_escalate(label, kern.st,
                                                  model.solver, outs)
    else:
        q, dq, tau, _ = ins_of(order[0])
        entries["dynamics"] = check_dynamics(label, model, 1, q, dq, tau)
    return dict(counts, steps=GYM_STEPS), entries, label


def check_image(dev):
    """Phase gym, obs_type="image": a hopper DartEnv on the card returns
    frames at its screen size; the frame after three steps is held to the
    frame the float64 CPU env renders from the same state (at most 1% of
    the pixels may differ: float32 against float64 poses move primitive
    edges by a pixel)."""
    import numpy as np
    import torch

    from dartenv_tpu_torch.envs import DartEnv
    from dartenv_tpu_torch.envs.tasks import make_task

    env = DartEnv(make_task("hopper", device=dev), obs_type="image",
                  screen_width=80, screen_height=45)
    twin = DartEnv(make_task("hopper", device="cpu", dtype=torch.float64))
    env.seed(0)
    f = env.reset()
    assert f.shape == (45, 80, 3) and f.dtype == np.uint8
    t0 = time.perf_counter()
    for _ in range(3):
        f, r, d, _ = env.step(np.full(3, 0.3))
    ms = (time.perf_counter() - t0) * 1e3 / 3
    twin.seed(0)
    twin.reset()
    twin._state = to_device(env._state, "cpu", torch.float64)
    ref = twin._render(mode="rgb_array", width=80, height=45)
    diff = float((f != ref).any(-1).mean())
    emit("gym", check="image", env="DartHopper-v1", shape=list(f.shape),
         pixels_differing_frac=diff, ms_per_step=ms, tol_frac=0.01)
    assert diff <= 0.01


def held_states(env, twin):
    """Rel errors (to max(1, |twin|)) of the card env's and the float64
    twin's state vectors."""
    import numpy as np

    a, b = env.state_vector(), twin.state_vector()
    return float(np.abs(a - b).max() / max(1.0, float(np.abs(b).max())))


def check_facade(dev):
    """Phase facade on walker2d: the pydart2 views on the card against the
    float64 CPU env in the same state (q, dq, M, c, com, every body's
    com: 1e-4 of max(1, |ref|)); world.collision_result after a step with
    ground contact (one world.step(), forces from its impulses); one
    do_simulation with a force staged by add_ext_force
    (kernels 4 and 2's hybrid mode, nothing else), and the servo walker of
    bench/scenes.py driven by commands staged by set_commands (kernels 3,
    4 and 2), each held to the twin at 1e-3 and its kernels at B = 1
    against their plain versions.  Returns the counts and entries."""
    import numpy as np
    import torch

    import dartenv_tpu_torch as gym
    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.envs import DartEnv
    from dartenv_tpu_torch.envs.walker2d import Walker2dTask
    from dartenv_tpu_torch.lcp.hybrid import escalation_size

    env = gym.make("DartWalker2d-v1").unwrapped
    twin = gym.make("DartWalker2d-v1", device="cpu",
                    dtype=torch.float64).unwrapped
    env.seed(1)
    env.reset()
    twin.seed(1)
    twin.reset()
    rng = np.random.default_rng(5)
    for _ in range(40):                       # settle onto the ground
        env.step(rng.uniform(-0.3, 0.3, 6))
        if env.world.collision_result.num_contacts() >= 2:
            break
    pre = env._state
    twin._state = to_device(pre, "cpu", torch.float64)
    sk, st = env.robot_skeleton, twin.robot_skeleton
    rel = lambda x, y: float(np.abs(x - y).max()
                             / max(1.0, float(np.abs(y).max())))
    views = dict(q=rel(sk.q, st.q), dq=rel(sk.dq, st.dq), M=rel(sk.M, st.M),
                 c=rel(sk.c, st.c), com=rel(sk.com(), st.com()),
                 body_com=max(rel(b.com(), tb.com()) for b, tb in
                              zip(sk.bodynodes, st.bodynodes)))
    # one physics substep (world.step: do_simulation of one frame, which
    # keeps the manifold and the impulses behind collision_result)
    env.world.step()
    twin.world.step()
    cr, tcr = env.world.collision_result, twin.world.collision_result
    key = lambda c: (c.bodynode_id, float(c.point[0]))
    cs, ts = sorted(cr.contacts, key=key), sorted(tcr.contacts, key=key)
    contact = dict(contacts=len(cs), twin_contacts=len(ts))
    if len(cs) == len(ts):
        contact.update(
            bodies_equal=[c.bodynode_id for c in cs]
            == [c.bodynode_id for c in ts],
            point_err=max(float(np.abs(c.point - t.point).max())
                          for c, t in zip(cs, ts)),
            force_rel_err=max(rel(c.force, t.force) for c, t in zip(cs, ts)))

    # a force staged by add_ext_force: the phase-wise step without kernel 3
    pre = env._state
    twin._state = to_device(pre, "cpu", torch.float64)
    force, offset = [300.0, 0.0, 40.0], [0.0, 0.1, 0.0]
    for e in (env, twin):
        e.robot_skeleton.bodynodes[0].add_ext_force(force, offset)
    f_ext = torch.as_tensor(env._pending_fext[None], dtype=torch.float32,
                            device=dev)
    zero_counters()
    env.do_simulation(np.zeros(9), 1)
    ext_counts = dict(read_counters(), steps=1)
    twin.do_simulation(np.zeros(9), 1)
    ext_err = held_states(env, twin)
    model, cfg = env.model, env.model.solver
    zero_tau = torch.zeros((1, 9), device=dev)
    _, _, prob, lam0 = phasewise_lcp(model, pre.sim.q, pre.sim.dq, zero_tau,
                                     pre.sim.lam, f_ext)
    A, b, lo, hi, act, mu, findex, _, _ = prob
    lam_k, res_k, pgs = compare_pgs("facade_ext_force", (
        A, b, lo, hi, findex, mu, act, lam0), cfg.pgs_iters, cfg.pgs_omega)
    worst, idx = torch.topk(res_k, escalation_size(1, cfg.escalate_frac,
                                                   cfg.escalate_kmax))
    hyb = check_hybrid_batch("facade_ext_force", cfg, findex,
                             (A, b, lo, hi, mu, act), lam_k, worst, idx)

    # servo commands staged by set_commands
    senv = DartEnv(Walker2dTask(scenes.servo_walker(dev)))
    stwin = DartEnv(Walker2dTask(scenes.servo_walker("cpu", torch.float64)))
    senv.seed(2)
    senv.reset()
    stwin.seed(2)
    stwin.reset()
    stwin._state = to_device(senv._state, "cpu", torch.float64)
    cmd = np.zeros(9)
    cmd[3:] = rng.uniform(-2.0, 2.0, 6)
    for e in (senv, stwin):
        e.robot_skeleton.set_commands(cmd)
    pre = senv._state
    zero_counters()
    senv.do_simulation(np.zeros(9), 4)
    servo_counts = dict(read_counters(), steps=1)
    stwin.do_simulation(np.zeros(9), 4)
    servo_err = held_states(senv, stwin)
    servo = torch.as_tensor(cmd[None], dtype=torch.float32, device=dev)
    servo_entries = check_phasewise_model(
        "facade_servo", senv.model, (pre.sim.q, pre.sim.dq, zero_tau,
                                     pre.sim.lam, servo))
    emit("facade", env="DartWalker2d-v1", views_rel_err=views,
         collision_result=contact, ext_force_state_rel_err=ext_err,
         ext_force_launches={k: v for k, v in ext_counts.items() if v},
         servo_state_rel_err=servo_err,
         servo_launches={k: v for k, v in servo_counts.items() if v},
         tol_views=1e-4, tol_state=1e-3)
    assert max(views.values()) <= 1e-4, views
    assert contact["contacts"] > 0 and len(cs) == len(ts)
    assert contact["bodies_equal"] and contact["point_err"] <= 1e-3
    assert ext_err <= 1e-3 and servo_err <= 1e-3
    assert ext_counts == dict.fromkeys(ext_counts, 0) | dict(
        pgs=1, bpp_hybrid=1, steps=1,
        **integrate_counts(env.model, 1)), ext_counts
    assert servo_counts == dict.fromkeys(servo_counts, 0) | dict(
        dynamics=4, pgs=4, bpp_hybrid=4, steps=1,
        **integrate_counts(senv.model, 4)), servo_counts
    return (ext_counts, dict(pgs=pgs, bpp_hybrid=hyb)), (servo_counts,
                                                         servo_entries)


def check_checked(dev, states):
    """Phase checked: engine/debug.make_checked_sim_step on walker2d at
    B = 4096 (the check states of phase substep): a clean substep of the
    envs whose contacts fit the cap gives err.get() None; a NaN written
    into env 17's tau gives the non-finite tau message naming env 17; the
    ms per substep checked (with and without err.get()) and unchecked,
    medians of CHECKED_REPEATS interleaved rounds with their spread."""
    import torch

    from dartenv_tpu_torch.engine import debug
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.envs.tasks import make_task

    model = make_task("walker2d", device=dev).model
    q, dq, tau, lam = states
    B = q.shape[0]
    state = SimState(q=q, dq=dq, time=q.new_zeros(B), lam=lam)
    step = make_sim_step(model)
    checked = debug.make_checked_sim_step(model)
    err, (_, contacts) = checked(state, tau)
    first = err.get()
    fit = contacts.overflow <= 0
    sub = SimState(q=q[fit], dq=dq[fit], time=q.new_zeros(int(fit.sum())),
                   lam=lam[fit])
    clean = checked(sub, tau[fit])[0].get()
    bad = tau.clone()
    bad[17, 4] = float("nan")
    msg = checked(state, bad)[0].get()
    # CHECKED_REPEATS rounds, the three timings interleaved in each
    runs = {"checked": lambda: checked(state, tau),
            "checked_get": lambda: checked(state, tau)[0].get(),
            "unchecked": lambda: step(state, tau)}
    ms = {k: [] for k in runs}
    for _ in range(CHECKED_REPEATS):
        for k, fn in runs.items():
            ms[k].append(time_ms(fn))
    med = {k: statistics.median(v) for k, v in ms.items()}
    over = [g / u - 1.0 for g, u in zip(ms["checked_get"], ms["unchecked"])]
    emit("checked", env="walker2d", B=B, overflow_envs=int((~fit).sum()),
         first_message=first, clean_envs=int(fit.sum()), clean_message=clean,
         nan_message=msg, repeats=CHECKED_REPEATS,
         ms_per_substep_checked=med["checked"],
         ms_per_substep_checked_get=med["checked_get"],
         ms_per_substep=med["unchecked"],
         ms_min_max={k: [min(v), max(v)] for k, v in ms.items()},
         overhead=med["checked_get"] / med["unchecked"] - 1.0,
         overhead_min_max=[min(over), max(over)])
    assert clean is None, clean
    assert msg == f"{debug.MSG_TAU_IN} (env 17)", msg
    assert first is None or first.startswith(debug.MSG_OVERFLOW), first


def check_trace(dev):
    """Phase trace: validation/trace.capture_trace of walker2d (the task's
    model) for 200 substeps of seeded torques from the default pose, on
    the card in float32 (kernels 1 and 2 at B = 1, counters zeroed just
    before) and on the CPU in float64; the compare_traces report is
    printed, not gated."""
    import numpy as np
    import torch

    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.validation import capture_trace, compare_traces

    T = 200
    models = {d: make_task("walker2d", device=d, dtype=t).model
              for d, t in ((dev, torch.float32), ("cpu", torch.float64))}
    n = models["cpu"].n
    tau = np.zeros((T, n))
    tau[:, 3:] = np.random.default_rng(0).uniform(-100.0, 100.0, (T, 6))
    q0 = models["cpu"].host("q_init")
    zero_counters()
    t0 = time.perf_counter()
    card = capture_trace(models[dev], q0, np.zeros(n), tau)
    ms = (time.perf_counter() - t0) * 1e3 / T
    counts = read_counters()
    ref = capture_trace(models["cpu"], q0, np.zeros(n), tau)
    rep = compare_traces(ref, card, atol=1e-3, rtol=1e-2)
    emit("trace", env="walker2d", substeps=T, report=rep,
         ms_per_substep=ms, launches={k: v for k, v in counts.items() if v},
         atol=1e-3, rtol=1e-2)
    assert np.isfinite(card.q).all() and np.isfinite(card.dq).all()
    assert counts["substep"] == T and counts["bpp_fused"] == T


def check_resume(dev, root):
    """Phase resume: walker2d at B = RESUME_B through VecEnv (kernels 1 and
    2), 6 control steps, save_pytree of the state and the generator, 8
    steps live; then a VecEnv and a torch.Generator built anew, restored
    by load_pytree, 8 steps: obs, reward and done equal to the bit.
    Returns the live run's launch counts."""
    import os

    import torch

    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel.vec_env import VecEnv
    from dartenv_tpu_torch.utils import checkpoint as ckpt

    task = make_task("walker2d", device=dev)
    B = RESUME_B
    agen = torch.Generator(device=dev)
    agen.manual_seed(6)
    acts = [(torch.rand((B, 6), generator=agen, device=dev) * 2 - 1)
            for _ in range(14)]

    def run(vec, state):
        out = []
        for a in acts[6:]:
            state, obs, r, d, _ = vec.step(state, a)
            out += [obs, r, d]
        return out

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    vec = VecEnv(task, B, max_episode_steps=1000, generator=gen)
    state, _ = vec.reset()
    for a in acts[:6]:
        state, *_ = vec.step(state, a)
    path = os.path.join(root, "build", "chip_smoke_resume", "ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ckpt.save_pytree(path, (state, gen))
    zero_counters()
    live = run(vec, state)
    counts = dict(read_counters(), steps=8)
    gen2 = torch.Generator(device=dev)
    vec2 = VecEnv(task, B, max_episode_steps=1000, generator=gen2)
    template, _ = vec2.reset()
    state2, g = ckpt.load_pytree(path, (template, gen2))
    resumed = run(vec2, state2)
    equal = all(torch.equal(x, y) for x, y in zip(live, resumed))
    dones = int(sum(int(x.sum()) for x in live[2::3]))
    emit("resume", env="walker2d", B=B, steps_before=6, steps_after=8,
         bit_equal=equal, auto_resets=dones,
         launches={k: v for k, v in counts.items() if v})
    assert g is gen2 and equal
    assert counts["substep"] == 32 and counts["bpp_fused"] == 32
    return counts


def harness_envelope(name, dev, envelope):
    """Phase harness_envelope: the JAX harness's own protocol through the
    port on the card (validation/residual.harness_residuals: B = 1, 160
    substeps, its seeded torques, the normalized residual of every LCP of
    engine/world.make_lcp_capture that carries an impulse); median, p95
    and max beside the JAX bounds and beside phase envelope's line for the
    model (`envelope`).  At B = 1 every LCP is escalated (K = 1).  Gated
    for walker2d (its CPU run does not fit the suite's time per test; the
    hopper is gated there)."""
    import numpy as np
    import torch

    from dartenv_tpu_torch.validation import residual

    t0 = time.perf_counter()
    r, state = residual.harness_residuals(name, device=dev)
    got = [float(np.median(r)), float(np.percentile(r, 95)), float(r.max())]
    bounds = residual.JAX_ENVELOPE[name]
    within = [g < b for g, b in zip(got, bounds)]
    emit("harness_envelope", env=name, B=1, substeps=residual.SUBSTEPS,
         lcps=len(r), median_p95_max=got, jax_bounds_tpu=list(bounds),
         within_jax_bounds=within, envelope_phase_median_p95_max=envelope,
         seconds=time.perf_counter() - t0,
         finite_state=bool(torch.isfinite(state.q).all()))
    assert len(r) > 20, f"{name}: the rollout never made contact"
    if name == "walker2d":
        assert all(within), got


# ---- the learner, the loaders and the golden engines (PR 10) -------------

LEARN = (4096, 16, 3)      # envs, horizon, train steps of phase learn
LEARN_LR, LEARN_GAMMA = 3e-4, 0.99
LOADER_B = 4096            # envs of each world of phase loaders
LOADER_SUBSTEPS = 10       # substeps of each world's counted drive
GOLDEN_ENVS = 64           # states / LCPs of phase golden per model
GOLDEN_ACC_TOL = 2e-4      # kernel 3's ddq vs the golden, of max(1, |ddq|)
GOLDEN_RES_TOL = 1e-4      # kernel 2's normalized residual (solved)


def check_learn(dev, smi):
    """Phase learn: the learner on the card.  distributed_init with NCCL
    at world size 1 (a file:// store in a temporary directory), then
    parallel/train.make_train_step on walker2d at B = 4096, horizon 16,
    three REINFORCE steps (collect, then update), every kernel counter
    set to 0 just before and read just after: kernel 1 and kernel 2's
    fused mode once a substep, no plain call.  The loss and parameters
    stay finite and every parameter moves; the third step's update is
    held to reinforce_update run on the CPU in float64 on the same
    parameters and trajectory: per tensor within one float32 ulp of
    max |p| (the card's parameters are float32) plus 1e-4 of the largest
    update.  Returns the launch counts."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel.sharding import distributed_init
    from dartenv_tpu_torch.parallel.train import (
        make_train_step, reinforce_update,
    )

    B, H, steps = LEARN
    tmp = tempfile.mkdtemp(prefix="chip_smoke_learn_")
    group = distributed_init("cuda", "file://" + os.path.join(tmp, "store"),
                             world_size=1, rank=0)
    try:
        backend = dist.get_backend(group)
        task = make_task("walker2d", device=dev)
        init_fn, train_step = make_train_step(task, B, H, group=group,
                                              lr=LEARN_LR, gamma=LEARN_GAMMA)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params, state = init_fn(gen)
        first = {k: v.detach().clone() for k, v in params.items()}
        torch.cuda.synchronize()
        zero_counters()
        wall, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, stats, traj = train_step.collect(params, state, gen)
            new, loss = train_step.update(params, traj)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            held = (params, traj, new)
            params = new
        counts = read_counters()
        plain = sum(plain_counts())
        episodes = float(stats.episodes)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    p0, traj, p1 = held
    p0_64 = {k: v.detach().double().cpu().requires_grad_()
             for k, v in p0.items()}
    traj64 = tuple(x.double().cpu() if x.is_floating_point() else x.cpu()
                   for x in traj)
    p1_64, loss64 = reinforce_update(p0_64, traj64, LEARN_LR, LEARN_GAMMA)
    held_err, held_tol = {}, {}
    for k, v in p1_64.items():
        v = v.detach()
        held_err[k] = float((p1[k].detach().double().cpu() - v).abs().max())
        held_tol[k] = (2.0 ** -23 * float(v.abs().max())
                       + 1e-4 * float((v - p0_64[k].detach()).abs().max()))
    med = statistics.median(wall)
    sub = steps * H * task.frame_skip
    emit("learn", env="walker2d", B=B, horizon=H, train_steps=steps,
         backend=backend, world_size=1, nvidia_smi=smi,
         wall_ms_per_train_step=wall, median_wall_ms=med,
         train_env_steps_per_s=B * H / (med / 1e3), losses=losses,
         loss_float64=float(loss64), episodes_last=episodes,
         **{f"{k}_launches": v for k, v in counts.items()},
         plain_calls=plain, held_abs_err=held_err, held_tol=held_tol)
    assert backend == "nccl", backend
    assert all(map(lambda x: x == x and abs(x) < float("inf"), losses))
    for k, v in params.items():
        assert torch.isfinite(v).all(), k
        assert not torch.equal(v.detach(), first[k]), f"{k} did not move"
    want = dict.fromkeys(counts, 0)
    want.update(substep=sub, bpp_fused=sub,
                **integrate_counts(task.model, sub))
    assert counts == want, (counts, want)
    assert plain == 0
    bad = {k: e for k, e in held_err.items() if not e <= held_tol[k]}
    assert not bad, f"learner update parts from float64: {bad}"
    return dict(counts, steps=steps * H)


def loader_worlds(dev):
    """name -> model of phase loaders on the card: the URDF double
    pendulum (welded base, the URDF's own solver settings), the URDF
    floating block on a ground and the SDF pendulum-and-crate world
    (composed: cross-skeleton pairs), the last two with walker2d's
    escalating solver settings."""
    import tempfile

    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.model import skel_model as sm
    from dartenv_tpu_torch.model.sdf_loader import parse_sdf
    from dartenv_tpu_torch.model.urdf_loader import parse_urdf

    esc = make_task("walker2d", device=dev).model.solver
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "world.sdf")
        with open(path, "w") as f:
            f.write(scenes.SDF_PENDULUM_CRATE)
        sdf = parse_sdf(path, device=dev).combined
    return {"urdf_pendulum": parse_urdf(scenes.URDF_PENDULUM,
                                        root_joint=sm.WELD, device=dev),
            "urdf_box": parse_urdf(scenes.URDF_BOX, ground=True, solver=esc,
                                   device=dev),
            "sdf_world": sdf.replace(solver=esc)}


def loader_states(name, model, B, dev):
    """(q, dq, tau) of a loader world: the pendulum's elbow pushed past
    its limit in three envs of four (its limit row live), the block and
    the crate 1-3 mm into the ground at small random tilts, random
    torques on the pendulums' joints."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev) * 2 - 1
    q = model.q_init.expand(B, -1).clone()
    dq = 0.2 * u(B, model.n)
    tau = torch.zeros_like(q)
    if name == "urdf_pendulum":
        q[:, 0] = u(B)
        past = torch.arange(B, device=dev) % 4 != 3
        q[:, 1] = torch.where(past, torch.sign(u(B)) * (2.05 + 0.1 * u(B).abs()),
                              1.5 * u(B))
        tau = 5.0 * u(B, model.n)
    elif name == "urdf_box":
        q[:, :3] = 0.1 * u(B, 3)
        q[:, 3], q[:, 5] = u(B), u(B)
        q[:, 4] = 0.098 + 0.001 * u(B)
    else:                          # the pendulum's 1 dof, then the crate's 6
        q[:, 0] = u(B)
        q[:, 1:4] = 0.02 * u(B, 3)
        q[:, 5] = model.q_init[5] - 0.002 + 0.001 * u(B)
        tau[:, 0] = 5.0 * u(B)
    return q, dq, tau


def check_loaders(dev):
    """Phase loaders: each world of loader_worlds at B = 4096 through
    engine/world.make_sim_step, LOADER_SUBSTEPS substeps with every
    counter set to 0 just before and read just after (the route and the
    kernels launched per substep); then, from the reached states, its
    kernels against their plain versions (fused route: kernel 1 by
    hold_substep, kernel 2's fused mode by check_escalate; phase-wise
    route: kernels 3, 4 and 2's hybrid mode by check_phasewise_model) and
    one substep in lockstep with the plain path composed here.  Then
    DartEnv([the pendulum's .urdf]) for 20 control steps on the card.
    Returns {world: (counts, {kernel: its check})}."""
    import tempfile

    import numpy as np
    import torch

    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.engine.constraints import build_layout
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.envs import DartEnv

    out = {}
    for name, model in loader_worlds(dev).items():
        B = LOADER_B
        q, dq, tau = loader_states(name, model, B, dev)
        st = SimState(q=q, dq=dq, time=q.new_zeros(B),
                      lam=q.new_zeros((B, build_layout(model).m)))
        step = make_sim_step(model)
        zero_counters()
        for _ in range(LOADER_SUBSTEPS):
            st, contacts = step(st, tau)
        torch.cuda.synchronize()
        counts, plain = read_counters(), sum(plain_counts())
        fused = hs.in_fused_scope(model)
        ins = (st.q, st.dq, tau, st.lam)
        assert all(torch.isfinite(x).all() for x in ins)
        emit("loader_route", world=name, B=B, n=model.n, m=build_layout(
            model).m, route="fused" if fused else "phasewise",
             substeps=LOADER_SUBSTEPS, plain_calls=plain,
             launches_per_substep={k: v / LOADER_SUBSTEPS
                                   for k, v in counts.items()},
             active_contacts=float(contacts.active.sum()))
        assert plain == 0
        cfg = model.solver
        escal = cfg.escalate_frac > 0
        if fused:
            want = dict.fromkeys(counts, 0)
            want.update(substep=LOADER_SUBSTEPS)
            if escal:
                want.update(bpp_fused=LOADER_SUBSTEPS)
            kern = hs.get_substep_kernel(model)
            outs = kern(*ins)
            checks = {"substep": hold_substep(name, model, kern, outs, ins,
                                              None)}
            if escal:
                checks["bpp_fused"] = check_escalate(name, kern.st, cfg,
                                                     outs)
            tiers = (plain_tiers(kern.st.findex_c, cfg_budgets(cfg))
                     if escal else ())
            sk, _ = step(SimState(q=ins[0], dq=ins[1], time=q.new_zeros(B),
                                  lam=ins[3]), tau)
            sp = plain_substep(model, kern.st, tiers, *ins[:2], ins[3], tau)
            rel = lambda x, y: ((x - y).abs() / y.abs().clamp(min=1.0)).max(
                1).values
            beyond = int(((rel(sk.q, sp[0]) > 1e-3)
                          | (rel(sk.dq, sp[1]) > 1e-3)).sum())
            may = BPP_MAY_DIVERGE * -(-B // 128)
            emit("lockstep", env=name, B=B, substeps=1, envs_beyond_tol=beyond,
                 tol=1e-3, tol_envs_beyond=may,
                 dq_err_q99=float(rel(sk.dq, sp[1]).quantile(0.99)))
            assert beyond <= may
        else:
            want = dict.fromkeys(counts, 0)
            want.update(dynamics=LOADER_SUBSTEPS, pgs=LOADER_SUBSTEPS,
                        bpp_hybrid=LOADER_SUBSTEPS if escal else 0)
            states = ins + (None,)
            checks = check_phasewise_model(name, model, states)
            lockstep_model(name, model, states)
        want.update(integrate_counts(model, LOADER_SUBSTEPS))
        assert counts == want, (name, counts, want)
        out[name] = (dict(counts, steps=LOADER_SUBSTEPS), checks)

    # the gym surface on a .urdf: the reference signature, on the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pendulum.urdf")
        with open(path, "w") as f:
            f.write(scenes.URDF_PENDULUM)
        env = DartEnv([path], frame_skip=4, observation_size=16,
                      action_bounds=np.array([[1.0], [-1.0]]), device=dev)
    env.seed(0)
    env.reset()
    x0 = env.state_vector()
    zero_counters()
    for _ in range(20):
        env.do_simulation(np.zeros(env.model.n), env.frame_skip)
    counts = read_counters()
    x1 = env.state_vector()
    route = "fused" if hs.in_fused_scope(env.model) else "phasewise"
    emit("loader_env", path="pendulum.urdf", n=env.model.n, route=route,
         control_steps=20, **{f"{k}_launches": v for k, v in counts.items()},
         finite=bool(np.isfinite(x1).all()),
         moved=float(np.abs(x1 - x0).max()))
    assert np.isfinite(x1).all() and np.abs(x1 - x0).max() > 0
    assert counts["substep" if route == "fused" else "dynamics"] == 80
    return out


def check_golden(dev, checks):
    """Phase golden: the C++ goldens (dartenv_tpu_torch.native, built with
    g++ here) hold kernels 3 and 2.  Kernel 3's dq_star on GOLDEN_ENVS
    walker2d and humanwalker rollout states: ddq = (dq_star - dq) / dt
    against native.aba in float64 on the same float32 inputs, within
    GOLDEN_ACC_TOL of max(1, |ddq|) per env.  Kernel 2's core mode (the
    solver="dantzig" mode's budgets) on GOLDEN_ENVS captured walker2d
    LCPs against native.lcp_solve, by normalized complementarity residual
    (friction LCPs have several solutions, so not by impulses): every
    golden point exact (below 1e-9), the kernel's below GOLDEN_RES_TOL on
    all but BPP_MAY_DIVERGE envs."""
    import numpy as np
    import torch

    from dartenv_tpu_torch import native
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp.dantzig import make_exact_solver
    from dartenv_tpu_torch.validation.residual import comp_residual

    t0 = time.time()
    native.build()
    build_s = time.time() - t0
    G = GOLDEN_ENVS
    host = lambda x: x.detach().double().cpu().numpy()
    acc = {}
    for e in ("walker2d", "humanwalker"):
        model = make_task(e, device=dev).model
        q, dq, tau = (x[:G] for x in checks[e]["states"][:3])
        dq_star = hd.get_dynamics_kernel(model)(q, dq, tau)[0]
        m64 = model.to(device="cpu", dtype=torch.float64)
        dt = float(model.dt)
        qh, dqh, tauh, dsh = map(host, (q, dq, tau, dq_star))
        errs = []
        for i in range(G):
            ref = native.aba(m64, qh[i], dqh[i], tauh[i], dt)
            got = (dsh[i] - dqh[i]) / dt
            errs.append(float(np.abs(got - ref).max()
                              / max(1.0, np.abs(ref).max())))
        acc[e] = max(errs)
    model = make_task("walker2d", device=dev, lcp_solver="dantzig").model
    q, dq, tau, lam_prev = (x[:G] for x in checks["walker2d"]["states"])
    _, _, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam_prev, None)
    A, b, lo, hi, act, mu, findex, _, _ = prob
    lam_k = host(make_exact_solver(findex)(A, b, lo, hi, mu, act, lam0))
    res_k, res_g, bad_g = [], [], 0
    for i in range(G):
        a = host(act[i]) > 0.5
        Ai, bi, mui = host(A[i]), host(b[i]), host(mu[i])
        loi, hii = np.where(a, host(lo[i]), 0.0), np.where(a, host(hi[i]),
                                                            0.0)
        x, _, bad = native.lcp_solve(Ai, bi, loi, hii, findex, mui)
        bad_g += bad
        r = lambda z: (comp_residual(Ai, bi, z, loi, hii, findex, mui,
                                     a.astype(np.float64))
                       / max(1.0, float(np.abs(z).max())))
        res_g.append(r(x))
        res_k.append(r(lam_k[i]))
    res_k, res_g = np.asarray(res_k), np.asarray(res_g)
    emit("golden", build_s=build_s, envs=G,
         kernel3_ddq_rel_err=acc, tol_ddq=GOLDEN_ACC_TOL,
         lcp_m=int(b.shape[1]), lcp_active_rows=float(act.sum()),
         kernel2_core_res_median_p95_max=[
             float(np.median(res_k)), float(np.quantile(res_k, 0.95)),
             float(res_k.max())],
         golden_res_max=float(res_g.max()), golden_violations=bad_g,
         kernel2_envs_above_tol=int((res_k > GOLDEN_RES_TOL).sum()),
         tol_res=GOLDEN_RES_TOL, tol_envs_above=BPP_MAY_DIVERGE)
    assert all(v <= GOLDEN_ACC_TOL for v in acc.values()), acc
    assert bad_g == 0 and res_g.max() <= 1e-9
    assert float(act.sum()) > G, "constraint rows are not live"
    assert int((res_k > GOLDEN_RES_TOL).sum()) <= BPP_MAY_DIVERGE


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script only runs on a GPU", file=sys.stderr)
        return 1

    import dartenv_tpu_torch  # noqa: F401  (asserts full-f32 products)
    from dartenv_tpu_torch import cuda_build
    from dartenv_tpu_torch.bench import scenes
    from dartenv_tpu_torch.bench.throughput import card_name
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.dynamics import hopper_integrate as hi
    from dartenv_tpu_torch.engine.constraints import build_layout
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp
    from dartenv_tpu_torch.validation import residual

    t_start = time.time()
    dev = torch.device("cuda")
    B = 4096

    # ---- 1. device ------------------------------------------------------
    smi = card_name(dev)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 2. build (all nvcc processes started together) -----------------
    t0 = time.time()
    kerns = {e: hs.get_substep_kernel(make_task(e, device=dev).model)
             for e in FUSED_ENVS}
    sunk_kerns = [hs.get_substep_kernel(sunk_model(kerns[e].model, d))
                  for e, d in SUNK_GROUND.items()]
    dyn_models = {e: make_task(e, device=dev).model
                  for e in ("cartpole", "doublependulum", "walker2d")}
    dyn_models.update(joint_chains(dev))
    dkerns = {e: hd.get_dynamics_kernel(m) for e, m in dyn_models.items()}
    # the DR builds of phase dr: kernel 1 and kernel 3 with per-env leaves
    dr_kerns = {(e, tag): hs.get_substep_kernel(
        kerns[e].model, dr_fields=dr_fields_of(tag, "substep"))
        for e, tag in DR_SUBSTEP}
    dr_dkerns = {(e, tag): hd.get_dynamics_kernel(
        dyn_models[e], dr_fields_of(tag, "dynamics"))
        for e, tag in DR_DYNAMICS}
    # kernel 1 with the bench CLI's knobs (12 PGS sweeps, phase bench_cli)
    knob_kern = hs.get_substep_kernel(knob_model(dev))
    # the BPP kernel: core and hybrid modes per row count (and per
    # refinement passes of the hybrid mode), fused mode per substep digest
    # (of the models that escalate); the core mode at walker2d's 24 rows
    # serves the solver="dantzig" path
    esc = [k for k in kerns.values() if k.st.cfg.escalate_frac > 0]
    # the phase-wise paths of the multi-skeleton world and the servo
    # walker, and the collision-matrix scenes: kernel 3 for each model,
    # the hybrid mode for the first two; the ES_REF64 builds (the fused
    # mode of humanwalker's digest with escalate_ref64, the hybrid mode
    # at its 41 rows)
    sim_models = {p: sim_model(p, dev) for p in SIM_PATHS}
    matrix_models = {nm: scenes.scene_builder(nm).finalize(device=dev)
                     for nm in scenes.SCENES}
    hw = kerns["humanwalker"]
    st64 = hs._SubStatic(hw.model.replace(solver=dataclasses.replace(
        hw.model.solver, escalate_ref64=REF64)))

    def solver_rows(model):
        lay, cap = build_layout(model), int(model.solver.contact_cap)
        ns = lay.contact_slots
        return lay.m - 3 * ns + 3 * (min(cap, ns) if cap else ns)

    bpp_keys = list(dict.fromkeys(
        [(k.st.m_c, hb.header(k.st.m_c)) for k in esc]
        + [(k.st.m_c, hb.header(k.st.m_c, k.st.cfg.escalate_ref))
           for k in esc]
        + [(k.st.m_c, k.st.escalation_header) for k in esc]
        + [(solver_rows(m), hb.header(solver_rows(m), m.solver.escalate_ref,
                                      m.solver.escalate_ref64))
           for m in sim_models.values()]
        + [(st64.m_c, st64.escalation_header),
           (st64.m_c, hb.header(st64.m_c, 0, REF64))]))
    # PR 10's phases: the loaders' worlds (kernel 1 and kernel 2's fused
    # mode on the fused route, kernel 3 and kernel 2's hybrid mode on the
    # phase-wise one) and kernel 3 on humanwalker (phase golden)
    loaders = loader_worlds(dev)
    fused_loaders = [hs.get_substep_kernel(m) for m in loaders.values()
                     if hs.in_fused_scope(m)]
    phasewise_loaders = [m for m in loaders.values()
                         if not hs.in_fused_scope(m)]
    bpp_keys += [(k.st.m_c, k.st.escalation_header) for k in fused_loaders
                 if k.st.cfg.escalate_frac > 0]
    bpp_keys += [(knob_kern.st.m_c, knob_kern.st.escalation_header)]
    bpp_keys += [(solver_rows(m), hb.header(solver_rows(m),
                                            m.solver.escalate_ref,
                                            m.solver.escalate_ref64))
                 for m in phasewise_loaders]
    bpp_keys = list(dict.fromkeys(bpp_keys))
    gkern = global_tables_kernel(sim_models["multiskel"])
    new_dkerns = [gkern] + list({id(k): k for k in (
        [hd.get_dynamics_kernel(m) for m in sim_models.values()]
        + [hd.get_dynamics_kernel(m) for m in matrix_models.values()]
        + [hd.get_dynamics_kernel(m) for m in phasewise_loaders]
        + [hd.get_dynamics_kernel(kerns["humanwalker"].model)])
        if k not in dkerns.values()}.values())
    builds = ([hb.start_build(m, h) for m, h in bpp_keys]
              + [hp.start_build()]
              + [k.start_build() for k in kerns.values()]
              + [k.start_build() for k in sunk_kerns]
              + [k.start_build() for k in dkerns.values()]
              + [k.start_build() for k in dr_kerns.values()]
              + [k.start_build() for k in dr_dkerns.values()]
              + [k.start_build() for k in new_dkerns]
              + [k.start_build() for k in fused_loaders]
              + [knob_kern.start_build(), hi.start_build()])
    for (m, h), bld in zip(bpp_keys, builds):
        hb.load(m, bld, h)
    hp.load(builds[len(bpp_keys)])
    for k in (list(kerns.values()) + sunk_kerns + list(dkerns.values())
              + list(dr_kerns.values()) + list(dr_dkerns.values())
              + new_dkerns + fused_loaders + [knob_kern]):
        k.load()
    hi.load()
    ptxas = {bld.tag + "/" + bld.so_path.split("/")[-2][-6:]:
             [ln.strip() for ln in cuda_build.build_log(bld).splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
             for bld in builds}
    emit("build", seconds=time.time() - t0, libraries=len(builds),
         ptxas=ptxas,
         substep_smem_bytes={e: k.load().substep_smem_bytes()
                             for e, k in kerns.items()},
         substep_envs_per_block={e: hs.launch_shape(k.st)
                                 for e, k in kerns.items()},
         dr_substep={f"{e}_{tag}": dict(
             dr_floats=k.dr_width, launch_shape=k.shape,
             smem_bytes=k.load().substep_smem_bytes())
             for (e, tag), k in dr_kerns.items()},
         dr_dynamics_floats={f"{e}_{tag}": k.dr_width
                             for (e, tag), k in dr_dkerns.items()},
         fused_smem_bytes={
             e: hb.load(k.st.m_c, None,
                        k.st.escalation_header).bpp_fused_smem_bytes()
             for e, k in kerns.items() if k in esc})
    st = kerns["walker2d"].st
    assert (st.n, st.ns, st.cap, st.m_c, st.layout.m) == (9, 14, 6, 24, 48)
    assert {e: (k.st.n, k.st.m_c) for e, k in kerns.items()} == {
        "walker2d": (9, 24), "hopper": (6, 15), "walker3d": (18, 36),
        "humanwalker": (29, 41), "reacher": (5, 5), "dog": (18, 36),
        "snake7link": (9, 48), "reacher2d": (2, 1)}
    assert not kerns["snake7link"].st.compact       # SS_COMPACT = 0
    assert (kerns["dog"].st.ns, kerns["dog"].st.cap) == (20, 8)
    ms_model = sim_models["multiskel"]
    assert (ms_model.n, ms_model.nb, build_layout(ms_model).contact_slots,
            build_layout(ms_model).m, solver_rows(ms_model)) == (
        15, 8, 39, 123, 36)
    assert solver_rows(sim_models["servo"]) == 30

    # ---- 3-5. substep and BPP kernels vs their plain versions, lockstep -
    checks = {e: check_env(e, Be, dev) for e, Be in FUSED_ENVS.items()}
    envelopes = {e: residual_envelope(e, dev, checks[e]["states"])
                 for e in residual.JAX_ENVELOPE}

    # ---- 5b. the position-update kernel vs its plain version ------------
    integ = {e: check_integrate(e, kerns[e].model, *checks[e]["states"][:2])
             for e in INTEGRATE_ENVS}

    # ---- 6. dynamics kernel vs its plain version ------------------------
    dyn = {}
    for seed, (e, model) in enumerate(dyn_models.items()):
        if e == "walker2d":
            q, dq, tau, _ = checks["walker2d"]["states"]
            Bd = B
        else:
            Bd = 8192 if e in ("cartpole", "doublependulum") else 1024
            q, dq, tau = random_states(model, Bd, seed, dev)
        dyn[e] = check_dynamics(e, model, Bd, q, dq, tau)
    # B not a multiple of the envs per block (128 threads per block in
    # csrc/dynamics.cu over the lane group): the last block is partly
    # filled
    for seed, (e, Bd) in enumerate((("cartpole", 8191), ("walker2d", 4095))):
        assert Bd % (128 // dkerns[e].group), (e, Bd)
        if e == "walker2d":
            q, dq, tau = (x[:Bd] for x in checks["walker2d"]["states"][:3])
        else:
            q, dq, tau = random_states(dyn_models[e], Bd, 100 + seed, dev)
        check_dynamics(e, dyn_models[e], Bd, q, dq, tau)

    # ---- 7. PGS kernel (and BPP on the hybrid's top K) vs plain ---------
    pgs, bpp_pert = check_pgs(dev, "walker2d", checks["walker2d"]["states"])
    pgs_hw, hybrid_hw = check_pgs(dev, "humanwalker",
                                  checks["humanwalker"]["states"])

    # ---- 7b. the BPP kernel's core mode over whole batches (dantzig) ----
    core = {e: check_core_batch(e, dev, checks[e]["states"])
            for e in ("walker2d", "walker3d", "humanwalker")}

    # ---- 8. lockstep of the phase-wise paths ----------------------------
    lockstep_phasewise("cartpole", dev)
    lockstep_phasewise("walker2d", dev, checks["walker2d"]["states"],
                       perturb=True)
    lockstep_phasewise("walker2d", dev, checks["walker2d"]["states"],
                       solver="dantzig")

    # ---- 8b. the multi-skeleton world, the servo walker, the matrix -----
    sim_checks = {}
    for p, model in sim_models.items():
        states = sim_states(p, model, SIM_PATHS[p][0], dev)
        sim_checks[p] = check_phasewise_model(p, model, states)
        lockstep_model(p, model, states)
        if p == "multiskel":
            integ[p] = check_integrate(p, model, *states[:2])
            check_capture(p, model, states)
            table_space(p, model, gkern, *states[:3])
            capsule_box_pairs(model, *states[:2])
    check_servo_behaviour(dev)
    check_matrix(dev)
    ref64 = check_ref64(dev, checks, kerns, hybrid_hw)

    # ---- 9. the main paths, launches counted per path -------------------
    counts = {key: drive_main_path(dev, *key) for key in PATHS}
    dantzig = ("walker2d", False, "dantzig")
    sim_counts = {p: drive_sim_path(p, dev) for p in SIM_PATHS}
    ref64_counts = {key: drive_main_path(dev, *key, ref64=REF64)
                    for key in REF64_PATHS}

    # ---- 9b. domain randomization: the DR kernels, then their paths -----
    dr = check_dr(dev, checks, dr_kerns, dyn_models)
    dr_counts = {e: drive_dr_path(dev, e, smi) for e in DR_PATHS}
    frames_counts = drive_frames_path(dev, smi, checks["walker2d"]["states"])

    # ---- 9c. the bench CLI: --all, the knobs, profile_dir ---------------
    knob_checks = check_knob_kernels(knob_kern, checks["walker2d"]["states"])
    cli_counts = check_bench_cli(dev, smi, os.path.dirname(
        os.path.abspath(__file__)))

    # ---- 10. device launches of one eager walker2d control step ---------
    from dartenv_tpu_torch.bench.profile_step import profile

    prof = profile("walker2d", B, steps=5, top=6)
    emit("launches", env="walker2d", B=B,
         device_launches_per_control_step=prof[
             "device_launches_per_control_step"],
         wall_ms_per_control_step=prof["wall_ms_per_control_step"],
         top_device_kernels=prof["top_device_kernels"], limit=700)
    assert prof["device_launches_per_control_step"] <= 700

    # ---- 12. the gym surface: single envs (B = 1) -----------------------
    import dartenv_tpu_torch as gym

    gym_runs = [drive_gym(i, dev)
                for i in sorted(s.id for s in gym.registry.all())]
    check_image(dev)
    (ext_counts, ext_entries), (servo_counts, servo_entries) = \
        check_facade(dev)
    check_checked(dev, checks["walker2d"]["states"])
    check_trace(dev)
    resume_counts = check_resume(dev, os.path.dirname(
        os.path.abspath(__file__)))
    for e in residual.HARNESS_TORQUE:
        harness_envelope(e, dev, envelopes[e])

    # ---- 13. the learner, the loaders, the golden engines ---------------
    learn_counts = check_learn(dev, smi)
    loader_runs = check_loaders(dev)
    check_golden(dev, checks)

    # ---- 11. the kernels line -------------------------------------------
    sources = {
        "substep": ("fused_substep", "dartenv_tpu_torch/csrc/substep.cu",
                    "dartenv_tpu/engine/pallas_substep.py:762"),
        "bpp_fused": ("bpp_escalate", "dartenv_tpu_torch/csrc/bpp.cu",
                      "dartenv_tpu/lcp/pallas_bpp.py:232"),
        "bpp_hybrid": ("bpp_hybrid", "dartenv_tpu_torch/csrc/bpp.cu",
                       "dartenv_tpu/lcp/pallas_bpp.py:232"),
        "dynamics": ("dynamics", "dartenv_tpu_torch/csrc/dynamics.cu",
                     "dartenv_tpu/dynamics/pallas_dynamics.py:807"),
        "pgs": ("pgs_solve", "dartenv_tpu_torch/csrc/pgs.cu",
                "dartenv_tpu/lcp/pallas_pgs.py:131"),
        "bpp_core": ("bpp_core", "dartenv_tpu_torch/csrc/bpp.cu",
                     "dartenv_tpu/lcp/pallas_bpp.py:232"),
        # port-only: XLA fuses the JAX package's position update
        "integrate": ("integrate", "dartenv_tpu_torch/csrc/integrate.cu",
                      "dartenv_tpu/dynamics/batched.py:384"),
    }
    # (env, path: a PATHS key or "dr", kernel, its check)
    entries = [(e, (e, False), key, checks[e][phase])
               for e in FUSED_ENVS for key, phase in (("substep", "substep"),
                                                      ("bpp_fused",
                                                       "escalate"))
               if phase in checks[e]]
    entries += [("cartpole", ("cartpole", False), "dynamics", dyn["cartpole"]),
                ("walker2d", ("walker2d", True), "pgs", pgs),
                ("walker2d", ("walker2d", True), "bpp_hybrid", bpp_pert)]
    entries += [("walker2d", "dr", "substep", dr["substep"]),
                ("walker2d", "dr", "bpp_fused", dr["escalate"]),
                ("cartpole", "dr", "dynamics", dr["dynamics"]),
                ("walker3d", "dr", "substep", dr["substep_walker3d"]),
                ("walker3d", "dr", "bpp_fused",
                 checks["walker3d"]["escalate"])]
    entries += [("walker2d", dantzig, "bpp_core", core["walker2d"]),
                ("walker2d", dantzig, "dynamics", dyn["walker2d"]),
                ("humanwalker", ("humanwalker", True), "pgs", pgs_hw),
                ("humanwalker", ("humanwalker", True), "bpp_hybrid",
                 hybrid_hw)]
    entries += [(e, (e, False), "integrate", integ[e])
                for e in INTEGRATE_ENVS]
    entries += [("humanwalker", ("humanwalker", True), "integrate",
                 integ["humanwalker"]),
                ("walker3d", "dr", "integrate", integ["walker3d"])]
    # (label, launch counts of its path, kernel, its check)
    rows = []
    for e, path, key, c in entries:
        label = e + ("_dr" if path == "dr" else
                     "_perturbed" if path[1] else
                     f"_{path[2]}" if len(path) > 2 else "")
        rows.append((label, dr_counts[e] if path == "dr" else counts[path],
                     key, c))
    # the slice's paths
    rows += [(p, sim_counts[p], key, sim_checks[p][key])
             for p in SIM_PATHS for key in ("dynamics", "pgs", "bpp_hybrid")]
    rows += [("multiskel", sim_counts["multiskel"], "integrate",
              integ["multiskel"])]
    hw_ref64 = ref64_counts[("humanwalker", False)]
    rows += [("humanwalker_ref64", hw_ref64, "substep",
              checks["humanwalker"]["substep"]),
             ("humanwalker_ref64", hw_ref64, "bpp_fused", ref64[0]),
             ("humanwalker_perturbed_ref64",
              ref64_counts[("humanwalker", True)], "bpp_hybrid", ref64[1])]
    # the gym surface's paths: each id's DartEnv at B = 1, the facade's
    # staged force and servo commands, the VecEnv resume
    rows += [(label, cnt, key, c) for cnt, ents, label in gym_runs
             for key, c in ents.items()]
    rows += [("facade_ext_force", ext_counts, key, c)
             for key, c in ext_entries.items()]
    rows += [("facade_servo", servo_counts, key, servo_entries[key])
             for key in ("dynamics", "pgs", "bpp_hybrid")]
    rows += [("walker2d_resume", resume_counts, key, checks["walker2d"][ph])
             for key, ph in (("substep", "substep"),
                             ("bpp_fused", "escalate"))]
    # PR 10's paths: the learner's rollout, the loaders' worlds
    rows += [("walker2d_learn", learn_counts, key, checks["walker2d"][ph])
             for key, ph in (("substep", "substep"),
                             ("bpp_fused", "escalate"))]
    rows += [(w, cnt, key, c) for w, (cnt, ents) in loader_runs.items()
             for key, c in ents.items()]
    # the frame-leaf DR path, the bench CLI's knob run
    rows += [("walker2d_frames", frames_counts, "pgs", pgs),
             ("walker2d_frames", frames_counts, "bpp_hybrid", bpp_pert)]
    rows += [("walker2d_bench_knobs", cli_counts, key, c)
             for key, c in knob_checks.items()]
    kernels = []
    for label, n, key, c in rows:
        kname, src, repl = sources[key]
        kernels.append({
            "name": f"{kname}[{label}]", "route": "cuda", "source": src,
            "replaces": repl, "launches": n[key],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1], "library_ms": None,
            "launches_per_control_step": n[key] / n["steps"],
            "device_ms": c.get("device_ms"), "shape": c["shape"]})
        if key == "dynamics" and label == "cartpole":
            w = dyn["walker2d"]
            kernels[-1].update(walker2d_states_device_ms=w["device_ms"],
                               walker2d_states_ms=w["ms"],
                               walker2d_states_shape=w["shape"])
    assert all(k["launches"] > 0 for k in kernels)
    emit("done", seconds=time.time() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
