#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts on a GPU.

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  python3 chip_smoke.py

It builds the port's four CUDA kernels from dartenv_tpu_torch/csrc (all
nvcc processes started together) and then, in float32:

  * for DartWalker2d and DartHopper at B = 4096 (the fused-substep path):
    the substep kernel and the BPP kernel's core mode against their plain
    PyTorch versions at that path's shapes; the escalation stage (the BPP
    kernel's fused mode, one launch) against its plain version on the same
    substep outputs, and for walker2d once more with a cold tier 2; the
    kernel path and a plain path composed here in lockstep;
  * the dynamics kernel against its plain version on cartpole and the
    double pendulum at B = 8192, on walker2d states at B = 4096 and on two
    ModelBuilder chains that hold the six joint types the substep kernel
    lacks, at B = 1024;
  * the PGS kernel, the BPP kernel's core mode on the hybrid's top K and
    its hybrid mode (the whole escalation, one launch) against their plain
    versions on the LCPs of perturbed walker2d's phase-wise step at
    B = 4096;
  * lockstep control steps of cartpole and of perturbed walker2d at
    B = 1024 beside plain paths composed here;
  * each path (bench_env: batched rollout under a random policy) with
    every kernel's launch counter and plain-call counter set to 0 just
    before it and read just after: walker2d and hopper, cartpole at
    B = 8192 for 1000 control steps, perturbed walker2d at B = 4096 for 100;
  * the device launches of one eager walker2d control step at B = 4096,
    counted by torch.profiler as dartenv_tpu_torch/bench/profile_step.py
    counts them (line `launches`).

Each phase prints one JSON line; any failing phase raises, and without a
GPU the script exits non-zero before printing a result.  The last line is
{"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
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


def substep_work(st, B):
    """(bytes, flops) one fused-substep launch must move / do for B envs:
    each input read once, each output written once; flops from the
    digest's sizes (dense counts of the stages that dominate)."""
    from dartenv_tpu_torch.engine.hopper_substep import _out_sizes

    n, nb, m, m_c = st.n, st.nb, st.layout.m, st.m_c
    words = 3 * n + m + sum(_out_sizes(st).values())
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
    it1, rf1, po1, it2, rf2, po2 = budgets
    n = rebuild_n
    flops = solve_flops(m, it1, rf1, po1) + 2 * m * m
    if it2 > 0:
        flops += solve_flops(m, it2, rf2, po2) + 2 * m * m
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
BPP_MAY_DIVERGE = 4            # envs of K = 128 that may take another branch
LOCK_MAY_DIVERGE = 2           # envs of 1024 beyond 1e-3 after one step
CONTROL_STEPS_BEFORE = 25      # control steps before the states are taken
# (env, perturb) -> (batch, horizon, rollouts); the first rollout of each
# is bench_env's warm-up
PATHS = {("walker2d", False): (4096, 100, 2), ("hopper", False): (4096, 100, 2),
         ("cartpole", False): (8192, 1000, 1),
         ("walker2d", True): (4096, 100, 1)}
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
                        cfg.escalate_iters2)


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
            make(*budgets[3:]) if budgets[3] > 0 else None)


def plain_substep(model, st, tiers, q, dq, lam, tau):
    """One substep through the plain versions only, composed here as the
    port's substep phase composes the kernels: substep_reference ->
    escalate_batch with the plain BPP -> integrate_positions.  Returns
    (q, dq, lam)."""
    from dartenv_tpu_torch.dynamics.batched import integrate_positions
    from dartenv_tpu_torch.engine import hopper_substep as hs

    outs = hs.substep_reference(model, st, q, dq, tau, lam)
    dq, lam = hs.escalate_reference(st, model.solver, outs, outs["dq_plus"],
                                    outs["lam_full"], *tiers)[:2]
    return integrate_positions(model, q, dq, st.dt), dq, lam


def check_bpp(name, cfg, findex, A, b, lo, hi, mu, act, lam_c):
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
         tol_lam=1e-5, tol_res_diff=1e-5, tol_envs_same=K - BPP_MAY_DIVERGE)
    assert torch.isfinite(lam_k).all()
    # These are the WORST K envs of a live rollout under the shipped 4 + 2
    # pivot budget, which does not close every one of them in either
    # version (the escalation stage keeps the better point per env).  The
    # kernel is held to its plain version env by env: impulses within 1e-5
    # and residuals within 1e-5.  A few envs may part ways: in float32 the
    # pivot's re-open test compares rounding noise with 1e-10, the two
    # versions sum in different orders, and one flipped row sends a
    # stalling solve down another branch.  Those envs are counted and
    # bounded, and over all K the kernel must solve (< 1e-4) as many envs
    # as the plain version, less the ones that parted.
    assert n_same >= K - BPP_MAY_DIVERGE, (n_same, K)
    assert bpp_err <= 1e-5 and res_diff_same <= 1e-5
    assert solved(r_k) >= solved(r_r) - (K - n_same)
    assert solved(r_k) > K // 2
    assert float(r_k.median()) < float(r_pgs.median())
    bb, bf = bpp_work(m_c, K, cfg.escalate_iters, cfg.escalate_refine, 3)
    return dict(max_abs_err=bpp_err, ms=bpp_ms, plain_ms=bpp_plain_ms,
                bound=bound(bb, bf),
                shape=f"{name} K={K} m={m_c} iters={cfg.escalate_iters} "
                      f"refine={cfg.escalate_refine} polish=3")


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
    assert solved(res_k) >= solved(res_r) - (K - n_same), (phase, name)
    return out, err


def check_escalate(name, st, cfg, outs, tier2=False):
    """Phase escalate: the escalation stage on a float32 CUDA batch (top K
    + one launch of the BPP kernel's fused mode) against its plain version
    (escalate_reference with the plain BPP) on the same substep outputs.
    Returns what the kernels line needs."""
    import dataclasses

    import torch

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
    plain_ms = time_ms(run_r, runs=5, warmup=1)
    n, m_c, m, width = st.escalation_dims
    eb, ef = escalate_work(K, m_c, budgets, width + n + m, n + m,
                           rebuild_n=n)
    emit("escalate", **line, iters2=cfg.escalate_iters2, ms=ms,
         plain_ms=plain_ms, bound_ms=bound(eb, ef)[0])
    assert torch.equal(dqp0, outs["dq_plus"])      # inputs not modified
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound=bound(eb, ef),
                shape=f"{name} K={K} m={m_c} n={n} fused "
                      f"iters={budgets[0]}+{budgets[1]} "
                      f"iters2={budgets[3]}+{budgets[4]}")


def check_env(name, B, dev):
    """Phases substep, bpp and lockstep for one env at batch B.  Returns
    what the kernels line needs."""
    import torch

    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    task = make_task(name, device=dev)
    model, cfg = task.model, task.model.solver
    kern = hs.get_substep_kernel(model)
    st = kern.st
    n_act = task.action_size
    # the plain path composed below is tier 1 only, as the shipped settings
    assert cfg.escalate_frac > 0 and cfg.escalate_iters2 == 0

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
    tau = task.action_to_tau(rand_a(B), ())
    assert torch.isfinite(q).all() and torch.isfinite(dq).all()

    outs = kern(q, dq, tau, lam_prev)
    torch.cuda.synchronize()
    ref = hs.substep_reference(model, st, q, dq, tau, lam_prev)
    got_b, ref_b = hs.output_blocks(st, outs), hs.output_blocks(st, ref)
    assert set(got_b) == set(ref_b) and "esc" not in got_b
    agree = torch.ones(B, dtype=torch.bool, device=dev)
    for f in DISCRETE:
        agree &= (got_b[f] == ref_b[f]).all(1)
    frac = float(agree.float().mean())
    errs, abs_errs, unequal = {}, {}, {}
    for f in got_b:
        a, r = got_b[f][agree], ref_b[f][agree]
        assert torch.isfinite(a).all(), f
        if f in EXACT_BLOCKS:
            unequal[f] = int((a != r).sum())
        else:
            abs_errs[f] = float((a - r).abs().max())
            errs[f] = abs_errs[f] / max(1.0, float(r.abs().max()))
    sub_ms = time_ms(lambda: kern(q, dq, tau, lam_prev))
    sub_plain_ms = time_ms(
        lambda: hs.substep_reference(model, st, q, dq, tau, lam_prev),
        runs=5, warmup=1)
    emit("substep", env=name, B=B, agree_frac=frac, rel_err=errs,
         abs_err=abs_errs, unequal_entries=unequal,
         active_slots=float(ref["con_active"].sum()),
         active_rows=float(ref_b["act"].sum()), ms=sub_ms,
         plain_ms=sub_plain_ms, tol_rel=1e-4, tol_agree=0.999)
    # (hopper stands on one foot and is in the air for part of its stride)
    assert float(ref["con_active"].sum()) > 0.05 * B, "contacts are not live"
    assert float(ref_b["act"].sum()) > B, "constraint rows are not live"
    assert frac >= 0.999, f"discrete fields agree on {frac:.5f} of envs"
    assert not any(unequal.values()), f"copied blocks differ: {unequal}"
    bad = {f: e for f, e in errs.items() if not e <= 1e-4}
    assert not bad, f"substep kernel disagrees: {bad}"

    # ---- 4. BPP kernel vs its plain version -----------------------------
    g = hs.gather_escalation(st, cfg, outs)
    K, m_c = g["b"].shape
    assert (K, m_c) == (hs.escalation_size(B, cfg.escalate_frac,
                                           cfg.escalate_kmax), st.m_c)
    bpp = check_bpp(name, cfg, st.findex_c, g["A"], g["b"], g["lo"],
                    g["hi"], g["mu"], g["act"], g["lam_c"])
    escalate = check_escalate(name, st, cfg, outs)
    if name == "walker2d":
        check_escalate(name, st, cfg, outs, tier2=True)

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
    drift, lock = [], None
    plain_before = hs.PLAIN_CALLS
    for i in range(8):
        tau_l = task.action_to_tau(rand_a(Bl), ())
        same = torch.ones(Bl, dtype=torch.bool, device=dev)
        for _ in range(task.frame_skip):
            sk, _ = sim_step(sk, tau_l)
            sp = plain_substep(model, st, tiers, *sp, tau_l)
            same &= (sk.lam[:, rows] > 0).eq(sp[2][:, rows] > 0).all(1)
        dq_err, q_err = rel(sk.dq, sp[1]), rel(sk.q, sp[0])
        if i == 0:
            lock = dict(same_contact_frac=float(same.float().mean()),
                        q_err=float(q_err[same].max()),
                        dq_err=float(dq_err[same].max()),
                        dq_err_all=float(dq_err.max()),
                        envs_beyond_tol=int(((dq_err > 1e-3)
                                             | (q_err > 1e-3))[same].sum()),
                        q_err_q99=float(q_err[same].quantile(0.99)),
                        dq_err_q99=float(dq_err[same].quantile(0.99)))
        drift.append(float(torch.nanmedian(dq_err)))
    emit("lockstep", env=name, B=Bl, **lock, median_dq_drift_per_step=drift,
         tol=1e-3, tol_envs_beyond=LOCK_MAY_DIVERGE)
    assert hs.PLAIN_CALLS == plain_before    # the phase took no plain call
    assert lock["same_contact_frac"] > 0.9
    # within 1e-3 on the envs with equal contact sets; an env whose exact
    # re-solve took another branch in one version (see the bpp phase) is
    # beyond it, and at most LOCK_MAY_DIVERGE envs may be
    assert lock["envs_beyond_tol"] <= LOCK_MAY_DIVERGE
    assert lock["q_err_q99"] <= 1e-3 and lock["dq_err_q99"] <= 1e-3

    sb, sf = substep_work(st, B)
    lay = f"n={st.n} m={st.layout.m} m_c={m_c}"
    return {
        "substep": dict(
            max_abs_err=max(abs_errs.values()), ms=sub_ms,
            plain_ms=sub_plain_ms, bound=bound(sb, sf),
            shape=f"{name} B={B} {lay}"),
        "bpp": bpp,
        "escalate": escalate,
        "states": (q, dq, tau, lam_prev),
    }


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


def dynamics_work(model, B):
    """(bytes, flops) of one dynamics launch for B envs: q, dq, tau read
    once, dq_star, M, phi, R_w, p_w written once; flops of the stages that
    dominate (kinematics, mass matrix, bias forces, Cholesky solve)."""
    n, nb = model.n, model.nb
    words = 3 * n + n + n * n + 6 * n + 12 * nb
    flops = (nb * 400 + nb * (n * 60 + n * (n + 1) * 6)
             + n ** 3 // 3 + 2 * n * n + 12 * n)
    return 4 * words * B, flops * B


def check_dynamics(name, model, B, q, dq, tau):
    """Phase dynamics for one model: the kernel against its plain version,
    output by output, relative to max(1, |ref|_inf)."""
    import torch

    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    kern = hd.get_dynamics_kernel(model)
    got = kern(q, dq, tau)
    torch.cuda.synchronize()
    ref = hd.dynamics_reference(model, q, dq, tau)
    errs, abs_errs = {}, {}
    for k, a, r in zip(DYN_TOL, got, ref):
        assert a.shape == r.shape and torch.isfinite(a).all(), k
        abs_errs[k] = float((a - r).abs().max())
        errs[k] = abs_errs[k] / max(1.0, float(r.abs().max()))
    ms = time_ms(lambda: kern(q, dq, tau))
    plain_ms = time_ms(lambda: hd.dynamics_reference(model, q, dq, tau),
                       runs=5, warmup=1)
    joints = sorted({int(t) for t in model.joint_type})
    emit("dynamics", env=name, B=B, n=model.n, nb=model.nb,
         joint_types=joints, rel_err=errs, abs_err=abs_errs, ms=ms,
         plain_ms=plain_ms, tol_rel=DYN_TOL)
    bad = {k: e for k, e in errs.items() if not e <= DYN_TOL[k]}
    assert not bad, f"dynamics kernel disagrees on {name}: {bad}"
    return dict(max_abs_err=max(abs_errs.values()), ms=ms,
                plain_ms=plain_ms, bound=bound(*dynamics_work(model, B)),
                shape=f"{name} B={B} n={model.n} nb={model.nb}")


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


def phasewise_lcp(model, q, dq, tau, lam_prev, f_ext):
    """The boxed LCPs of the phase-wise step with an external force, as
    engine/world.make_sim_step assembles them (plain dynamics, collision,
    assemble_lcp, compacted warm start).  Returns (dq_star, contacts,
    (A, b, lo, hi, act, mu, findex, MinvJt, row_sel), lam0)."""
    from dartenv_tpu_torch.collision.narrowphase import collide
    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.engine.constraints import (
        assemble_lcp, build_layout, compact_lam,
    )

    dt = model.dt
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt, f_ext)
    dq_star = dq + dt * ddq
    contacts = collide(model, kin.R_w, kin.p_w)
    A, b, lo, hi, act, mu, findex, MinvJt, row_sel, _ = assemble_lcp(
        model, build_layout(model), kin.phi, M, q, dq, dq_star, contacts,
        dt)
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
    return escalate_rows(A, b, lo, hi, mu, act, lam, idx, worst, findex,
                         cfg.escalate_tol,
                         *plain_tiers(findex, cfg_budgets(cfg)))[0]


def plain_phasewise_substep(model, q, dq, lam, tau, f_ext):
    """One phase-wise substep through the plain versions only, composed
    here as engine/world.make_sim_step composes the kernels: without an
    external force the dynamics kernel's plain version (the models here
    have no constraint rows then); with one, the plain dynamics,
    collision, assembly and the plain hybrid solve.  Then the position
    update.  Returns (q, dq, lam)."""
    import torch

    from dartenv_tpu_torch.dynamics import batched
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine.constraints import (
        build_layout, scatter_lam,
    )

    m = build_layout(model).m
    if f_ext is None:
        assert m == 0
        dq_plus = hd.dynamics_reference(model, q, dq, tau)[0]
    else:
        dq_star, _, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam,
                                               f_ext)
        A, b, lo, hi, act, mu, findex, MinvJt, row_sel = prob
        lam_c = plain_hybrid(model.solver, findex, A, b, lo, hi, mu, act,
                             lam0)
        dq_plus = dq_star + torch.sum(MinvJt * lam_c[:, None, :], dim=-1)
        lam = scatter_lam(lam_c, row_sel, m)
    return (batched.integrate_positions(model, q, dq_plus, model.dt),
            dq_plus, lam)


def check_pgs(dev, states):
    """Phase pgs: the PGS kernel against its plain version on the LCPs of
    perturbed walker2d's phase-wise step at B = 4096 (states from the
    walker2d rollout, about half of the envs pushed), then the BPP kernel
    on the hybrid's top K of those.  Returns what the kernels line needs
    for both."""
    import torch

    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp
    from dartenv_tpu_torch.lcp.hybrid import escalate_rows, escalation_size

    task = make_task("walker2d", device=dev)
    model, cfg = task.model, task.model.solver
    q, dq, tau, lam_prev = states
    B = q.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    f_ext = random_pushes(model, task, B, gen, dev)
    _, _, prob, lam0 = phasewise_lcp(model, q, dq, tau, lam_prev, f_ext)
    A, b, lo, hi, act, mu, findex, _, _ = prob
    m = b.shape[1]
    args = (A, b, lo, hi, findex, mu, act)
    kw = dict(iters=cfg.pgs_iters, omega=cfg.pgs_omega, lam0=lam0,
              return_residual=True)
    lam_k, res_k = hp.pgs_solve_cuda(*args, **kw)
    torch.cuda.synchronize()
    lam_r, res_r = hp.pgs_solve_reference(*args, **kw)
    lam_bad = (lam_k - lam_r).abs() > 1e-6 + 1e-5 * lam_r.abs()
    res_bad = (res_k - res_r).abs() > 1e-7 + 1e-4 * res_r.abs()
    lam_err = float((lam_k - lam_r).abs().max())
    ms = time_ms(lambda: hp.pgs_solve_cuda(*args, **kw))
    plain_ms = time_ms(lambda: hp.pgs_solve_reference(*args, **kw),
                       runs=5, warmup=1)
    emit("pgs", env="walker2d_perturbed", B=B, m=m, iters=cfg.pgs_iters,
         active_rows=float(act.sum()), lam_abs_err=lam_err,
         lam_abs_max=float(lam_r.abs().max()),
         res_abs_err=float((res_k - res_r).abs().max()),
         res_max=float(res_r.max()), res_median=float(res_r.median()),
         lam_entries_beyond_tol=int(lam_bad.sum()),
         res_envs_beyond_tol=int(res_bad.sum()),
         res_envs_unequal=int((res_k != res_r).sum()), ms=ms,
         plain_ms=plain_ms, tol_lam=dict(rtol=1e-5, atol=1e-6),
         tol_res=dict(rtol=1e-4, atol=1e-7))
    assert float(act.sum()) > B, "constraint rows are not live"
    assert torch.isfinite(lam_k).all() and torch.isfinite(res_k).all()
    assert not bool(lam_bad.any()) and not bool(res_bad.any())
    words = m * m + 7 * m + 1          # A, 6 vectors in; lam, res out
    flops = 2 * (cfg.pgs_iters + 1) * m * (m + 4)
    pgs = dict(max_abs_err=lam_err, ms=ms, plain_ms=plain_ms,
               bound=bound(4 * words * B, flops * B),
               shape=f"walker2d_perturbed B={B} m_c={m} "
                     f"iters={cfg.pgs_iters} residual")

    K = escalation_size(B, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res_k, K)
    check_bpp("walker2d_perturbed", cfg, findex, A[idx], b[idx], lo[idx],
              hi[idx], mu[idx], act[idx], lam_k[idx])

    # the hybrid mode: the whole escalation of the phase-wise solve
    budgets = cfg_budgets(cfg)
    tiers = plain_tiers(findex, budgets)
    run_k = lambda: hb.bpp_hybrid(A, b, lo, hi, mu, act, lam_k, idx, worst,
                                  findex, cfg.escalate_tol, budgets)
    run_r = lambda: escalate_rows(A, b, lo, hi, mu, act, lam_k, idx, worst,
                                  findex, cfg.escalate_tol, *tiers)
    out_k, take_k, kept_k = run_k()
    torch.cuda.synchronize()
    out_r, take_r, kept_r = run_r()
    rest = torch.ones(B, dtype=torch.bool, device=dev)
    rest[idx] = False
    others = (torch.equal(out_k[rest], out_r[rest])
              and torch.equal(out_k[rest], lam_k[rest]))
    line, err = compare_escalation(
        "hybrid", "walker2d_perturbed", K, (out_k[idx], take_k, kept_k),
        (out_r[idx], take_r, kept_r), others)
    ms = time_ms(run_k)
    plain_ms = time_ms(run_r, runs=5, warmup=1)
    hbb, hbf = escalate_work(K, m, budgets, m * m + 7 * m, m)
    emit("hybrid", **line, ms=ms, plain_ms=plain_ms,
         bound_ms=bound(hbb, hbf)[0])
    bpp = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound=bound(hbb, hbf),
               shape=f"walker2d_perturbed K={K} m={m} hybrid "
                     f"iters={budgets[0]}+{budgets[1]}")
    return pgs, bpp


def plain_counts():
    """The plain-call counters of all four kernels' dispatchers."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    return (hs.PLAIN_CALLS, hb.PLAIN_CALLS, hd.PLAIN_CALLS, hp.PLAIN_CALLS)


def lockstep_phasewise(name, dev, states=None):
    """Phase lockstep for a phase-wise path: one control step at B = 1024,
    the port's sim step (the kernels) beside plain_phasewise_substep, the
    same external force in both when `states` (q, dq, tau, lam) are given
    (perturbed walker2d), none otherwise (cartpole, from reset states);
    contact sets compared after every substep."""
    import torch

    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step
    from dartenv_tpu_torch.envs.base import make_env_reset

    B = 1024 if states is None else min(1024, states[0].shape[0])
    task = make_task(name, device=dev)
    model = task.model
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    if states is None:
        sim = make_env_reset(task)(B, gen)[0].sim
        f_ext = None
    else:
        q, dq, _, lam = (x[:B].clone() for x in states)
        sim = SimState(q=q, dq=dq, time=q.new_zeros(B), lam=lam)
        f_ext = random_pushes(model, task, B, gen, dev)
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
    for _ in range(task.frame_skip):
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
    emit("lockstep", env=name + ("" if f_ext is None else "_perturbed"),
         B=B, **lock, tol=1e-3, tol_envs_beyond=LOCK_MAY_DIVERGE)
    assert torch.isfinite(sk.q).all() and torch.isfinite(sk.dq).all()
    assert plain_counts() == plain_before    # the kernel path took none
    assert lock["same_contact_frac"] > 0.9
    assert lock["envs_beyond_tol"] <= LOCK_MAY_DIVERGE
    if f_ext is not None:
        assert impulse_rows > B, "contacts are not live"


def drive_main_path(dev, name, perturb=False):
    """Phase rollout: the batched rollout of one path through bench_env,
    with every kernel's launch counter and every plain-call counter set to
    0 just before and read just after.  Returns the launch counts."""
    import torch

    from dartenv_tpu_torch.bench.throughput import bench_env
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    B, horizon, rollouts = PATHS[(name, perturb)]
    hs.SUBSTEP_LAUNCHES = hd.DYNAMICS_LAUNCHES = hp.PGS_LAUNCHES = 0
    hb.CORE_LAUNCHES = hb.FUSED_LAUNCHES = hb.HYBRID_LAUNCHES = 0
    hs.PLAIN_CALLS = hb.PLAIN_CALLS = hd.PLAIN_CALLS = hp.PLAIN_CALLS = 0
    t0 = time.time()
    out = bench_env(name, batch=B, horizon=horizon, iters=rollouts - 1,
                    max_episode_steps=1000, device=dev,
                    return_state=True, perturb=perturb)
    seconds = time.time() - t0
    counts = dict(substep=hs.SUBSTEP_LAUNCHES, bpp_core=hb.CORE_LAUNCHES,
                  bpp_fused=hb.FUSED_LAUNCHES, bpp_hybrid=hb.HYBRID_LAUNCHES,
                  dynamics=hd.DYNAMICS_LAUNCHES, pgs=hp.PGS_LAUNCHES)
    plain = sum(plain_counts())
    end, task = out.pop("state"), out.pop("task")
    obs = task.obs(end.sim, end.aux)
    steps_run = out["control_steps_run"]
    finite = all(bool(torch.isfinite(x).all())
                 for x in (end.sim.q, end.sim.dq, obs))
    emit("rollout", **out, **{f"{k}_launches": v for k, v in counts.items()},
         plain_calls=plain, finite_state=finite, seconds=seconds)
    assert finite
    assert obs.shape[0] == B and end.sim.q.shape == (B, task.model.n)
    assert out["episodes_seen"] > 0
    sub = task.frame_skip * steps_run
    want = dict.fromkeys(counts, 0)
    if perturb:                      # the external-force route
        want.update(bpp_hybrid=sub, pgs=sub)
    elif hs.in_fused_scope(task.model):
        want.update(substep=sub, bpp_fused=sub)
    else:                            # no constraint rows: kernel 3 only
        want.update(dynamics=sub)
    assert counts == want, (counts, want)
    assert plain == 0
    return dict(counts, steps=steps_run)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script only runs on a GPU", file=sys.stderr)
        return 1

    import dartenv_tpu_torch  # noqa: F401  (asserts full-f32 products)
    from dartenv_tpu_torch import cuda_build
    from dartenv_tpu_torch.bench.throughput import make_task
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
    from dartenv_tpu_torch.engine import hopper_substep as hs
    from dartenv_tpu_torch.lcp import hopper_bpp as hb
    from dartenv_tpu_torch.lcp import hopper_pgs as hp

    t_start = time.time()
    dev = torch.device("cuda")
    envs = ("walker2d", "hopper")
    B = 4096

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # ---- 2. build (all nvcc processes started together) -----------------
    t0 = time.time()
    kerns = {e: hs.get_substep_kernel(make_task(e, device=dev).model)
             for e in envs}
    dyn_models = {e: make_task(e, device=dev).model
                  for e in ("cartpole", "doublependulum", "walker2d")}
    dyn_models.update(joint_chains(dev))
    dkerns = {e: hd.get_dynamics_kernel(m) for e, m in dyn_models.items()}
    # the BPP kernel: core and hybrid modes per row count, fused mode per
    # substep digest
    bpp_keys = [(k.st.m_c, None) for k in kerns.values()] + [
        (k.st.m_c, k.st.escalation_header) for k in kerns.values()]
    builds = ([hb.start_build(m, h) for m, h in bpp_keys]
              + [hp.start_build()]
              + [k.start_build() for k in kerns.values()]
              + [k.start_build() for k in dkerns.values()])
    for (m, h), bld in zip(bpp_keys, builds):
        hb.load(m, bld, h)
    hp.load(builds[len(bpp_keys)])
    for k in list(kerns.values()) + list(dkerns.values()):
        k.load()
    ptxas = {bld.tag + "/" + bld.so_path.split("/")[-2][-6:]:
             [ln.strip() for ln in cuda_build.build_log(bld).splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
             for bld in builds}
    emit("build", seconds=time.time() - t0, libraries=len(builds),
         ptxas=ptxas,
         substep_smem_bytes={e: k.load().substep_smem_bytes()
                             for e, k in kerns.items()})
    st = kerns["walker2d"].st
    assert (st.n, st.ns, st.cap, st.m_c, st.layout.m) == (9, 14, 6, 24, 48)

    # ---- 3-5. substep and BPP kernels vs their plain versions, lockstep -
    checks = {e: check_env(e, B, dev) for e in envs}

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

    # ---- 7. PGS kernel (and BPP on the hybrid's top K) vs plain ---------
    pgs, bpp_pert = check_pgs(dev, checks["walker2d"]["states"])

    # ---- 8. lockstep of the phase-wise paths ----------------------------
    lockstep_phasewise("cartpole", dev)
    lockstep_phasewise("walker2d", dev, checks["walker2d"]["states"])

    # ---- 9. the main paths, launches counted per path -------------------
    counts = {key: drive_main_path(dev, *key) for key in PATHS}

    # ---- 10. device launches of one eager walker2d control step ---------
    from dartenv_tpu_torch.bench.profile_step import profile

    prof = profile("walker2d", B, steps=5, top=6)
    emit("launches", env="walker2d", B=B,
         device_launches_per_control_step=prof[
             "device_launches_per_control_step"],
         wall_ms_per_control_step=prof["wall_ms_per_control_step"],
         device_busy_share=prof["device_busy_share"],
         top_device_kernels=prof["top_device_kernels"], limit=700)
    assert prof["device_launches_per_control_step"] <= 700

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
    }
    entries = [(e, False, key, checks[e][phase])
               for e in envs for key, phase in (("substep", "substep"),
                                                ("bpp_fused", "escalate"))]
    entries += [("cartpole", False, "dynamics", dyn["cartpole"]),
                ("walker2d", True, "pgs", pgs),
                ("walker2d", True, "bpp_hybrid", bpp_pert)]
    kernels = []
    for e, perturb, key, c in entries:
        kname, src, repl = sources[key]
        n = counts[(e, perturb)]
        label = e + ("_perturbed" if perturb else "")
        kernels.append({
            "name": f"{kname}[{label}]", "route": "cuda", "source": src,
            "replaces": repl, "launches": n[key],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
            "bound_by": c["bound"][1], "library_ms": None,
            "launches_per_control_step": n[key] / n["steps"],
            "shape": c["shape"]})
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
