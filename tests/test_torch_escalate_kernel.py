"""PyTorch port, the escalation kernel (csrc/bpp.cu, lcp/hopper_bpp.py):
  (a) the fused mode's per-env arithmetic outside the warp collectives
      (csrc/escalate_body.h: operator rebuild, residual, keep-best, delta
      patches), built with g++, against the plain composition
      (gather_escalation, comp_residual, escalate_reference) on walker2d
      and hopper at K = 8, float32, the plain BPP's impulses handed in,
      within 1e-5 of max(1, |ref|);
  (b) the dispatch rule: a CPU batch runs the plain composition;
  (c) the refusal of m > 32 rows, before any CUDA call;
  (d) the tier policy's one source: the solvers of the plain composition
      carry the tuple the kernel is launched with."""
import shutil

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.bench.throughput import make_task
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.lcp.hopper_pgs import pgs_solve_reference
from dartenv_tpu_torch.lcp.hybrid import (
    comp_residual, escalation_size, keep_best, make_hybrid_solver,
)
from torch_port_util import rel_err


def _substep_outputs(name, B, seed, **solver_kw):
    """A float32 CPU batch of the plain substep's outputs, with contacts
    pressed in and random warm starts so the PGS leaves offenders."""
    model = make_task(name, device="cpu", **solver_kw).model
    st = ths._SubStatic(model)
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    q = model.q_init.numpy()[None] + rng.uniform(-0.1, 0.1, (B, model.n))
    q[:, 1] -= rng.uniform(0.0, 0.08, B)
    dq = rng.uniform(-1.5, 1.5, (B, model.n))
    tau = rng.uniform(-80.0, 80.0, (B, model.n))
    lam = rng.uniform(0.0, 0.5, (B, st.layout.m))
    outs = ths.substep_reference(model, st, f(q), f(dq), f(tau), f(lam))
    return model, st, outs


def _tiers(st, cfg):
    return hopper_bpp.tier_solvers(st.findex_c, hopper_bpp.tier_budgets(
        cfg.escalate_iters, cfg.escalate_refine, cfg.escalate_iters2))


def _launches():
    return (hopper_bpp.CORE_LAUNCHES, hopper_bpp.FUSED_LAUNCHES,
            hopper_bpp.HYBRID_LAUNCHES)


@pytest.mark.parametrize("name,iters2", [("walker2d", 0), ("hopper", 4)])
def test_host_build_of_fused_mode_matches_plain(name, iters2):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    model, st, outs = _substep_outputs(name, 256, 3, escalate_iters2=iters2)
    cfg = model.solver
    assert escalation_size(256, cfg.escalate_frac, cfg.escalate_kmax) == 8
    exact1, exact2 = _tiers(st, cfg)
    g = ths.gather_escalation(st, cfg, outs)
    prob = (g["A"], g["b"], g["lo"], g["hi"], g["mu"], g["act"])
    lam1 = exact1(*prob, g["lam_c"])
    lam2 = None if exact2 is None else exact2(*prob,
                                              torch.zeros_like(lam1))
    dqp, lamf, idx, take, _ = ths.escalate_reference(
        st, cfg, outs, outs["dq_plus"], outs["lam_full"], exact1, exact2)
    assert torch.equal(idx, g["idx"])
    host = hopper_bpp.fused_host(
        st.escalation_header, st.escalation_dims, st.findex_c,
        outs["esc"][idx], outs["dq_plus"][idx], outs["lam_full"][idx],
        g["worst"], lam1, lam2, cfg.escalate_tol)
    resid = lambda lam: comp_residual(*prob[:2], lam, g["lo"], g["hi"],
                                      st.findex_c, g["mu"], g["act"])
    # The operator is held against gather_escalation evaluated in float64
    # on the same float32 rows: PyTorch's vectorized CPU torch.sqrt can be
    # one ulp from the correctly rounded value (the kernel's sqrtf is
    # correctly rounded), and hopper's M is conditioned so that one ulp of
    # L[0][0] moves M^-1 Jc^T by several 1e-6 of its max; two float32
    # evaluations of the same formula then differ by more than 1e-5.
    g64 = ths.gather_escalation(st, cfg, {k: outs[k].double()
                                          for k in ("res", "esc")})
    pairs = {"A": (host["A"], g64["A"]),
             "MinvJt": (host["MinvJt"], g64["MinvJt"]),
             "res_tier1": (host["res"][:, 0], resid(lam1)),
             "dq_plus": (host["dq_plus"], dqp[idx]),
             "lam_full": (host["lam_full"], lamf[idx])}
    if lam2 is not None:
        pairs["res_tier2"] = (host["res"][:, 1], resid(lam2))
    for k, (a, r) in pairs.items():
        assert rel_err(a, r) <= 1e-5, (k, rel_err(a, r))
    assert torch.equal(host["take"], take)
    assert bool(take.any()), "no escalated env changed: the case is vacuous"


def test_cpu_batch_runs_the_plain_composition():
    """escalate_batch and make_hybrid_solver on a CPU batch: the torch
    sequences (no kernel launch), equal to the bit to the stages composed
    here."""
    model, st, outs = _substep_outputs("walker2d", 64, 4)
    cfg = model.solver
    exact1, _ = _tiers(st, cfg)
    launches, plain = _launches(), hopper_bpp.PLAIN_CALLS
    dqp, lamf = ths.escalate_batch(st, cfg, outs, outs["dq_plus"],
                                   outs["lam_full"], exact1)
    ref = ths.escalate_reference(st, cfg, outs, outs["dq_plus"],
                                 outs["lam_full"], exact1)
    assert torch.equal(dqp, ref[0]) and torch.equal(lamf, ref[1])
    assert not torch.equal(dqp, outs["dq_plus"])

    g = ths.gather_escalation(st, cfg, outs)
    A, b, lo, hi, mu, act = (g[k] for k in ("A", "b", "lo", "hi", "mu",
                                            "act"))
    kw = dict(iters=cfg.pgs_iters, omega=cfg.pgs_omega,
              escalate_frac=0.25, escalate_tol=cfg.escalate_tol,
              escalate_iters=cfg.escalate_iters, escalate_kmax=128,
              escalate_refine=cfg.escalate_refine)
    got = make_hybrid_solver(st.findex_c, **kw)(A, b, lo, hi, mu, act,
                                                g["lam_c"])
    lam, res = pgs_solve_reference(A, b, lo, hi, st.findex_c, mu, act,
                                   iters=cfg.pgs_iters, omega=cfg.pgs_omega,
                                   lam0=g["lam_c"], return_residual=True)
    worst, idx = torch.topk(res, escalation_size(lam.shape[0], 0.25, 128))
    m = b.shape[1]
    pk = torch.cat([b, lo, hi, mu, act, lam], dim=1)[idx]
    bk, lok, hik, muk, actk, lamk = pk.split(m, dim=1)
    lam_new, _, _ = keep_best((A[idx], bk, lok, hik, muk, actk),
                              st.findex_c, worst, lamk, cfg.escalate_tol,
                              exact1)
    assert torch.equal(got, lam.index_copy(0, idx, lam_new))
    assert _launches() == launches
    assert hopper_bpp.PLAIN_CALLS > plain


def test_more_than_32_rows_are_refused_before_any_cuda_call():
    K, m = 4, 33
    z = torch.zeros((K, m))
    idx = torch.zeros((K,), dtype=torch.int64)
    findex = -np.ones(m, dtype=np.int64)
    budgets = hopper_bpp.tier_budgets(4, 2, 0)
    with pytest.raises(NotImplementedError, match="m = 33"):
        hopper_bpp.bpp_hybrid(torch.zeros((K, m, m)), z, z, z, z, z, z, idx,
                              z[:, 0], findex, 1e-5, budgets)
    with pytest.raises(NotImplementedError, match="m = 33"):
        hopper_bpp.bpp_fused("", (9, m, 66, 500), z, z, z, idx, z[:, 0],
                             findex, 1e-5, budgets)
    with pytest.raises(NotImplementedError, match="m = 33"):
        hopper_bpp.start_build(m)
    # within the limit, a CPU tensor is refused by the CUDA-only modes
    with pytest.raises(ValueError, match="CUDA"):
        hopper_bpp.bpp_hybrid(torch.zeros((K, 24, 24)), *[z[:, :24]] * 6,
                              idx, z[:, 0], findex[:24], 1e-5, budgets)


def test_tier_solvers_carry_the_kernels_budgets():
    """tier_budgets is the one source of the escalation's tiers: the
    solvers built from it give the same tuple back (what the fused and
    hybrid modes are launched with), and a solver built otherwise is
    refused rather than ignored."""
    for iters2 in (0, 4):
        budgets = hopper_bpp.tier_budgets(4, 2, iters2)
        assert budgets[:3] == (4, 2, hopper_bpp.TIER_POLISH[0])
        assert budgets[3:] == ((iters2, 6, hopper_bpp.TIER_POLISH[1])
                               if iters2 else (0, 0, 0))
        exact1, exact2 = hopper_bpp.tier_solvers(np.array([-1, 0, 0]),
                                                 budgets)
        assert (exact2 is None) == (iters2 == 0)
        assert hopper_bpp.solver_budgets(exact1, exact2) == budgets
    assert hopper_bpp.tier_budgets(6, -1, 0)[1] == 6     # default refine
    with pytest.raises(TypeError, match="tier_solvers"):
        hopper_bpp.solver_budgets(lambda *a: None)
