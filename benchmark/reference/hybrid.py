"""Hybrid LCP solve: batched PGS + exact re-solve of the worst envs.

After the batched PGS solve,

  1. every env's normalized complementarity residual (`comp_residual`;
     fused into the PGS kernel on a float32 CUDA batch),
  2. the worst K = min(B, kmax, ceil(frac * B)) envs by residual
     (`escalation_size`, `torch.topk`),
  3. ONE gather of their problems and a warm tier-1 exact re-solve
     (lcp/dantzig.make_exact_solver: the BPP kernel on a float32 CUDA
     batch), with an optional cold tier-2,
  4. `keep_best`: a re-solved point replaces the PGS one only where the
     PGS residual exceeded `escalate_tol` and the new residual is lower;
     with `escalate_ref64` > 0 the mixed-precision refinement tier
     (lcp/dantzig.refine_mixed), else with `escalate_ref` > 0 the
     compensated one (lcp/dantzig.refine_compensated), then refines the
     kept point, and its result is kept by the same rule,
  5. scatter back: envs outside the top K keep their PGS impulses bit for
     bit.

On a float32 CUDA batch, stages 3-5 are ONE launch of the escalation
kernel's hybrid mode (lcp/bpp.bpp_hybrid); any other batch runs
them as the torch composition below (`escalate_rows`), which is that
mode's plain version.

`make_hybrid_solver` is the phase-wise path's solver (the fused substep
phase runs the same stages over its packed buffer, in
engine/hopper_substep.escalate_batch, through `escalation_size` and
`keep_best` of this module).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.dantzig import refine_compensated, refine_mixed
from benchmark.reference.pgs import findex_tensors
from benchmark.reference.linalg import seq_mv


def comp_residual(A, b, x, lo, hi, findex, mu, active, seq: bool = False):
    """Normalized max complementarity violation at x's own friction-bound
    fixed point over active rows.  A: (..., m, m), vectors (..., m);
    returns (...,) scalars normalized by max(1, |x|_inf) per problem.
    seq: w = A x summed in the kernels' order (math/linalg.seq_mv), as the
    escalation kernel's es_residual sums it."""
    fidx, has_f = findex_tensors(findex, x.device)
    has_f = has_f.to(x.dtype)
    bd = mu * torch.abs(x[..., fidx]) * has_f + 1e20 * (1 - has_f)
    lo_e = torch.maximum(lo, -bd)
    hi_e = torch.minimum(hi, bd)
    w = (seq_mv(A, x) if seq
         else torch.sum(A * x[..., None, :], dim=-1)) + b
    scale = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                        min=1.0)
    eps = 1e-6 * scale + 1e-9
    at_lo = x <= lo_e + eps
    at_hi = x >= hi_e - eps
    zero = torch.zeros_like(w)
    res = torch.where(at_lo & at_hi, zero,
                      torch.where(at_lo, -w,
                                  torch.where(at_hi, w, torch.abs(w))))
    res = torch.maximum(res, torch.maximum(lo_e - x, x - hi_e))
    res = torch.where(active > 0.5, res, zero)
    return torch.amax(res / scale, dim=-1)


def escalation_size(B: int, frac: float, kmax: int) -> int:
    """K = min(B, kmax, ceil(frac * B)): how many envs are re-solved."""
    return min(B, int(kmax), max(1, int(np.ceil(B * frac))))


def keep_best(prob, findex, worst, lamk, tol, exact1, exact2=None,
              ref_passes: int = 0, ref64_passes: int = 0):
    """The escalation's keep-best rule over K gathered problems.

    prob: (A, b, lo, hi, mu, active) of the K envs; worst: their PGS
    residuals; lamk: their PGS impulses.  Tier 1 re-solves warm from lamk,
    the optional tier 2 cold; a point is taken only where the residual it
    replaces exceeds `tol` and its own is lower.  Then a refinement tier
    refines the kept point — with ref64_passes > 0 the mixed-precision one
    (lcp/dantzig.refine_mixed), else with ref_passes > 0 the compensated
    one (lcp/dantzig.refine_compensated) — and its result is taken by the
    same rule against the kept point's residual (the JAX package's order:
    its res_cur is that point's residual).  Returns
    (lam_new, take, res_kept) with take (K,) bool: which envs changed, and
    res_kept (K,): the residual of the point kept (`worst` where none was
    taken).  The residuals sum in the kernels' order (it is the plain
    version of the escalation kernel's fused and hybrid modes)."""
    A, b, lo, hi, mu, act = prob

    def resid(lam):
        return comp_residual(A, b, lam, lo, hi, findex, mu, act, seq=True)

    def take_where(take_new, lam_c, res_c, lam_new, res_kept):
        return (torch.where(take_new[:, None], lam_c, lam_new),
                torch.where(take_new, res_c, res_kept))

    lam_ex = exact1(*prob, lamk)
    res_ex = resid(lam_ex)
    take = (worst > tol) & (res_ex < worst)
    lam_new, res_kept = take_where(take, lam_ex, res_ex, lamk, worst)
    if exact2 is not None:
        lam_c2 = exact2(*prob, torch.zeros_like(lamk))
        res_c2 = resid(lam_c2)
        take2 = (res_kept > tol) & (res_c2 < res_kept)
        lam_new, res_kept = take_where(take2, lam_c2, res_c2, lam_new,
                                       res_kept)
        take = take | take2
    if ref64_passes > 0 or ref_passes > 0:
        refine, passes = ((refine_mixed, ref64_passes) if ref64_passes > 0
                          else (refine_compensated, ref_passes))
        lam_r = refine(A, b, lo, hi, findex, mu, act, lam_new, passes=passes)
        res_r = resid(lam_r)
        take_r = (res_kept > tol) & (res_r < res_kept)
        lam_new, res_kept = take_where(take_r, lam_r, res_r, lam_new,
                                       res_kept)
        take = take | take_r
    return lam_new, take, res_kept


def escalate_rows(A, b, lo, hi, mu, active, lam, idx, worst, findex, tol,
                  exact1, exact2=None, ref_passes: int = 0,
                  ref64_passes: int = 0):
    """The plain version of the escalation kernel's hybrid mode: ONE
    packed gather of rows idx, `keep_best` (with its refinement tier), and
    the rows written back into a copy of
    lam (envs outside idx keep their impulses bit for bit).  Returns (lam,
    take, res_kept)."""
    m = b.shape[1]
    # the six (B, m) operands gathered as one packed buffer
    pk = torch.cat([b, lo, hi, mu, active, lam], dim=1)[idx]
    bk, lok, hik, muk, actk, lamk = pk.split(m, dim=1)
    prob = (A[idx], bk, lok, hik, muk, actk)
    lam_new, take, res_kept = keep_best(prob, findex, worst, lamk, tol,
                                        exact1, exact2, ref_passes,
                                        ref64_passes)
    return lam.index_copy(0, idx, lam_new), take, res_kept


def make_hybrid_solver(findex, iters: int, omega: float = 1.0,
                       escalate_frac: float = 0.0,
                       escalate_tol: float = 1e-6,
                       escalate_iters: int = 8,
                       escalate_kmax: int = 128,
                       escalate_iters2: int = 0,
                       escalate_refine: int = -1,
                       escalate_ref64: int = 0,
                       escalate_ref: int = 0):
    """Batched boxed-LCP solver: solve(A, b, lo, hi, mu, active, lam0) ->
    lam (B, m), PGS with exact re-solve of the worst envs when
    escalate_frac > 0 (plain PGS otherwise), and a refinement tier on the
    re-solved envs: escalate_ref64 passes of the mixed-precision one, else
    escalate_ref passes of the compensated one, all as plain tensor code.
    The mixed-precision tier always runs when it is asked for."""
    from benchmark.reference import bpp
    from benchmark.reference.pgs_batch import pgs_solve_batch

    findex = np.asarray(findex)
    budgets = bpp.tier_budgets(escalate_iters, escalate_refine,
                               escalate_iters2, escalate_ref, escalate_ref64)
    exact1, exact2 = bpp.tier_solvers(findex, budgets)

    def solve(A, b, lo, hi, mu, active, lam0):
        B, m = b.shape
        esc = escalate_frac > 0.0 and m > 0
        if not esc:
            return pgs_solve_batch(A, b, lo, hi, findex, mu, active,
                                   iters=iters, omega=omega, lam0=lam0)
        lam, res = pgs_solve_batch(A, b, lo, hi, findex, mu, active,
                                   iters=iters, omega=omega, lam0=lam0,
                                   return_residual=True)
        K = escalation_size(B, escalate_frac, escalate_kmax)
        worst, idx = torch.topk(res, K)
        return escalate_rows(A, b, lo, hi, mu, active, lam, idx, worst,
                             findex, escalate_tol, exact1, exact2,
                             *budgets[6:8])[0]

    return solve
