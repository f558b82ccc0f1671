"""PyTorch port, the phase-wise hybrid solver's compensated refinement
tier (escalate_ref > 0, which DartHumanWalker sets):
  (a) lcp/hybrid.make_hybrid_solver(escalate_ref=2) against the JAX
      make_hybrid_solver on the same seeded boxed LCPs, float64, CPU:
      impulses within 1e-9, the refinement tier having changed the point
      of some escalated envs; escalate_ref64 wins where both are set;
  (b) the hybrid mode of the BPP kernel above 32 rows with ES_REFC = 2
      (csrc/bpp_body.h bp_tiers, then csrc/escalate_body.h
      es_refine_tier), built with the host C++ compiler and run as one
      lane, against its plain version (lcp/hybrid.keep_best with two
      refinement passes) on humanwalker's escalated LCPs (m = 41): the
      kept points, take flags and kept residuals equal to the bit, as
      tests/test_torch_sum_order.py holds the core mode."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.lcp.hybrid import make_hybrid_solver as jax_hybrid
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.lcp import hopper_pgs
from dartenv_tpu_torch.lcp.hybrid import (
    comp_residual, escalate_rows, keep_best, make_hybrid_solver,
)
from test_refine_mixed import _make_lcp
from test_torch_kernels3d import _escalated_lcps
from torch_port_util import N, T

# few PGS sweeps and pivots, so that the escalated envs' exact points are
# rough and the refinement passes have something to recover
SOLVER = dict(iters=3, escalate_frac=0.25, escalate_tol=1e-12,
              escalate_iters=2, escalate_refine=1)


def _lcps(B=8, m=11, seed=3):
    rng = np.random.default_rng(seed)
    probs = [_make_lcp(rng, m=m, cond=1e3, n_con=3) for _ in range(B)]
    A, b, lo, hi, mu, act = (np.stack([p[i] for p in probs])
                             for i in (0, 1, 2, 3, 5, 6))
    return (A, b, lo, hi, mu, act), probs[0][4]


def test_hybrid_refinement_tier_matches_jax_f64():
    (A, b, lo, hi, mu, act), findex = _lcps()
    B = b.shape[0]
    lam0 = np.zeros_like(b)
    j = lambda x: jnp.asarray(x, jnp.float64)
    jsolve = jax.jit(jax.vmap(jax_hybrid(findex, escalate_ref=2,
                                         **SOLVER)))
    lam_j = np.asarray(jsolve(*map(j, (A, b, lo, hi, mu, act, lam0))))
    args = tuple(map(T, (A, b, lo, hi, mu, act, lam0)))
    plain = hopper_pgs.PLAIN_CALLS
    lam_t = make_hybrid_solver(findex, escalate_ref=2, **SOLVER)(*args)
    assert hopper_pgs.PLAIN_CALLS == plain + 1
    np.testing.assert_allclose(N(lam_t), lam_j, rtol=0, atol=1e-9)
    # the tier moved the kept point of some escalated env
    lam_0 = make_hybrid_solver(findex, escalate_ref=0, **SOLVER)(*args)
    moved = (lam_t != lam_0).any(1)
    assert 0 < int(moved.sum()) <= B // 4
    res = lambda x: comp_residual(*args[:2], x, *args[2:4], findex,
                                  *args[4:6])
    assert bool((res(lam_t)[moved] < res(lam_0)[moved]).all())
    # escalate_ref64 (tests/test_torch_refine_mixed.py) wins over it
    lam_64 = make_hybrid_solver(findex, escalate_ref=2, escalate_ref64=1,
                                **SOLVER)(*args)
    assert torch.equal(lam_64, make_hybrid_solver(
        findex, escalate_ref64=1, **SOLVER)(*args))


def test_hybrid_mode_host_build_with_refinement_equals_plain_to_the_bit():
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    cfg, findex, g = _escalated_lcps("humanwalker", 128, 4)
    budgets = hopper_bpp.tier_budgets(cfg.escalate_iters,
                                      cfg.escalate_refine,
                                      cfg.escalate_iters2, cfg.escalate_ref)
    assert budgets[6] == 2 and g["b"].shape == (16, 41)
    prob = tuple(g[k] for k in ("A", "b", "lo", "hi", "mu", "act"))
    worst = comp_residual(*prob[:2], g["lam_c"], *prob[2:4], findex,
                          *prob[4:], seq=True)
    exact1, exact2 = hopper_bpp.tier_solvers(findex, budgets)
    ref = keep_best(prob, findex, worst, g["lam_c"], cfg.escalate_tol,
                    exact1, exact2, budgets[6])
    got = hopper_bpp.hybrid_host(*prob[:4], findex, *prob[4:], g["lam_c"],
                                 worst, cfg.escalate_tol, budgets)
    for name, a, r in zip(("lam", "take", "res"), got, ref):
        assert torch.equal(a, r), name
    # the refinement tier took on some envs, and escalate_rows (the
    # hybrid mode's plain version over a batch) keeps those points
    no_ref = keep_best(prob, findex, worst, g["lam_c"], cfg.escalate_tol,
                       exact1, exact2, 0)
    assert bool((ref[0] != no_ref[0]).any())
    idx = torch.arange(16)
    rows = escalate_rows(*prob, g["lam_c"], idx, worst, findex,
                         cfg.escalate_tol, exact1, exact2, budgets[6])
    assert torch.equal(rows[0], ref[0])
