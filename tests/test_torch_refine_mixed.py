"""PyTorch port, the mixed-precision refinement tier (escalate_ref64):
  (a) lcp/dantzig.refine_mixed against the JAX package's under x64 on the
      JAX tests' ill-conditioned boxed LCPs: float64 inputs within 1e-12,
      float32 inputs (float64 residuals) within 1e-6 of max(1, |x|);
  (b) make_hybrid_solver(escalate_ref64=2) against the JAX
      make_hybrid_solver(escalate_ref64=2) under x64, float64, within 1e-9
      (as the compensated tier's test), and the precedence of the two
      tiers;
  (c) the escalation kernel's ES_REF64 build, compiled with the host C++
      compiler and run as one lane: its refinement (es_refine64) against
      refine_mixed (to the bit on humanwalker's escalated LCPs, m = 41;
      within 1e-6 on the cond-3e4 LCPs), its hybrid mode against
      keep_best(ref64_passes=2) to the bit on humanwalker's, and its fused
      mode's per-env arithmetic against escalate_reference on the
      humanwalker digest with escalate_ref64 = 2.
The reference's tier is inert unless JAX's float64 switch is on (the
suite turns it on); the port's always runs when asked for."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.lcp.dantzig import refine_mixed as jax_refine_mixed
from dartenv_tpu.lcp.hybrid import make_hybrid_solver as jax_hybrid
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.lcp.dantzig import dantzig_solve, refine_mixed
from dartenv_tpu_torch.lcp.hybrid import (
    comp_residual, keep_best, make_hybrid_solver,
)
from test_refine_mixed import _make_lcp
from test_torch_hybrid_refine import SOLVER, _lcps
from test_torch_kernels3d import _escalated_lcps, _states
from torch_port_util import N, T, rel_err


def _rough_points(seed, K=6, m=20):
    """K of the JAX tests' LCPs and a rough point of each (a short
    block-pivoting solve), numpy float64."""
    rng = np.random.default_rng(seed)
    probs = [_make_lcp(rng, m=m, cond=3e4, n_con=4) for _ in range(K)]
    A, b, lo, hi, mu, act = (np.stack([p[i] for p in probs])
                             for i in (0, 1, 2, 3, 5, 6))
    findex = probs[0][4]
    x = dantzig_solve(*map(T, (A, b, lo, hi)), findex, T(mu), T(act),
                      iters=3, polish_iters=0, refine_iters=0)
    return (A, b, lo, hi, mu, act), findex, N(x)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_refine_mixed_matches_jax(dtype):
    (A, b, lo, hi, mu, act), findex, x = _rough_points(0)
    c = lambda v: np.asarray(v, dtype)
    args = [c(v) for v in (A, b, lo, hi)]
    vecs = [c(mu), c(act), c(x)]
    ref = np.asarray(jax.vmap(lambda A_, b_, l_, h_, m_, a_, x_:
                              jax_refine_mixed(A_, b_, l_, h_, findex, m_,
                                               a_, x_, passes=2))(
        *map(jnp.asarray, args + vecs)))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    got = refine_mixed(*[T(v, tdt) for v in args], findex,
                       *[T(v, tdt) for v in vecs], passes=2)
    assert got.dtype == tdt
    tol = 1e-12 if dtype == np.float64 else 1e-6
    assert rel_err(got, ref) <= tol, rel_err(got, ref)
    # never worse than the input, better on some (float64 residuals of
    # the problem as the tier saw it)
    d64 = lambda v: T(np.asarray(v, np.float64))
    r = lambda v: comp_residual(d64(args[0]), d64(args[1]), d64(N(v)),
                                d64(args[2]), d64(args[3]), findex,
                                d64(vecs[0]), d64(vecs[1]))
    assert bool((r(got) <= r(vecs[2]) + 1e-12).all())
    assert bool((r(got) < r(vecs[2])).any())


def test_hybrid_ref64_tier_matches_jax_f64():
    (A, b, lo, hi, mu, act), findex = _lcps()
    lam0 = np.zeros_like(b)
    j = lambda x: jnp.asarray(x, jnp.float64)
    jsolve = jax.jit(jax.vmap(jax_hybrid(findex, escalate_ref64=2,
                                         **SOLVER)))
    lam_j = np.asarray(jsolve(*map(j, (A, b, lo, hi, mu, act, lam0))))
    args = tuple(map(T, (A, b, lo, hi, mu, act, lam0)))
    lam_t = make_hybrid_solver(findex, escalate_ref64=2, **SOLVER)(*args)
    np.testing.assert_allclose(N(lam_t), lam_j, rtol=0, atol=1e-9)
    lam_0 = make_hybrid_solver(findex, **SOLVER)(*args)
    assert bool((lam_t != lam_0).any(1).any())          # the tier took
    # ref64 wins over escalate_ref, in the tier tuple too
    both = make_hybrid_solver(findex, escalate_ref=2, escalate_ref64=2,
                              **SOLVER)(*args)
    assert torch.equal(both, lam_t)
    assert hopper_bpp.tier_budgets(4, 2, 0, 2, 2)[6:8] == (0, 2)
    assert hopper_bpp.header(41, 2, 2) == ("#define ES_M 41\n"
                                           "#define ES_REF64 2\n")


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")


@pytest.mark.parametrize("case", ["random_m20", "humanwalker_m41"])
def test_refine64_host_build_equals_plain(case):
    _need_gxx()
    if case == "humanwalker_m41":
        cfg, findex, g = _escalated_lcps("humanwalker", 64, 3)
        prob = tuple(g[k] for k in ("A", "b", "lo", "hi", "mu", "act"))
        x = g["lam_c"]
    else:
        p, findex, x = _rough_points(1, K=8)
        prob = tuple(T(v, torch.float32) for v in p)
        x = T(x, torch.float32)
    got, r_in, r_out = hopper_bpp.refine64_host(*prob[:4], findex,
                                                *prob[4:], x, 2)
    ref = refine_mixed(*prob[:4], findex, *prob[4:], x, passes=2)
    r64 = lambda v: comp_residual(*[t.double() for t in prob[:2]],
                                  v.double(), *[t.double() for t in
                                                prob[2:4]], findex,
                                  *[t.double() for t in prob[4:]], seq=True)
    assert torch.equal(r_in, r64(x))
    if case == "humanwalker_m41":
        # the escalation's own problems: equal to the bit
        assert torch.equal(got, ref) and torch.equal(r_out, r64(ref))
    else:
        # cond 3e4 at m = 20: the g++ build's float32 correction solve
        # may round one entry of one problem another way than PyTorch's
        # CPU kernels (one ulp, after which the float64 iterates part)
        assert rel_err(got, ref) <= 1e-6, rel_err(got, ref)
        assert rel_err(r_out, r64(ref)) <= 1e-6
    assert bool((r_out <= r_in).all()) and bool((r_out < r_in).any())


def test_hybrid_mode_ref64_host_build_equals_plain_to_the_bit():
    _need_gxx()
    cfg, findex, g = _escalated_lcps("humanwalker", 128, 4)
    budgets = hopper_bpp.tier_budgets(cfg.escalate_iters,
                                      cfg.escalate_refine,
                                      cfg.escalate_iters2, 0, 2)
    assert budgets[6:8] == (0, 2)
    prob = tuple(g[k] for k in ("A", "b", "lo", "hi", "mu", "act"))
    worst = comp_residual(*prob[:2], g["lam_c"], *prob[2:4], findex,
                          *prob[4:], seq=True)
    exact1, exact2 = hopper_bpp.tier_solvers(findex, budgets)
    ref = keep_best(prob, findex, worst, g["lam_c"], cfg.escalate_tol,
                    exact1, exact2, *budgets[6:8])
    got = hopper_bpp.hybrid_host(*prob[:4], findex, *prob[4:], g["lam_c"],
                                 worst, cfg.escalate_tol, budgets)
    for name, a, r in zip(("lam", "take", "res"), got, ref):
        assert torch.equal(a, r), name
    no_ref = keep_best(prob, findex, worst, g["lam_c"], cfg.escalate_tol,
                       exact1, exact2)
    assert bool((ref[0] != no_ref[0]).any())      # the f64 tier took


def test_fused_mode_ref64_host_build_matches_plain():
    """The humanwalker digest with escalate_ref64 = 2 (and its
    escalate_ref 2, which the float64 tier overrides): the fused mode's
    per-env arithmetic (rebuild, keep-best, es_refine64, patches) against
    escalate_reference, at the bounds of the compensated tier's test."""
    _need_gxx()
    model, st, ins = _states("humanwalker", 64, 3)
    model = model.replace(solver=dataclasses.replace(model.solver,
                                                     escalate_ref64=2))
    st = ths._SubStatic(model)
    assert st.ref_passes == (0, 2)
    assert "#define ES_REF64 2" in st.escalation_header
    assert "#define ES_REFC 0" in st.escalation_header
    assert st.escalation_dims[4:] == (0, 2)
    outs = ths.substep_reference(model, st, *ins)
    cfg = model.solver
    exact1, exact2 = hopper_bpp.tier_solvers(
        st.findex_c, hopper_bpp.tier_budgets(
            cfg.escalate_iters, cfg.escalate_refine, cfg.escalate_iters2,
            *st.ref_passes))
    g = ths.gather_escalation(st, cfg, outs)
    prob = (g["A"], g["b"], g["lo"], g["hi"], g["mu"], g["act"])
    lam1 = exact1(*prob, g["lam_c"])
    dqp, lamf, idx, take, res_kept = ths.escalate_reference(
        st, cfg, outs, outs["dq_plus"], outs["lam_full"], exact1)
    host = hopper_bpp.fused_host(
        st.escalation_header, st.escalation_dims, st.findex_c,
        outs["esc"][idx], outs["dq_plus"][idx], outs["lam_full"][idx],
        g["worst"], lam1, None, cfg.escalate_tol)
    assert torch.equal(host["take"], take)
    assert bool(take.any())
    assert float((host["res"][:, 2] - res_kept).abs().max()) <= 1e-5
    assert rel_err(host["dq_plus"], dqp[idx]) <= 1e-5
    assert rel_err(host["lam_full"], lamf[idx]) <= 1e-2
