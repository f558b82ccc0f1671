"""PyTorch port, the kernels' arithmetic on the 3D models, built with the
host C++ compiler (g++) and run as one lane per env, against the plain
PyTorch versions, float32:
  (a) kernel 1 (csrc/substep_body.h) on walker3d (n 18, m_c 36) and
      humanwalker (n 29, m_c 41) states: discrete and copied blocks equal
      to the plain version's; computed blocks within 1e-4 of the plain
      version evaluated in float64 on the same float32 inputs (the float32
      plain version inverts M with a relative 1e-6 diagonal jitter that
      the kernel's Cholesky, like the JAX kernel's, does not add: it moves
      walker3d's dq_plus by 2e-3 and humanwalker's by 7e-4), and within
      2e-2 of the float32 plain version (tests/test_pallas_substep.py's
      bound for the n = 29 gap between the two factorizations); reacher
      (no contact slots, limit rows only) within 1e-4 of the float32 plain
      version;
  (b) kernel 2's fused mode outside the solves (csrc/escalate_body.h) at
      walker3d, where the operator is rebuilt through the recursive
      inverse for n > 12 as the plain version does (a Cholesky rebuild
      misses A by 8e-4 here), and at humanwalker with its two compensated
      refinement passes;
  (c) the core mode's solve above 32 rows (csrc/bpp_body.h) at m = 36
      (walker3d's LCPs) and m = 64, and the refinement tier's arithmetic
      on humanwalker's LCPs."""
import shutil

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.lcp.dantzig import comp_residual_ff, refine_compensated
from dartenv_tpu_torch.lcp.hybrid import comp_residual, escalation_size
from test_refine_mixed import _make_lcp
from torch_port_util import rel_err

DISCRETE = ("con_active", "act", "sel_slots", "overflow", "lo", "hi", "mu")


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")


def _states(name, B, seed):
    """Seeded float32 states of a task: the initial pose moved a little,
    the walkers' roots lowered into the ground, random joint torques and
    warm starts; the reacher's joints pushed past their limits."""
    task = make_task(name, device="cpu")
    model = task.model
    st = ths._SubStatic(model)
    rng = np.random.default_rng(seed)
    q = model.q_init.numpy()[None] + rng.uniform(-0.05, 0.05, (B, model.n))
    if name == "reacher":
        lim = model.host("limited") > 0
        up = model.host("q_upper")
        q[:, lim] = up[lim] + rng.uniform(-0.05, 0.1, (B, int(lim.sum())))
    else:
        q[:, 4] -= rng.uniform(0.0, 0.1, B)
    dq = rng.uniform(-1.0, 1.0, (B, model.n))
    a = rng.uniform(-1.0, 1.0, (B, task.action_size))
    tau = task.action_to_tau(torch.as_tensor(a, dtype=torch.float32),
                             ()).numpy()
    lam = rng.uniform(0.0, 0.5, (B, st.layout.m))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return model, st, (f(q), f(dq), f(tau), f(lam))


@pytest.mark.parametrize("name", ["reacher", "walker3d", "humanwalker"])
def test_substep_host_build_matches_plain(name):
    model, st, ins = _states(name, 32, 1)
    got = ths.SubstepKernel(model, st).run_host(*ins)
    ref = ths.substep_reference(model, st, *ins)
    m64 = make_task(name, device="cpu", dtype=torch.float64).model
    ref64 = ths.substep_reference(m64, ths._SubStatic(m64),
                                  *[x.double() for x in ins])
    g, r, r64 = (ths.output_blocks(st, o) for o in (got, ref, ref64))
    for f in DISCRETE:
        assert torch.equal(g[f], r[f]), f
    assert float(r["act"].sum()) > 32, "constraint rows are not live"
    if name == "reacher":
        assert st.ns == 0 and st.cap == 0
    else:
        assert float(r["con_active"].sum()) > 32, "contacts are not live"
    for f in g:
        if f in DISCRETE or g[f].numel() == 0:
            continue
        if name == "reacher":
            assert rel_err(g[f], r[f]) <= 1e-4, (f, rel_err(g[f], r[f]))
            continue
        # envs whose float64 contact selection is the float32 one
        same = torch.ones(32, dtype=torch.bool)
        for d in ("con_active", "act", "sel_slots"):
            same &= (r64[d] == r[d].double()).all(1)
        assert int(same.sum()) >= 24
        assert rel_err(g[f][same], r64[f][same]) <= 1e-4, (
            f, rel_err(g[f][same], r64[f][same]))
        assert rel_err(g[f], r[f]) <= 2e-2, (f, rel_err(g[f], r[f]))


@pytest.mark.parametrize("name", ["walker3d", "humanwalker"])
def test_fused_mode_host_build_matches_plain(name):
    """The rebuild above n = 12, the keep-best, the refinement tier
    (humanwalker) and the patches against escalate_reference, with the
    plain tier-1 solver's impulses handed in.  Operator, M^-1 Jc^T, tier
    residual and dq_plus within 1e-5 of max(1, |plain|), take flags equal;
    kept residuals and lam_full within 1e-6 of each other and 1e-5 of
    max(1, |plain|) at walker3d; at humanwalker, whose 41 rows hold
    redundant foot contacts, the refined points may part along the
    operator's near-null directions, which leave dq_plus unmoved: there
    lam_full within 1e-2 and the kept residuals within 1e-5 of each other
    (the escalation's tolerance)."""
    model, st, ins = _states(name, 64, 3)
    outs = ths.substep_reference(model, st, *ins)
    cfg = model.solver
    assert escalation_size(64, cfg.escalate_frac, cfg.escalate_kmax) in (2,
                                                                         8)
    exact1, exact2 = hopper_bpp.tier_solvers(
        st.findex_c, hopper_bpp.tier_budgets(
            cfg.escalate_iters, cfg.escalate_refine, cfg.escalate_iters2,
            cfg.escalate_ref))
    assert exact2 is None
    g = ths.gather_escalation(st, cfg, outs)
    prob = (g["A"], g["b"], g["lo"], g["hi"], g["mu"], g["act"])
    lam1 = exact1(*prob, g["lam_c"])
    dqp, lamf, idx, take, res_kept = ths.escalate_reference(
        st, cfg, outs, outs["dq_plus"], outs["lam_full"], exact1)
    host = hopper_bpp.fused_host(
        st.escalation_header, st.escalation_dims, st.findex_c,
        outs["esc"][idx], outs["dq_plus"][idx], outs["lam_full"][idx],
        g["worst"], lam1, None, cfg.escalate_tol)
    resid = lambda lam: comp_residual(*prob[:2], lam, g["lo"], g["hi"],
                                      st.findex_c, g["mu"], g["act"])
    for k, (a, r) in {"A": (host["A"], g["A"]),
                      "MinvJt": (host["MinvJt"], g["MinvJt"]),
                      "res_tier1": (host["res"][:, 0], resid(lam1)),
                      "dq_plus": (host["dq_plus"], dqp[idx])}.items():
        assert rel_err(a, r) <= 1e-5, (k, rel_err(a, r))
    assert torch.equal(host["take"], take)
    assert bool(take.any()), "no escalated env changed: the case is vacuous"
    res_tol = 1e-5 if cfg.escalate_ref else 1e-6
    assert float((host["res"][:, 2] - res_kept).abs().max()) <= res_tol
    lam_tol = 1e-2 if cfg.escalate_ref else 1e-5
    assert rel_err(host["lam_full"], lamf[idx]) <= lam_tol
    if cfg.escalate_ref:
        # the refinement tier lowered the kept residual below tier 1's
        assert bool((host["res"][:, 2] < host["res"][:, 0]).any())
        assert bool((res_kept < resid(lam1)).any())


def _escalated_lcps(name, B, seed):
    model, st, ins = _states(name, B, seed)
    outs = ths.substep_reference(model, st, *ins)
    g = ths.gather_escalation(st, model.solver, outs)
    return model.solver, st.findex_c, g


def _random_lcps(K, m, seed):
    """K seeded well-conditioned (condition number 10) boxed LCPs of m
    rows with friction coupling, cold started."""
    rng = np.random.default_rng(seed)
    probs = [_make_lcp(rng, m=m, n_con=m // 4, cond=10.0) for _ in range(K)]
    f = lambda i: torch.as_tensor(np.stack([p[i] for p in probs]),
                                  dtype=torch.float32)
    g = dict(A=f(0), b=f(1), lo=f(2), hi=f(3), mu=f(5), act=f(6),
             lam_c=torch.zeros((K, m)))
    return probs[0][4], g


@pytest.mark.parametrize("case", ["random_m36", "random_m64",
                                  "walker3d_m36"])
def test_core_mode_above_32_rows_host_build_matches_plain(case):
    """The solve with the lanes over rows against bpp_solve_reference.
    On well-conditioned LCPs of 36 and 64 rows, env by env as
    chip_smoke.py's bpp phase holds the kernel: impulses within 1e-5 of
    max(1, |plain|) on all but one in eight envs (in float32 a pivot's
    re-open test compares rounding noise with 1e-10, the host build's
    matvecs sum in column order and PyTorch's CPU sums in vector lanes,
    and one flipped row sends a solve down another branch), and as many
    envs solved below 1e-4 as the plain version, less those.  On the 16
    worst LCPs of a walker3d batch (m = 36, the shipped 8 + 2 pivots,
    which leave half of them unsolved in either version, each a chain
    that parts on rounding) the host build must solve below 1e-4 as many
    as the plain version less a quarter of them."""
    if case == "walker3d_m36":
        cfg, findex, g = _escalated_lcps("walker3d", 512, 4)
        iters, refine, polish = cfg.escalate_iters, cfg.escalate_refine, 3
    else:
        findex, g = _random_lcps(16, int(case[-2:]), 6)
        iters, refine, polish = 16, 6, 3
    K, m = g["b"].shape
    assert m == int(case[-2:]) and K == 16
    args = (g["A"], g["b"], g["lo"], g["hi"], findex, g["mu"], g["act"])
    kw = dict(iters=iters, polish_iters=polish, lam0=g["lam_c"],
              refine_iters=refine)
    got = hopper_bpp.core_host(*args, **kw)
    ref = hopper_bpp.bpp_solve_reference(*args, **kw)
    assert torch.isfinite(got).all()
    resid = lambda lam: comp_residual(g["A"], g["b"], lam, g["lo"], g["hi"],
                                      findex, g["mu"], g["act"])
    solved = lambda lam: int((resid(lam) < 1e-4).sum())
    if case == "walker3d_m36":
        assert solved(got) >= solved(ref) - K // 4
        assert solved(ref) >= K // 4
        return
    env_err = ((got - ref).abs().max(1).values
               / ref.abs().max(1).values.clamp(min=1.0))
    same = env_err <= 1e-5
    assert int(same.sum()) >= K - K // 8, env_err
    assert solved(got) >= solved(ref) - int((~same).sum())
    assert solved(ref) >= K - K // 8


@pytest.mark.parametrize("case", ["humanwalker_m41", "random_m10"])
def test_refinement_tier_host_build_matches_plain(case):
    """es_refine / es_residual_ff against refine_compensated /
    comp_residual_ff, two passes from the plain tier-1 points, the same
    float32 inputs: on humanwalker's escalated LCPs (m = 41: the inverse
    of linalg_body.h) and on well-conditioned random LCPs of 10 rows (its
    Cholesky branch, as solve_psd's for m <= 12).  The compensated
    residual equal to the bit; the refined points' compensated residuals
    within 1e-7 of each other and the points within 1e-2 of max(1,
    |plain|): the 41-row inverse sums in another order than PyTorch's, and
    humanwalker's redundant contact rows let points of equal residual part
    along the operator's near-null directions."""
    if case == "humanwalker_m41":
        cfg, findex, g = _escalated_lcps("humanwalker", 64, 3)
        iters, refine = cfg.escalate_iters, cfg.escalate_refine
    else:
        findex, g = _random_lcps(16, 10, 8)
        iters, refine = 2, 0
    exact1, _ = hopper_bpp.tier_solvers(findex, hopper_bpp.tier_budgets(
        iters, refine, 0))
    prob = (g["A"], g["b"], g["lo"], g["hi"])
    vecs = (g["mu"], g["act"])
    lam1 = exact1(*prob, *vecs, g["lam_c"])
    x, r_in, r_out = hopper_bpp.refine_host(*prob, findex, *vecs, lam1, 2)
    ref = refine_compensated(*prob, findex, *vecs, lam1, passes=2)
    ff = lambda lam: comp_residual_ff(g["A"], g["b"], lam, g["lo"], g["hi"],
                                      findex, *vecs)
    assert torch.equal(r_in, ff(lam1))
    assert rel_err(x, ref) <= 1e-2, rel_err(x, ref)
    assert float((r_out - ff(ref)).abs().max()) <= 1e-7
    # keep-best: never worse, and better on some
    assert bool((r_out <= r_in).all()) and bool((r_out < r_in).any())
