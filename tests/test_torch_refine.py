"""PyTorch port, the escalation's compensated (double-float) refinement
tier against the JAX package:
  (a) lcp/dantzig.comp_residual_ff and refine_compensated on seeded boxed
      LCPs of 41 rows (humanwalker's compacted size) with friction
      coupling: the compensated residual equal to the bit in float32 and
      float64; the refined point within 1e-5 of max(1, |x|) in float32
      (XLA and PyTorch sum the inverse's products in other orders; the
      operators have condition numbers near 3e4) and 1e-12 in float64.
      One refinement pass: the JAX function traces its 41-row inverse once
      per pass (about 9 s of the CPU's time each).
  (b) engine/hopper_substep.escalate_reference with the refinement tier
      against the JAX escalate_batch(..., refc_passes=...) on the same
      substep outputs of humanwalker (m_c = 41, n = 29), float64: the
      tier's place after the exact tiers, its keep-best and the patches,
      dq_plus and lam_full within 1e-8.  One pass (escalate_ref = 1): JAX
      traces and compiles escalate_batch in 12 s on the CPU with one pass
      and in 25 s with humanwalker's two; the two-pass tier is held against
      the port's plain version by tests/test_torch_kernels3d.py.  The exact
      tier of both is the same cheap stand-in (a projected Jacobi step,
      written in each framework) for the same reason; the exact tiers
      themselves are held by tests/test_torch_escalation.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.engine import pallas_substep as jps
from dartenv_tpu.envs.base import with_solver as jax_with_solver
from dartenv_tpu.lcp import dantzig as jd
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.lcp import dantzig as td
from dartenv_tpu_torch.lcp.hopper_bpp import bpp_solve_reference
from test_refine_mixed import _make_lcp
from torch_port_util import N, T, port_model


def _problems(npdt, K=6, m=41, seed=11):
    """K seeded LCPs of m rows (12 contacts with friction, 5 unilateral
    rows) and a point to refine: the float64 pivoting solution, rounded
    to npdt and moved by a relative 1e-4, so its sets are (mostly) the
    solution's and a pass has something to recover."""
    rng = np.random.default_rng(seed)
    probs = [_make_lcp(rng, m=m, n_con=12) for _ in range(K)]
    findex = probs[0][4]
    A, b, lo, hi, mu, act = (np.stack([p[i] for p in probs])
                             for i in (0, 1, 2, 3, 5, 6))
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)
    x64 = bpp_solve_reference(t(A), t(b), t(lo), t(hi), findex, t(mu),
                              t(act), iters=30, polish_iters=0).numpy()
    x0 = x64 * (1.0 + 1e-4 * rng.standard_normal(x64.shape))
    cast = lambda x: x.astype(npdt)
    return tuple(map(cast, (A, b, lo, hi, mu, act))), findex, cast(x0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_refine_functions_match_jax(dtype):
    npdt = np.dtype(dtype).type
    (A, b, lo, hi, mu, act), findex, x0 = _problems(npdt)
    t = lambda x: torch.as_tensor(x)
    j = lambda x: jnp.asarray(x)
    r_t = td.comp_residual_ff(t(A), t(b), t(x0), t(lo), t(hi), findex,
                              t(mu), t(act))

    def jax_side(A_, b_, lo_, hi_, mu_, act_, x_):
        return (jd.comp_residual_ff(A_, b_, x_, lo_, hi_, findex, mu_,
                                    act_),
                jd.refine_compensated(A_, b_, lo_, hi_, findex, mu_, act_,
                                      x_, passes=1))

    r_j, x_j = jax.jit(jax_side)(j(A), j(b), j(lo), j(hi), j(mu), j(act),
                                 j(x0))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    x_t = td.refine_compensated(t(A), t(b), t(lo), t(hi), findex, t(mu),
                                t(act), t(x0), passes=1)
    x_j = np.asarray(x_j)
    tol = 1e-5 if npdt == np.float32 else 1e-12
    err = (np.abs(x_t.numpy() - x_j).max(1)
           / np.maximum(1.0, np.abs(x_j).max(1)))
    assert err.max() <= tol, err
    # the pass moved the points (the case is not vacuous) and kept the
    # better one by the compensated residual
    r_new = td.comp_residual_ff(t(A), t(b), x_t, t(lo), t(hi), findex,
                                t(mu), t(act))
    assert bool((r_new <= r_t).all()) and bool((r_new < r_t).any())


def _jacobi(xp, A, b, lo, hi, act, lam0):
    """A projected Jacobi step from lam0: the stand-in exact tier."""
    d = xp.diagonal(A, axis1=-2, axis2=-1) if xp is jnp else \
        torch.diagonal(A, dim1=-2, dim2=-1)
    w = (A * lam0[..., None, :]).sum(-1) + b
    x = lam0 - w / d
    return xp.minimum(xp.maximum(x, lo), hi) * act


def test_escalate_reference_refinement_tier_matches_jax():
    jm = jax_with_solver(
        jax_make_task("humanwalker", dtype=jnp.float64).model, None,
        escalate_frac=1.0 / 4, escalate_tol=1e-7, pgs_iters=3,
        escalate_ref=1)
    tm = port_model(jm)
    jst, tst = jps._SubStatic(jm), ths._SubStatic(tm)
    assert (jst.m_c, jm.n) == (41, 29)
    cfg = jm.solver
    B, n, m = 8, jm.n, jst.layout.m
    rng = np.random.default_rng(5)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    q[:, 4] -= rng.uniform(0.0, 0.1, B)     # feet pressed into the ground
    dq = rng.uniform(-1.0, 1.0, (B, n))
    tau = np.concatenate([np.zeros((B, 6)),
                          rng.uniform(-50, 50, (B, n - 6))], axis=1)
    outs = ths.substep_reference(tm, tst, T(q), T(dq), T(tau),
                                 torch.zeros((B, m), dtype=torch.float64))
    jouts = {k: jnp.asarray(N(outs[k])) for k in ("res", "esc")}
    dqp0, lamf0 = outs["dq_plus"], outs["lam_full"]

    def jex(A, b, lo, hi, mu, act, lam0):
        return _jacobi(jnp, A, b, lo, hi, act, lam0)

    def tex(A, b, lo, hi, mu, act, lam0):
        return _jacobi(torch, A, b, lo, hi, act, lam0)

    jdqp, jlamf = jax.jit(lambda o, d, l: jps.escalate_batch(
        jst, cfg, o, d, l, jex, None, jnp.float64,
        refc_passes=cfg.escalate_ref))(
        jouts, jnp.asarray(N(dqp0)), jnp.asarray(N(lamf0)))
    dqp, lamf, idx, take, res_kept = ths.escalate_reference(
        tst, tm.solver, outs, dqp0, lamf0, tex)
    np.testing.assert_allclose(N(dqp), np.asarray(jdqp), rtol=0, atol=1e-8)
    np.testing.assert_allclose(N(lamf), np.asarray(jlamf), rtol=0,
                               atol=1e-8)
    # the refinement tier took some envs, and only escalated envs changed
    assert int(take.sum()) > 0
    changed = (dqp != dqp0).any(dim=1)
    assert set(torch.nonzero(changed)[:, 0].tolist()) <= set(idx.tolist())
    # escalate_batch runs the same sequence (no kernel on a CPU batch)
    got = ths.escalate_batch(tst, tm.solver, outs, dqp0, lamf0, tex)
    assert torch.equal(got[0], dqp) and torch.equal(got[1], lamf)
