"""PyTorch port, the PGS kernel (lcp/hopper_pgs.py) and the batched LCP
solvers around it (lcp/pgs.make_pgs_solver, lcp/hybrid.make_hybrid_solver):

* the kernel's plain version against the Pallas kernel in interpret mode
  (float32), with and without the fused residual, on the problems of
  tests/test_pallas_kernels.py: impulses rtol 1e-5 / atol 1e-6, residuals
  rtol 1e-4 / atol 1e-7 (that file's bounds);
* the batched hybrid solver against jax.vmap of the JAX package's
  make_hybrid_solver in float64, with walker2d's escalation settings and
  a K capped by kmax below ceil(frac * B): 1e-9;
* the dispatch: plain versions on a CPU batch, counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.lcp.hybrid import (
    make_hybrid_solver as jax_make_hybrid_solver,
)
from dartenv_tpu.lcp.pallas_pgs import pgs_solve_pallas
from dartenv_tpu_torch.lcp import hopper_pgs as hp
from dartenv_tpu_torch.lcp.hybrid import comp_residual, make_hybrid_solver
from dartenv_tpu_torch.lcp.pgs import make_pgs_solver
from test_torch_bpp import _problems
from torch_port_util import N, T


@pytest.mark.parametrize("residual", [False, True])
def test_reference_matches_pallas_interpret_f32(residual):
    A, b, lo, hi, mu, act, findex = _problems(seed=1)
    lam0 = np.random.default_rng(5).uniform(0.0, 0.2, b.shape) * act
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    run = jax.jit(lambda *a: pgs_solve_pallas(
        *a[:4], findex, a[4], a[5], iters=4, omega=1.1, lam0=a[6],
        interpret=True, return_residual=residual))
    ref = run(*(f32(x) for x in (A, b, lo, hi, mu, act, lam0)))
    t32 = lambda x: T(x, torch.float32)
    got = hp.pgs_solve_reference(*(t32(x) for x in (A, b, lo, hi)), findex,
                                 t32(mu), t32(act), iters=4, omega=1.1,
                                 lam0=t32(lam0), return_residual=residual)
    if not residual:
        got, ref = (got,), (ref,)
    np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-6)
    assert got[0].dtype == torch.float32
    if residual:
        np.testing.assert_allclose(N(got[1]), np.asarray(ref[1]),
                                   rtol=1e-4, atol=1e-7)
        assert N(got[1]).max() > 1e-4       # the residual is not vacuous


def test_hybrid_matches_jax_f64():
    """Walker2d's escalation settings (8 PGS sweeps, tol 1e-5, 4 damped +
    2 refine pivots), frac 1/4 of B = 12 capped at kmax = 2; warm start."""
    B = 12
    A, b, lo, hi, mu, act, findex = _problems(B=B, seed=7)
    lam0 = np.random.default_rng(6).uniform(0.0, 0.2, b.shape) * act
    kw = dict(iters=8, escalate_frac=0.25, escalate_tol=1e-5,
              escalate_iters=4, escalate_refine=2, escalate_kmax=2)
    jsolve = jax.jit(jax.vmap(jax_make_hybrid_solver(findex, **kw)))
    j = lambda x: jnp.asarray(x, jnp.float64)
    ref = np.asarray(jsolve(*(j(x) for x in (A, b, lo, hi, mu, act,
                                              lam0))))
    got = make_hybrid_solver(findex, **kw)(*(T(x) for x in (
        A, b, lo, hi, mu, act, lam0)))
    np.testing.assert_allclose(N(got), ref, rtol=0, atol=1e-9)
    # exactly K = 2 envs escalated: they differ from plain PGS, the rest
    # keep their PGS impulses bit for bit
    pgs = make_pgs_solver(findex, iters=8)(*(T(x) for x in (
        A, b, lo, hi, mu, act, lam0)))
    changed = (got != pgs).any(dim=1)
    assert int(changed.sum()) == 2
    res = comp_residual(*(T(x) for x in (A, b)), pgs, T(lo), T(hi), findex,
                        T(mu), T(act))
    assert set(torch.nonzero(changed)[:, 0].tolist()) == set(
        torch.topk(res, 2).indices.tolist())


def test_cpu_dispatch_runs_plain_versions():
    *prob, findex = _problems(B=3, seed=2)
    A, b, lo, hi, mu, act = (T(x) for x in prob)
    before = hp.PLAIN_CALLS, hp.PGS_LAUNCHES
    lam = make_pgs_solver(findex, iters=5)(A, b, lo, hi, mu, act,
                                           torch.zeros_like(b))
    assert (hp.PLAIN_CALLS, hp.PGS_LAUNCHES) == (before[0] + 1, before[1])
    # the kernel's wrapper on a CPU tensor is its plain version
    lam2, res = hp.pgs_solve_cuda(A, b, lo, hi, findex, mu, act, iters=5,
                                  return_residual=True)
    assert torch.equal(lam, lam2) and res.shape == (3,)
    assert hp.PGS_LAUNCHES == before[1]
