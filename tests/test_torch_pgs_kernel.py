"""PyTorch port, the PGS kernel's arithmetic (csrc/pgs_row.h, csrc/pgs.cu)
without a GPU: csrc/pgs_host.cpp runs the sweeps and the fused residual
of one env as one lane that holds every row, in the order the card's
lanes take them (lcp/hopper_pgs.pgs_solve_host).

* the sweeps against the plain version (pgs_solve_reference) in float32,
  on the problems of tests/test_pallas_kernels.py, on perturbed
  walker2d's LCPs (m = 24, friction rows) and at m = 40 (rows beyond the
  32 lanes), at the JAX package's bound between its Pallas kernel and XLA
  (tests/test_pallas_kernels.py): impulses rtol 1e-5 / atol 1e-6;
  residuals rtol 1e-4 / atol 1e-7 against the plain residual formula
  (lcp/hybrid.comp_residual) with its row sums taken in the kernel's
  order (row_dot: lane-strided partials, then the xor butterfly), the
  order of the plain version's sums on the card.  The CPU's own
  torch.sum adds 8-wide partials instead, and that order alone moves one
  residual in 512 perturbed-walker2d envs beyond 1e-7 (PERF.md);
* the same build against the JAX package on the same inputs: its Pallas
  PGS kernel in interpret mode (impulses rtol 1e-5 / atol 1e-6) and its
  comp_residual on the host build's impulses (rtol 1e-4 / atol 1e-7), on
  the problems of tests/test_pallas_kernels.py and at m = 40.  The metric
  is evaluated in float64 on the float32 inputs: XLA's float32 row sums
  round in another order than the kernel's, and on these residuals of
  1e-5 to 1e-8 that alone can move the two float32 values 1.6e-7 apart;
* the wrapper's refusal of m beyond the kernel's 256 rows.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.lcp.hybrid import comp_residual as jax_comp_residual
from dartenv_tpu.lcp.pallas_pgs import pgs_solve_pallas
from dartenv_tpu_torch.lcp import hopper_pgs as hp
from dartenv_tpu_torch.lcp.pgs import findex_tensors
from test_torch_bpp import _problems
from torch_port_util import rel_err

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no host C++ compiler")


def _row_dot_order(A, lam):
    """A_i . lam for every row i, summed as csrc/pgs_row.h's row_dot sums
    it: lane l's partial over j = l, l + 32, ... in order, then the
    partials added in the xor butterfly's tree (16, 8, 4, 2, 1)."""
    prod = A * lam[..., None, :]
    p = torch.zeros(prod.shape[:-1] + (32,), dtype=prod.dtype)
    for j in range(prod.shape[-1]):
        p[..., j % 32] = p[..., j % 32] + prod[..., j]
    o = 16
    while o:
        p[..., :o] = p[..., :o] + p[..., o:2 * o]
        o //= 2
    return p[..., 0]


def _residual(A, b, x, lo, hi, findex, mu, active):
    """lcp/hybrid.comp_residual, its row sums in row_dot's order."""
    fidx, has_f = findex_tensors(findex, x.device)
    has_f = has_f.to(x.dtype)
    bd = mu * torch.abs(x[..., fidx]) * has_f + 1e20 * (1 - has_f)
    lo_e = torch.maximum(lo, -bd)
    hi_e = torch.minimum(hi, bd)
    w = _row_dot_order(A, x) + b
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
    return torch.amax(res, dim=-1) / scale[..., 0]


def _f32_problems(B, nc, nl, seed, warm):
    A, b, lo, hi, mu, act, findex = _problems(B=B, nc=nc, nl=nl, seed=seed)
    lam0 = (np.random.default_rng(seed + 100).uniform(0.0, 0.2, b.shape)
            * act if warm else np.zeros_like(b))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return (t(A), t(b), t(lo), t(hi), findex, t(mu), t(act), t(lam0))


@pytest.fixture(scope="module")
def walker2d_lcps():
    """Perturbed walker2d's phase-wise LCPs (m = 24, friction rows) after
    15 control steps of the port's rollout on the CPU, about half of the
    64 envs pushed, as bench/kernel_stages.perturbed_lcps builds them."""
    from dartenv_tpu_torch.bench.kernel_stages import perturbed_lcps
    from dartenv_tpu_torch.envs.tasks import make_task
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    task = make_task("walker2d", device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    B = 64
    vec = VecEnv(task, B, max_episode_steps=1000, generator=gen)
    state, _ = vec.reset()
    hi = torch.as_tensor(task.control_bounds[0], dtype=torch.float32)
    act = lambda: (torch.rand((B, task.action_size), generator=gen)
                   * 2 - 1) * hi
    for _ in range(15):
        state, *_ = vec.step(state, act())
    tau = task.action_to_tau(act(), ())
    out = perturbed_lcps(task, state.sim.q, state.sim.dq, tau,
                         state.sim.lam)
    assert out[0].shape == (B, 24, 24) and float(out[6].sum()) > B
    return out


def _check(A, b, lo, hi, findex, mu, act, lam0, iters, omega):
    kw = dict(iters=iters, omega=omega, lam0=lam0, return_residual=True)
    lam, res = hp.pgs_solve_host(A, b, lo, hi, findex, mu, act, **kw)
    lam_r, res_r = hp.pgs_solve_reference(A, b, lo, hi, findex, mu, act,
                                          **kw)
    assert lam.dtype == torch.float32
    np.testing.assert_allclose(lam.numpy(), lam_r.numpy(), rtol=1e-5,
                               atol=1e-6)
    res_o = _residual(A, b, lam, lo, hi, findex, mu, act)
    np.testing.assert_allclose(res.numpy(), res_o.numpy(), rtol=1e-4,
                               atol=1e-7)
    # the plain version's residual (torch.sum's own order) within f32
    # rounding of the kernel's
    assert rel_err(res, res_r) <= 1e-6
    assert float(res_r.max()) > 0.0            # not vacuous


@pytest.mark.parametrize("seed,iters,omega,warm", [
    (1, 20, 1.0, False), (2, 20, 1.0, False), (3, 10, 1.0, False),
    (4, 10, 1.0, False), (6, 10, 1.0, False), (1, 4, 1.1, True)])
def test_sweeps_match_plain_on_jax_problems(seed, iters, omega, warm):
    """The generator and seeds of tests/test_pallas_kernels.py (m = 17)."""
    p = _f32_problems(8, 4, 5, seed, warm)
    _check(*p, iters=iters, omega=omega)


def test_sweeps_match_plain_on_walker2d_lcps(walker2d_lcps):
    """8 sweeps, warm-started, as the perturbed path runs them."""
    _check(*walker2d_lcps, iters=8, omega=1.0)


@pytest.mark.parametrize("seed", [7, 8])
def test_sweeps_match_plain_beyond_32_rows(seed):
    """m = 40: rows 32..39 sit in each lane's second slot."""
    p = _f32_problems(16, 10, 10, seed, warm=True)
    assert p[1].shape[1] == 40
    _check(*p, iters=8, omega=1.0)


@pytest.mark.parametrize("B,nc,nl,seed,iters,omega,warm", [
    (8, 4, 5, 1, 20, 1.0, False), (8, 4, 5, 2, 20, 1.0, False),
    (8, 4, 5, 3, 10, 1.0, False), (8, 4, 5, 4, 10, 1.0, False),
    (8, 4, 5, 6, 10, 1.0, False), (8, 4, 5, 1, 4, 1.1, True),
    (16, 10, 10, 7, 8, 1.0, True), (16, 10, 10, 8, 8, 1.0, True)])
def test_sweeps_match_jax_pallas_interpret(B, nc, nl, seed, iters, omega,
                                           warm):
    """The host build against the JAX package's PGS kernel (Pallas,
    interpret mode) on the same float32 inputs, and its residual against
    the JAX package's comp_residual, in float64, on those inputs and the
    host build's impulses."""
    A, b, lo, hi, findex, mu, act, lam0 = _f32_problems(B, nc, nl, seed,
                                                        warm)
    lam, res = hp.pgs_solve_host(A, b, lo, hi, findex, mu, act, iters=iters,
                                 omega=omega, lam0=lam0,
                                 return_residual=True)
    j = lambda x: jnp.asarray(x.numpy())
    lam_j, res_j = pgs_solve_pallas(
        j(A), j(b), j(lo), j(hi), findex, j(mu), j(act), iters=iters,
        omega=omega, lam0=j(lam0), interpret=True, return_residual=True)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_j), rtol=1e-5,
                               atol=1e-6)
    j64 = lambda x: jnp.asarray(x.numpy().astype(np.float64))
    res_m = jax.vmap(lambda *a: jax_comp_residual(
        a[0], a[1], a[2], a[3], a[4], findex, a[5], a[6]))(
            *(j64(x) for x in (A, b, lam, lo, hi, mu, act)))
    assert res_m.dtype == jnp.float64
    np.testing.assert_allclose(res.numpy(), np.asarray(res_m), rtol=1e-4,
                               atol=1e-7)
    assert float(res.max()) > 1e-7             # beyond atol: not vacuous


def test_wrapper_refuses_more_rows_than_it_serves():
    A, b, lo, hi, findex, mu, act, _ = _f32_problems(1, 86, 0, 0, False)
    assert b.shape[1] == 258 > hp.MAX_ROWS
    with pytest.raises(ValueError, match="m <= 256"):
        hp.pgs_solve_host(A, b, lo, hi, findex, mu, act, iters=1)
