"""PyTorch port, the exact-everywhere solver="dantzig" mode (the
reference's own default solver) against the JAX package, float64, CPU:
  (a) routing: the fused substep phase declines the mode, run_lcp_solver
      sends it to lcp/dantzig.make_exact_solver (the BPP kernel's plain
      version on a CPU batch) and refuses an unknown mode;
  (b) run_lcp_solver on the boxed LCPs of walker2d and hopper batches,
      assembled by both packages from the same states (JAX:
      engine/world.make_lcp_capture, which also solves them with its
      run_lcp_solver): the operators within 1e-10, every residual
      <= 1e-8, impulses within 1e-6 of JAX's except on envs that friction
      multiplicity parts (a solution set, not a point: docs/SOLVERS.md
      47-51), which are held by residual alone and counted;
  (c) one phase-wise sim step of a hopper batch in the mode against the
      JAX make_sim_step: q, dq and the impulses within 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.engine.world import make_lcp_capture
from dartenv_tpu.engine.world import make_sim_step as jax_make_sim_step
from dartenv_tpu.envs.hopper import make_hopper_task as jax_hopper
from dartenv_tpu.envs.walker2d import make_walker2d_task as jax_walker2d
from dartenv_tpu_torch.collision.narrowphase import collide
from dartenv_tpu_torch.dynamics import batched
from dartenv_tpu_torch.engine.constraints import (
    assemble_lcp, build_layout, compact_lam, run_lcp_solver,
)
from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase
from dartenv_tpu_torch.engine.world import SimState, make_sim_step
from dartenv_tpu_torch.envs.base import with_solver
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.lcp.hybrid import comp_residual
from torch_port_util import N, T, port_model

FACTORIES = {"walker2d": jax_walker2d, "hopper": jax_hopper}
# walker2d at contact_cap 4 (m_c = 18 rows, the shipped 6 give 24): the
# JAX side's trace of its exact solver over 24 rows takes over 20 s
SOLVER_KW = {"walker2d": dict(contact_cap=4), "hopper": {}}


def _states(jm, B, seed):
    """Seeded states around the initial pose with the feet pressed into
    the ground, joint torques and warm starts."""
    rng = np.random.default_rng(seed)
    n, m = jm.n, build_layout(port_model(jm)).m
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.05, 0.05, (B, n))
    q[:, 1] -= rng.uniform(0.0, 0.03, B)
    dq = rng.uniform(-0.5, 0.5, (B, n))
    tau = np.concatenate([np.zeros((B, 3)),
                          rng.uniform(-100, 100, (B, n - 3))], 1)
    lam = rng.uniform(0.0, 0.3, (B, m))
    return q, dq, tau, lam


def test_dantzig_mode_routing():
    tm = port_model(jax_walker2d(dtype=jnp.float64, lcp_solver="dantzig")
                    .model)
    assert tm.solver.solver == "dantzig"
    assert make_substep_phase(tm) is None
    rng = np.random.default_rng(0)
    B, m = 3, 5
    G = rng.normal(size=(B, m, m + 2))
    A = T(G @ G.transpose(0, 2, 1) / m + 1e-3 * np.eye(m))
    b, lo = T(rng.normal(size=(B, m))), T(np.zeros((B, m)))
    hi, mu, act = T(np.full((B, m), 1e20)), T(np.zeros((B, m))), T(
        np.ones((B, m)))
    findex = -np.ones(m, dtype=np.int64)
    plain = hopper_bpp.PLAIN_CALLS
    lam = run_lcp_solver(tm.solver, findex, A, b, lo, hi, mu, act, None)
    assert hopper_bpp.PLAIN_CALLS == plain + 1
    # make_exact_solver's defaults: 24 damped pivots, the default
    # undamped count, 10 polish sweeps, a zero warm start
    assert torch.equal(lam, hopper_bpp.bpp_solve_reference(
        A, b, lo, hi, findex, mu, act, iters=24, polish_iters=10,
        lam0=torch.zeros_like(b)))
    assert float(comp_residual(A, b, lam, lo, hi, findex, mu,
                               act).max()) <= 1e-8
    bad = with_solver(tm, solver="lemke").solver
    with pytest.raises(NotImplementedError, match="lemke"):
        run_lcp_solver(bad, findex, A, b, lo, hi, mu, act, None)


def _port_lcp(tm, q, dq, tau, lam):
    """The port's phase-wise assembly (as engine/world.phasewise_substep
    composes it on a CPU batch)."""
    dt = tm.dt
    kin = batched.bkin(tm, q, dq)
    ddq, M = batched.forward_dynamics(tm, kin, q, dq, tau, dt)
    dq_star = dq + dt * ddq
    contacts = collide(tm, kin.R_w, kin.p_w)
    A, b, lo, hi, act, mu, findex, MinvJt, row_sel, _ = assemble_lcp(
        tm, build_layout(tm), kin.phi, M, q, dq, dq_star, contacts, dt)
    return (A, b, lo, hi, act, mu), findex, compact_lam(lam, row_sel, act)


@pytest.mark.parametrize("env", sorted(FACTORIES))
def test_run_lcp_solver_dantzig_matches_jax_f64(env):
    jm = FACTORIES[env](dtype=jnp.float64, lcp_solver="dantzig",
                        **SOLVER_KW[env]).model
    tm = port_model(jm)
    B = 8
    q, dq, tau, lam = _states(jm, B, 5)
    cap = make_lcp_capture(jm)
    jcap = jax.jit(jax.vmap(lambda s, t: {
        k: v for k, v in cap(s, t).items() if k != "findex"}))(
        JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq), time=jnp.zeros(B),
                  lam=jnp.asarray(lam)), jnp.asarray(tau))
    prob, findex, lam0 = _port_lcp(tm, T(q), T(dq), T(tau), T(lam))
    A, b, lo, hi, act, mu = prob
    for k, got in zip(("A", "b", "lo", "hi", "active", "mu"), prob):
        np.testing.assert_allclose(N(got), np.asarray(jcap[k]), rtol=0,
                                   atol=1e-10, err_msg=k)
    assert float(act[:, 0::3].sum()) > B        # contacts are live
    plain = hopper_bpp.PLAIN_CALLS
    lam_t = run_lcp_solver(tm.solver, findex, A, b, lo, hi, mu, act, lam0)
    assert hopper_bpp.PLAIN_CALLS == plain + 1
    lam_j = np.asarray(jcap["lam"])
    res = lambda x: N(comp_residual(A, b, T(x), lo, hi, findex, mu, act))
    r_t, r_j = res(N(lam_t)), res(lam_j)
    assert r_t.max() <= 1e-8 and r_j.max() <= 1e-8, (r_t, r_j)
    err = np.abs(N(lam_t) - lam_j).max(1)
    parted = err > 1e-6
    # only friction rows may part: the normal impulses are unique where
    # the operator restricted to them is definite
    print(f"{env}: {int(parted.sum())} of {B} envs parted by friction "
          f"multiplicity, max impulse difference {err.max():.2e}")
    assert int(parted.sum()) <= B // 4


def test_phasewise_dantzig_step_matches_jax_f64():
    """One sim step of a hopper batch (B = 4, m_c = 15) in the dantzig
    mode: the port's phase-wise path (the dynamics phase, collision,
    assembly, the exact solve over the batch) against the JAX
    make_sim_step, whose fused substep declines the mode as well."""
    from dartenv_tpu_torch.dynamics import hopper_dynamics as hd

    jm = jax_hopper(dtype=jnp.float64, lcp_solver="dantzig").model
    tm = port_model(jm)
    B = 4
    q, dq, tau, lam = _states(jm, B, 9)
    js, _ = jax.jit(jax.vmap(jax_make_sim_step(jm)))(
        JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq), time=jnp.zeros(B),
                  lam=jnp.asarray(lam)), jnp.asarray(tau))
    plain = (hd.PLAIN_CALLS, hopper_bpp.PLAIN_CALLS)
    ts, c = make_sim_step(tm)(
        SimState(q=T(q), dq=T(dq), time=T(np.zeros(B)), lam=T(lam)), T(tau))
    assert (hd.PLAIN_CALLS, hopper_bpp.PLAIN_CALLS) == (plain[0] + 1,
                                                        plain[1] + 1)
    assert float(c.active.sum()) > 0
    for name, got, ref in (("q", ts.q, js.q), ("dq", ts.dq, js.dq),
                           ("lam", ts.lam, js.lam)):
        np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0,
                                   atol=1e-9, err_msg=name)
