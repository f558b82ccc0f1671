"""PyTorch port, servo-motor rows vs the JAX package (float64, CPU): the
row layout, the assembled rows with a servo target (1e-12), a few
phase-wise substeps of the servo walker2d with random commands against
JAX's vmapped step, and the four behaviours of the JAX servo tests on
the port (a pinned command reached, a saturated per-substep velocity
change bounded by flimit * dt / I, a hold against gravity, no rows
without a force limit)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.collision import narrowphase as jn
from dartenv_tpu.dynamics import batched as jb
from dartenv_tpu.engine import constraints as jc
from dartenv_tpu.engine.world import SimState as JSimState
from dartenv_tpu.engine.world import make_sim_step as jax_make_sim_step
from dartenv_tpu_torch.bench import scenes
from dartenv_tpu_torch.collision import narrowphase as tn
from dartenv_tpu_torch.dynamics import batched as tb
from dartenv_tpu_torch.engine import constraints as tc
from dartenv_tpu_torch.engine.world import init_state, make_sim_step
from dartenv_tpu_torch.model import skel_model as sm
from dartenv_tpu_torch.model.builder import ModelBuilder, box_inertia
from torch_port_util import N, T, port_model, rel_err

TOL = 1e-12
FLIMIT = 50.0


def _servo_walker_jax():
    jm = jax_make_task("walker2d", dtype=jnp.float64).model
    fl = np.zeros(jm.n)
    fl[3:] = FLIMIT
    return jm.replace(servo_flimit=jnp.asarray(fl))


def test_servo_layout_matches_jax():
    jm = _servo_walker_jax()
    got = scenes.servo_walker("cpu", torch.float64, flimit=FLIMIT)
    assert torch.equal(got.servo_flimit, port_model(jm).servo_flimit)
    jl, tl = jc.build_layout(jm), tc.build_layout(got)
    assert tl.servo_dofs == jl.servo_dofs == (3, 4, 5, 6, 7, 8)
    assert tl.m == jl.m == 54
    np.testing.assert_array_equal(tl.findex, jl.findex)
    np.testing.assert_array_equal(tl.sv_onehot, np.asarray(jl.sv_onehot))


def test_servo_rows_match_jax():
    """assemble_rows with a servo target on random walker2d states: the
    servo rows are boxed to +-flimit * dt with findex -1."""
    jm = _servo_walker_jax()
    tm = port_model(jm)
    B = 5
    rng = np.random.default_rng(0)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.2, 0.2, (B, jm.n))
    q[:, 1] -= 0.15                         # feet in the ground
    dq = rng.normal(size=(B, jm.n))
    dq_star = dq + rng.normal(size=(B, jm.n)) * 0.01
    cmd = rng.uniform(-3, 3, (B, jm.n))
    jl, tl = jc.build_layout(jm), tc.build_layout(tm)

    def jax_rows(qi, dqi, dsi, ci):
        kin = jb.bkin(jm, qi, dqi)
        con = jn.collide(jm, kin.R_w, kin.p_w)
        return jc.assemble_rows(jm, jl, kin.phi, qi, dqi, dsi, con, jm.dt,
                                servo_target=ci)

    ref = jax.jit(jax.vmap(jax_rows))(*[jnp.asarray(x)
                                        for x in (q, dq, dq_star, cmd)])
    kin = tb.bkin(tm, T(q), T(dq))
    con = tn.collide(tm, kin.R_w, kin.p_w)
    got = tc.assemble_rows(tm, tl, kin.phi, T(q), T(dq), T(dq_star), con,
                           tm.dt, servo_target=T(cmd))
    for a, r in zip(got, ref):
        assert rel_err(a, r) <= TOL, rel_err(a, r)
    lo, hi = N(got[2])[:, -6:], N(got[3])[:, -6:]
    np.testing.assert_allclose(hi, FLIMIT * tm.dt)
    np.testing.assert_allclose(lo, -FLIMIT * tm.dt)


def test_servo_walker_steps_like_jax():
    """Three substeps of the servo walker2d (B = 4, random commands, the
    task's contact cap, plain PGS) against JAX's vmapped step."""
    jm = _servo_walker_jax()
    jm = jm.replace(solver=dataclasses.replace(jm.solver,
                                               escalate_frac=0.0))
    tm = port_model(jm)
    B = 4
    rng = np.random.default_rng(1)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.1, 0.1, (B, jm.n))
    q[:, 1] -= 0.1
    dq = rng.normal(size=(B, jm.n)) * 0.3
    tau = rng.uniform(-40, 40, (B, jm.n)) * (np.arange(jm.n) >= 3)
    cmd = rng.uniform(-2, 2, (B, jm.n))
    lam = np.zeros((B, jc.build_layout(jm).m))
    js = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                   time=jnp.zeros(B), lam=jnp.asarray(lam))
    jstep = jax.jit(jax.vmap(jax_make_sim_step(jm)))
    tstep = make_sim_step(tm)
    ts = init_state(tm, B)
    ts = dataclasses.replace(ts, q=T(q), dq=T(dq))
    for _ in range(3):
        js, _ = jstep(js, jnp.asarray(tau), None, jnp.asarray(cmd))
        ts, _ = tstep(ts, T(tau), None, T(cmd))
    for a, r in ((ts.q, js.q), (ts.dq, js.dq), (ts.lam, js.lam)):
        assert rel_err(a, r) <= TOL, rel_err(a, r)
    assert float(np.abs(N(ts.lam)[:, -6:]).max()) > 0     # servo rows work


def _servo_pendulum(flimit):
    b = ModelBuilder(dt=0.002, gravity=(0.0, -9.81, 0.0))
    b.add_body("l1", None, sm.REVOLUTE, axes=[(0, 0, 1)],
               cj_pos=(0, 0.5, 0), mass=1.0,
               inertia=box_inertia(1.0, (0.05, 0.5, 0.05)),
               servo_flimit=flimit)
    return b.finalize(dtype=torch.float64, device="cpu")


def test_servo_behaviours():
    B = 3
    zero = torch.zeros((B, 1), dtype=torch.float64)
    # a pinned command is reached in a few substeps
    model = _servo_pendulum(1e4)
    step = make_sim_step(model)
    st = init_state(model, B)
    cmd = torch.full((B, 1), 1.7, dtype=torch.float64)
    for _ in range(5):
        st, _ = step(st, zero, None, cmd)
    np.testing.assert_allclose(N(st.dq), 1.7, atol=1e-8)
    # a weak servo saturates: dv per substep <= flimit * dt / I
    flimit = 0.5
    model = _servo_pendulum(flimit)
    step = make_sim_step(model)
    st = init_state(model, B)
    I_hinge = float(model.inertia[0, 2, 2] + model.mass[0] * 0.25)
    dv_max = flimit * model.dt / I_hinge
    cmd = torch.full((B, 1), 50.0, dtype=torch.float64)
    prev = N(st.dq).copy()
    for _ in range(3):
        st, _ = step(st, zero, None, cmd)
        assert (N(st.dq) - prev <= dv_max * 1.01 + 1e-10).all()
        prev = N(st.dq).copy()
    assert (N(st.dq) < 49.0).all()
    # command 0 holds the pendulum against gravity
    model = _servo_pendulum(1e4)
    step = make_sim_step(model)
    st = init_state(model, B)
    st = dataclasses.replace(st, q=torch.full((B, 1), 0.7,
                                              dtype=torch.float64))
    for _ in range(50):
        st, _ = step(st, zero, None, torch.zeros_like(zero))
    np.testing.assert_allclose(N(st.dq), 0.0, atol=1e-6)
    assert (np.abs(N(st.q) - 0.7) < 1e-3).all()
    # no rows without a force limit
    assert tc.build_layout(_servo_pendulum(0.0)).servo_dofs == ()
    assert tc.build_layout(_servo_pendulum(2.0)).servo_dofs == (0,)
