"""PyTorch port, dynamics layer vs the JAX package on the same numpy
inputs (float64, CPU, B = 4): bkin, mass_matrix, bias_forces,
forward_dynamics, integrate_positions, fk_positions.  Tolerance 1e-10:
both sides are float64 and differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.dynamics import algorithms as jalg
from dartenv_tpu.dynamics import batched as jb
from dartenv_tpu.model import skel_model as jsm
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu.model.builder import box_inertia
from dartenv_tpu_torch.dynamics import algorithms as talg
from dartenv_tpu_torch.dynamics import batched as tb
from dartenv_tpu_torch.model import skel_model as tsm
from dartenv_tpu_torch.model.builder import ModelBuilder as TBuilder
from torch_port_util import N, T, port_model, rel_err

TOL = 1e-10
B = 4


def _build(Bld, sm, finalize):
    """PRISMATIC + WELD + REVOLUTE chain with springs and damping."""
    b = Bld(dt=0.002)
    b.add_body("slider", None, sm.PRISMATIC, axes=[(1, 0, 0)], mass=1.2,
               inertia=box_inertia(1.2, (0.1, 0.05, 0.05)), damping=0.3,
               spring=2.0, rest=0.1)
    b.add_body("plate", "slider", sm.WELD, mass=0.4, pj_pos=(0, 0.1, 0),
               inertia=box_inertia(0.4, (0.05, 0.02, 0.05)), com=(0.01, 0, 0))
    b.add_body("arm", "plate", sm.REVOLUTE, axes=[(0, 0, 1)], mass=0.7,
               inertia=box_inertia(0.7, (0.03, 0.2, 0.03)),
               pj_pos=(0, 0.05, 0), cj_pos=(0, 0.2, 0), damping=0.05,
               com=(0, -0.02, 0.01))
    return finalize(b)


def _build_all_joints(Bld, sm, finalize):
    """A FREE-rooted tree through every remaining joint family, with
    non-trivial joint frames, axes and COM offsets."""
    from dartenv_tpu.model.builder import rpy_to_mat

    b = Bld(dt=0.002)
    ine = lambda m: box_inertia(m, (0.1, 0.06, 0.04))
    b.add_body("root", None, sm.FREE, mass=2.0, inertia=ine(2.0),
               com=(0.01, 0.02, 0.0))
    b.add_body("uni", "root", sm.UNIVERSAL, axes=[(1, 0, 0), (0, 0.6, 0.8)],
               mass=0.8, inertia=ine(0.8), pj_pos=(0.1, 0, 0),
               pj_rot=rpy_to_mat(0.2, -0.1, 0.3), cj_pos=(0, 0.1, 0),
               damping=0.02)
    b.add_body("eul", "uni", sm.EULER, mass=0.6, inertia=ine(0.6),
               pj_pos=(0, -0.2, 0), cj_rot=rpy_to_mat(0.1, 0.2, -0.1),
               com=(0, 0.03, 0.01))
    b.add_body("ball", "root", sm.BALL, mass=0.5, inertia=ine(0.5),
               pj_pos=(-0.1, 0.1, 0), cj_pos=(0.02, 0, 0.05))
    b.add_body("tra", "ball", sm.TRANSLATIONAL, mass=0.4, inertia=ine(0.4),
               spring=3.0, rest=(0.0, 0.1, 0.0))
    b.add_body("scr", "eul", sm.SCREW, axes=[(0, 0, 1)], pitch=0.3,
               mass=0.3, inertia=ine(0.3), pj_pos=(0, -0.1, 0))
    b.add_body("pla", "scr", sm.PLANAR, mass=0.3, inertia=ine(0.3),
               axes=[(0, 1, 0), (0, 0, 1), (1, 0, 0)], cj_pos=(0, 0.05, 0))
    return finalize(b)


def _models(name):
    if name == "alljoints":
        jm = _build_all_joints(JBuilder, jsm,
                               lambda b: b.finalize(dtype=jnp.float64))
        tm = _build_all_joints(TBuilder, tsm, lambda b: b.finalize(
            dtype=torch.float64, device="cpu"))
        return jm, tm
    if name == "chain":
        jm = _build(JBuilder, jsm, lambda b: b.finalize(dtype=jnp.float64))
        tm = _build(TBuilder, tsm, lambda b: b.finalize(
            dtype=torch.float64, device="cpu"))
        return jm, tm
    jm = jax_make_task(name, dtype=jnp.float64).model
    return jm, port_model(jm)


def _inputs(jm, seed):
    rng = np.random.default_rng(seed)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.4, 0.4, (B, jm.n))
    dq = rng.uniform(-2.0, 2.0, (B, jm.n))
    tau = rng.uniform(-50.0, 50.0, (B, jm.n))
    q[0, :3] = 0.0                  # exp map at the identity (Taylor branch)
    return q, dq, tau


@pytest.mark.parametrize("name", ["hopper", "walker2d", "chain",
                                  "alljoints"])
def test_dynamics_matches_jax(name):
    jm, tm = _models(name)
    q, dq, tau = _inputs(jm, 11)
    dt = float(jm.dt)

    def jax_all(qq, dd, tt):
        kin = jb.bkin(jm, qq, dd)
        M = jb.mass_matrix(jm, kin)
        C = jb.bias_forces(jm, kin)
        ddq, M2 = jb.forward_dynamics(jm, kin, qq, dd, tt, dt)
        q_new = jb.integrate_positions(jm, qq, dd, dt)
        R_f, p_f = jalg.fk_positions(jm, qq)
        return dict(R_w=kin.R_w, p_w=kin.p_w, S=kin.S, Sdot=kin.Sdot,
                    v=kin.v, a_bias=kin.a_bias, phi=kin.phi, M=M, C=C,
                    ddq=ddq, q_new=q_new, R_f=R_f, p_f=p_f)

    ref = jax.jit(jax.vmap(jax_all))(jnp.asarray(q), jnp.asarray(dq),
                                     jnp.asarray(tau))
    tq, tdq, ttau = T(q), T(dq), T(tau)
    kin = tb.bkin(tm, tq, tdq)
    ddq, M2 = tb.forward_dynamics(tm, kin, tq, tdq, ttau, dt)
    R_f, p_f = talg.fk_positions(tm, tq)
    got = dict(R_w=kin.R_w, p_w=kin.p_w, S=kin.S, Sdot=kin.Sdot, v=kin.v,
               a_bias=kin.a_bias, phi=kin.phi, M=tb.mass_matrix(tm, kin),
               C=tb.bias_forces(tm, kin), ddq=ddq,
               q_new=tb.integrate_positions(tm, tq, tdq, dt),
               R_f=R_f, p_f=p_f)
    for k in ref:
        assert N(got[k]).shape == np.asarray(ref[k]).shape, k
        assert rel_err(got[k], ref[k]) <= TOL, (k, rel_err(got[k], ref[k]))
    assert rel_err(M2, ref["M"]) <= TOL
    # per-joint position integration agrees with the batched one
    from dartenv_tpu_torch.dynamics.joints import integrate_joint_position
    for i in range(tm.nb):
        a, b = tm.q_start[i], tm.q_start[i] + tm.ndof[i]
        if a == b:
            continue                                   # weld: no dofs
        qj = integrate_joint_position(tm.joint_type[i], tq[:, a:b],
                                      tdq[:, a:b], dt)
        assert rel_err(qj, got["q_new"][:, a:b]) <= TOL, i


def test_phasewise_step_matches_jax_for_a_model_without_rows():
    """A model with no constraint rows is outside the fused path: the
    port's sim step runs the phase-wise composition, as the JAX one does."""
    from dartenv_tpu.engine.world import SimState as JSimState
    from dartenv_tpu.engine.world import make_sim_step as jax_make_sim_step
    from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase
    from dartenv_tpu_torch.engine.world import make_sim_step
    from dartenv_tpu_torch.model.convert import sim_state_from_numpy

    jm, tm = _models("chain")
    assert make_substep_phase(tm) is None
    q, dq, tau = _inputs(jm, 12)
    jstate = JSimState(q=jnp.asarray(q), dq=jnp.asarray(dq),
                       time=jnp.zeros(B), lam=None)
    jnew, _ = jax.jit(jax.vmap(jax_make_sim_step(jm)))(jstate,
                                                      jnp.asarray(tau))
    state = sim_state_from_numpy(q, dq, device="cpu", dtype=torch.float64)
    new, contacts = make_sim_step(tm)(state, T(tau))
    assert rel_err(new.q, jnew.q) <= TOL and rel_err(new.dq, jnew.dq) <= TOL
    assert rel_err(new.time, jnew.time) <= TOL and new.lam is None
    assert contacts.pos.shape == (B, 0, 3)


def _fk_full_pass(model, q):
    """The pose-only pass over every body, written out: the reference
    that fk_positions' default call is held to, bit for bit."""
    from dartenv_tpu_torch.dynamics.joints import JOINT_FNS
    from dartenv_tpu_torch.math import spatial as sp

    R_w, p_w = [], []
    for i in range(model.nb):
        a, b = model.q_start[i], model.q_start[i] + model.ndof[i]
        Rj, pj = JOINT_FNS[model.joint_type[i]](model.axes[i], q[:, a:b])
        R1 = sp.mm(model.pj_rot[i], Rj)
        p1 = model.pj_pos[i] + sp.mv(model.pj_rot[i], pj)
        cj_inv_R = model.cj_rot[i].transpose(-1, -2)
        cj_inv_p = -sp.mv(cj_inv_R, model.cj_pos[i])
        R_rel = sp.mm(R1, cj_inv_R)
        p_rel = p1 + sp.mv(R1, cj_inv_p)
        par = model.parent[i]
        if par < 0:
            R_w.append(R_rel)
            p_w.append(p_rel)
        else:
            R_w.append(sp.mm(R_w[par], R_rel))
            p_w.append(p_w[par] + sp.mv(R_w[par], p_rel))
    return torch.stack(R_w, dim=1), torch.stack(p_w, dim=1)


@pytest.mark.parametrize("name", ["walker2d", "hopper", "walker3d", "dog",
                                  "humanwalker"])
def test_chain_fk_matches_full_fk_to_the_bit(name):
    """fk_positions over a body set visits only their ancestor chains and
    returns, bit for bit, the rows of the full pass; the default call
    keeps the full pass's bits (float32, the production precision)."""
    from dartenv_tpu_torch.bench.throughput import make_task

    m = make_task(name, device="cpu").model
    g = torch.Generator().manual_seed(5)
    q = m.q_init + 0.4 * (2.0 * torch.rand((16, m.n), generator=g,
                                           dtype=m.dtype) - 1.0)
    R_full, p_full = _fk_full_pass(m, q)
    R_def, p_def = talg.fk_positions(m, q)
    assert torch.equal(R_def, R_full) and torch.equal(p_def, p_full)
    leaves = [i for i in range(m.nb) if i not in m.parent]
    sets = ([(0,)] + [(i,) for i in leaves] + [(leaves[-1], leaves[0])]
            + [tuple(range(m.nb))])
    for bodies in sets:
        R, p = talg.fk_positions(m, q, bodies)
        assert R.shape == (16, len(bodies), 3, 3), bodies
        assert torch.equal(R, R_full[:, list(bodies)]), bodies
        assert torch.equal(p, p_full[:, list(bodies)]), bodies
