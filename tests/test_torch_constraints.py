"""PyTorch port, collision + constraint + PGS layer vs the JAX package on
the same numpy inputs (float64, CPU): collide, assemble_lcp (with and
without a binding contact_cap, with forced score ties), pgs_solve,
comp_residual.  Continuous outputs <= 1e-10, discrete outputs exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.collision import narrowphase as jnp_col
from dartenv_tpu.dynamics import batched as jb
from dartenv_tpu.engine import constraints as jc
from dartenv_tpu.engine.pallas_substep import _SubStatic
from dartenv_tpu.envs.base import with_solver as jax_with_solver
from dartenv_tpu.lcp.hybrid import comp_residual as jax_comp_residual
from dartenv_tpu.lcp.pgs import pgs_solve as jax_pgs_solve
from dartenv_tpu.model import skel_model as jsm
from dartenv_tpu.model.builder import ModelBuilder as JBuilder
from dartenv_tpu.model.builder import box_inertia
from dartenv_tpu_torch.collision import narrowphase as t_col
from dartenv_tpu_torch.dynamics import batched as tb
from dartenv_tpu_torch.engine import constraints as tc
from dartenv_tpu_torch.lcp.hybrid import comp_residual
from dartenv_tpu_torch.lcp.pgs import pgs_solve
from torch_port_util import N, T, port_model, rel_err

TOL = 1e-10
B = 4


def _box_model():
    """Planar body carrying a box, a sphere and a capsule over a ground
    halfspace, with a limited revolute child: every geom family and every
    row family of the ported scope."""
    b = JBuilder(dt=0.002)
    b.add_body("base", None, jsm.PLANAR, mass=2.0,
               inertia=box_inertia(2.0, (0.2, 0.1, 0.15)),
               dof_friction=(0.0, 0.0, 0.3))
    b.add_body("arm", "base", jsm.REVOLUTE, axes=[(0, 0, 1)], mass=0.5,
               inertia=box_inertia(0.5, (0.05, 0.15, 0.05)),
               pj_pos=(0.2, 0, 0), cj_pos=(0, 0.15, 0),
               q_lower=-0.2, q_upper=0.2)
    b.add_geom("base", jsm.GEOM_BOX, (0.2, 0.1, 0.15), friction=0.7,
               restitution=0.2)
    b.add_geom("arm", jsm.GEOM_SPHERE, (0.08,), pos=(0, -0.15, 0))
    b.add_geom("arm", jsm.GEOM_CAPSULE, (0.04, 0.1), pos=(0, 0.05, 0))
    b.add_ground(offset=0.0, friction=0.9)
    return b.finalize(dtype=jnp.float64)


def _setup(name, seed, **solver_kw):
    if name == "box":
        jm = _box_model()
        drop = 0.12
    else:
        jm = jax_make_task(name, dtype=jnp.float64).model
        drop = 0.08
    jm = jax_with_solver(jm, None, escalate_frac=0.0, **solver_kw)
    rng = np.random.default_rng(seed)
    q = np.asarray(jm.q_init)[None] + rng.uniform(-0.3, 0.3, (B, jm.n))
    q[:, 1] -= drop - (0.1 if name == "box" else 0.0)
    if name == "box":
        q[:, 1] = rng.uniform(0.05, 0.12, B)
        q[:, 3] = rng.uniform(-0.35, 0.35, B)
    dq = rng.uniform(-1.5, 1.5, (B, jm.n))
    tau = rng.uniform(-50.0, 50.0, (B, jm.n))
    return jm, port_model(jm), q, dq, tau


def _jax_kin(jm, q, dq, tau):
    dt = float(jm.dt)

    def f(qq, dd, tt):
        kin = jb.bkin(jm, qq, dd)
        ddq, M = jb.forward_dynamics(jm, kin, qq, dd, tt, dt, None)
        return kin.phi, M, dd + dt * ddq, jnp_col.collide(jm, kin.R_w,
                                                          kin.p_w)
    return jax.jit(jax.vmap(f))(jnp.asarray(q), jnp.asarray(dq),
                                jnp.asarray(tau))


@pytest.mark.parametrize("name", ["walker2d", "hopper", "box"])
def test_collide_matches_jax(name):
    jm, tm, q, dq, tau = _setup(name, 3, contact_cap=2)
    _phi, _M, _dqs, jcon = _jax_kin(jm, q, dq, tau)
    kin = tb.bkin(tm, T(q), T(dq))
    tcon = t_col.collide(tm, kin.R_w, kin.p_w)
    assert t_col.num_slots(tm) == jnp_col.num_slots(jm)
    assert t_col.slot_layout(tm) == jnp_col.slot_layout(jm)
    for f in ("pos", "normal", "depth", "friction", "restitution"):
        assert rel_err(getattr(tcon, f), getattr(jcon, f)) <= TOL, f
    np.testing.assert_array_equal(N(tcon.active), np.asarray(jcon.active))
    np.testing.assert_array_equal(N(tcon.overflow),
                                  np.asarray(jcon.overflow))
    assert N(tcon.active).sum() > 0


@pytest.mark.parametrize("name,cap,ties", [
    ("walker2d", 0, False), ("walker2d", 6, False), ("walker2d", 3, True),
    ("box", 3, True),
])
def test_assemble_lcp_pgs_residual_match_jax(name, cap, ties):
    jm, tm, q, dq, tau = _setup(name, 5, contact_cap=cap, pgs_iters=6)
    dt = float(jm.dt)
    phi, M, dq_star, jcon = _jax_kin(jm, q, dq, tau)
    if ties:
        # force exact score ties: depths quantized, all slots active
        depth = np.round(np.abs(np.asarray(jcon.depth)), 1) + 0.1
        jcon = dataclasses.replace(
            jcon, depth=jnp.asarray(depth),
            active=jnp.ones_like(jcon.active))
    tcon = t_col.Contacts(**{
        f.name: T(getattr(jcon, f.name))
        for f in dataclasses.fields(jcon)})
    jl, tl = jc.build_layout(jm), tc.build_layout(tm)
    assert (jl.m, jl.contact_slots, jl.limit_dofs, jl.friction_dofs) == \
        (tl.m, tl.contact_slots, tl.limit_dofs, tl.friction_dofs)
    np.testing.assert_array_equal(jl.findex, tl.findex)

    def jax_asm(ph, MM, qq, dd, ds, con, lam_prev):
        A, b, lo, hi, act, mu, findex, MinvJt, sel = jc.assemble_lcp(
            jm, jl, ph, MM, qq, dd, ds, con, dt)
        lam0 = (sel @ lam_prev if sel is not None else lam_prev) * act
        lam = jax_pgs_solve(A, b, lo, hi, findex, mu, act,
                            iters=jm.solver.pgs_iters, lam0=lam0)
        res = jax_comp_residual(A, b, lam, lo, hi, findex, mu, act)
        rows = (jnp.argmax(sel, axis=1) if sel is not None
                else jnp.arange(jl.m))
        return dict(A=A, b=b, lo=lo, hi=hi, act=act, mu=mu, MinvJt=MinvJt,
                    lam=lam, res=res, rows=rows)

    rng = np.random.default_rng(9)
    lam_prev = rng.uniform(0.0, 0.5, (B, jl.m))
    ref = jax.jit(jax.vmap(jax_asm))(
        phi, M, jnp.asarray(q), jnp.asarray(dq), dq_star, jcon,
        jnp.asarray(lam_prev))
    jfindex = _SubStatic(jm).findex_c      # the compacted static findex

    A, b, lo, hi, act, mu, findex, MinvJt, row_sel, _J = tc.assemble_lcp(
        tm, tl, T(phi), T(M), T(q), T(dq), T(dq_star), tcon, dt)
    np.testing.assert_array_equal(np.asarray(jfindex), findex)
    rows = (N(row_sel) if row_sel is not None
            else np.broadcast_to(np.arange(tl.m), (B, tl.m)))
    np.testing.assert_array_equal(rows, np.asarray(ref["rows"]))
    np.testing.assert_array_equal(N(act), np.asarray(ref["act"]))
    lam0 = tc.compact_lam(T(lam_prev), row_sel, act)
    lam = pgs_solve(A, b, lo, hi, findex, mu, act,
                    iters=tm.solver.pgs_iters, lam0=lam0)
    res = comp_residual(A, b, lam, lo, hi, findex, mu, act)
    got = dict(A=A, b=b, lo=lo, hi=hi, mu=mu, MinvJt=MinvJt, lam=lam,
               res=res)
    for k, v in got.items():
        assert rel_err(v, ref[k]) <= TOL, (k, rel_err(v, ref[k]))
    assert N(act).sum() > 0 and np.abs(N(lam)).max() > 0
