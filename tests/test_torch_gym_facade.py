"""PyTorch port, the pydart2 facade against the JAX package's, on the CPU
in float64: `Skeleton.M` and `Skeleton.c` (dynamics/batched at B = 1)
against JAX's per-body `crba` and `rnea_bias`, the state views and COMs,
`world.collision_result` as a set of contacts, and a force staged by
`add_ext_force` and servo commands staged by `set_commands` stepped
against the JAX env."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.dynamics.algorithms import crba, fk, rnea_bias
from dartenv_tpu.envs.base import DartEnv as JDartEnv
from dartenv_tpu.envs.walker2d import Walker2dTask as JWalker2dTask
from dartenv_tpu_torch.bench import scenes
from dartenv_tpu_torch.envs import DartEnv
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.envs.walker2d import Walker2dTask

TOL = 1e-12        # M, c, COMs: relative to max(1, |ref|)
STEP_TOL = 1e-10   # states after staged forces / commands, absolute


def _pair(name, seed=0):
    """(port env, JAX env) of a task in float64, reset from the same seed
    and then set to the same random state."""
    env = DartEnv(make_task(name, dtype=torch.float64, device="cpu"))
    jenv = JDartEnv(jax_make_task(name, dtype=jnp.float64))
    for e in (env, jenv):
        e.seed(seed)
        e.reset()
    rng = np.random.default_rng(seed)
    n = env.model.n
    q = env.model.host("q_init") + rng.uniform(-0.2, 0.2, n)
    dq = rng.uniform(-1.0, 1.0, n)
    for e in (env, jenv):
        e.set_state(q, dq)
    return env, jenv, q, dq


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", ["hopper", "walker3d", "dog"])
def test_mass_matrix_and_bias_forces_match_jax(name):
    env, jenv, q, dq = _pair(name)
    skel = env.robot_skeleton
    kin = fk(jenv.model, jnp.asarray(q), jnp.asarray(dq))
    _close(skel.M, crba(jenv.model, kin), TOL)
    _close(skel.c, rnea_bias(jenv.model, kin, jnp.asarray(dq)), TOL)
    _close(skel.M, jenv.robot_skeleton.M, TOL)
    assert np.linalg.eigvalsh(skel.M).min() > 0


def test_state_views_and_coms_match_jax():
    env, jenv, q, dq = _pair("walker2d", seed=3)
    skel, jskel = env.robot_skeleton, jenv.robot_skeleton
    np.testing.assert_array_equal(skel.q, q)
    np.testing.assert_array_equal(skel.dq, dq)
    _close(skel.com(), jskel.com(), TOL)
    for b, jb in zip(skel.bodynodes, jskel.bodynodes):
        assert b.name == jb.name and b.mass() == pytest.approx(jb.mass())
        _close(b.com(), jb.com(), TOL)
        _close(b.to_world([0.1, -0.2, 0.3]), jb.to_world([0.1, -0.2, 0.3]),
               TOL)
    np.testing.assert_array_equal(skel.q_lower, jskel.q_lower)
    for j, jj in zip(skel.joints, jskel.joints):
        assert j.name == jj.name and j.num_dofs() == jj.num_dofs()
        for d, jd in zip(j.dofs, jj.dofs):
            assert d.position() == pytest.approx(jd.position(), abs=1e-15)
            assert d.has_position_limit() == jd.has_position_limit()
    skel.set_positions(q + 0.01)
    np.testing.assert_allclose(skel.q, q + 0.01, rtol=0, atol=1e-15)
    skel.dq = dq * 0.5
    np.testing.assert_allclose(env.state_vector()[env.model.n:], dq * 0.5,
                               rtol=0, atol=1e-15)
    assert skel.bodynode(skel.bodynodes[2].name) is skel.bodynodes[2]
    assert env.world.dt == jenv.world.dt
    np.testing.assert_array_equal(env.world.gravity, jenv.world.gravity)


def _contact_set(cr):
    return sorted((c.bodynode_id, *np.round(c.point, 9)) + tuple(
        np.concatenate([c.normal, c.force, [c.penetration_depth]]))
        for c in cr.contacts)


def test_collision_result_matches_jax():
    """The hopper set just above the ground with its staged zero forces,
    stepped by world.step() until it touches: the active contacts (body,
    point, normal, force, depth) equal the JAX facade's as a set."""
    env, jenv, q, dq = _pair("hopper", seed=1)
    q = env.model.host("q_init").copy()
    q[1] -= 0.02
    for e in (env, jenv):
        e.set_state(q, np.zeros_like(q))
        e.robot_skeleton.set_forces(np.zeros(e.model.n))
    assert _contact_set(env.world.collision_result) == _contact_set(
        jenv.world.collision_result)
    for _ in range(40):
        env.world.step()
        jenv.world.step()
        if env.world.collision_result.num_contacts():
            break
    cr, jcr = env.world.collision_result, jenv.world.collision_result
    assert cr.num_contacts() > 0
    assert cr.num_contacts() == jcr.num_contacts()
    got, ref = np.array(_contact_set(cr)), np.array(_contact_set(jcr))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(ref).max()))
    assert sum(c.force[1] for c in cr.contacts) > 0.0
    assert env.world.time == pytest.approx(jenv.world.time)


def test_add_ext_force_matches_jax():
    """A force at a body-frame offset staged on the torso: one
    do_simulation frame equals the JAX env's, pushes along +x, and the
    force is cleared after the step."""
    env, jenv, q, dq = _pair("hopper", seed=2)
    for e in (env, jenv):
        e.robot_skeleton.bodynodes[0].add_ext_force([500.0, 0.0, 30.0],
                                                    offset=[0.0, 0.1, 0.0])
    v0 = env.robot_skeleton.dq[0]
    env.do_simulation(np.zeros(env.model.n), 1)
    jenv.do_simulation(np.zeros(env.model.n), 1)
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=STEP_TOL)
    assert env.robot_skeleton.dq[0] - v0 > 0.02
    assert env._pending_fext is None
    for e in (env, jenv):
        e.do_simulation(np.zeros(env.model.n), 1)
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=STEP_TOL)


def test_set_commands_matches_jax():
    """The servo walker (servo rows on the 6 actuated dofs): commands
    staged by set_commands drive do_simulation as the JAX env's do."""
    fl = np.zeros(9)
    fl[3:] = 50.0
    jm = jax_make_task("walker2d", dtype=jnp.float64).model.replace(
        servo_flimit=jnp.asarray(fl))
    jenv = JDartEnv(JWalker2dTask(jm))
    env = DartEnv(Walker2dTask(scenes.servo_walker("cpu", torch.float64)))
    u = np.array([0.0, 0.0, 0.0, 1.5, -1.0, 0.5, -0.5, 2.0, 0.0])
    for e in (env, jenv):
        e.seed(5)
        e.reset()
        e.robot_skeleton.set_commands(u)
    np.testing.assert_array_equal(env.robot_skeleton.commands(), u)
    for _ in range(2):
        env.do_simulation(np.zeros(9), 2)
        jenv.do_simulation(np.zeros(9), 2)
    np.testing.assert_allclose(env.state_vector(), jenv.state_vector(),
                               rtol=0, atol=STEP_TOL)
