"""pydart2-style object facade over a DartEnv's single env.

The reference env layer codes against pydart2's object surface
(`skel.q`, `skel.dq`, `skel.set_forces`, `bodynodes[i].com()`,
`world.collision_result.contacts`, joint limits, the mass matrix `skel.M`,
the bias forces `skel.c`).  Here the engine state is a batch of one in the
owning `DartEnv` (the single source of truth); these classes are thin
views that read it as numpy and write it back through `env.set_state`.
`Skeleton.M` and `Skeleton.c` evaluate dynamics/batched.mass_matrix and
bias_forces at B = 1.  Hot-path code should use the batched API instead.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _env_values(env, name):
    """A (1, n) state tensor of the env (q or dq) as float64 numpy (n,)."""
    return env._host(getattr(env._state.sim, name))


class BodyNode:
    """Read view of one body (reference: pydart2 BodyNode)."""

    def __init__(self, env, index: int):
        self._env = env
        self.id = index
        self.name = env.model.body_names[index]

    def _pose(self):
        from dartenv_tpu_torch.dynamics.algorithms import fk_positions

        env = self._env
        R_w, p_w = fk_positions(env.model, env._state.sim.q)
        return env._host(R_w)[self.id], env._host(p_w)[self.id]

    def com(self) -> np.ndarray:
        R, p = self._pose()
        return p + R @ self._env.model.host("com")[self.id]

    def to_world(self, x=(0.0, 0.0, 0.0)) -> np.ndarray:
        R, p = self._pose()
        return p + R @ np.asarray(x, dtype=np.float64)

    def mass(self) -> float:
        return float(self._env.model.host("mass")[self.id])

    def add_ext_force(self, force, offset=(0.0, 0.0, 0.0)):
        """Accumulate a world-frame force at a body-frame offset for the
        next do_simulation (reference: BodyNode.add_ext_force)."""
        self._env._add_ext_force(self.id, force, offset)


class Dof:
    def __init__(self, env, index: int):
        self._env = env
        self.id = index

    @property
    def position_lower_limit(self) -> float:
        return float(self._env.model.host("q_lower")[self.id])

    @property
    def position_upper_limit(self) -> float:
        return float(self._env.model.host("q_upper")[self.id])

    def has_position_limit(self) -> bool:
        return bool(self._env.model.host("limited")[self.id] > 0)

    def position(self) -> float:
        return float(_env_values(self._env, "q")[self.id])

    def velocity(self) -> float:
        return float(_env_values(self._env, "dq")[self.id])

    def damping_coefficient(self) -> float:
        return float(self._env.model.host("damping")[self.id])


class Joint:
    def __init__(self, env, index: int):
        self._env = env
        self.id = index
        self.name = env.model.joint_names[index]
        a = env.model.q_start[index]
        self.dofs = [Dof(env, a + k) for k in range(env.model.ndof[index])]

    def num_dofs(self) -> int:
        return len(self.dofs)


class Skeleton:
    """Read / set view of one skeleton (reference: pydart2 Skeleton).

    Reads go through the env's current state; setters call `env.set_state`
    so there is exactly one state owner.
    """

    def __init__(self, env, name=None, body_range=None, dof_range=None):
        """body_range / dof_range: (start, count) of one skeleton of a
        composed multi-skeleton world (model/compose.py); None = the whole
        model."""
        self._env = env
        m = env.model
        self._b0, self._nb = body_range if body_range else (0, m.nb)
        self._d0, self._nd = dof_range if dof_range else (0, m.n)
        self.name = name or getattr(m, "name", "robot")
        self.bodynodes: List[BodyNode] = [
            BodyNode(env, self._b0 + i) for i in range(self._nb)]
        self.joints: List[Joint] = [
            Joint(env, self._b0 + i) for i in range(self._nb)]

    def _dslice(self):
        return slice(self._d0, self._d0 + self._nd)

    # -- state ------------------------------------------------------------
    @property
    def ndofs(self) -> int:
        return self._nd

    @property
    def q(self) -> np.ndarray:
        return _env_values(self._env, "q")[self._dslice()]

    @q.setter
    def q(self, value):
        self.set_positions(value)

    @property
    def dq(self) -> np.ndarray:
        return _env_values(self._env, "dq")[self._dslice()]

    @dq.setter
    def dq(self, value):
        self.set_velocities(value)

    def positions(self) -> np.ndarray:
        return self.q

    def velocities(self) -> np.ndarray:
        return self.dq

    def _full(self, part, name):
        full = _env_values(self._env, name)
        full[self._dslice()] = np.asarray(part, dtype=np.float64)
        return full

    def set_positions(self, q):
        self._env.set_state(self._full(q, "q"), _env_values(self._env, "dq"))

    def set_velocities(self, dq):
        self._env.set_state(_env_values(self._env, "q"), self._full(dq, "dq"))

    def set_forces(self, tau):
        """Stage generalized forces for the next world.step() (reference:
        Skeleton.set_forces)."""
        if self._env._staged_tau is None:
            self._env._staged_tau = np.zeros(self._env.model.n)
        self._env._staged_tau[self._dslice()] = np.asarray(
            tau, dtype=np.float64)

    def forces(self) -> np.ndarray:
        tau = self._env._staged_tau
        return (np.zeros(self.ndofs) if tau is None
                else tau[self._dslice()].copy())

    def set_commands(self, u):
        """Stage servo velocity commands for the dofs with servo_flimit > 0
        (reference: Skeleton::setCommands on SERVO actuator dofs); every
        do_simulation after this passes them as the servo target."""
        if self._env._staged_servo is None:
            self._env._staged_servo = np.zeros(self._env.model.n)
        self._env._staged_servo[self._dslice()] = np.asarray(
            u, dtype=np.float64)

    def commands(self) -> np.ndarray:
        u = self._env._staged_servo
        return (np.zeros(self.ndofs) if u is None
                else u[self._dslice()].copy())

    # -- limits -----------------------------------------------------------
    @property
    def q_lower(self) -> np.ndarray:
        return self._env.model.host("q_lower")[self._dslice()]

    @property
    def q_upper(self) -> np.ndarray:
        return self._env.model.host("q_upper")[self._dslice()]

    # -- dynamics quantities ---------------------------------------------
    def _kin(self):
        from dartenv_tpu_torch.dynamics import batched

        sim = self._env._state.sim
        return batched.bkin(self._env.model, sim.q, sim.dq)

    @property
    def M(self) -> np.ndarray:
        """Mass matrix at the current configuration (reference:
        Skeleton.M), dynamics/batched.mass_matrix at B = 1."""
        from dartenv_tpu_torch.dynamics import batched

        M = self._env._host(batched.mass_matrix(self._env.model,
                                                self._kin()))
        return M[self._dslice(), self._dslice()]

    @property
    def c(self) -> np.ndarray:
        """Coriolis + gravity bias forces (reference: Skeleton.c, i.e.
        coriolis_and_gravity_forces), dynamics/batched.bias_forces at
        B = 1."""
        from dartenv_tpu_torch.dynamics import batched

        return self._env._host(batched.bias_forces(
            self._env.model, self._kin()))[self._dslice()]

    def com(self) -> np.ndarray:
        """Whole-skeleton world COM (mass-weighted)."""
        from dartenv_tpu_torch.dynamics.algorithms import fk_positions

        env, m = self._env, self._env.model
        R_w, p_w = fk_positions(m, env._state.sim.q)
        bsl = slice(self._b0, self._b0 + self._nb)
        mass = m.host("mass")[bsl]
        coms = (env._host(p_w) + np.einsum(
            "bij,bj->bi", env._host(R_w), m.host("com")))[bsl]
        return (mass[:, None] * coms).sum(0) / mass.sum()

    def bodynode(self, name: str) -> Optional[BodyNode]:
        for b in self.bodynodes:
            if b.name == name:
                return b
        return None


class Contact:
    """One contact record (reference: pydart2 contact.py)."""

    def __init__(self, point, normal, force, depth, bodynode_id):
        self.point = point        # (3,) world
        self.normal = normal      # (3,) world
        self.force = force        # (3,) world contact force on the robot
        self.penetration_depth = depth
        self.bodynode_id = bodynode_id

    @property
    def p(self):
        return self.point

    @property
    def n(self):
        return self.normal

    @property
    def f(self):
        return self.force


class CollisionResult:
    """Last-substep contact manifold (reference: world.collision_result).

    `contacts` lists only ACTIVE slots; forces come from the LCP impulses
    of the most recent do_simulation (impulse / dt, normal direction and
    both tangents)."""

    def __init__(self, contacts: List[Contact]):
        self.contacts = contacts

    def num_contacts(self) -> int:
        return len(self.contacts)


class WorldFacade:
    """Reference: pydart2 World.  Stepping goes through the env, so the
    facade runs the env's own sim step."""

    def __init__(self, env):
        self._env = env
        ranges = getattr(env.model, "skel_ranges", ())
        if ranges:
            # composed multi-skeleton world: one view per source skeleton
            self.skeletons = [
                Skeleton(env, name=nm, body_range=(b0, nb),
                         dof_range=(d0, nd))
                for nm, b0, nb, d0, nd in ranges]
        else:
            self.skeletons = [Skeleton(env)]

    @property
    def dt(self) -> float:
        return float(self._env.model.dt)

    @property
    def time(self) -> float:
        return float(self._env._state.sim.time[0])

    @property
    def gravity(self) -> np.ndarray:
        return self._env.model.host("gravity")

    @property
    def collision_result(self) -> CollisionResult:
        return self._env._collision_result()

    def check_collision(self) -> CollisionResult:
        return self._env._collision_result()

    def step(self):
        """One physics substep with the staged forces (reference:
        world.step())."""
        tau = self._env._staged_tau
        if tau is None:
            tau = np.zeros(self._env.model.n)
        self._env.do_simulation(tau, 1)

    def reset(self):
        m = self._env.model
        self._env.set_state(m.host("q_init"), m.host("dq_init"))
        self._env._staged_tau = None
