"""DartCartPole and DartCartPoleSwingUp: continuous-force cartpole.

1-dim action, control_bounds +-1, force on the cart x100 (swing-up x40),
frame_skip 2; obs (4,) = [q, dq].  CartPole: reward 1.0 per step, done
when |theta| > 0.2 or |x| > 2.4 or the state is non-finite.  SwingUp: the
pole starts hanging down, reward cos(theta) - 1e-3 ||a||^2, done when
|x| > 2.4 or the state is non-finite.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dartenv_tpu_torch.engine.world import SimState
from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle


class CartPoleTask(Task):
    name = "DartCartPole"
    frame_skip = 2
    obs_size = 4
    control_bounds = np.array([[1.0], [-1.0]])
    action_scale = 100.0
    reset_noise = 0.01

    def action_to_tau(self, a, aux):
        tau = a.new_zeros((a.shape[0], self.model.n))
        tau[:, 0] = a[:, 0] * self.action_scale
        return tau

    def obs(self, sim, aux):
        return torch.cat([sim.q, sim.dq], dim=-1)

    def reward(self, sim_prev, sim, a, contacts, aux):
        return sim.q.new_ones(sim.q.shape[0])

    def done(self, sim, aux):
        finite = torch.all(torch.isfinite(sim.state_vector()), dim=-1)
        return ~(finite & (torch.abs(sim.q[:, 1]) <= 0.2)
                 & (torch.abs(sim.q[:, 0]) <= 2.4))


class CartPoleSwingUpTask(CartPoleTask):
    """Swing-up variant: the pole starts hanging down, cos-based reward."""

    name = "DartCartPoleSwingUp"
    action_scale = 40.0

    def reset_sim(self, batch: int, generator=None, noise=None) -> SimState:
        sim = super().reset_sim(batch, generator, noise)
        q = sim.q.clone()
        q[:, 1] += math.pi
        return SimState(q=q, dq=sim.dq, time=sim.time, lam=sim.lam)

    def np_reset_sim(self, np_random):
        q, dq = super().np_reset_sim(np_random)
        q[1] += np.pi
        return q, dq

    def reward(self, sim_prev, sim, a, contacts, aux):
        return torch.cos(sim.q[:, 1]) - 1e-3 * torch.sum(a * a, dim=-1)

    def done(self, sim, aux):
        finite = torch.all(torch.isfinite(sim.state_vector()), dim=-1)
        return ~(finite & (torch.abs(sim.q[:, 0]) <= 2.4))


def make_cartpole_task(dtype=torch.float32, lcp_solver=None, device="cuda",
                       **solver_kw) -> CartPoleTask:
    world = parse_skel(asset_path("cartpole.skel"), dtype=dtype,
                       device=device)
    return CartPoleTask(with_solver(world.robot, lcp_solver, **solver_kw))


def make_cartpole_swingup_task(dtype=torch.float32, lcp_solver=None,
                               device="cuda", **solver_kw
                               ) -> CartPoleSwingUpTask:
    world = parse_skel(asset_path("cartpole.skel"), dtype=dtype,
                       device=device)
    return CartPoleSwingUpTask(
        with_solver(world.robot, lcp_solver, **solver_kw))


class DartCartPoleEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_cartpole_task(dtype=dtype, device=device))


class DartCartPoleSwingUpEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_cartpole_swingup_task(dtype=dtype, device=device))
