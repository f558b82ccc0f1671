"""DartSnake7Link: planar 7-link snake slithering on the ground.

PLANAR zx root (ground-plane translation and yaw, passive) + 6 actuated
yaw joints (tau[3:] = a * 10), frame_skip 4; obs (16,) = [q without the
root's translations, clip(dq, +-10)]; reward = dx/dt + 0.1 -
1e-3 ||a||^2; done only on a non-finite state or |s[3:]| >= 100 (a snake
cannot fall).
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle


class Snake7LinkTask(Task):
    name = "DartSnake7Link"
    frame_skip = 4
    obs_size = 16
    control_bounds = np.array([[1.0] * 6, [-1.0] * 6])
    action_scale = 10.0
    reset_noise = 0.005
    # PLANAR zx root: q = [z, x, yaw]; forward progress is the x
    # translation, dof 1
    forward_dof = 1

    def action_to_tau(self, a, aux):
        tau = a.new_zeros((a.shape[0], self.model.n))
        tau[:, 3:] = a * self.action_scale
        return tau

    def obs(self, sim, aux):
        # drop the root translations (z, x); keep yaw and the joint angles
        return torch.cat([sim.q[:, 2:], torch.clamp(sim.dq, -10.0, 10.0)],
                         dim=-1)

    def reward(self, sim_prev, sim, a, contacts, aux):
        d = self.forward_dof
        vel = (sim.q[:, d] - sim_prev.q[:, d]) / self.dt
        return vel + 0.1 - 1e-3 * torch.sum(a * a, dim=-1)

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        return ~(torch.all(torch.isfinite(s), dim=-1)
                 & torch.all(torch.abs(s[:, 3:]) < 100.0, dim=-1))


def make_snake7link_task(dtype=torch.float32, lcp_solver=None,
                         device="cuda", **solver_kw) -> Snake7LinkTask:
    world = parse_skel(asset_path("snake_7link.skel"), dtype=dtype,
                       device=device)
    kw = dict(pgs_iters=10)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return Snake7LinkTask(with_solver(world.robot, lcp_solver, **kw))


class DartSnake7LinkEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_snake7link_task(dtype=dtype, device=device))
