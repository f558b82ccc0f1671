"""DartWalker2d: planar biped with multi-contact ground interaction.

6 actuated dofs (tau[3:] = a*100), frame_skip 4; obs (17,) =
[q[1:], clip(dq, +-10)]; reward = dx/dt + 1.0 - 1e-3*||a||^2;
done unless 0.8 < height < 2.0 and |pitch| < 1.0.
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.dynamics.algorithms import fk_positions
from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.math.spatial import mv
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle


class Walker2dTask(Task):
    name = "DartWalker2d"
    frame_skip = 4
    obs_size = 17
    control_bounds = np.array([[1.0] * 6, [-1.0] * 6])
    action_scale = 100.0
    reset_noise = 0.005
    torso_body = 0

    def action_to_tau(self, a, aux):
        tau = a.new_zeros((a.shape[0], self.model.n))
        tau[:, 3:] = a * self.action_scale
        return tau

    def obs(self, sim, aux):
        return torch.cat([sim.q[:, 1:], torch.clamp(sim.dq, -10.0, 10.0)],
                         dim=-1)

    def height_pitch(self, sim):
        t = self.torso_body
        R_w, p_w = fk_positions(self.model, sim.q, (t,))
        com_t = p_w[:, 0] + mv(R_w[:, 0], self.model.com[t])
        return com_t[:, 1], sim.q[:, 2]

    def reward(self, sim_prev, sim, a, contacts, aux):
        vel = (sim.q[:, 0] - sim_prev.q[:, 0]) / self.dt
        return vel + 1.0 - 1e-3 * torch.sum(a * a, dim=-1)

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        height, pitch = self.height_pitch(sim)
        ok = (
            torch.all(torch.isfinite(s), dim=-1)
            & torch.all(torch.abs(s[:, 2:]) < 100.0, dim=-1)
            & (height > 0.8)
            & (height < 2.0)
            & (torch.abs(pitch) < 1.0)
        )
        return ~ok


def make_walker2d_task(dtype=torch.float32, lcp_solver=None, device="cuda",
                       **solver_kw) -> Walker2dTask:
    world = parse_skel(asset_path("walker2d.skel"), dtype=dtype,
                       device=device)
    # contact_cap: at most 6 simultaneously active contact slots for this
    # morphology; warm-started PGS with exact escalation of the worst 1/32
    # of envs per substep at a 4 damped + 2 refine pivot budget
    kw = dict(contact_cap=6, pgs_iters=8, escalate_frac=1.0 / 32,
              escalate_tol=1e-5, escalate_iters=4, escalate_refine=2)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return Walker2dTask(with_solver(world.robot, lcp_solver, **kw))


class DartWalker2dEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_walker2d_task(dtype=dtype, device=device))
