"""DartWalker3d: 3D biped walker (free-root pelvis + two six-dof legs).

12 actuated dofs (tau[6:] = a*100, the FREE root passive), frame_skip 4;
obs (35,) = [q without the root's world x, clip(dq, +-10)];
reward = dx/dt + 1.0 - 1e-3*||a||^2; done unless all finite,
|s[6:]| < 100, 0.8 < pelvis COM height < 2.0 and the pelvis upright
(R[1, 1] > 0.5).
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.dynamics.algorithms import fk_positions
from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.math.spatial import mv
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle


class Walker3dTask(Task):
    name = "DartWalker3d"
    frame_skip = 4
    obs_size = 35
    control_bounds = np.array([[1.0] * 12, [-1.0] * 12])
    action_scale = 100.0
    reset_noise = 0.005
    pelvis_body = 0
    forward_dof = 3   # FREE root q = [so3 (3), xyz (3)]: x translation

    def action_to_tau(self, a, aux):
        tau = a.new_zeros((a.shape[0], self.model.n))
        tau[:, 6:] = a * self.action_scale
        return tau

    def obs(self, sim, aux):
        q = torch.cat([sim.q[:, :3], sim.q[:, 4:]], dim=-1)
        return torch.cat([q, torch.clamp(sim.dq, -10.0, 10.0)], dim=-1)

    def pelvis_pose(self, sim):
        """(R (B, 3, 3), COM position (B, 3)) of the pelvis in the world."""
        R_w, p_w = fk_positions(self.model, sim.q)
        b = self.pelvis_body
        return R_w[:, b], p_w[:, b] + mv(R_w[:, b], self.model.com[b])

    def reward(self, sim_prev, sim, a, contacts, aux):
        d = self.forward_dof
        vel = (sim.q[:, d] - sim_prev.q[:, d]) / self.dt
        return vel + 1.0 - 1e-3 * torch.sum(a * a, dim=-1)

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        R, p = self.pelvis_pose(sim)
        upright = R[:, 1, 1]  # world-y component of the pelvis y axis
        ok = (
            torch.all(torch.isfinite(s), dim=-1)
            & torch.all(torch.abs(s[:, 6:]) < 100.0, dim=-1)
            & (p[:, 1] > 0.8) & (p[:, 1] < 2.0)
            & (upright > 0.5)
        )
        return ~ok


def make_walker3d_task(dtype=torch.float32, lcp_solver=None, device="cuda",
                       **solver_kw) -> Walker3dTask:
    world = parse_skel(asset_path("walker3d.skel"), dtype=dtype,
                       device=device)
    # at most 8 simultaneously active contact slots for this morphology;
    # exact escalation of the worst 1/32 at an 8 damped + 2 refine pivot
    # budget
    kw = dict(contact_cap=8, pgs_iters=20, escalate_frac=1.0 / 32,
              escalate_tol=1e-5, escalate_iters=8, escalate_refine=2)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return Walker3dTask(with_solver(world.robot, lcp_solver, **kw))


class DartWalker3dEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_walker3d_task(dtype=dtype, device=device))
