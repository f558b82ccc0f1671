"""DartHopper: planar one-leg hopper with ground contact.

3 actuated dofs (tau[3:] = a*200, root passive), frame_skip 4, sim dt
0.002; obs (11,) = [q[1:], clip(dq, +-10)];
reward = dx/dt + 1.0 alive - 1e-3*||a||^2 - 0.5*joint_limit_penalty
(penalty 1.5 per side when the knee dof is within 0.05 of a limit);
done unless all finite, |s[2:]|<100, height>0.7, |pitch|<0.2.
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.envs.base import DartEnv, with_solver
from dartenv_tpu_torch.envs.walker2d import Walker2dTask
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle


class HopperTask(Walker2dTask):
    name = "DartHopper"
    obs_size = 11
    control_bounds = np.array([[1.0] * 3, [-1.0] * 3])
    action_scale = 200.0
    knee_dof = -2  # second-to-last dof

    def reward(self, sim_prev, sim, a, contacts, aux):
        r = super().reward(sim_prev, sim, a, contacts, aux)
        # joint-limit proximity penalty on the knee
        d = self.knee_dof % self.model.n
        near_lo = (sim.q[:, d] - self.model.q_lower[d]) < 0.05
        near_hi = (self.model.q_upper[d] - sim.q[:, d]) < 0.05
        penalty = 1.5 * (near_lo.to(r.dtype) + near_hi.to(r.dtype))
        return r - 0.5 * penalty

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        height, pitch = self.height_pitch(sim)
        ok = (
            torch.all(torch.isfinite(s), dim=-1)
            & torch.all(torch.abs(s[:, 2:]) < 100.0, dim=-1)
            & (height > 0.7)
            & (torch.abs(pitch) < 0.2)
        )
        return ~ok


def make_hopper_task(dtype=torch.float32, lcp_solver=None, device="cuda",
                     **solver_kw) -> HopperTask:
    world = parse_skel(asset_path("hopper_capsule.skel"), dtype=dtype,
                       device=device)
    # contact_cap: at most 4 simultaneously active contact slots; hopper's
    # degenerate two-point landings are the motivating case for escalation
    kw = dict(contact_cap=4, pgs_iters=10, escalate_frac=1.0 / 32,
              escalate_tol=1e-5, escalate_iters=4, escalate_refine=2)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return HopperTask(with_solver(world.robot, lcp_solver, **kw))


class DartHopperEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_hopper_task(dtype=dtype, device=device))
