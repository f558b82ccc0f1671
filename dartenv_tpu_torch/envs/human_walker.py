"""DartHumanWalker: full 3D humanoid walking (the "DartHumanoid" of the
baseline configurations).

kima humanoid, 29 dofs (FREE root + 23 actuated, tau[6:] = a * ACTION_SCALE),
frame_skip 15 at dt 0.002; obs (57,) = [q without the forward root
translation q[3] (28), clip(dq, +-10) (29)];
reward = 4.5 alive - |dx/dt - 1.0| - 1e-3 ||a||^2; done unless all
finite, the pelvis height offset q[4] within (-0.35, 0.35) and
|q[0]|, |q[2]| < 0.8.
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle

# actuated dofs 6..29: spine(3), hipR(3), kneeR, ankleR(2),
# hipL(3), kneeL, ankleL(2), shoulderR(3), elbowR, shoulderL(3), elbowL
ACTION_SCALE = np.array(
    [150.0, 100.0, 150.0,
     120.0, 60.0, 160.0, 120.0, 90.0, 40.0,
     120.0, 60.0, 160.0, 120.0, 90.0, 40.0,
     50.0, 30.0, 50.0, 40.0,
     50.0, 30.0, 50.0, 40.0]
)

_TARGET_VEL = 1.0
_ALIVE_BONUS = 4.5


class HumanWalkerTask(Task):
    name = "DartHumanWalker"
    frame_skip = 15
    obs_size = 57
    control_bounds = np.array([[1.0] * 23, [-1.0] * 23])
    reset_noise = 0.005

    def __init__(self, model):
        super().__init__(model)
        self._scale = torch.as_tensor(ACTION_SCALE, dtype=model.dtype,
                                      device=model.device)

    def action_to_tau(self, a, aux):
        tau = a.new_zeros((a.shape[0], self.model.n))
        tau[:, 6:] = a * self._scale
        return tau

    def obs(self, sim, aux):
        q_obs = torch.cat([sim.q[:, :3], sim.q[:, 4:]], dim=-1)
        return torch.cat([q_obs, torch.clamp(sim.dq, -10.0, 10.0)], dim=-1)

    def reward(self, sim_prev, sim, a, contacts, aux):
        vel = (sim.q[:, 3] - sim_prev.q[:, 3]) / self.dt
        energy = 1e-3 * torch.sum(a * a, dim=-1)
        return _ALIVE_BONUS - torch.abs(vel - _TARGET_VEL) - energy

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        height = sim.q[:, 4]   # pelvis height offset (root translation y)
        rot = sim.q[:, :3]
        ok = (
            torch.all(torch.isfinite(s), dim=-1)
            & (height > -0.35) & (height < 0.35)
            & (torch.abs(rot[:, 0]) < 0.8)
            & (torch.abs(rot[:, 2]) < 0.8)
        )
        return ~ok


def make_humanwalker_task(dtype=torch.float32, lcp_solver=None,
                          device="cuda", **solver_kw) -> HumanWalkerTask:
    world = parse_skel(asset_path("kima_humanwalker.skel"), dtype=dtype,
                       device=device)
    # the 8 foot-capsule slots capped at 6, 15 warm PGS sweeps, and exact
    # escalation of the worst 1/8 (K = 128 at B = 1024): a warm 16-pivot
    # tier 1 and two compensated (double-float) refinement passes
    kw = dict(contact_cap=6, pgs_iters=15, escalate_frac=1.0 / 8,
              escalate_tol=1e-5, escalate_iters=16, escalate_ref=2)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return HumanWalkerTask(with_solver(world.robot, lcp_solver, **kw))


class DartHumanWalkerEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_humanwalker_task(dtype=dtype, device=device))
