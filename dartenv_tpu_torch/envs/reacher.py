"""DartReacher: 3D 5-dof arm reaching a target sphere.

Fully actuated (tau = a * 10), frame_skip 4; obs (21,) =
[cos q, sin q, target xyz, dq, fingertip - target];
reward = -||fingertip - target|| - 0.1 ||a||^2; the target is drawn on
reset in the shell 0.25 <= r <= 0.75 (uniform direction, uniform radius);
episodes end only through the time limit (or a non-finite state).
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.dynamics.algorithms import body_point_world
from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle

_FINGERTIP_OFFSET = (0.2, 0.0, 0.0)  # in link2 body frame
_TARGET_R_MIN = 0.25
_TARGET_R_MAX = 0.75


class ReacherTask(Task):
    name = "DartReacher"
    frame_skip = 4
    obs_size = 21
    control_bounds = np.array([[1.0] * 5, [-1.0] * 5])
    action_scale = 10.0
    reset_noise = 0.01

    def fingertip(self, q):
        return body_point_world(self.model, q, 1, _FINGERTIP_OFFSET)

    def action_to_tau(self, a, aux):
        return a * self.action_scale     # fully actuated, n == action dim

    def aux_init(self, batch: int):
        aux = super().aux_init(batch)
        return dict(aux or {}, target=self.model.q_init.new_zeros((batch,
                                                                   3)))

    def aux_reset(self, aux, generator=None):
        """A new target per env from `generator`: a normal direction,
        normalized, times a radius uniform in [0.25, 0.75]."""
        m = self.model
        B = aux["target"].shape[0]
        d = torch.randn((B, 3), generator=generator, device=m.device,
                        dtype=m.dtype)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True),
                            min=1e-9)
        r = torch.rand((B, 1), generator=generator, device=m.device,
                       dtype=m.dtype)
        r = _TARGET_R_MIN + (_TARGET_R_MAX - _TARGET_R_MIN) * r
        return dict(aux, target=d * r)

    def np_reset_aux(self, np_random, aux):
        """The single-env target, in the reference reset_model's draw
        order: rejection-sample a point of the cube [-0.75, 0.75]^3 until it
        lies in the shell 0.25 <= r <= 0.75."""
        while True:
            t = np_random.uniform(low=-_TARGET_R_MAX, high=_TARGET_R_MAX,
                                  size=3)
            if _TARGET_R_MIN <= np.linalg.norm(t) <= _TARGET_R_MAX:
                break
        return dict(aux, target=torch.as_tensor(
            t[None], dtype=self.model.dtype, device=self.model.device))

    def obs(self, sim, aux):
        target = aux["target"]
        vec = self.fingertip(sim.q) - target
        return torch.cat([torch.cos(sim.q), torch.sin(sim.q), target,
                          sim.dq, vec], dim=-1)

    def reward(self, sim_prev, sim, a, contacts, aux):
        vec = self.fingertip(sim.q) - aux["target"]
        reward_dist = -torch.linalg.vector_norm(vec, dim=-1)
        reward_ctrl = -0.1 * torch.sum(a * a, dim=-1)
        return reward_dist + reward_ctrl

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        return ~torch.all(torch.isfinite(s), dim=-1)


def make_reacher_task(dtype=torch.float32, lcp_solver=None, device="cuda",
                      **solver_kw) -> ReacherTask:
    world = parse_skel(asset_path("reacher.skel"), dtype=dtype,
                       device=device)
    # 5 joint-limit rows and no contact: 10 PGS sweeps on the small SPD
    # operator, no escalation
    kw = dict(pgs_iters=10)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return ReacherTask(with_solver(world.robot, lcp_solver, **kw))


class DartReacherEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_reacher_task(dtype=dtype, device=device))
