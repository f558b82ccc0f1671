"""DartReacher2d: planar 2-link arm reaching a target in the x-y plane.

Fully actuated (tau = a * 10), frame_skip 4; obs (10,) =
[cos q, sin q, target xy, dq, fingertip - target (xy)];
reward = -||fingertip - target|| - 0.1 ||a||^2; the target is drawn on
reset in the annulus 0.25 <= r <= 0.75 (uniform angle, uniform radius);
episodes end only through the time limit (or a non-finite state).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dartenv_tpu_torch.dynamics.algorithms import body_point_world
from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle

_FINGERTIP_OFFSET = (0.2, 0.0, 0.0)  # in link2 body frame
_TARGET_R_MIN = 0.25
_TARGET_R_MAX = 0.75


class Reacher2dTask(Task):
    name = "DartReacher2d"
    frame_skip = 4
    obs_size = 10
    control_bounds = np.array([[1.0] * 2, [-1.0] * 2])
    action_scale = 10.0
    reset_noise = 0.01

    def fingertip(self, q):
        return body_point_world(self.model, q, 1, _FINGERTIP_OFFSET)[:, :2]

    def action_to_tau(self, a, aux):
        return a * self.action_scale     # fully actuated, n == action dim

    def aux_init(self, batch: int):
        aux = super().aux_init(batch)
        return dict(aux or {}, target=self.model.q_init.new_zeros((batch,
                                                                   2)))

    def aux_reset(self, aux, generator=None):
        """A new target per env from `generator`: an angle uniform in
        [-pi, pi) and a radius uniform in [0.25, 0.75]."""
        m = self.model
        B = aux["target"].shape[0]
        u = torch.rand((B, 2), generator=generator, device=m.device,
                       dtype=m.dtype)
        angle = (2.0 * u[:, 0] - 1.0) * math.pi
        r = _TARGET_R_MIN + (_TARGET_R_MAX - _TARGET_R_MIN) * u[:, 1]
        return dict(aux, target=r[:, None] * torch.stack(
            [torch.cos(angle), torch.sin(angle)], dim=-1))

    def np_reset_aux(self, np_random, aux):
        """The single-env target, in the reference reset_model's draw
        order: rejection-sample a point of the cube [-0.75, 0.75]^2 until it
        lies in the shell 0.25 <= r <= 0.75."""
        while True:
            t = np_random.uniform(low=-_TARGET_R_MAX, high=_TARGET_R_MAX,
                                  size=2)
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
        return (-torch.linalg.vector_norm(vec, dim=-1)
                - 0.1 * torch.sum(a * a, dim=-1))

    def done(self, sim, aux):
        s = torch.cat([sim.q, sim.dq], dim=-1)
        return ~torch.all(torch.isfinite(s), dim=-1)


def make_reacher2d_task(dtype=torch.float32, lcp_solver=None,
                        device="cuda", **solver_kw) -> Reacher2dTask:
    world = parse_skel(asset_path("reacher2d.skel"), dtype=dtype,
                       device=device)
    kw = dict(pgs_iters=10)
    kw.update(solver_kw)           # caller overrides beat the task defaults
    return Reacher2dTask(with_solver(world.robot, lcp_solver, **kw))


class DartReacher2dEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_reacher2d_task(dtype=dtype, device=device))
