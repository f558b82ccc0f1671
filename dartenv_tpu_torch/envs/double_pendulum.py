"""DartDoubleInvertedPendulum: cart with a two-link pole.

1-dim action scaled x40, frame_skip 2; obs (8,) =
[x, sin th1, sin th2, cos th1, cos th2, dq]; reward = 10 alive bonus -
tip-distance penalty - velocity penalty; done when the tip drops below
half its upright height or the state goes non-finite.
"""
from __future__ import annotations

import numpy as np
import torch

from dartenv_tpu_torch.dynamics.algorithms import body_point_world
from dartenv_tpu_torch.envs.base import DartEnv, Task, with_solver
from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel
from dartenv_tpu_torch.utils.ezpickle import EzPickle

# pole half-length: the tip is this far above pole2's origin (see asset)
_TIP_OFFSET = (0.0, 0.3, 0.0)
_UPRIGHT_TIP_Y = 1.2  # world tip height with both links upright (see asset)


class DoubleInvertedPendulumTask(Task):
    name = "DartDoubleInvertedPendulum"
    frame_skip = 2
    obs_size = 8
    control_bounds = np.array([[1.0], [-1.0]])
    action_scale = 40.0
    reset_noise = 0.01

    def action_to_tau(self, a, aux):
        tau = a.new_zeros((a.shape[0], self.model.n))
        tau[:, 0] = a[:, 0] * self.action_scale
        return tau

    def _tip(self, sim):
        return body_point_world(self.model, sim.q, self.model.nb - 1,
                                _TIP_OFFSET)

    def obs(self, sim, aux):
        q = sim.q
        return torch.cat([q[:, :1], torch.sin(q[:, 1:]), torch.cos(q[:, 1:]),
                          sim.dq], dim=-1)

    def reward(self, sim_prev, sim, a, contacts, aux):
        tip = self._tip(sim)
        dist2 = tip[:, 0] ** 2 + (tip[:, 1] - _UPRIGHT_TIP_Y) ** 2
        v1, v2 = sim.dq[:, 1], sim.dq[:, 2]
        return 10.0 - 0.01 * dist2 - 1e-3 * v1 * v1 - 5e-3 * v2 * v2

    def done(self, sim, aux):
        finite = torch.all(torch.isfinite(sim.state_vector()), dim=-1)
        return ~(finite & (self._tip(sim)[:, 1] > 0.5 * _UPRIGHT_TIP_Y))


def make_double_pendulum_task(dtype=torch.float32, lcp_solver=None,
                              device="cuda", **solver_kw
                              ) -> DoubleInvertedPendulumTask:
    world = parse_skel(asset_path("doublependulum.skel"), dtype=dtype,
                       device=device)
    return DoubleInvertedPendulumTask(
        with_solver(world.robot, lcp_solver, **solver_kw))


class DartDoubleInvertedPendulumEnv(DartEnv, EzPickle):
    def __init__(self, device="cuda", dtype=torch.float32):
        EzPickle.__init__(self, device=device, dtype=dtype)
        super().__init__(make_double_pendulum_task(dtype=dtype, device=device))
