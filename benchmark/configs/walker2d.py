"""The plain reference of DartWalker2d's task hooks (dart-env's
gym/envs/dart/walker2d.py): tau[3:] = a * 100; obs = [q[1:],
clip(dq, +-10)]; reward = dx/dt + 1 - 1e-3 |a|^2; done unless all finite,
|s[2:]| < 100, 0.8 < torso height < 2 and |pitch| < 1."""
import torch

from benchmark.reference.algorithms import fk_positions
from benchmark.reference.spatial import mv

TORSO = 0


class Context:
    def __init__(self, model, config):
        self.model = model
        self.scale = float(config["action_scale"])
        self.dt = float(model.dt) * int(config["frame_skip"])


def action_to_tau(ctx, a):
    tau = a.new_zeros((a.shape[0], ctx.model.n))
    tau[:, 3:] = a * ctx.scale
    return tau


def obs(ctx, sim):
    return torch.cat([sim.q[:, 1:], torch.clamp(sim.dq, -10.0, 10.0)],
                     dim=-1)


def reward(ctx, prev, sim, a):
    vel = (sim.q[:, 0] - prev.q[:, 0]) / ctx.dt
    return vel + 1.0 - 1e-3 * torch.sum(a * a, dim=-1)


def done(ctx, sim):
    s = torch.cat([sim.q, sim.dq], dim=-1)
    R_w, p_w = fk_positions(ctx.model, sim.q)
    com = p_w[:, TORSO] + mv(R_w[:, TORSO], ctx.model.com[TORSO])
    height, pitch = com[:, 1], sim.q[:, 2]
    ok = (torch.all(torch.isfinite(s), dim=-1)
          & torch.all(torch.abs(s[:, 2:]) < 100.0, dim=-1)
          & (height > 0.8) & (height < 2.0) & (torch.abs(pitch) < 1.0))
    return ~ok
