"""The plain reference of DartHumanWalker's task hooks (dart-env's
gym/envs/dart/human_walker.py on the kima humanoid): tau[6:] = a * the
per-dof scales; obs = [q without q[3], clip(dq, +-10)]; reward = 4.5 -
|dx/dt - 1| - 1e-3 |a|^2 with x = q[3]; done unless all finite, the
pelvis height offset q[4] in (-0.35, 0.35) and |q[0]|, |q[2]| < 0.8."""
import torch


class Context:
    def __init__(self, model, config):
        self.model = model
        self.scale = torch.as_tensor(config["action_scale"],
                                     dtype=model.dtype, device=model.device)
        self.dt = float(model.dt) * int(config["frame_skip"])


def action_to_tau(ctx, a):
    tau = a.new_zeros((a.shape[0], ctx.model.n))
    tau[:, 6:] = a * ctx.scale.to(a.dtype)
    return tau


def obs(ctx, sim):
    q_obs = torch.cat([sim.q[:, :3], sim.q[:, 4:]], dim=-1)
    return torch.cat([q_obs, torch.clamp(sim.dq, -10.0, 10.0)], dim=-1)


def reward(ctx, prev, sim, a):
    vel = (sim.q[:, 3] - prev.q[:, 3]) / ctx.dt
    return 4.5 - torch.abs(vel - 1.0) - 1e-3 * torch.sum(a * a, dim=-1)


def done(ctx, sim):
    s = torch.cat([sim.q, sim.dq], dim=-1)
    height, rot = sim.q[:, 4], sim.q[:, :3]
    ok = (torch.all(torch.isfinite(s), dim=-1)
          & (height > -0.35) & (height < 0.35)
          & (torch.abs(rot[:, 0]) < 0.8) & (torch.abs(rot[:, 2]) < 0.8))
    return ~ok
