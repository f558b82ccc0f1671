"""The plain reference of one control step of a batch of envs: the engine
of this folder (dynamics, collision, rows, PGS, the exact escalation, the
position update) under the env layer (action clamp and scale, the
perturbation dice, obs, reward, done, the episode cap, auto-reset).

    ref = RefEnv(config, skel_bytes, task_hooks, device="cuda",
                 dtype=torch.float64)
    out = ref.step(pre, actions, reset_noise, perturb_noise)

`pre` is a dict of the batch's state before the step (q, dq, lam, steps
and, with pushes, perturb_force, perturb_ttl); `out` the same after it,
with obs, reward, done and terminal_obs.  Everything the step derives
(the model, its tables, the solver's tiers) is worked out here from the
.skel bytes and the configuration's solver settings.
"""
from __future__ import annotations

import dataclasses
import io

import numpy as np
import torch

from benchmark.reference import batched
from benchmark.reference.constraints import build_layout, solve_constraints
from benchmark.reference.narrowphase import collide
from benchmark.reference.skel_model import SolverConfig
from benchmark.reference.skel_parser import parse_skel
from benchmark.reference.substep import (
    _SubStatic, escalate_reference, escalation_tiers, in_fused_scope,
    substep_reference,
)


@dataclasses.dataclass(frozen=True)
class Sim:
    q: torch.Tensor
    dq: torch.Tensor


class RefEnv:
    """One configuration's env step in plain PyTorch, in `dtype` on
    `device`.  `hooks` is the configuration's task module (obs, reward,
    done, action_to_tau)."""

    def __init__(self, config, skel_bytes, hooks, device="cuda",
                 dtype=torch.float64, storage=None):
        world = parse_skel(io.BytesIO(skel_bytes), dtype=dtype,
                           device=device)
        model = world.robot.replace(solver=SolverConfig(**config["solver"]))
        self.model, self.hooks, self.config = model, hooks, config
        self.device, self.dtype = device, dtype
        # storage: a lower precision (torch.bfloat16) that every state,
        # input and output is rounded to between substeps (the control)
        self.storage = storage
        self.frame_skip = int(config["frame_skip"])
        self.layout = build_layout(model)
        self.fused = (in_fused_scope(model)
                      and model.solver.solver == "pgs")
        if self.fused:
            self.st = _SubStatic(model)
            self.tiers = escalation_tiers(self.st, model.solver)
        bounds = np.asarray(config["control_bounds"], dtype=np.float64)
        self.hi = torch.as_tensor(bounds[0], dtype=dtype, device=device)
        self.lo = torch.as_tensor(bounds[1], dtype=dtype, device=device)
        self.ctx = hooks.Context(model, config)

    def t(self, x):
        return self.r(x.to(device=self.device, dtype=self.dtype))

    def r(self, x):
        """x rounded to the storage precision, if one is set."""
        if self.storage is None or not x.is_floating_point():
            return x
        return x.to(self.storage).to(self.dtype)

    # -- the engine ------------------------------------------------------
    def substep(self, q, dq, lam, tau, f_ext=None):
        """One substep: the fused composition without an external force
        (as the program runs it), else the phase-wise one with the plain
        dynamics given the force.  Returns (q, dq, lam)."""
        model, dt = self.model, float(self.model.dt)
        if f_ext is None and self.fused:
            outs = substep_reference(model, self.st, q, dq, tau, lam)
            dq_plus, lam_full = outs["dq_plus"], outs["lam_full"]
            if self.tiers[0] is not None:
                dq_plus, lam_full = escalate_reference(
                    self.st, model.solver, outs, dq_plus, lam_full,
                    *self.tiers)[:2]
        else:
            kin = batched.bkin(model, q, dq)
            ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt,
                                              f_ext)
            dq_star = dq + dt * ddq
            contacts = collide(model, kin.R_w, kin.p_w)
            dq_plus, lam_full = solve_constraints(
                model, self.layout, kin.phi, M, q, dq, dq_star, contacts,
                dt, lam_prev=lam)
        q_new = batched.integrate_positions(model, q, dq_plus, dt)
        return self.r(q_new), self.r(dq_plus), self.r(lam_full)

    # -- the env layer ---------------------------------------------------
    def reset(self, noise):
        """The reset state of every env from its (2, B, n) noise."""
        m = self.model
        noise = self.t(noise)
        B = noise.shape[1]
        out = dict(q=m.q_init + noise[0], dq=m.dq_init + noise[1],
                   lam=m.q_init.new_zeros((B, self.layout.m)),
                   steps=torch.zeros(B, dtype=torch.int64,
                                     device=self.device))
        if self.config.get("perturbation") is not None:
            out["perturb_force"] = m.q_init.new_zeros((B, 3))
            out["perturb_ttl"] = torch.zeros(B, dtype=torch.int64,
                                             device=self.device)
        out = {k: self.r(v) for k, v in out.items()}
        out["obs"] = self.r(self.hooks.obs(self.ctx, Sim(out["q"], out["dq"])))
        return out

    def step(self, pre, actions, reset_noise, perturb_noise=None,
             max_episode_steps=None):
        """One control step of the batch from `pre` (see the module
        docstring); perturb_noise: the (u, axis, sign) dice, (S, B) each,
        when the configuration has pushes."""
        m = self.model
        q, dq, lam = self.t(pre["q"]), self.t(pre["dq"]), self.t(pre["lam"])
        a = torch.minimum(torch.maximum(self.t(actions), self.lo), self.hi)
        tau = self.hooks.action_to_tau(self.ctx, a)
        B = q.shape[0]
        out = {}
        push = self.config.get("perturbation")
        if push is not None:
            prob, mag, body_id, duration = push
            u, axis, sign = perturb_noise
            u, sign = self.t(u), self.t(sign)
            force = self.t(pre["perturb_force"])
            ttl = pre["perturb_ttl"].to(self.device, torch.int64)
            for k in range(self.frame_skip):
                start = (ttl <= 0) & (u[k] < prob)
                fresh = torch.zeros_like(force).scatter_(
                    1, axis[k].to(self.device, torch.int64)[:, None],
                    (sign[k] * mag)[:, None])
                force = torch.where(
                    start[:, None], fresh,
                    torch.where((ttl > 0)[:, None], force,
                                torch.zeros_like(force)))
                ttl = torch.where(start, torch.full_like(ttl, duration),
                                  torch.clamp(ttl - 1, min=0))
                f_ext = force.new_zeros((B, m.nb, 6))
                f_ext[:, body_id, 3:] = force
                q, dq, lam = self.substep(q, dq, lam, tau, f_ext)
            out["perturb_force"], out["perturb_ttl"] = force, ttl
        else:
            for _ in range(self.frame_skip):
                q, dq, lam = self.substep(q, dq, lam, tau)
        prev, new = Sim(self.t(pre["q"]), self.t(pre["dq"])), Sim(q, dq)
        obs = self.r(self.hooks.obs(self.ctx, new))
        reward = self.r(self.hooks.reward(self.ctx, prev, new, a))
        done = self.hooks.done(self.ctx, new)
        steps = pre["steps"].to(self.device, torch.int64) + 1
        if max_episode_steps is not None:
            done = done | (steps >= max_episode_steps)
        out.update(q=q, dq=dq, lam=lam, steps=steps, obs=obs, reward=reward,
                   done=done, terminal_obs=obs)
        if reset_noise is not None:
            rs = self.reset(reset_noise)
            for k in rs:
                if k in out:
                    d = done.reshape(done.shape + (1,) * (out[k].ndim - 1))
                    out[k] = torch.where(d, rs[k], out[k])
            out["terminal_obs"] = obs
        return out
