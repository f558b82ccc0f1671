"""Task layer: a per-environment bundle of functions (action -> tau, obs,
reward, done, reset) over a SkelModel, and the fused batched env step.

Behavioral invariants (the reference's DartEnv): action clamped to
control_bounds BEFORE scaling; tau applied to the full dof vector with root
dofs zeroed; same tau for every frame_skip substep; reward dt =
sim_dt * frame_skip; termination on the post-step state; reset perturbs
the skel-file default pose.

Everything here is batch-first: hooks take and return (B, ...) tensors.
Not ported yet: the single-env object-oriented `DartEnv` shim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from dartenv_tpu_torch.engine.world import (
    SimState, make_do_simulation, make_sim_step,
)
from dartenv_tpu_torch.model.skel_model import SkelModel


def with_solver(model: SkelModel, lcp_solver: Optional[str] = None,
                **overrides) -> SkelModel:
    """Override SolverConfig fields on a model (task-factory plumbing)."""
    if lcp_solver is not None:
        overrides["solver"] = lcp_solver
    if not overrides:
        return model
    return model.replace(
        solver=dataclasses.replace(model.solver, **overrides))


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Complete state of a batch of envs for the functional path.

    The JAX package's EnvState carries a per-env PRNG `key`; it has no
    counterpart here: randomness comes from an explicit `torch.Generator`
    (or from noise tensors) handed to `reset` / `step`."""

    sim: SimState
    aux: Any         # task-specific tensors (empty tuple when unused)
    steps: Any       # (B,) int32 episode step counter


class Task:
    """Function bundle for one environment family; hooks are batch-first."""

    name: str = "task"
    frame_skip: int = 1
    obs_size: int = 0
    # (2, m): row 0 = upper, row 1 = lower
    control_bounds: np.ndarray = np.zeros((2, 0))
    # reset noise: uniform(-s, s) added to q_init / dq_init
    reset_noise: float = 0.01
    # random external perturbation (the reference DartEnv's
    # add_perturbation / perturbation_parameters = [prob, magnitude,
    # body_id, duration]): per substep, an env not being pushed starts a
    # push with probability `prob`, of `magnitude` N along +-x or +-y on
    # body `body_id`, for `duration` substeps
    add_perturbation: bool = False
    perturbation_parameters = (0.05, 30.0, 0, 40)
    # carry LCP impulses across substeps to warm-start the solver
    warm_start: bool = True

    def __init__(self, model: SkelModel):
        self.model = model
        self._lcp_rows = None

    def lam_init(self, batch: int):
        """Zero LCP-impulse carry enabling warm starts (or None when
        disabled / the model has no constraint rows)."""
        if not self.warm_start:
            return None
        if self._lcp_rows is None:
            from dartenv_tpu_torch.engine.constraints import build_layout
            self._lcp_rows = build_layout(self.model).m
        if self._lcp_rows == 0:
            return None
        return self.model.q_init.new_zeros((batch, self._lcp_rows))

    def action_to_tau(self, a, aux):
        raise NotImplementedError

    def obs(self, sim: SimState, aux):
        raise NotImplementedError

    def reward(self, sim_prev: SimState, sim: SimState, a, contacts, aux):
        raise NotImplementedError

    def done(self, sim: SimState, aux):
        raise NotImplementedError

    def aux_init(self, batch: int):
        """Initial aux of a batch: the perturbation state (force (B, 3) and
        remaining substeps `perturb_ttl` (B,) int32) when perturbations are
        on, else an empty tuple."""
        if self.add_perturbation:
            m = self.model
            return {"perturb_force": m.q_init.new_zeros((batch, 3)),
                    "perturb_ttl": torch.zeros(batch, dtype=torch.int32,
                                               device=m.device)}
        return ()

    def aux_reset(self, aux, generator=None):
        """Task state drawn anew on reset, from `generator` (the reacher's
        target); the default keeps `aux_init`'s."""
        return aux

    def perturb_noise_sample(self, batch: int, generator=None):
        """The perturbation dice of one control step, per substep and env:
        (u (S, B) uniform in [0, 1), axis (S, B) int64 in {0, 1}, sign
        (S, B) in {-1, +1}), S = frame_skip, drawn from `generator`."""
        shape = (self.frame_skip, batch)
        dev = self.model.device
        u = torch.rand(shape, generator=generator, device=dev,
                       dtype=self.model.dtype)
        axis = torch.randint(0, 2, shape, generator=generator, device=dev)
        sign = torch.randint(0, 2, shape, generator=generator,
                             device=dev).to(self.model.dtype) * 2 - 1
        return u, axis, sign

    def reset_noise_sample(self, batch: int, generator=None):
        """(2, B, n) uniform(-s, s) noise for (q, dq), drawn on the model's
        device from `generator` (a torch.Generator on that device)."""
        m = self.model
        u = torch.rand((2, batch, m.n), generator=generator,
                       device=m.device, dtype=m.dtype)
        return (2.0 * u - 1.0) * self.reset_noise

    def reset_sim(self, batch: int, generator=None, noise=None) -> SimState:
        """q, dq = defaults + U(-s, s).  `noise` ((2, B, n), already scaled)
        replaces the draw, so a test can hand the same numbers to another
        implementation."""
        m = self.model
        if noise is None:
            noise = self.reset_noise_sample(batch, generator)
        noise = torch.as_tensor(noise, device=m.device, dtype=m.dtype)
        return SimState(q=m.q_init + noise[0], dq=m.dq_init + noise[1],
                        time=m.q_init.new_zeros(batch),
                        lam=self.lam_init(batch))

    @property
    def dt(self) -> float:
        """Control dt = sim dt * frame_skip."""
        return self.model.dt * self.frame_skip

    @property
    def action_size(self) -> int:
        return self.control_bounds.shape[1]


def make_env_step(task: Task):
    """Fused batched env step: (EnvState, actions (B, m), generator=None,
    perturb_noise=None) -> (EnvState, obs, reward, done, step_info),
    frame_skip substeps inside.

    With `task.add_perturbation` the dice are rolled once per substep (the
    reference's granularity), from `generator` or from `perturb_noise`
    (the (u, axis, sign) of Task.perturb_noise_sample, handed in so a test
    can give another implementation the same numbers), and every substep
    takes the external-force route of the sim step.  step_info holds
    `contact_overflow` (B,) and, with perturbations,
    `perturb_env_share` (frame_skip,): the share of envs pushed in each
    substep."""
    model = task.model
    perturb = task.add_perturbation
    if perturb:
        sub_step = make_sim_step(model)
    else:
        do_sim = make_do_simulation(model, task.frame_skip)
    hi = torch.as_tensor(task.control_bounds[0], dtype=model.dtype,
                         device=model.device)
    lo = torch.as_tensor(task.control_bounds[1], dtype=model.dtype,
                         device=model.device)
    prob, mag, body_id, duration = task.perturbation_parameters

    def perturbed_sim(sim, tau, aux, noise):
        """frame_skip substeps with a per-substep push; returns (sim,
        contacts, aux, the share of envs pushed in each substep)."""
        u, axis, sign = noise
        force, ttl = aux["perturb_force"], aux["perturb_ttl"]
        B = force.shape[0]
        overflow, pushed = None, []
        for k in range(task.frame_skip):
            start = (ttl <= 0) & (u[k] < prob)
            fresh = torch.zeros_like(force).scatter_(
                1, axis[k][:, None], (sign[k] * mag)[:, None])
            live = ttl > 0
            force = torch.where(
                start[:, None], fresh,
                torch.where(live[:, None], force, torch.zeros_like(force)))
            ttl = torch.where(start, torch.full_like(ttl, duration),
                              torch.clamp(ttl - 1, min=0))
            pushed.append(torch.mean((force != 0).any(dim=1).to(
                force.dtype)))
            f_ext = force.new_zeros((B, model.nb, 6))
            f_ext[:, body_id, 3:] = force
            sim, contacts = sub_step(sim, tau, f_ext)
            overflow = (contacts.overflow if overflow is None
                        else torch.maximum(overflow, contacts.overflow))
        contacts = dataclasses.replace(contacts, overflow=overflow)
        return sim, contacts, dict(aux, perturb_force=force,
                                   perturb_ttl=ttl), torch.stack(pushed)

    def env_step(state: EnvState, action, generator=None,
                 perturb_noise=None):
        a = torch.minimum(torch.maximum(action, lo), hi)
        tau = task.action_to_tau(a, state.aux)
        aux = state.aux
        step_info = {}
        if perturb:
            if perturb_noise is None:
                perturb_noise = task.perturb_noise_sample(a.shape[0],
                                                          generator)
            sim_new, contacts, aux, pushed = perturbed_sim(
                state.sim, tau, aux, perturb_noise)
            step_info["perturb_env_share"] = pushed
        else:
            sim_new, contacts = do_sim(state.sim, tau)
        # contact_overflow > 0: the active-set cap dropped contacts
        step_info["contact_overflow"] = contacts.overflow
        obs = task.obs(sim_new, aux)
        reward = task.reward(state.sim, sim_new, a, contacts, aux)
        done = task.done(sim_new, aux)
        new_state = EnvState(sim=sim_new, aux=aux, steps=state.steps + 1)
        return new_state, obs, reward, done, step_info

    return env_step


def make_env_reset(task: Task):
    """Batched reset: (batch, generator=None, noise=None) ->
    (EnvState, obs)."""
    def env_reset(batch: int, generator=None, noise=None):
        aux = task.aux_reset(task.aux_init(batch), generator)
        sim = task.reset_sim(batch, generator, noise)
        state = EnvState(
            sim=sim, aux=aux,
            steps=torch.zeros(batch, dtype=torch.int32,
                              device=task.model.device))
        return state, task.obs(sim, aux)

    return env_reset
