"""Task layer: a per-environment bundle of functions (action -> tau, obs,
reward, done, reset) over a SkelModel, and the fused batched env step.

Behavioral invariants (the reference's DartEnv): action clamped to
control_bounds BEFORE scaling; tau applied to the full dof vector with root
dofs zeroed; same tau for every frame_skip substep; reward dt =
sim_dt * frame_skip; termination on the post-step state; reset perturbs
the skel-file default pose.

Everything here is batch-first: hooks take and return (B, ...) tensors.
Not ported yet: the random-perturbation branch of the env step and the
single-env object-oriented `DartEnv` shim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from dartenv_tpu_torch.engine.world import SimState, make_do_simulation
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
    add_perturbation: bool = False
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
        return ()

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
    """Fused batched env step: (EnvState, actions (B, m)) ->
    (EnvState, obs, reward, done, step_info), frame_skip substeps inside."""
    if task.add_perturbation:
        raise NotImplementedError(
            "the random-perturbation branch of the env step is not ported "
            "yet")
    model = task.model
    do_sim = make_do_simulation(model, task.frame_skip)
    hi = torch.as_tensor(task.control_bounds[0], dtype=model.dtype,
                         device=model.device)
    lo = torch.as_tensor(task.control_bounds[1], dtype=model.dtype,
                         device=model.device)

    def env_step(state: EnvState, action):
        a = torch.minimum(torch.maximum(action, lo), hi)
        tau = task.action_to_tau(a, state.aux)
        sim_new, contacts = do_sim(state.sim, tau)
        obs = task.obs(sim_new, state.aux)
        reward = task.reward(state.sim, sim_new, a, contacts, state.aux)
        done = task.done(sim_new, state.aux)
        new_state = EnvState(sim=sim_new, aux=state.aux,
                             steps=state.steps + 1)
        # contact_overflow > 0: the active-set cap dropped contacts
        step_info = {"contact_overflow": contacts.overflow}
        return new_state, obs, reward, done, step_info

    return env_step


def make_env_reset(task: Task):
    """Batched reset: (batch, generator=None, noise=None) ->
    (EnvState, obs)."""
    def env_reset(batch: int, generator=None, noise=None):
        aux = task.aux_init(batch)
        sim = task.reset_sim(batch, generator, noise)
        state = EnvState(
            sim=sim, aux=aux,
            steps=torch.zeros(batch, dtype=torch.int32,
                              device=task.model.device))
        return state, task.obs(sim, aux)

    return env_reset
