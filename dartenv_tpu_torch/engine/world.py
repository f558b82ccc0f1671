"""The simulation step of a batch of envs.

Op order of one substep (the reference engine's World::step):

  1. smooth forward dynamics (implicit spring/damping)
  2. integrate velocities        dq* = dq + dt * ddq
  3. collision detection at the *current* positions
  4. constraint solve (contacts + joint limits) -> impulses -> dq+
  5. integrate positions with dq+ (exp-map for ball/free joints)
  6. time += dt

Models inside the fused path's scope run steps 1-5 through
engine/hopper_substep.make_substep_phase (the CUDA kernels on a float32
CUDA batch); other models run the phase-wise composition below.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from dartenv_tpu_torch.collision.narrowphase import collide
from dartenv_tpu_torch.dynamics import batched
from dartenv_tpu_torch.engine.constraints import (
    build_layout, solve_constraints,
)
from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase
from dartenv_tpu_torch.model.skel_model import SkelModel


@dataclasses.dataclass(frozen=True)
class SimState:
    """Full simulation state of a batch: q, dq (B, n), time (B,), and the
    previous substep's LCP impulses lam (B, m) for warm starts (None
    disables warm starting)."""

    q: Any
    dq: Any
    time: Any
    lam: Any = None

    def state_vector(self):
        """concat(q, dq) per env."""
        return torch.cat([self.q, self.dq], dim=-1)


def init_state(model: SkelModel, batch: int, warm_start: bool = True
               ) -> SimState:
    """The model's default pose, repeated `batch` times, on the model's
    device and dtype."""
    q = model.q_init.expand(batch, -1).clone()
    dq = model.dq_init.expand(batch, -1).clone()
    lam = None
    if warm_start:
        lam = q.new_zeros((batch, build_layout(model).m))
    return SimState(q=q, dq=dq, time=q.new_zeros(batch), lam=lam)


def make_sim_step(model: SkelModel, return_impulses: bool = False
                  ) -> Callable:
    """Build the single-substep function of a model:
    step(state, tau) -> (state', Contacts), or (state', (Contacts, lam))
    with `return_impulses`.  tau: (B, n) generalized forces."""
    layout = build_layout(model)
    dt = model.dt
    sub_phase = make_substep_phase(model)

    def step(state: SimState, tau):
        q, dq = state.q, state.dq
        if sub_phase is not None:
            lam_prev = (state.lam if state.lam is not None
                        else q.new_zeros((q.shape[0], layout.m)))
            q_new, dq_plus, lam, contacts = sub_phase(q, dq, lam_prev, tau)
        else:
            kin = batched.bkin(model, q, dq)
            ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt)
            dq_star = dq + dt * ddq
            contacts = collide(model, kin.R_w, kin.p_w)
            dq_plus, lam = solve_constraints(
                model, layout, kin.phi, M, q, dq, dq_star, contacts, dt,
                lam_prev=state.lam)
            q_new = batched.integrate_positions(model, q, dq_plus, dt)
        out = (contacts, lam) if return_impulses else contacts
        lam_carry = lam if state.lam is not None else None
        return SimState(q=q_new, dq=dq_plus, time=state.time + dt,
                        lam=lam_carry), out

    return step


def make_do_simulation(model: SkelModel, frame_skip: int,
                       return_impulses: bool = False) -> Callable:
    """frame_skip substeps with the same tau.  The returned contacts are
    the last substep's, with `overflow` the max over the substeps (the
    last substep alone could mask a mid-step overflow)."""
    step = make_sim_step(model, return_impulses=return_impulses)

    def do_sim(state: SimState, tau):
        overflow = None
        for _ in range(frame_skip):
            state, out = step(state, tau)
            c = out[0] if return_impulses else out
            overflow = (c.overflow if overflow is None
                        else torch.maximum(overflow, c.overflow))
        contacts = dataclasses.replace(c, overflow=overflow)
        out = (contacts, out[1]) if return_impulses else contacts
        return state, out

    return do_sim
