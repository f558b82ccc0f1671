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
CUDA batch); other models (self and cross-skeleton pairs, servo rows,
cylinder / ellipsoid / mesh geoms), the solver="dantzig" mode, and every
step given an external force or a servo target, run the phase-wise
composition below: step 1-2 through
dynamics/hopper_dynamics.make_dynamics_phase (the dynamics kernel on a
float32 CUDA batch) unless an external force is given, which takes the
plain dynamics/batched path; step 4 through
engine/constraints.solve_constraints (on a float32 CUDA batch the PGS
kernel and the BPP kernel for escalation, or in the "dantzig" mode the
BPP kernel over the whole batch); step 5, on either path, through
dynamics/hopper_integrate.integrate (the position-update kernel on a
float32 CUDA batch of a model with a BALL or FREE joint).

The phases run inside spans (utils/span.py: torch.profiler
record_function ranges while a profiler runs, nothing otherwise) named
as the JAX package's named scopes, so a profile attributes each launch
to its phase:

  substep_fused       the fused phase: kernel 1, the Contacts assembly
    constraints         in it, escalate_batch (top K, kernel 2 fused)
    integrate           in it, the position update
  substep_fused_dr    the fused phase of a randomized batch, split alike
  dynamics            phase-wise steps 1-2
  collision           phase-wise step 3
  constraints         phase-wise step 4
  integrate           phase-wise step 5

Around them, outside the engine: `env.step`, `env.action`, `env.push`,
`env.obs`, `env.reward`, `env.done`, `env.reset` (parallel/vec_env.py,
envs/base.make_env_step) and `gym.step`, `gym.host_copy`, `gym.reset`
(envs/base.DartEnv).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from dartenv_tpu_torch.collision.narrowphase import collide
from dartenv_tpu_torch.dynamics import batched, hopper_integrate
from dartenv_tpu_torch.dynamics.hopper_dynamics import make_dynamics_phase
from dartenv_tpu_torch.engine.constraints import (
    build_layout, solve_constraints, solve_lcp,
)
from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase
from dartenv_tpu_torch.model.skel_model import SkelModel
from dartenv_tpu_torch.utils.span import span


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


def phasewise_substep(model: SkelModel, layout, state: SimState, tau,
                      dyn=None, f_ext_world=None, servo_target=None):
    """Steps 1-5 of one substep as separate phases: the dynamics phase
    `dyn(q, dq, tau)` (or, when dyn is None, the plain dynamics/batched
    path with the external force `f_ext_world`), collision,
    solve_constraints (with the servo commands `servo_target`, (B, n) or
    None), the position update.  `model` may carry per-env leaves
    (domain randomization) that the plain stages read.  Returns
    (q_new, dq_plus, lam, Contacts)."""
    q, dq, dt = state.q, state.dq, model.dt
    with span("dynamics"):
        if dyn is not None:
            dq_star, M, phi, R_w, p_w = dyn(q, dq, tau)
        else:
            kin = batched.bkin(model, q, dq)
            ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt,
                                              f_ext_world)
            dq_star = dq + dt * ddq
            phi, R_w, p_w = kin.phi, kin.R_w, kin.p_w
    with span("collision"):
        contacts = collide(model, R_w, p_w)
    with span("constraints"):
        dq_plus, lam = solve_constraints(
            model, layout, phi, M, q, dq, dq_star, contacts, dt,
            lam_prev=state.lam, servo_target=servo_target)
    with span("integrate"):
        q_new = hopper_integrate.integrate(model, q, dq_plus, dt)
    return q_new, dq_plus, lam, contacts


def _lam_prev(state: SimState, m: int):
    """A substep's warm start: the carried impulses, or zeros (B, m) when
    the state does not warm-start."""
    if state.lam is not None:
        return state.lam
    return state.q.new_zeros((state.q.shape[0], m))


def _advance(state: SimState, dt, q_new, dq_plus, lam, contacts,
             return_impulses: bool = False):
    """(state', out) after a substep: lam carried only where the state
    warm-starts; out is the Contacts, or (Contacts, lam) with
    `return_impulses`."""
    out = (contacts, lam) if return_impulses else contacts
    lam_carry = lam if state.lam is not None else None
    return SimState(q=q_new, dq=dq_plus, time=state.time + dt,
                    lam=lam_carry), out


def make_sim_step(model: SkelModel, return_impulses: bool = False
                  ) -> Callable:
    """Build the single-substep function of a model:
    step(state, tau, f_ext_world=None, servo_target=None) -> (state',
    Contacts), or (state', (Contacts, lam)) with `return_impulses`.
    tau: (B, n) generalized forces; f_ext_world: optional (B, nb, 6)
    [torque; force] in world coordinates at each body origin;
    servo_target: optional (B, n) commanded dof velocities of the servo
    rows (None: zero commands).  A step given either takes the phase-wise
    path; only an external force bypasses the dynamics phase."""
    layout = build_layout(model)
    hopper_integrate.prepare(model)
    sub_phase = make_substep_phase(model)
    dyn_phase = make_dynamics_phase(model)

    def step(state: SimState, tau, f_ext_world=None, servo_target=None):
        if (sub_phase is not None and f_ext_world is None
                and servo_target is None):
            with span("substep_fused"):
                res = sub_phase(state.q, state.dq,
                                _lam_prev(state, layout.m), tau)
        else:
            dyn = dyn_phase if f_ext_world is None else None
            res = phasewise_substep(model, layout, state, tau, dyn,
                                    f_ext_world, servo_target)
        return _advance(state, model.dt, *res, return_impulses)

    return step


def make_dr_sim_step(model: SkelModel, dr_fields,
                     return_impulses: bool = False) -> Optional[Callable]:
    """The fused-path sim step of a domain-randomized batch:
    step(state, tau, dr_vals) -> (state', Contacts), or (state',
    (Contacts, lam)) with `return_impulses`; dr_vals is a tuple of the
    per-env values of the `dr_fields` leaves ((B, ...) tensors, in that
    order).  `model` is the base model (every static structure, and the
    values of the leaves that are not randomized).  A float32 CUDA batch
    runs the substep kernel with the DR leaves as per-env inputs, then the
    escalation kernel's fused mode and the position update; a CPU or
    float64 batch runs their plain versions on the per-env model.  None
    when the fused path cannot serve the model or a field is outside
    hopper_substep.DR_FIELDS_SUB (the caller keeps the phase-wise path)."""
    sub_phase = make_substep_phase(model, dr_fields=tuple(dr_fields))
    if sub_phase is None:
        return None
    m = build_layout(model).m

    def step(state: SimState, tau, dr_vals):
        lam_prev = _lam_prev(state, m)
        with span("substep_fused_dr"):
            res = sub_phase(state.q, state.dq, lam_prev, tau, *dr_vals)
        return _advance(state, model.dt, *res, return_impulses)

    return step


def make_lcp_capture(model: SkelModel) -> Callable:
    """Validation hook: capture(state, tau) -> dict with the exact boxed
    LCPs of a batch's substep as the solver sees them (after the active-set
    compaction), and the engine's own solution: A (B, m, m), b, lo, hi,
    active, mu (B, m), findex (m,) numpy, lam (B, m), dq_star and dq_plus
    (B, n).  The LCPs are built from the plain dynamics; `lam` comes from
    engine/constraints.solve_lcp, the production solve (on a float32
    CUDA batch the PGS kernel and the BPP kernel's hybrid mode, or its
    core mode in the "dantzig" mode)."""
    layout = build_layout(model)
    dt = model.dt

    def capture(state: SimState, tau):
        q, dq = state.q, state.dq
        kin = batched.bkin(model, q, dq)
        ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt, None)
        dq_star = dq + dt * ddq
        contacts = collide(model, kin.R_w, kin.p_w)
        dq_plus, lam, lcp = solve_lcp(model, layout, kin.phi, M, q, dq,
                                      dq_star, contacts, dt, state.lam)
        A, b, lo, hi, active, mu, findex = lcp[:7]
        return dict(A=A, b=b, lo=lo, hi=hi, active=active, mu=mu,
                    findex=findex, lam=lam, dq_star=dq_star,
                    dq_plus=dq_plus)

    return capture


def make_do_simulation(model: SkelModel, frame_skip: int,
                       return_impulses: bool = False) -> Callable:
    """frame_skip substeps with the same tau (and the same external force
    and servo target, if any).  The returned contacts are the last
    substep's, with `overflow` the max over the substeps (the last substep
    alone could mask a mid-step overflow)."""
    step = make_sim_step(model, return_impulses=return_impulses)

    def do_sim(state: SimState, tau, f_ext_world=None, servo_target=None):
        overflow = None
        for _ in range(frame_skip):
            state, out = step(state, tau, f_ext_world, servo_target)
            c = out[0] if return_impulses else out
            overflow = (c.overflow if overflow is None
                        else torch.maximum(overflow, c.overflow))
        contacts = dataclasses.replace(c, overflow=overflow)
        out = (contacts, out[1]) if return_impulses else contacts
        return state, out

    return do_sim
