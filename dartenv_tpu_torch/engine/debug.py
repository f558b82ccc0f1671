"""Flag-gated debug mode: a checked simulation step.

On the device, the failures that silently corrupt a rollout are NaN state,
contact-cap overflow and a diverging constraint solve.  The checked step
wraps `make_sim_step` and asserts, per env and per substep:

  * q / dq / tau in, q / dq / impulses out all finite (NaN poisoning
    surfaces at the substep that produced it, not 200 steps later as a
    `done` flag);
  * impulse magnitudes below a blow-up bound;
  * no contact-cap overflow (the capped LCP silently drops contacts).

Each check is a (B,) boolean tensor computed on the device; nothing syncs
inside the step.  The returned `CheckError` value is the counterpart of
checkify's error: `err.get()` syncs once and gives the first failing
check's message with the first failing env, or None; `err.throw()` raises
it.  Off the hot path by construction: production code calls
`make_sim_step`; debugging and CI call `make_checked_sim_step`.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from dartenv_tpu_torch.engine.world import SimState, make_sim_step
from dartenv_tpu_torch.model.skel_model import SkelModel

# the messages of the checks, in program order
MSG_Q_IN = "sim_step input: non-finite q"
MSG_DQ_IN = "sim_step input: non-finite dq"
MSG_TAU_IN = "sim_step input: non-finite tau"
MSG_Q_OUT = ("sim_step output: non-finite q (dynamics or integration "
             "produced NaN/inf)")
MSG_DQ_OUT = ("sim_step output: non-finite dq (constraint solve or smooth "
              "dynamics produced NaN/inf)")
MSG_LAM = "LCP impulses non-finite"
MSG_LAM_MAX = "LCP impulse blow-up: |lam| exceeds bound"
MSG_OVERFLOW = ("contact_cap overflow: more active contacts than the LCP "
                "active-set cap; physics silently degraded (raise "
                "SolverConfig.contact_cap)")


class CheckFailed(RuntimeError):
    """Raised by CheckError.throw()."""


class CheckError:
    """The checks of one checked substep: (message, (B,) bool tensor of
    the envs that FAILED it) in program order, still on the device."""

    def __init__(self, checks: List[Tuple[str, torch.Tensor]]):
        self.checks = checks

    def get(self) -> Optional[str]:
        """The first failing check's message and its first failing env
        ("<message> (env i)"), or None when every env passed.  One copy
        from the device."""
        if not self.checks:
            return None
        fails = torch.stack([f for _, f in self.checks]).cpu()
        hit = fails.any(dim=1).nonzero()
        if hit.numel() == 0:
            return None
        c = int(hit[0, 0])
        env = int(fails[c].nonzero()[0, 0])
        return f"{self.checks[c][0]} (env {env})"

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise CheckFailed(msg)


def _not_finite(*xs):
    """(B, len(xs)) True where an env's row of each x (B, n) (all of one
    width) holds a NaN or inf: one stack, one test, one reduction."""
    return ~torch.isfinite(torch.stack(xs, dim=1)).all(dim=2)


def make_checked_sim_step(model: SkelModel, lam_max: float = 1e4,
                          max_overflow: int = 0) -> Callable:
    """Build the checked substep of a batch:
    checked(state, tau, f_ext_world=None, servo_target=None) ->
    (err, (state', contacts)), the arguments and results of
    engine/world.make_sim_step's step with the CheckError `err`."""
    step = make_sim_step(model)

    def checked(state: SimState, tau, f_ext_world=None, servo_target=None):
        bad_in = _not_finite(state.q, state.dq, tau)
        checks = [(MSG_Q_IN, bad_in[:, 0]), (MSG_DQ_IN, bad_in[:, 1]),
                  (MSG_TAU_IN, bad_in[:, 2])]
        new_state, contacts = step(state, tau, f_ext_world, servo_target)
        bad_out = _not_finite(new_state.q, new_state.dq)
        checks += [(MSG_Q_OUT, bad_out[:, 0]), (MSG_DQ_OUT, bad_out[:, 1])]
        if new_state.lam is not None:
            lam = new_state.lam
            checks += [(MSG_LAM, _not_finite(lam)[:, 0]),
                       (MSG_LAM_MAX,
                        ~(lam.abs().amax(dim=1) < lam_max))]
        checks.append((MSG_OVERFLOW, contacts.overflow > max_overflow))
        return CheckError(checks), (new_state, contacts)

    return checked


def checked_rollout(model: SkelModel, state: SimState, taus,
                    **kw) -> SimState:
    """Run a tau sequence (T, B, n) through the checked step, raising a
    located error at the first corrupt substep."""
    checked = make_checked_sim_step(model, **kw)
    for t in range(taus.shape[0]):
        err, (state, _) = checked(state, taus[t])
        err.throw()
    return state
