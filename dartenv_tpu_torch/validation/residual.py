"""The residual harness: one env (B = 1) for 160 substeps under seeded
torques, and the normalized complementarity residual of each LCP that
engine/world.make_lcp_capture captures (the protocol of the JAX package's
PGS residual envelope).

    r = harness_residuals("hopper")            # on the card, float32
    r = harness_residuals("hopper", device="cpu")

Residual metric: max complementarity violation of the boxed LCP at the
solver's own friction-bound fixed point, normalized by the impulse scale.

The batched envelope (scripts/torch_residual_envelope.py, chip_smoke.py
phase envelope) steps the fused path through `make_envelope_substep`:
every env's substep residual, the escalated envs' replaced by the residual
of the point the escalation kept (escalate_batch's with_diag record).
"""
from __future__ import annotations

import numpy as np
import torch

SUBSTEPS = 160
# env -> N m per unit action
HARNESS_TORQUE = {"walker2d": 100.0, "hopper": 200.0, "walker3d": 100.0,
                  "dog": 60.0, "humanwalker": 100.0}
# env -> (median, p95, max) bounds of the JAX package's envelope
JAX_ENVELOPE = {"walker2d": (1e-6, 1e-5, 1e-4), "hopper": (1e-6, 1e-5, 1e-4),
                "walker3d": (1e-5, 1e-4, 5e-3), "dog": (1e-5, 1e-4, 1e-4),
                "humanwalker": (1e-5, 1e-4, 5e-3)}


def comp_residual(A, b, x, lo, hi, findex, mu, active):
    """Max complementarity violation of one boxed LCP (float64 numpy) at
    the friction bounds mu |x[findex]|, over the active rows."""
    lo, hi = lo.copy(), hi.copy()
    fmask = findex >= 0
    if fmask.any():
        bd = mu[fmask] * np.abs(x[findex[fmask]])
        lo[fmask] = np.maximum(lo[fmask], -bd)
        hi[fmask] = np.minimum(hi[fmask], bd)
    w = A @ x + b
    at_lo = x <= lo + 1e-9
    at_hi = x >= hi - 1e-9
    res = np.where(at_lo & at_hi, 0.0,
                   np.where(at_lo, -w, np.where(at_hi, w, np.abs(w))))
    res = np.maximum(res, np.maximum(lo - x, x - hi))
    res = np.where(active > 0.5, res, 0.0)
    return float(res.max(initial=0.0))


def harness_residuals(env, device="cuda"):
    """The normalized residuals of the protocol's LCPs that carry an
    impulse, for `env` (a key of HARNESS_TORQUE) in float32 on `device`.
    Returns (residuals, final SimState)."""
    from dartenv_tpu_torch.engine.world import (
        init_state, make_lcp_capture, make_sim_step,
    )
    from dartenv_tpu_torch.envs.tasks import make_task

    task = make_task(env, dtype=torch.float32, device=device)
    model = task.model
    step, capture = make_sim_step(model), make_lcp_capture(model)
    state = init_state(model, 1, warm_start=True)
    rng = np.random.default_rng(0)
    out = []
    for k in range(SUBSTEPS):
        if k % task.frame_skip == 0:
            a = rng.uniform(-1.0, 1.0, model.n - 3)
            tau = torch.zeros((1, model.n), device=device)
            tau[0, 3:] = torch.as_tensor(a, dtype=torch.float32,
                                         device=device) * HARNESS_TORQUE[env]
        p = capture(state, tau)
        h = {k: v[0].double().cpu().numpy() for k, v in p.items()
             if torch.is_tensor(v)}
        lam = h["lam"]
        if np.abs(lam).max() > 1e-9:
            act = h["active"] > 0.5
            out.append(comp_residual(
                h["A"], h["b"], lam, np.where(act, h["lo"], 0.0),
                np.where(act, h["hi"], 0.0), np.asarray(p["findex"]),
                h["mu"], act.astype(np.float64))
                / max(1.0, np.abs(lam).max()))
        state, _ = step(state, tau)
    return np.asarray(out), state


# percentiles of the batched envelope's records (the JAX package's
# scripts/residual_envelope.py)
ENVELOPE_PCTS = (50.0, 95.0, 99.0, 99.9, 100.0)


def envelope_percentiles(x):
    """ENVELOPE_PCTS of the residuals x (B,), a tensor on x's device."""
    q = torch.tensor(ENVELOPE_PCTS, dtype=x.dtype, device=x.device) / 100.0
    return torch.quantile(x, q)


def make_envelope_substep(model):
    """sub(q, dq, lam, tau) -> (q', dq', lam', diag): one substep of the
    program's fused phase (engine/hopper_substep.make_substep_phase with
    `with_diag`), whose escalation record `diag` (res_pre, idx, envelope)
    it returns.  ValueError for a model the program does not step through
    the fused phase, or one that does not escalate; `sub.st` is the
    phase's static data."""
    from dartenv_tpu_torch.engine.hopper_substep import make_substep_phase

    phase = make_substep_phase(model, with_diag=True)
    if phase is None:
        raise ValueError(f"{model.name}: not a fused-path model")

    def sub(q, dq, lam, tau):
        q_new, dq_plus, lam_full, _, diag = phase(q, dq, lam, tau)
        return q_new, dq_plus, lam_full, diag

    sub.st = phase.st
    return sub
