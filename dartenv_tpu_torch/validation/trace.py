"""Trace capture and comparison: the parity harness.

`capture_trace` drives one env (a batch of one) substep by substep through
engine/world.make_sim_step on the model's device and dtype, and records
the post-substep (q, dq, lam) as host float64; `compare_traces` diffs two
records.  The `Trace` schema is engine-agnostic, so a trace of another
engine (the JAX package, the reference) plugs in unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Trace:
    """Per-substep record of a driven rollout (host numpy, f64)."""

    q: np.ndarray        # (T, n) post-substep positions
    dq: np.ndarray       # (T, n) post-substep velocities
    lam: np.ndarray      # (T, m) constraint impulses (0 when no solver rows)
    dtype: str = "float64"
    meta: Optional[Dict[str, Any]] = None


def capture_trace(model, q0, dq0, tau_seq) -> Trace:
    """Drive the engine with a (T, n) tau sequence (one tau per SUBSTEP)
    from (q0, dq0) with cold-started solves (no warm-start carry),
    recording post-substep (q, dq, lam).  A Python loop over the substeps
    at B = 1; the records stay on the device until one copy at the end."""
    from dartenv_tpu_torch.engine.constraints import build_layout
    from dartenv_tpu_torch.engine.world import SimState, make_sim_step

    step = make_sim_step(model, return_impulses=True)
    layout = build_layout(model)
    as_t = lambda x: torch.tensor(np.asarray(x, dtype=np.float64),
                                  dtype=model.dtype, device=model.device)
    state = SimState(q=as_t(q0)[None], dq=as_t(dq0)[None],
                     time=model.q_init.new_zeros(1))
    taus = as_t(tau_seq)
    qs, dqs, lams = [], [], []
    for t in range(taus.shape[0]):
        state, (_contacts, lam) = step(state, taus[t][None])
        qs.append(state.q[0])
        dqs.append(state.dq[0])
        lams.append(lam[0])
    host = lambda xs: torch.stack(xs).to("cpu", torch.float64).numpy()
    return Trace(q=host(qs), dq=host(dqs), lam=host(lams),
                 dtype=str(model.dtype).replace("torch.", ""),
                 meta={"n_rows": int(layout.m)})


def compare_traces(a: Trace, b: Trace, atol: float = 1e-9,
                   rtol: float = 1e-7) -> Dict[str, Any]:
    """State-by-state diff.  Returns per-field max abs error, the first
    substep where tolerance is exceeded (-1 = never), and whether discrete
    contact events (lam > 0 pattern) agree."""
    report: Dict[str, Any] = {}
    T = min(a.q.shape[0], b.q.shape[0])
    diverged = -1
    for t in range(T):
        ok = np.allclose(a.q[t], b.q[t], atol=atol, rtol=rtol) and \
            np.allclose(a.dq[t], b.dq[t], atol=atol, rtol=rtol)
        if not ok:
            diverged = t
            break
    report["first_divergence"] = diverged
    report["max_q_err"] = float(np.abs(a.q[:T] - b.q[:T]).max())
    report["max_dq_err"] = float(np.abs(a.dq[:T] - b.dq[:T]).max())
    if a.lam.size and b.lam.size and a.lam.shape == b.lam.shape:
        ev_a = a.lam[:T] > 1e-9
        ev_b = b.lam[:T] > 1e-9
        report["contact_events_match"] = bool((ev_a == ev_b).all())
        report["max_lam_err"] = float(np.abs(a.lam[:T] - b.lam[:T]).max())
    return report


def self_consistency_report(asset: str, T: int = 200, seed: int = 0,
                            tau_scale: float = 1.0,
                            device="cuda") -> Dict[str, Any]:
    """float32-vs-float64 self-consistency for one task asset: the same
    seeded tau sequence through a float64 build on the CPU (the plain
    versions) and a float32 build on `device` (on a GPU, the kernels);
    float32 is held to a per-step tolerance and identical discrete contact
    events rather than bitwise equality."""
    from dartenv_tpu_torch.model.skel_parser import asset_path, parse_skel

    traces = {}
    for dtype, dev in ((torch.float64, "cpu"), (torch.float32, device)):
        model = parse_skel(asset_path(asset), dtype=dtype, device=dev).robot
        n = model.n
        tau = np.random.default_rng(seed).uniform(-tau_scale, tau_scale,
                                                  (T, n))
        traces[dtype] = capture_trace(model, model.host("q_init"),
                                      np.zeros(n), tau)
    # per-step drift is chaotic: a loose rtol, and event agreement
    return {"f32_vs_f64": compare_traces(
        traces[torch.float64], traces[torch.float32], atol=1e-3,
        rtol=1e-2)}
