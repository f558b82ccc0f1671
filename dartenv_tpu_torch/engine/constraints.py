"""Constraint assembly: contacts + joint limits + joint Coulomb friction
-> one boxed LCP per env, batch-first.

Row semantics (ODE-style rows, as in the JAX package's
engine/constraints.py):
* contact normal row: lam >= 0, target velocity =
    max(restitution * (-v_n), erp * max(depth - allowance, 0)/dt capped at
    max_erv);
* two friction rows per contact with findex coupling (friction pyramid),
  tangents from a deterministic basis of the normal;
* joint-limit row per limited dof, sign-flipped into ">=0, lam>=0" form,
  activated on violation;
* Coulomb joint-friction row per dof with dof_friction > 0:
  |impulse| <= friction_force * dt.
Servo-motor rows are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dartenv_tpu_torch.collision.narrowphase import (
    Contacts, slot_layout, topk_stable,
)
from dartenv_tpu_torch.lcp.pgs import pgs_solve
from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.math.linalg import (
    _UNROLL_MAX, _pmm, chol, chol_solve, inv_psd,
)
from dartenv_tpu_torch.model.skel_model import SkelModel


def tangent_basis(n):
    """Deterministic tangent frame for unit normals n (..., 3)."""
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(n)
    ez[..., 2] = 1.0
    ref = torch.where(torch.abs(n[..., :1]) < 0.9, ex, ez)
    t1 = sp.cross(n, ref)
    t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True)
    t2 = sp.cross(n, t1)
    return t1, t2


@dataclasses.dataclass(frozen=True)
class RowLayout:
    """Static structure of the LCP (host-side, built once per model).

    Row order: [3 per contact slot (n, t1, t2)] ++ [limit rows] ++
    [dof friction rows].
    """

    m: int
    contact_slots: int
    limit_dofs: tuple
    friction_dofs: tuple
    findex: np.ndarray       # (m,)
    slot_body: tuple         # body_a per slot
    slot_mask: np.ndarray    # (ns, n) ancestor mask of each slot's body
    lim_onehot: np.ndarray   # (nl, n)
    fr_onehot: np.ndarray    # (nf, n)


def has_servo_rows(model: SkelModel) -> bool:
    return (model.servo_flimit is not None
            and model.servo_flimit.numel() > 0
            and float(model.servo_flimit.max()) > 0.0)


def build_layout(model: SkelModel) -> RowLayout:
    if has_servo_rows(model):
        raise NotImplementedError("servo-motor rows are not ported yet")
    slot_body, _slot_body_b, _ = slot_layout(model)
    ns = len(slot_body)
    n = model.n
    limit_dofs = tuple(int(d) for d in
                       np.nonzero(model.host("limited") > 0.5)[0])
    friction_dofs = tuple(int(d) for d in
                          np.nonzero(model.host("dof_friction") > 0.0)[0])
    m = 3 * ns + len(limit_dofs) + len(friction_dofs)
    findex = -np.ones(m, dtype=np.int64)
    for s in range(ns):
        findex[3 * s + 1] = 3 * s
        findex[3 * s + 2] = 3 * s
    amask = model.host("ancestor_mask")
    slot_mask = (amask[np.asarray(slot_body, dtype=np.int64)].copy()
                 if ns else np.zeros((0, n)))
    lim_onehot = np.zeros((len(limit_dofs), n))
    for i, d in enumerate(limit_dofs):
        lim_onehot[i, d] = 1.0
    fr_onehot = np.zeros((len(friction_dofs), n))
    for i, d in enumerate(friction_dofs):
        fr_onehot[i, d] = 1.0
    return RowLayout(
        m=m, contact_slots=ns, limit_dofs=limit_dofs,
        friction_dofs=friction_dofs, findex=findex, slot_body=slot_body,
        slot_mask=slot_mask, lim_onehot=lim_onehot, fr_onehot=fr_onehot,
    )


def compacted_findex(layout: RowLayout, cap: int) -> np.ndarray:
    """Static findex of the compacted row stack: (n, t1, t2) blocks for
    the `cap` kept slots, then the plain tail."""
    n_tail = layout.m - 3 * layout.contact_slots
    return np.concatenate([
        np.stack([-np.ones(cap, np.int64), 3 * np.arange(cap),
                  3 * np.arange(cap)], axis=1).reshape(-1),
        -np.ones(n_tail, np.int64),
    ])


def assemble_rows(model: SkelModel, layout: RowLayout, phi, q,
                  dq_before, dq_star, contacts: Contacts, dt):
    """(J (B, m, n), b, lo, hi, active, mu (B, m)) for the full row stack."""
    n = model.n
    B = dq_star.shape[0]
    dtype, device = dq_star.dtype, dq_star.device
    cfg = model.solver
    big = 1e20
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    Js, bs, los, his, acts, mus = [], [], [], [], [], []

    ns = layout.contact_slots
    if ns:
        w_cols, v_cols = phi[..., :3], phi[..., 3:]          # (B, n, 3)
        p = contacts.pos                                     # (B, ns, 3)
        mask = t(layout.slot_mask)                           # (ns, n)
        cols = (v_cols[:, None, :, :]
                + sp.cross(w_cols[:, None, :, :].expand(B, ns, n, 3),
                           p[:, :, None, :].expand(B, ns, n, 3))
                ) * mask[:, :, None]
        nrm = contacts.normal
        t1, t2 = tangent_basis(nrm)
        D = torch.stack([nrm, t1, t2], dim=2)                # (B, ns, 3, 3)
        Jc = torch.sum(D[:, :, :, None, :] * cols[:, :, None, :, :],
                       dim=-1)                               # (B, ns, 3, n)
        v_star = torch.sum(Jc * dq_star[:, None, None, :], dim=-1)
        v_n_before = torch.sum(Jc[:, :, 0, :] * dq_before[:, None, :],
                               dim=-1)
        bounce = contacts.restitution * torch.clamp(-v_n_before, min=0.0)
        erp_push = torch.clamp(
            cfg.erp * torch.clamp(contacts.depth - cfg.allowance, min=0.0)
            / dt,
            max=cfg.max_erv)
        desired = torch.maximum(bounce, erp_push)
        b_c = torch.cat([v_star[..., :1] - desired[..., None],
                         v_star[..., 1:]], dim=-1).reshape(B, 3 * ns)
        zf = torch.zeros_like(contacts.friction)
        Js.append(Jc.reshape(B, 3 * ns, n))
        bs.append(b_c)
        los.append((t([0.0, -1.0, -1.0]) * big).repeat(ns).expand(B, -1))
        his.append(torch.full((B, 3 * ns), big, dtype=dtype, device=device))
        acts.append(contacts.active.repeat_interleave(3, dim=1))
        mus.append(torch.stack([zf, contacts.friction, contacts.friction],
                               dim=2).reshape(B, 3 * ns))

    nl = len(layout.limit_dofs)
    if nl:
        ld = list(layout.limit_dofs)
        lo_v = model.q_lower[ld] - q[:, ld]
        hi_v = q[:, ld] - model.q_upper[ld]
        high_active = hi_v > 0.0
        active_l = ((lo_v > 0.0) | high_active).to(dtype) * model.limited[ld]
        sign = torch.where(high_active, -1.0, 1.0).to(dtype)
        viol = torch.clamp(torch.maximum(lo_v, hi_v), min=0.0)
        target = torch.clamp(cfg.joint_erp * viol / dt, max=cfg.max_erv)
        Js.append(sign[:, :, None] * t(layout.lim_onehot))
        bs.append(sign * dq_star[:, ld] - target)
        los.append(torch.zeros((B, nl), dtype=dtype, device=device))
        his.append(torch.full((B, nl), big, dtype=dtype, device=device))
        acts.append(active_l)
        mus.append(torch.zeros((B, nl), dtype=dtype, device=device))

    nf = len(layout.friction_dofs)
    if nf:
        fd = list(layout.friction_dofs)
        bound = (model.dof_friction[fd] * dt).expand(B, nf)
        Js.append(t(layout.fr_onehot).expand(B, nf, n))
        bs.append(dq_star[:, fd])
        los.append(-bound)
        his.append(bound)
        acts.append(torch.ones((B, nf), dtype=dtype, device=device))
        mus.append(torch.zeros((B, nf), dtype=dtype, device=device))

    cat = lambda xs: torch.cat(xs, dim=1)
    return cat(Js), cat(bs), cat(los), cat(his), cat(acts), cat(mus)


def assemble_lcp(model: SkelModel, layout: RowLayout, phi,
                 M, q, dq_before, dq_star, contacts: Contacts, dt):
    """Assemble the per-env boxed LCP as the solver sees it.

    Returns (A, b, lo, hi, active, mu, findex, MinvJt, row_sel, J) where
    `findex` is the static (possibly compacted) friction-index array,
    `row_sel` the (B, m_c) int64 indices of the kept rows in the full
    stack (None when contact_cap is off) and J the (compacted) rows."""
    m = layout.m
    dtype, device = dq_star.dtype, dq_star.device
    cfg = model.solver

    J, b, lo, hi, active, mu = assemble_rows(
        model, layout, phi, q, dq_before, dq_star, contacts, dt)

    # ---- active-set compaction (contact_cap) ----------------------------
    # keep the best `cap` slots (active first, then deepest; ties to the
    # lower slot index), then restore the original slot order: PGS is
    # order-dependent, so the capped sweep must visit surviving rows in
    # the uncapped order
    ns = layout.contact_slots
    cap = int(cfg.contact_cap)
    findex = layout.findex
    row_sel = None
    if cap and 0 < cap < ns:
        score = contacts.active * 1e4 + contacts.depth
        _, slot_idx = topk_stable(score, cap)              # (B, cap)
        slot_idx, _ = torch.sort(slot_idx, dim=-1)
        crow = (slot_idx[:, :, None] * 3
                + torch.arange(3, device=device)).reshape(-1, 3 * cap)
        tail = torch.arange(3 * ns, m, device=device).expand(
            crow.shape[0], -1)
        row_sel = torch.cat([crow, tail], dim=1)           # (B, m_c)
        take = lambda x: torch.gather(x, 1, row_sel)
        J = torch.gather(J, 1, row_sel[:, :, None].expand(-1, -1, model.n))
        b, lo, hi = take(b), take(lo), take(hi)
        active, mu = take(active), take(mu)
        findex = compacted_findex(layout, cap)
        m = row_sel.shape[1]

    Jt = J.transpose(-1, -2)
    if model.n > _UNROLL_MAX:
        MinvJt = _pmm(inv_psd(M, eps=1e-10), Jt)           # (B, n, m)
    else:
        MinvJt = chol_solve(chol(M, eps=1e-10), Jt)
    A = _pmm(J, MinvJt)
    eye = torch.eye(m, dtype=dtype, device=device)
    A = A + cfg.cfm * eye
    # mask inactive rows out of the operator so they can't pollute pivots
    A = (A * active[:, :, None] * active[:, None, :]
         + eye * (1.0 - active)[:, None, :])
    return A, b, lo, hi, active, mu, findex, MinvJt, row_sel, J


def compact_lam(lam_prev, row_sel, active):
    """Warm-start impulses in the solver's row stack: gathered by the
    compaction and masked by the current active set."""
    lam0 = lam_prev if row_sel is None else torch.gather(lam_prev, 1,
                                                         row_sel)
    return lam0 * active


def scatter_lam(lam, row_sel, m: int):
    """Compacted impulses back to the full row stack (dropped rows 0)."""
    if row_sel is None:
        return lam
    return lam.new_zeros((lam.shape[0], m)).scatter_(1, row_sel, lam)


def solve_constraints(model: SkelModel, layout: RowLayout, phi,
                      M, q, dq_before, dq_star, contacts: Contacts, dt,
                      lam_prev=None):
    """Assemble + PGS-solve the per-env boxed LCP; returns (dq_plus, lam)
    with lam on the full row stack.  (Hybrid escalation runs in the fused
    substep phase, engine/hopper_substep.)"""
    if layout.m == 0:
        return dq_star, dq_star.new_zeros((dq_star.shape[0], 0))
    cfg = model.solver
    if cfg.solver != "pgs":
        raise NotImplementedError(
            f"solver={cfg.solver!r} mode is not ported yet")
    A, b, lo, hi, active, mu, findex, MinvJt, row_sel, _ = assemble_lcp(
        model, layout, phi, M, q, dq_before, dq_star, contacts, dt)
    lam0 = (compact_lam(lam_prev, row_sel, active)
            if lam_prev is not None else None)
    lam = pgs_solve(A, b, lo, hi, findex, mu, active, iters=cfg.pgs_iters,
                    lam0=lam0, omega=cfg.pgs_omega)
    dq_plus = dq_star + torch.sum(MinvJt * lam[:, None, :], dim=-1)
    return dq_plus, scatter_lam(lam, row_sel, layout.m)
