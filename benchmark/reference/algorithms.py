"""Per-body articulated-body algorithms: FK, ABA, CRBA, RNEA of ONE env,
and the batched pose-only forward kinematics the task layer calls.

The single-env forms (`fk`, `aba`, `crba`, `rnea_bias`,
`forward_dynamics_crb`) are the body recursions of the reference's
Featherstone dynamics, one env at a time: q, dq, tau are (n,) tensors.
They are what the C++ golden ABA (`native.aba`) is held to, and stand
apart from dynamics/batched (the production path's world-frame
formulation), so each checks the other.

Implicit joint spring/damping is folded into the solve with the time
step: D += dt*d + dt^2*k and the spring force uses -k (q - q0 + dt*dq).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from benchmark.reference.joints import JOINT_FNS, joint_kinematics
from benchmark.reference import spatial as sp
from benchmark.reference.linalg import solve_psd
from benchmark.reference.skel_model import SkelModel


@dataclasses.dataclass(frozen=True)
class Kin:
    """Forward-kinematics cache for one configuration (single env)."""

    R_w: Any    # (nb, 3, 3) body orientation in world
    p_w: Any    # (nb, 3) body origin in world
    E: Any      # (nb, 3, 3) parent->child motion-transform rotation (R_rel^T)
    r: Any      # (nb, 3)   child origin in parent frame
    S: Any      # (n, 6)    per-dof motion subspace columns, child body frame
    Sdot: Any   # (n, 6)    d/dt of S (velocity-product term)
    v: Any      # (nb, 6)   body spatial velocity, body frame


def _joint_slices(model: SkelModel):
    return [(i, model.q_start[i], model.q_start[i] + model.ndof[i])
            for i in range(model.nb)]


def fk(model: SkelModel, q, dq) -> Kin:
    """Forward kinematics and body velocities of one env: q, dq (n,)."""
    R_w, p_w, E, r, v, S_rows, Sd_rows = [], [], [], [], [], [], []
    for i, a, b in _joint_slices(model):
        qj, dqj = q[a:b], dq[a:b]
        Rj, pj, Sj, Sdj = joint_kinematics(model.joint_type[i],
                                           model.axes[i], qj, dqj)
        # T_rel = T_pj o T_joint o inv(T_cj)
        R1, p1 = sp.t_compose(model.pj_rot[i], model.pj_pos[i], Rj, pj)
        cj_inv_R, cj_inv_p = sp.t_inv(model.cj_rot[i], model.cj_pos[i])
        R_rel, p_rel = sp.t_compose(R1, p1, cj_inv_R, cj_inv_p)
        # motion subspace into the child body frame: Ad_{T_cj} S_joint
        cjR, cjp = model.cj_rot[i], model.cj_pos[i]

        def _ad(cols):
            wb = cjR @ cols[:3, :]
            vb = cjR @ cols[3:, :] + torch.linalg.cross(
                cjp[:, None].expand_as(wb), wb, dim=0)
            return torch.cat([wb, vb], dim=0)

        Sb, Sdb = _ad(Sj), _ad(Sdj)
        Ei = R_rel.T
        par = model.parent[i]
        if par < 0:
            Rwi, pwi = R_rel, p_rel
            v_par = q.new_zeros(6)
        else:
            Rwi = R_w[par] @ R_rel
            pwi = p_w[par] + R_w[par] @ p_rel
            v_par = v[par]
        vi = sp.xmotion_apply(Ei, p_rel, v_par) + Sb @ dqj
        R_w.append(Rwi)
        p_w.append(pwi)
        E.append(Ei)
        r.append(p_rel)
        v.append(vi)
        S_rows.append(Sb.T)
        Sd_rows.append(Sdb.T)
    empty = q.new_zeros((0, 6))
    return Kin(R_w=torch.stack(R_w), p_w=torch.stack(p_w),
               E=torch.stack(E), r=torch.stack(r),
               S=torch.cat(S_rows) if S_rows else empty,
               Sdot=torch.cat(Sd_rows) if Sd_rows else empty,
               v=torch.stack(v))


def fk_positions(model: SkelModel, q):
    """Pose-only forward kinematics of a batch: q (B, n) ->
    (R_w (B, nb, 3, 3), p_w (B, nb, 3))."""
    R_w, p_w = [], []
    for i in range(model.nb):
        a, b = model.q_start[i], model.q_start[i] + model.ndof[i]
        Rj, pj = JOINT_FNS[model.joint_type[i]](model.axes[i], q[:, a:b])
        # T_rel = T_pj o T_joint o inv(T_cj)
        R1 = sp.mm(model.pj_rot[i], Rj)
        p1 = model.pj_pos[i] + sp.mv(model.pj_rot[i], pj)
        cj_inv_R = model.cj_rot[i].transpose(-1, -2)
        cj_inv_p = -sp.mv(cj_inv_R, model.cj_pos[i])
        R_rel = sp.mm(R1, cj_inv_R)
        p_rel = p1 + sp.mv(R1, cj_inv_p)
        par = model.parent[i]
        if par < 0:
            R_w.append(R_rel)
            p_w.append(p_rel)
        else:
            R_w.append(sp.mm(R_w[par], R_rel))
            p_w.append(p_w[par] + sp.mv(R_w[par], p_rel))
    return torch.stack(R_w, dim=1), torch.stack(p_w, dim=1)


def body_point_world(model: SkelModel, q, body: int, offset):
    """World position (B, 3) of a body-frame point (e.g. a fingertip)."""
    R_w, p_w = fk_positions(model, q)
    off = torch.as_tensor(offset, dtype=q.dtype, device=q.device)
    return p_w[:, body] + sp.mv(R_w[:, body], off)


def _body_inertias(model: SkelModel):
    return sp.spatial_inertia(model.mass, model.com, model.inertia)


def _fext_body(model: SkelModel, kin: Kin, f_ext_world):
    """External [torque; force] (nb, 6) in world coordinates, applied at
    each body origin -> body-frame spatial forces (nb, 6)."""
    if f_ext_world is None:
        return None
    Rt = kin.R_w.transpose(-1, -2)
    return torch.cat([sp.mv(Rt, f_ext_world[..., :3]),
                      sp.mv(Rt, f_ext_world[..., 3:])], dim=-1)


def _bias_c(model: SkelModel, kin: Kin, dq):
    """Velocity-product acceleration c_i = crm(v_i) S dq + Sdot dq per
    body."""
    cs = []
    for i, a, b in _joint_slices(model):
        vJ = kin.S[a:b].T @ dq[a:b]
        cs.append(sp.crm(kin.v[i], vJ) + kin.Sdot[a:b].T @ dq[a:b])
    return cs


def aba(model: SkelModel, kin: Kin, q, dq, tau, dt, f_ext_world=None):
    """Articulated Body Algorithm (O(n)) with implicit spring/damping:
    articulated inertias and bias forces tip to root, accelerations root
    to tip.  Returns ddq (n,)."""
    nb = model.nb
    I = _body_inertias(model)
    fext_b = _fext_body(model, kin, f_ext_world)
    c = _bias_c(model, kin, dq)

    IA = [I[i] for i in range(nb)]
    pA = []
    for i in range(nb):
        p_i = sp.crf(kin.v[i], sp.inertia_mul(I[i], kin.v[i]))
        if fext_b is not None:
            p_i = p_i - fext_b[i]
        pA.append(p_i)

    d, k = model.damping, model.spring_stiff
    tau_total = tau - d * dq - k * (q - model.rest_pos + dt * dq)

    U, Dinv_l, u_l = [None] * nb, [None] * nb, [None] * nb
    slices = _joint_slices(model)
    for i, a, b in reversed(slices):
        Sb = kin.S[a:b].T                      # (6, nd)
        nd = b - a
        Ui = IA[i] @ Sb
        if nd > 0:
            Di = Sb.T @ Ui + torch.diag(dt * d[a:b] + dt * dt * k[a:b])
            Dinv = (torch.linalg.inv(Di + 1e-12 * torch.eye(
                nd, dtype=q.dtype, device=q.device)) if nd > 1
                else 1.0 / Di)
            ui = tau_total[a:b] - Sb.T @ pA[i]
        else:
            Dinv = ui = None
        U[i], Dinv_l[i], u_l[i] = Ui, Dinv, ui
        par = model.parent[i]
        if par >= 0:
            if nd > 0:
                Ia = IA[i] - Ui @ (Dinv @ Ui.T)
                pa = pA[i] + Ia @ c[i] + Ui @ (Dinv @ ui)
            else:
                Ia = IA[i]
                pa = pA[i] + Ia @ c[i]
            X = sp.xmotion_mat(kin.E[i], kin.r[i])
            IA[par] = IA[par] + X.T @ Ia @ X
            pA[par] = pA[par] + X.T @ pa

    a_base = torch.cat([torch.zeros_like(model.gravity), -model.gravity])
    acc = [None] * nb
    ddq = torch.zeros_like(q)
    for i, a, b in slices:
        par = model.parent[i]
        a_par = a_base if par < 0 else acc[par]
        a_prime = sp.xmotion_apply(kin.E[i], kin.r[i], a_par) + c[i]
        if b > a:
            qdd = Dinv_l[i] @ (u_l[i] - U[i].T @ a_prime)
            ddq[a:b] = qdd
            acc[i] = a_prime + kin.S[a:b].T @ qdd
        else:
            acc[i] = a_prime
    return ddq


def crba(model: SkelModel, kin: Kin):
    """Composite Rigid Body Algorithm: joint-space mass matrix M (n, n)."""
    nb = model.nb
    I = _body_inertias(model)
    Ic = [I[i] for i in range(nb)]
    X = [sp.xmotion_mat(kin.E[i], kin.r[i]) for i in range(nb)]
    for i in reversed(range(nb)):
        par = model.parent[i]
        if par >= 0:
            Ic[par] = Ic[par] + X[i].T @ Ic[i] @ X[i]
    M = kin.S.new_zeros((model.n, model.n))
    for i, a, b in _joint_slices(model):
        if b == a:
            continue
        Sb = kin.S[a:b].T
        F = Ic[i] @ Sb                       # (6, nd)
        M[a:b, a:b] = Sb.T @ F
        j = i
        while model.parent[j] >= 0:
            F = X[j].T @ F
            j = model.parent[j]
            ja, jb = model.q_start[j], model.q_start[j] + model.ndof[j]
            if jb > ja:
                blk = F.T @ kin.S[ja:jb].T    # (nd_i, nd_j)
                M[a:b, ja:jb] = blk
                M[ja:jb, a:b] = blk.T
    return M


def rnea_bias(model: SkelModel, kin: Kin, dq, f_ext_world=None):
    """Generalized bias forces C(q, dq) (Coriolis + gravity - external):
    inverse dynamics at ddq = 0, so that M ddq + C = tau for unconstrained
    motion (spring and damping terms are the caller's)."""
    nb = model.nb
    I = _body_inertias(model)
    fext_b = _fext_body(model, kin, f_ext_world)
    c = _bias_c(model, kin, dq)
    a_base = torch.cat([torch.zeros_like(model.gravity), -model.gravity])

    acc, f = [None] * nb, [None] * nb
    slices = _joint_slices(model)
    for i, a, b in slices:
        par = model.parent[i]
        a_par = a_base if par < 0 else acc[par]
        acc[i] = sp.xmotion_apply(kin.E[i], kin.r[i], a_par) + c[i]
        f_i = sp.inertia_mul(I[i], acc[i]) + sp.crf(
            kin.v[i], sp.inertia_mul(I[i], kin.v[i]))
        if fext_b is not None:
            f_i = f_i - fext_b[i]
        f[i] = f_i

    C = dq.new_zeros(model.n)
    for i, a, b in reversed(slices):
        if b > a:
            C[a:b] = kin.S[a:b] @ f[i]
        par = model.parent[i]
        if par >= 0:
            f[par] = f[par] + sp.xforce_inv_apply(kin.E[i], kin.r[i], f[i])
    return C


def forward_dynamics_crb(model: SkelModel, kin: Kin, q, dq, tau, dt,
                         f_ext_world=None):
    """Forward dynamics through (M + dt*D + dt^2*K) ddq = tau_total - C,
    the implicit spring/damper scheme of `aba`.  Returns (ddq, M)."""
    M = crba(model, kin)
    C = rnea_bias(model, kin, dq, f_ext_world)
    d, k = model.damping, model.spring_stiff
    tau_total = tau - d * dq - k * (q - model.rest_pos + dt * dq) - C
    ddq = solve_psd(M + torch.diag(dt * d + dt * dt * k), tau_total,
                    eps=1e-10)
    return ddq, M
